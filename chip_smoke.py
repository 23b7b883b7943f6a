#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --kernel-times [--src DIR]
    python3 chip_smoke.py --path-times [--src DIR]
    python3 chip_smoke.py --decode-ab PARENT_SRC [--src DIR]

Eight paths, each at full width with random weights from --seed, in bf16
(and, in phase 22, the dry run of the production meshes):
stablelm-1.6b served (dense; prefill attention in the flash-attention
kernel), olmoe-1b-7b served (MoE; the same attention kernel, and the
expert FFN in the moe_mlp kernel), stablelm-1.6b trained (AdamW with int8
gradient compression, whose quantization is the quantize kernel),
rwkv6-7b served (RWKV-6; the time mix's recurrence in the wkv6 kernel),
and jamba-v0.1-52b served at one period of its 8-layer pattern (Mamba,
attention and MoE; the attention layer's prefill in the flash kernel,
every MoE FFN in moe_mlp, the Mamba scan in plain PyTorch as in JAX), and
qwen2-vl-7b served (the VLM backbone: M-RoPE, a 256-token vision prefix
in front of every prompt; prefill attention in the flash kernel at GQA
28/4, its mask the vision prefix's, see phase 3), and whisper-small
served (encoder-decoder: 1500 encoder frames a request; flash not causal
in the encoder and in cross attention, causal in the decoder), and
stablelm-1.6b trained through the Trainer loop at 2 layers (checkpoints,
a failure, a restore and a replay; the quantize kernel in every step).
Phases, each of which raises on failure (the script then exits non-zero):

1. card     -- the card's name and power limit (nvidia-smi), torch and CUDA
2. build    -- compile the four kernels from the sources in this checkout,
               one nvcc each (sm_90a), all started together, and print the
               compiler's report
3. sweep    -- each kernel against its plain PyTorch version on the card:
               flash over the sweep of tests/test_kernels.py x {f32, bf16}
               plus ragged lengths on both sides of the 128-row tiles,
               GQA, d=16 and 32, windows that end inside a tile,
               olmoe's heads, and qwen2-vl-7b's GQA 28/4 at d=128 with and
               without a vision prefix (keys below the prefix visible to
               every row), and whisper-small's heads not causal over 1500
               keys (its encoder, and cross attention from 1, 129 and 416
               queries); flash on a slice of query rows with their
               offset (q_offset: causal, windowed, with a prefix, d=64
               and 128), each shard of a split sequence against those
               rows of the whole call (bit for bit counted), and qwen2-vl-
               7b's last context-parallel shard (2048 rows of 32768 keys)
               timed against its bound and SDPA with the mask; moe_mlp
               over its sweep of
               tests/test_kernels.py and olmoe's widths at the ragged
               capacities its prefill and decode give, decode steps of
               4 and 8 slots and of C > 1 folded into one row tile, then at
               jamba-v0.1-52b's and mixtral-8x22b's widths (d_ff 14336 and
               16384: the split schedule), timed at their prefill shapes;
               mixtral's prefill blocks through 16 calls on d_ff slices of
               1024 columns, as the op's d_ff layout runs each rank's
               slice on the (16, 16) mesh, their sum against the whole
               call, and the slice's call timed against its bound;
               quantize bit for bit over the sweep of tests/test_kernels.py
               x block {128, 256}, ragged lengths and edge rows; wkv6 over
               the sweep of tests/test_kernels.py, strong and slow decay,
               ragged lengths and rwkv6-7b's heads, from a zero and from a
               random state, y and the final state
4. model    -- stablelm-1.6b: a 2048-token prefill through the kernel path,
               and through the plain attention with the same weights;
               logits compared
5. serve    -- BatchServer(slots=4, seq_capacity=4096) serves 8 requests of
               128-2048 prompt tokens, 32 new tokens each: the main path,
               with every kernel's launch count read around it
6. timing   -- flash kernel, plain version and scaled_dot_product_attention
               (a yardstick the port never calls) at the main path's shape,
               then the kernel alone at each prompt length the serve run had
7. profile  -- torch.profiler over a second, smaller serve run: the device's
               busy share of prefill and of decode steps, and device time by
               kernel name
8. olmoe    -- stablelm's parameters freed, olmoe-1b-7b drawn, then phases
               4, 5 and 7 for it (the model phase puts the plain expert FFN
               in the kernel's place), and the moe_mlp kernel, its plain
               version and three torch.bmm (a yardstick the port never
               calls) timed at the prefill (C=320) and decode (G=4, C=1)
               shapes, where the kernel is also checked to keep h in f32,
               and alone at three shapes that tell whether L2 or device
               memory sets its pace
9. train    -- olmoe freed; stablelm-1.6b, f32 master params drawn on the
               card, 10 steps of build_train_step on 4 x 2048 tokens of the
               synthetic pipeline with grad_compress: finite, falling loss,
               one quantize launch per parameter leaf per step and no
               forward-only kernel launch
10. grads   -- one more step's real gradients plus error buffer, leaf by
               leaf: the quantize kernel against its plain version, bit for
               bit; compress_gradients timed against the step
11. qtiming -- the quantize kernel and its plain version on the largest
               leaf and over all leaves, against the bytes bound
12. tprofile -- torch.profiler over 2 train steps: the device's busy share
               and device time by step phase and by kernel
13. moetrain -- olmoe-1b-7b at full width cut to 2 of its 16 layers (full
               depth does not fit one card in f32 with AdamW): 2 steps with
               grad_compress, finite loss, a nonzero aux loss, a gradient
               on every expert and on the router
14. rwkv     -- the train states freed; rwkv6-7b drawn at full width, its
               zero- and one-initialised leaves perturbed from the seed;
               phases 4 and 5 for it (the model phase puts the plain chunked
               scan in the kernel's place), a prefill of 2047 tokens and one
               decode step against a prefill of 2048 (the state handoff),
               the kernel, its plain version and the plain chunked scan
               timed at the prefill shape and the kernel alone at each
               served length, then phase 7 for it
15. rwkvtrain -- rwkv6-7b at full width cut to 2 of its 32 layers: 2 steps
               with grad_compress, finite loss, a gradient on every leaf of
               the time mix, no wkv6 launch
16. fidelity -- repro_torch.core.fidelity at full width: NativeBackend times
               stablelm-1.6b's and olmoe-1b-7b's prefill step at b=1 s=2048
               (run while each model is loaded, after phases 7 and 8);
               then DryRunBackend on fake CUDA tensors, params included:
               the prefills of stablelm-1.6b (24 flash ops), olmoe-1b-7b
               (16 flash and 16 moe_mlp), rwkv6-7b (32 wkv6) and
               deepseek-67b (95 flash; its 134 GB of bf16 params never
               exist), jamba-v0.1-52b at all 32 layers (4 flash and 16
               moe_mlp; 104 GB of bf16 params never exist), qwen2-vl-7b
               (28 flash; 1792 tokens and the 256-token vision prefix,
               flops within 1% of the analytic count), whisper-small (36
               flash; 416 tokens and 1500 frames, flops within 1% of the
               analytic count), each with every op costed by a rule, and
               the
               train cell's step (15 quantize ops, no forward-only
               kernel): no launch, no device memory, each total beside
               the analytic 2 N tokens plus attention (and the Mamba
               recurrence); then the detailed rung on the card's model:
               DesimBackend replays stablelm-1.6b's and olmoe-1b-7b's
               prefill dry runs and the train cell's on h100_card() (the
               port's own simulator, one H100 SXM5), one line each with
               the native ms (the prefills' NativeBackend, phase 12's
               median step), the predicted ms, predicted/measured, the
               dry run's flops and bytes and the card; it fails if a
               replay raises, a prediction is not positive, or the
               trace's flops and bytes are not the dry run's totals
17. jamba  -- everything before freed; jamba-v0.1-52b at full width cut to
               one period (8 of its 32 layers: 52 B parameters do not fit
               one card), drawn in f32 and cast to bf16 leaf by leaf (the
               init's peak printed); phase 4 for it with both the flash
               and the moe_mlp wrappers replaced by their plain versions;
               a prefill of 2047 tokens and one decode step against a
               prefill of 2048 (the conv and ssm state handoff, dropless
               routing); phase 5 (exactly 8 flash launches, none in a
               decode step, and 4 moe_mlp launches per prefill and per
               decode step); flash at its attention shape (GQA 32/8,
               d=128) against SDPA and moe_mlp at its decode shape (G=4,
               C=1); the plain Mamba scan's peak memory and time at 2048
               tokens; then phase 7 for it, with the scan's device time
18. qwen2-vl -- jamba freed; qwen2-vl-7b at full width and depth (28
               layers, 7.6 B params), drawn in f32 and cast to bf16 leaf
               by leaf (the init's peak printed); phase 4 on 256 vision
               and 1792 text tokens (the plain flash in the kernel's
               place); phase 5 with a vision prefix drawn from the seed
               on every request (exactly 224 flash launches, none in a
               decode step); flash at GQA 28/4 d=128 against SDPA
               (enable_gqa), and alone with the 256-key prefix; phase 7
               for it
19. whisper -- qwen2-vl freed; whisper-small at full width and depth (12
               encoder layers over 1500 frames, 12 decoder layers, 285.5
               M params); phase 4 on a 416-token prompt and its frames (the
               plain flash in the kernel's place); phase 5 at a 448-token
               capacity (its decoder context), prompts of 16-416 tokens,
               every request with frames drawn from the seed (exactly 288
               = 36 x 8 flash launches, none in a decode step); flash
               against SDPA at the encoder's shape (not causal, 1500 x
               1500) and at cross attention's (416 x 1500); phase 7 for it
20. trainer -- whisper freed; stablelm-1.6b at full width cut to 2 of its 24
               layers, trained by repro_torch.train.Trainer: 6 steps of 4 x
               2048 tokens with grad_compress, async checkpoints every 2
               steps (keep_n=1) under _ckpt/, a SimulatedFailure at step 5:
               the trainer restores step 4 and replays it.  The replayed
               step's loss equals its first run's bit for bit; the loss
               falls; one quantize launch per leaf per step run, replay
               included, and no forward-only kernel launch; the final
               checkpoint, restored into TensorSpecs on the card, equals
               the trainer's final state bit for bit; the checkpoint's
               bytes, the directory's free space (three checkpoints or it
               raises), a save's foreground ms, the background write's
               and the restore's seconds and GB/s
21. mesh   -- a world-1 NCCL process group (an in-memory store) and the
               (1, 1) ("data", "model") mesh of repro_torch.launch.mesh;
               stablelm-1.6b at full width and depth, its params
               distributed by MeshSharder.param_shardings(param_specs()[1]):
               a 2048-token prefill and 8 decode steps through
               build_prefill_step and build_decode_step with the sharder,
               logits bit for bit equal to the same steps on plain tensors,
               exactly 24 flash launches in the prefill and none in decode;
               olmoe-1b-7b the same way (16 flash and 16 moe_mlp launches a
               prefill, 16 moe_mlp a decode step); the host ms of the
               sharded and the plain prefill and decode step, in turns;
               stablelm-1.6b at 2 of 24 layers: 2 train steps on DTensor
               state with grad_compress and shard_like_params, the losses
               bit for bit equal to the plain steps', 15 quantize launches
               a step; phase 20's final checkpoint restored with shardings
               onto the mesh, bit for bit against the plain restore; the
               process group destroyed
22. dryrun -- repro_torch.launch.dryrun on the card: (a) on a world-1 NCCL
               group and the (1, 1) mesh, stablelm-1.6b's prefill_32k cell
               cut to batch 1 and olmoe-1b-7b's decode_32k cut to batch 4,
               each dry-run and then run for real on DTensors of its specs
               (params drawn from the seed): the dry run's kernel ops equal
               the launches and its argument bytes the real arguments',
               exactly; its predicted peak beside max_memory_allocated,
               their ratio within DRYRUN_PEAK_BOUND, and its roofline
               bound over the CUDA-event ms, printed; then the train loss
               on stablelm-1.6b's logits for 4 x 4096 tokens split over
               the mesh's "model" dim (its vocab-split path), forward and
               backward: dry-run, then run, its loss and gradient equal to
               the plain tensors' bit for bit, its predicted peak over
               max_memory_allocated (within DRYRUN_PEAK_BOUND) and its ms
               printed; (b) production
               cells under PyTorch's fake process group on fake CUDA
               tensors, on the (16, 16) mesh (stablelm-1.6b and
               minicpm-2b train_4k, olmoe-1b-7b prefill_32k, deepseek-67b
               prefill_32k and decode_32k, olmoe-1b-7b decode_32k: its
               cache's layers split over "data", moved a layer at a time,
               qwen2-vl-7b, minicpm-2b and
               whisper-small prefill_32k, jamba-v0.1-52b long_500k,
               mixtral-8x22b decode_32k: its experts' d_ff split) and the
               (2, 16, 16) one (olmoe-1b-7b prefill_32k): each ok, one JSON
               line each (per-device GB, fits_hbm, the dominant roofline
               term and bound, useful flops, collective bytes by kind,
               kernel ops, host seconds, the largest ops by bytes, the
               count of its desim trace's ops), each
               costed as the last rank along "model"; each cell's desim
               trace (core.fidelity.step_trace) holds its collectives,
               their count and bytes by kind those of the dry run; a
               decode cell returns its cache argument; no cell replicates
               a kernel or moves a stacked layer leaf whole, and no train
               cell whose rules split the vocab has an op of the whole
               vocab among its largest; where the rules split the heads,
               the per-device flash flops times the ranks that split them
               equal the global flash flops, and where they split the
               query rows (qwen2-vl-7b's, minicpm-2b's and whisper-small's
               context-parallel prefills), the costed rank's (the last
               rows) times those ranks are at least the global flops
23. servesim -- serving and sampled simulation on the card's model: the
               serve phase's batched decode step (4 slots, capacity 4096)
               of stablelm-1.6b and olmoe-1b-7b dry-run on fake CUDA
               tensors at full width (no launch, no device memory;
               olmoe's moe_mlp op once a layer) and ServingCost fitted to
               it by from_hlo_cost at the whole static cache, decode_cost
               giving back its flops and bytes to 1e-9; ServeSim on
               h100_card(1) with phase 5's 8 requests: the predicted ms a
               decode step, the TPOT and the live context it charged, on
               one line with phase 5's measured median and their ratio;
               FleetSim on h100_fleet(6, 1) with stablelm's fit and the
               flash crowd of examples/fleet_sim.py (420 requests,
               least_loaded, 2-6 replicas, atomic): replicas, scale-ups
               and downs, TTFT p50/p99, goodput, and a fresh
               FleetController's replay of its feed equal to its decision
               log; the SimPoint lap on phase 16's train step trace
               chained over 20 steps, every fifth an evaluation pass
               (stablelm's prefill trace): full detail, sampled_run with
               the default SamplePlan, sampled_run with simpoint_plan,
               and take_region_checkpoints, restore_fanout by two spawned
               workers and reconstruct, each within 0.05 of full detail,
               the fanout equal to a serial restore

Every kernel's bound is its ``cost`` (flops, bytes) in its ``ops.py``, the
definition the dry run's kernel ops are costed by.  It prints the fidelity,
trainer, mesh, dry-run (phase 22) and serving-simulation (phase 23)
results and the kernel table as one JSON line each, then the card's name and power limit, then the result line
{"ok": true, "device": {...}} last.
Without a CUDA device, or without the repo's ``src/repro_torch`` beside it,
it exits non-zero and prints no result.

``--kernel-times`` runs only phases 1 and 2 for the flash_attention,
moe_mlp and wkv6 kernels and their timings (phase 6's at stablelm's,
olmoe's and qwen2-vl's attention shapes and whisper-small's two; phase
8's at olmoe's prefill and decode, and at jamba's and mixtral's prefill,
and the waves; wkv6 at
rwkv6-7b's prefill shape and at each prompt length of the serve run,
each checked once against its plain version, with its bound and share
of the bound), then
prints the times as one JSON line and the card's line, with no result
line (the tree must hold each kernel's ``cost``).  ``--path-times`` runs
only phases 1 and 2 for flash_attention and moe_mlp and times stablelm-1.6b's
and olmoe-1b-7b's serving paths (a 2048-token prefill, the serve run of
phase 5, the host time of a wrapper call), then prints them as one JSON line
and the card's line.  ``--src DIR`` imports and builds ``repro_torch`` from
DIR instead of this checkout's ``src``: run once per tree, in turns, to
compare two trees (e.g. a parent commit unpacked with ``git archive``) on
one card.  ``--decode-ab PARENT_SRC`` times the plain decode step of the
tree at ``--src`` and of the one at PARENT_SRC in one process, in turns
on the same params, tokens and cache contents (stablelm-1.6b and
olmoe-1b-7b at full width, the serve run's batch), so that both trees
share the host's noise; it prints the times and the ratios as one JSON
line and the card's line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH, MOE_ARCH, RWKV_ARCH = "stablelm-1.6b", "olmoe-1b-7b", "rwkv6-7b"
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
SERVE_REQUESTS, SERVE_SLOTS, SERVE_CAP, SERVE_NEW = 8, 4, 4096, 32
PROFILE_REQUESTS, PROFILE_NEW, PROFILE_TOP = 4, 8, 8
MAIN_SHAPE = dict(b=1, s=2048, h=32, d=64)    # stablelm prefill attention
MOE_ATTN_SHAPE = dict(b=1, s=2048, h=16, d=128)  # olmoe prefill attention
# model phase: the kernel and plain paths differ only in the order of f32
# sums inside attention, which flips bf16 roundings of attention outputs by
# one ulp (2^-8 relative); 24 residual layers spread the flips.  5% of the
# largest logit is ~13 such ulps; a wrong mask, scale or head mapping moves
# logits by the order of the logits themselves.
LOGIT_RTOL = 0.05
TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py
MOE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py
# olmoe's model phase: the two paths differ only inside the expert FFN,
# in the order of its f32 sums (both keep h in f32), which flips bf16
# roundings of a layer's output by one ulp.  A
# router near a tie between its 8th and 9th expert may then pick the
# other one for that token, a larger but local change; 16 layers of it
# stay well inside 5% of the largest logit, while a wrong kernel moves
# logits by the order of the logits themselves.
MOE_LOGIT_RTOL = 0.05
# (g, e, c, d, f): tests/test_kernels.py's moe_mlp sweep, then olmoe-1b-7b
# (E=64, D=2048, F=1024) at the capacities of prompts of 159, 1762 and 2048
# tokens (C=25, 276, 320) and of a decode step over 4 slots (G=4, C=1),
# then decode steps folded into one row tile per expert (G C <= 64: 8
# slots, and C > 1) at olmoe's widths and at a narrow one
MOE_SWEEP = [(2, 4, 128, 64, 256), (1, 2, 64, 128, 512), (2, 2, 128, 32, 128),
             (1, 64, 1, 2048, 1024), (1, 64, 25, 2048, 1024),
             (1, 64, 276, 2048, 1024), (1, 64, 320, 2048, 1024),
             (4, 64, 1, 2048, 1024), (8, 64, 1, 2048, 1024),
             (3, 64, 5, 2048, 1024), (2, 64, 17, 2048, 1024),
             (8, 4, 1, 64, 256), (3, 4, 5, 64, 256), (2, 4, 17, 64, 256)]
MOE_PREFILL, MOE_DECODE = (1, 64, 320, 2048, 1024), (4, 64, 1, 2048, 1024)
# d_ff too large for the one-pass schedule: jamba-v0.1-52b (E=16, top-2,
# capacity factor 1.0) and mixtral-8x22b (E=8, top-2, capacity factor 1.25)
# at the capacity of a 2048-token prefill, ceil(2048 * 2 * cf / E), and of
# a decode step over 4 slots (G=4, C=1)
MOE_LARGE_F = [(1, 16, 256, 4096, 14336), (4, 16, 1, 4096, 14336),
               (1, 8, 640, 6144, 16384), (4, 8, 1, 6144, 16384)]
MOE_LARGE_F_PREFILL = {"jamba-v0.1-52b": MOE_LARGE_F[0],
                       "mixtral-8x22b": MOE_LARGE_F[2]}
# mixtral-8x22b's 8 experts do not divide the 16 ranks of "model": its
# rules split the experts' d_ff, and each rank's expert_mlp call runs its
# slice of 16384 / 16 columns (the op's d_ff layout, a partial sum)
MOE_D_FF_SLICES = 16
# wkv6: (b, s, h, n, chunk), tests/test_kernels.py's sweep, then ragged
# lengths and rwkv6-7b's heads at the model phase's length
WKV_SWEEP = [(2, 128, 2, 64, 64), (1, 256, 4, 32, 32), (2, 64, 1, 16, 16),
             (1, 96, 2, 32, 32), (1, 1, 2, 64, 32), (1, 77, 2, 64, 32),
             (1, 1036, 2, 64, 32), (1, 2048, 64, 64, 32)]
# y: 5e-4 in f32 (tests/test_kernels.py); in bf16 the kernel and its plain
# version compute in f32 from the same inputs and round y once, so they
# may land one bf16 ulp apart, which is at most 2^-7 (7.8e-3) of |y|
# (just above a power of two): 8e-3.  The final state is f32 in both:
# 5e-4.
WKV_TOL = {"float32": 5e-4, "bfloat16": 8e-3}
RWKV_SHAPE = dict(b=1, s=2048, h=64, n=64)    # rwkv6-7b prefill time mix
RWKV_CHUNK = 32                               # the model's chunk
# rwkv6-7b's model phase: the kernel runs the recurrence token by token,
# the plain path the chunked scan; they sum in other f32 orders, which
# flips bf16 roundings of the time mix's output by one ulp, and 32
# residual layers spread the flips.  5% of the largest logit is many such
# ulps; a wrong state, decay or bonus moves logits by their own scale.
# The handoff (a decode step after 2047 tokens against a prefill of 2048)
# differs in the same way.
RWKV_LOGIT_RTOL = 0.05
RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = 2, 2
# training: stablelm-1.6b at full width and depth on 4 x 2048 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROFILE_STEPS = 4, 2048, 10, 2
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 2
# quantize: tests/test_kernels.py's lengths, then ragged ones
QUANT_SIZES = [256, 1000, 4096, 65536, 1, 77, 3 * 256 + 5, 1000003]
# fidelity: the batch and length of the native and dry-run prefills, and
# NativeBackend's timed calls after its warm-up
FIDELITY_B, FIDELITY_S, FIDELITY_ITERS = 1, 2048, 5
DENSE_67B = "deepseek-67b"
# jamba-v0.1-52b: one period of its 8-layer pattern on the card (13.3 B
# params, 26.5 GB in bf16, 53.1 GB in f32 at init); all 32 layers only
# in the dry run
JAMBA_ARCH, JAMBA_PERIODS = "jamba-v0.1-52b", 1
JAMBA_ATTN_SHAPE = dict(b=1, s=2048, h=32, kvh=8, d=128)
JAMBA_MOE_DECODE = MOE_LARGE_F[1]              # G=4 C=1, E=16, F=14336
# jamba's model phase and handoff: the kernel and plain paths differ in
# the order of f32 sums inside attention and the expert FFN, which flips
# bf16 roundings by one ulp; 8 layers of Mamba state carry the flips.
# The handoff's decode step runs the one-token recurrence where the
# longer prefill runs the chunked scan.  5% of the largest logit is many
# such ulps; a wrong state, mask or expert moves logits by their scale.
JAMBA_LOGIT_RTOL = 0.05
# qwen2-vl-7b: all 28 layers at full width (7.615 B params, 15.2 GB in
# bf16, 30.5 GB in f32 at init); every request and the model phase's
# prefill carry the 256-token vision prefix of the stub frontend
VLM_ARCH = "qwen2-vl-7b"
VLM_ATTN_SHAPE = dict(b=1, s=2048, h=28, kvh=4, d=128)
# the model phase: as stablelm's, the two paths differ only in the order
# of f32 sums inside attention; 28 layers spread the one-ulp flips
VLM_LOGIT_RTOL = 0.05
# the Trainer (phase 20): stablelm-1.6b at full width cut to 2 of its 24
# layers (514 M params; its f32 params, moments and error buffer make an
# 8.2 GB checkpoint, 26 GB at full depth), checkpoints every 2 steps into
# TRAINER_CKPT_DIR (listed in .gitignore, removed after phase 21, which
# restores the final checkpoint onto a mesh), a failure injected at step
# 5, so that step 4 is replayed from the step-4 checkpoint
TRAINER_LAYERS, TRAINER_STEPS, TRAINER_EVERY, TRAINER_FAIL_AT = 2, 6, 2, 5
TRAINER_CKPT_DIR = "_ckpt"
# the mesh (phase 21): a world-1 NCCL group and the (1, 1) ("data",
# "model") mesh; stablelm-1.6b and olmoe-1b-7b served at full width and
# depth with DTensor params (a 2048-token prefill, 8 decode steps), and
# stablelm-1.6b at 2 layers trained 2 steps on DTensor state; each held
# bit for bit against the same steps on plain tensors
MESH_SEQ, MESH_DECODE_STEPS = 2048, 8
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 2
# the production-mesh dry run (phase 22): two cells cut to a batch that
# fits one card, dry-run and run on the (1, 1) mesh of a world-1 NCCL
# group (stablelm-1.6b's 32768-token prefill at batch 1, flash; olmoe-1b-7b
# decoding at batch 4 against its 32768-slot cache, 17.2 GB in bf16, with
# 27.7 GB of f32 params: moe_mlp), the predicted peak held against
# DRYRUN_PEAK_BOUND (PERF.md); then production cells on the (16, 16) and
# (2, 16, 16) meshes of PyTorch's fake process group, on fake CUDA tensors,
# each costed as the last rank along "model" (qwen2-vl-7b's, minicpm-2b's
# and whisper-small's prefills split their query rows over it: that rank
# holds the heaviest rows)
DRYRUN_NATIVE = [("stablelm-1.6b", "prefill_32k", 1),
                 ("olmoe-1b-7b", "decode_32k", 4)]
DRYRUN_PEAK_BOUND = (0.9, 1.1)
# the train loss on the (1, 1) mesh: stablelm-1.6b's logits for batch x
# seq tokens, the vocab split over "model" (a split of one)
DRYRUN_LOSS = ("stablelm-1.6b", 4, 4096)
DRYRUN_CELLS = [(False, [("stablelm-1.6b", "train_4k"),
                         ("minicpm-2b", "train_4k"),
                         ("olmoe-1b-7b", "prefill_32k"),
                         ("deepseek-67b", "prefill_32k"),
                         ("deepseek-67b", "decode_32k"),
                         ("olmoe-1b-7b", "decode_32k"),
                         ("qwen2-vl-7b", "prefill_32k"),
                         ("minicpm-2b", "prefill_32k"),
                         ("whisper-small", "prefill_32k"),
                         ("jamba-v0.1-52b", "long_500k"),
                         ("mixtral-8x22b", "decode_32k")]),
                (True, [("olmoe-1b-7b", "prefill_32k")])]
# each wrapper's custom op, by the counters' names
OP_OF = {"flash_attention": "flash_attention", "moe_mlp": "expert_mlp",
         "quantize": "quantize_blocks", "wkv6": "wkv6"}
# whisper-small at full width and depth: 12 encoder layers over its 1500
# frames, 12 decoder layers (285.5 M params); prompts and new tokens within
# its published 448-token decoder context (max_target_positions,
# hf:openai/whisper-small).  A prefill launches flash 36 times: the
# encoder's (non-causal, 1500 x 1500), the decoder's self attention
# (causal) and its cross attention (non-causal over the 1500 frames).
WHISPER_ARCH = "whisper-small"
WHISPER_CAP, WHISPER_PROMPT = 448, 416
WHISPER_LENS = (16, WHISPER_PROMPT + 1)
WHISPER_ENC_SHAPE = dict(b=1, s=1500, h=12, d=64, causal=False)
WHISPER_CROSS_SHAPE = dict(b=1, s=WHISPER_PROMPT, s_kv=1500, h=12, d=64,
                           causal=False)
# the model phase: as stablelm's, the two paths differ only in the order
# of f32 sums inside attention; 24 layers spread the one-ulp flips
WHISPER_LOGIT_RTOL = 0.05
# serving and sampled simulation on the card's model (phase 23): the
# SimPoint lap chains the train step's desim trace over SIMPOINT_STEPS
# steps, every SIMPOINT_EVAL_EVERY-th an evaluation pass (a prefill), so
# that SimPoint finds two phases and the fanout restores two regions in
# two workers; windows of SIMPOINT_WINDOW steps; a sampled run lands
# within SAMPLED_BOUND of full detail, the reference's own bound
# (tests/test_sampling.py, tests/test_simpoint.py)
SIMPOINT_STEPS, SIMPOINT_WINDOW, SIMPOINT_EVAL_EVERY = 20, 2, 5
SAMPLED_BOUND = 0.05


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_of(flops: float, nbytes: float, peak_flops: float):
    """(bound ms, what bounds it): the larger of ``flops`` at
    ``peak_flops`` and ``nbytes`` at the memory rate, both from the
    kernel's ``cost``."""
    return max((flops / peak_flops * 1e3, "operations"),
               (nbytes / PEAK_BYTES * 1e3, "bytes"))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, queued behind a
    ~20 ms sleep kernel: the calls are all enqueued before the first
    starts, so a kernel shorter than its wrapper's host time is timed on
    the card, not on the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(build, mods) -> None:
    """One nvcc per kernel source, all started together; the compiler's
    report (registers, shared memory, spills) printed."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        paths = list(pool.map(lambda m: build.build(m.SOURCE), mods))
    print(f"build: {len(mods)} kernels in {time.perf_counter() - t0:.1f} s")
    for mod, path in zip(mods, paths):
        mod.load()
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"  ptxas {path.name}: {line.strip()}")


def kernel_times(torch, np, card: str, src: Path, seed: int) -> None:
    """--kernel-times: flash_attention, moe_mlp and wkv6 from ``src``,
    built and timed at the main paths' shapes, each checked against its
    plain version first."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.moe_mlp import kernel as moe_kernel
    from repro_torch.kernels.moe_mlp import ops as moe_ops
    from repro_torch.kernels.rwkv6_wkv import kernel as w_kernel
    from repro_torch.kernels.rwkv6_wkv import ops as w_ops
    phase_build(build, (kernel, moe_kernel, w_kernel))
    times = {f"{ARCH} attention": phase_timing(torch, ops, MAIN_SHAPE),
             f"{MOE_ARCH} attention": phase_timing(torch, ops,
                                                   MOE_ATTN_SHAPE),
             f"{VLM_ARCH} attention": phase_timing(torch, ops,
                                                   VLM_ATTN_SHAPE),
             f"{WHISPER_ARCH} encoder attention": phase_timing(
                 torch, ops, WHISPER_ENC_SHAPE),
             f"{WHISPER_ARCH} cross attention": phase_timing(
                 torch, ops, WHISPER_CROSS_SHAPE)}
    shapes = {f"{MOE_ARCH} prefill": MOE_PREFILL,
              f"{MOE_ARCH} decode": MOE_DECODE,
              **{f"{a} prefill": sh for a, sh in MOE_LARGE_F_PREFILL.items()}}
    for label, shape in shapes.items():
        times[label] = phase_moe_timing(torch, moe_ops, shape, label, card)
        torch.cuda.empty_cache()
    phase_moe_waves(torch, moe_ops, card)
    from repro_torch.configs import get_config
    lens = serve_lengths(np.random.default_rng(seed))
    times[f"{RWKV_ARCH} wkv6"] = {
        "prefill": phase_wkv_timing(torch, w_ops, None, card),
        "lengths": phase_wkv_lengths(torch, w_ops, lens,
                                     get_config(RWKV_ARCH).n_layers, card)}
    print(json.dumps({"src": str(src), "times": times}))


def path_times(torch, np, card: str, src: Path, seed: int) -> None:
    """--path-times: stablelm-1.6b's and olmoe-1b-7b's serving paths from
    ``src`` at full width: a 2048-token prefill (host clock ending in a
    synchronize, median and least of 5 after 2 warm-ups), the serve run
    of phase 5 (prefill ms per request, decode ms per step), and the host
    time of one kernel wrapper call at the decode step's shapes (moe_mlp)
    and at a one-token prefill (flash), enqueued without a synchronize,
    and the aten and custom ops one decode step of the serve run's batch
    dispatches (a ``TorchDispatchMode`` counting them by name).
    It calls nothing that a tree of an earlier slice lacks, so a parent
    tree runs it too."""
    import collections
    import statistics

    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.moe_mlp import kernel as moe_kernel
    from repro_torch.kernels.moe_mlp import ops as moe_ops
    from repro_torch.models import build_model
    from repro_torch.serve import BatchServer, Request
    from repro_torch.serve.step import build_decode_step
    phase_build(build, (kernel, moe_kernel))

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    def decode_ops(model, params, cfg):
        step = build_decode_step(model)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_SLOTS, 1),
                                         device="cuda", generator=gen),
                 "cache": model.init_cache(SERVE_SLOTS, SERVE_CAP, "cuda"),
                 "cur_len": torch.arange(SERVE_SLOTS, device="cuda") + 100}
        step(params, batch)
        count = OpCount()
        with count:
            step(params, batch)
        return dict(sorted(count.n.items()))
    gen = torch.Generator(device="cuda").manual_seed(13)

    def host_us(fn, blocks=20, n=100):
        """The least mean over ``blocks`` blocks of ``n`` calls: the
        host shares its cores, and the least block is the one that ran
        undisturbed."""
        fn()
        best = math.inf
        for _ in range(blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
        return best

    q = torch.randn(1, 1, 32, 64, generator=gen, device="cuda").bfloat16()
    x, wi, wg, wo = _moe_inputs(torch, gen, *MOE_DECODE, torch.bfloat16)
    out = {"wrapper host us": {
        "flash_attention s=1": host_us(lambda: ops.flash_attention(q, q, q)),
        "moe_mlp decode": host_us(lambda: moe_ops.expert_mlp(x, wi, wg, wo))}}
    del x, wi, wg, wo
    for arch in (ARCH, MOE_ARCH):
        cfg = get_config(arch)
        model = build_model(cfg)
        params = model.load(model.init(seed, "cuda"), "cuda")
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                               generator=gen)
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rng = np.random.default_rng(seed)
        lens = serve_lengths(rng)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)),
                        max_new_tokens=SERVE_NEW) for i, n in enumerate(lens)]
        srv = BatchServer(model, params, slots=SERVE_SLOTS,
                          seq_capacity=SERVE_CAP, device="cuda")
        srv.serve(reqs)
        dec = np.array(srv.decode_seconds) * 1e3
        out[arch] = {"prefill s=2048 ms median": statistics.median(times[2:]),
                     "prefill s=2048 ms min": min(times[2:]),
                     "serve prefill ms per request":
                         float(np.mean(srv.prefill_seconds) * 1e3),
                     "decode ms per step median": float(np.median(dec)),
                     "decode ms per step min": float(dec.min()),
                     "decode steps": srv.decode_steps}
        del srv
        ops_by_name = decode_ops(model, params, cfg)
        out[arch]["decode ops per step"] = sum(ops_by_name.values())
        out[arch]["decode ops by name"] = ops_by_name
        print(f"path times {arch}: {out[arch]} [{card}]")
        del params, model
        torch.cuda.empty_cache()
    print(json.dumps({"src": str(src), "path_times": out}))


def decode_ab(torch, np, card: str, src: Path, parent: Path,
              seed: int, turns: int = 60) -> None:
    """--decode-ab: the plain decode step of ``src`` (A) and of
    ``parent`` (B) in one process.  B's ``repro_torch`` is copied under
    a temporary directory as ``repro_torch_ab`` (the name replaced in
    its sources, its custom ops' namespace with it) so that both import
    side by side.  For each arch: one params tree, a cache each (zeros,
    capacity SERVE_CAP) and the same tokens and per-slot lengths; the
    first steps' logits must agree bit for bit; then ``turns`` turns of
    A, B, B, A, each step's host ms ending in a synchronize.  The ratio
    B / A of each turn's means, its median, and each tree's median and
    least step are printed."""
    import re
    import shutil
    import statistics
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_mlp import kernel as moe_kernel
    from repro_torch.models import build_model
    from repro_torch.serve.step import build_decode_step
    tmp = Path(tempfile.mkdtemp(prefix="decode_ab_"))
    try:
        dst = tmp / "repro_torch_ab"
        shutil.copytree(parent / "repro_torch", dst,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        for f in dst.rglob("*.py"):
            f.write_text(re.sub(r"\brepro_torch\b", "repro_torch_ab",
                                f.read_text()))
        sys.path.insert(0, str(tmp))
        import importlib
        ab = {m: importlib.import_module(f"repro_torch_ab.{m}")
              for m in ("configs", "kernels.build", "kernels.moe_mlp.kernel",
                        "models", "serve.step")}
        phase_build(build, (moe_kernel,))
        phase_build(ab["kernels.build"], (ab["kernels.moe_mlp.kernel"],))
        gen = torch.Generator(device="cuda").manual_seed(17)
        out = {}
        for arch in (ARCH, MOE_ARCH):
            cfg = get_config(arch)
            model = build_model(cfg)
            model_b = ab["models"].build_model(ab["configs"].get_config(arch))
            params = model.load(model.init(seed, "cuda"), "cuda")
            steps = {"A": build_decode_step(model),
                     "B": ab["serve.step"].build_decode_step(model_b)}
            caches = {"A": model.init_cache(SERVE_SLOTS, SERVE_CAP, "cuda"),
                      "B": model_b.init_cache(SERVE_SLOTS, SERVE_CAP,
                                              "cuda")}
            tokens = torch.randint(0, cfg.vocab_size, (SERVE_SLOTS, 1),
                                   device="cuda", generator=gen)
            cur = torch.arange(SERVE_SLOTS, device="cuda") * 97 + 100

            def run(t):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, logits, _ = steps[t](params, {"tokens": tokens,
                                                 "cache": caches[t],
                                                 "cur_len": cur})
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3, logits

            _, la = run("A")
            _, lb = run("B")
            if not torch.equal(la, lb):
                raise RuntimeError(f"decode-ab {arch}: the trees' logits "
                                   f"differ")
            ms = {"A": [], "B": []}
            ratios = []
            for _ in range(turns):
                turn = {"A": [], "B": []}
                for t in "ABBA":
                    turn[t].append(run(t)[0])
                for t in "AB":
                    ms[t] += turn[t]
                ratios.append(statistics.mean(turn["B"])
                              / statistics.mean(turn["A"]))
            out[arch] = {
                "A ms median": statistics.median(ms["A"]),
                "B ms median": statistics.median(ms["B"]),
                "A ms min": min(ms["A"]), "B ms min": min(ms["B"]),
                "B/A median of turns": statistics.median(ratios),
                "B/A turns quartiles": statistics.quantiles(ratios, n=4),
                "turns": turns}
            print(f"decode-ab {arch}: {out[arch]} [{card}]")
            del params, caches, model, model_b, steps
            torch.cuda.empty_cache()
        print(json.dumps({"src": str(src), "parent": str(parent),
                          "decode_ab": out}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the kernel on a slice of query rows with their offset (context
# parallelism): (b, n, h, kvh, d, window, prefix, s_kv, q_offset), rows
# [q_offset, q_offset + n) of a sequence of s_kv keys; causal at offsets
# on and off the 128-row tiles, the last rows, windows that reach back
# past the offset, qwen2-vl-7b's GQA 28/4 with its 256-key prefix (rows
# inside and past it), one row, and not causal (window None: the offset
# masks nothing)
OFFSET_SWEEP = [(1, 256, 4, 4, 64, 0, 0, 512, 256),
                (2, 200, 4, 2, 64, 0, 0, 1000, 800),
                (1, 300, 4, 2, 128, 0, 0, 1024, 500),
                (1, 128, 16, 16, 128, 0, 0, 2048, 1920),
                (1, 257, 4, 2, 64, 100, 0, 700, 300),
                (1, 200, 4, 2, 128, 64, 0, 513, 313),
                (1, 128, 28, 4, 128, 0, 256, 512, 128),
                (1, 300, 4, 2, 64, 0, 256, 1024, 100),
                (1, 129, 28, 4, 128, 0, 256, 2048, 1919),
                (1, 1, 4, 4, 64, 0, 0, 777, 776),
                (1, 129, 12, 12, 64, None, 0, 1500, 640)]
# the rows of one sequence split over ranks, each shard run with its
# offset and held against those rows of the whole call: (b, s, h, kvh,
# d, prefix, window, shards), shards as (q_offset, n); tile-aligned and
# ragged splits
SHARD_ROWS = [(1, 2048, 32, 32, 64, 0, 0, [(o, 128) for o in
                                           range(0, 2048, 128)]),
              (1, 2048, 28, 4, 128, 256, 0, [(0, 700), (700, 700),
                                             (1400, 648)]),
              (1, 1000, 4, 2, 128, 0, 100, [(0, 250), (250, 250),
                                            (500, 250), (750, 250)])]
# qwen2-vl-7b's prefill_32k on the (16, 16) mesh splits each sequence's
# 32768 query rows over the 16 ranks of "model": the last rank's shard,
# the heaviest, with every key and the 256-key vision prefix
CP_SHARD = dict(b=1, s=2048, s_kv=32768, q_offset=30720, h=28, kvh=4,
                d=128, prefix=256)


def phase_sweep(torch, ops) -> None:
    sweep = [(2, 256, 4, 4, 64, 0), (1, 512, 2, 2, 128, 0),
             (2, 256, 4, 4, 64, 128), (1, 128, 8, 8, 32, 0),
             (3, 192, 2, 2, 64, 0),
             # ragged s, GQA 32/8 at d=128, d=16, a window, not causal
             # (window None)
             (1, 1, 4, 4, 64, 0), (1, 77, 4, 4, 64, 0), (1, 1000, 4, 4, 64, 0),
             (1, 512, 32, 8, 128, 0), (2, 50, 4, 1, 16, 0),
             (1, 300, 4, 2, 64, 100), (2, 130, 4, 2, 32, None),
             # stablelm's own heads at its longest served prompt and at the
             # model phase's length
             (1, 1762, 32, 32, 64, 0), (1, 2048, 32, 32, 64, 0),
             # s on both sides of the bf16 kernel's 128-row q and KV tiles
             (1, 127, 4, 4, 64, 0), (1, 128, 4, 2, 64, 0),
             (1, 129, 4, 4, 64, 0), (2, 191, 4, 2, 64, 0),
             (1, 255, 4, 4, 128, 0), (1, 257, 4, 4, 64, 0),
             # windows that end inside a KV tile, not causal across edges
             (1, 513, 4, 2, 64, 200), (1, 300, 2, 2, 128, 100),
             (1, 257, 4, 2, 64, None),
             # olmoe-1b-7b's heads at its longest profiled prompt and at
             # 2048; GQA 32/8 at d=128 across a tile edge; d=16 and 32
             (1, 1953, 16, 16, 128, 0), (1, 2048, 16, 16, 128, 0),
             (1, 257, 32, 8, 128, 0), (1, 257, 4, 2, 16, 0),
             (2, 129, 4, 4, 32, 0),
             # qwen2-vl-7b's GQA 28/4 (seven query heads a kv head) at
             # d=128: 2048, its shortest served merged length 415 = 256 +
             # 159, across a tile edge and one token; then with its
             # 256-token vision prefix (keys below it visible to every
             # row: the M-RoPE mask), a prefix past s, and smaller ones
             # that end inside and at a tile edge
             (1, 2048, 28, 4, 128, 0), (1, 415, 28, 4, 128, 0),
             (1, 129, 28, 4, 128, 0), (1, 1, 28, 4, 128, 0),
             (1, 2048, 28, 4, 128, 0, 256), (1, 415, 28, 4, 128, 0, 256),
             (1, 129, 28, 4, 128, 0, 256), (1, 300, 4, 2, 64, 0, 100),
             (2, 255, 4, 1, 32, 0, 128),
             # whisper-small: the encoder (not causal over its 1500
             # frames), then cross attention (not causal, s_kv = 1500)
             # at its longest prompt, one token, and across a tile edge
             (1, 1500, 12, 12, 64, None, 0, 1500),
             (1, 416, 12, 12, 64, None, 0, 1500),
             (1, 1, 12, 12, 64, None, 0, 1500),
             (1, 129, 12, 12, 64, None, 0, 1500)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, s, h, kvh, d, win, *extra in sweep:
            prefix, s_kv = extra + [0, s][len(extra):]
            q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, s_kv, kvh, d, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(b, s_kv, kvh, d, generator=gen,
                            device="cuda").to(dtype)
            kw = dict(causal=win is not None, window=win or 0, prefix=prefix)
            got = ops.flash_attention(q, k, v, **kw)
            want = ops.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            lim = TOL[name] * (1 + want.float().abs())
            ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
            case = (f"{name} b={b} s={s} s_kv={s_kv} h={h} kvh={kvh} d={d} "
                    f"causal={kw['causal']} window={kw['window']} "
                    f"prefix={kw['prefix']}")
            print(f"sweep {case}: max_abs_err={float(err.max()):.3e} "
                  f"tol={TOL[name]} {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with its plain version ({case})")
        for b, n, h, kvh, d, win, prefix, s_kv, off in OFFSET_SWEEP:
            q = torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, s_kv, kvh, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            kw = dict(causal=win is not None, window=win or 0, prefix=prefix,
                      q_offset=off)
            got = ops.flash_attention(q, k, v, **kw)
            want = ops.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            lim = TOL[name] * (1 + want.float().abs())
            ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
            case = (f"{name} b={b} rows [{off}, {off + n}) s_kv={s_kv} h={h} "
                    f"kvh={kvh} d={d} causal={kw['causal']} "
                    f"window={kw['window']} prefix={prefix}")
            print(f"sweep q_offset {case}: max_abs_err={float(err.max()):.3e}"
                  f" tol={TOL[name]} {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with its plain version ({case})")


def phase_shard_rows(torch, ops) -> dict:
    """Each shard of ``SHARD_ROWS`` through the kernel with its offset,
    against those rows of the kernel's whole-sequence call: within the
    sweep's tolerance, and whether bit for bit (printed, counted)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        n_bit = n_all = 0
        worst = 0.0
        for b, s, h, kvh, d, prefix, win, shards in SHARD_ROWS:
            q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, s, kvh, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            kw = dict(prefix=prefix, window=win)
            whole = ops.flash_attention(q, k, v, **kw)
            for off, n in shards:
                got = ops.flash_attention(q[:, off:off + n], k, v,
                                          q_offset=off, **kw)
                want = whole[:, off:off + n]
                err = (got.float() - want.float()).abs()
                lim = TOL[name] * (1 + want.float().abs())
                check(bool((err <= lim).all()),
                      f"{name} rows [{off}, {off + n}) of s={s} h={h} "
                      f"kvh={kvh} d={d}: max_abs_err {float(err.max())} "
                      f"against the whole call")
                n_bit += bool(torch.equal(got, want))
                n_all += 1
                worst = max(worst, float(err.max()))
        out[name] = {"shards": n_all, "bit_equal": n_bit,
                     "max_abs_err": worst}
        print(f"shard rows {name}: {n_bit} of {n_all} shards bit for bit "
              f"equal to the whole call's rows, max_abs_err {worst:.3e} "
              f"(tol {TOL[name]})")
    return out


def phase_shard_timing(torch, ops, card: str) -> dict:
    """The kernel at ``CP_SHARD`` (the last query rows of a 32768-token
    prefill, with their offset), held against its plain version; its ms,
    the plain version's, the bound of its ``cost`` with the offset and
    scaled_dot_product_attention over the same rows with the same mask
    as an explicit boolean ``attn_mask`` and ``enable_gqa``."""
    import torch.nn.functional as F
    b, s, s_kv, off, h, kvh, d, prefix = (CP_SHARD[k] for k in (
        "b", "s", "s_kv", "q_offset", "h", "kvh", "d", "prefix"))
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s_kv, kvh, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    kw = dict(prefix=prefix, q_offset=off)
    want = ops.flash_attention_plain(q, k, v, **kw).float()
    lim = TOL["bfloat16"] * (1 + want.abs())
    diff = (ops.flash_attention(q, k, v, **kw).float() - want).abs()
    err = float(diff.max())
    check(bool((diff <= lim).all()), f"shard kernel error {err}")
    rows = off + torch.arange(s, device="cuda")
    keys = torch.arange(s_kv, device="cuda")
    mask = (keys[None, :] <= rows[:, None]) | (keys[None, :] < prefix)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    check(bool(((sdpa().transpose(1, 2).float() - want).abs() <= lim).all()),
          "scaled_dot_product_attention with the shard's mask computes "
          "another function")
    del want, lim, diff
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: ops.flash_attention_plain(q, k, v, **kw),
                       iters=5, warmup=1)
    lib_ms = cuda_ms(sdpa)
    flops, nbytes = ops.cost(q.shape, k.shape, q.dtype, prefix=prefix,
                             q_offset=off)
    bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"timing rows [{off}, {off + s}) of s_kv={s_kv} h={h} kvh={kvh} "
          f"d={d} bf16 prefix={prefix} (qwen2-vl-7b's last context-parallel "
          f"shard): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"(attn_mask, enable_gqa) {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB);"
          f" kernel at {flops / ms / 1e9:.2f} TFLOP/s; max_abs_err "
          f"{err:.3e} [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms,
                shape="b={b} rows [{o}, {e}) of s_kv={s_kv} h={h} kvh={kvh} "
                      "d={d} bf16 prefix={prefix} (qwen2-vl-7b prefill_32k, "
                      "the last of 16 context-parallel shards)".format(
                          o=off, e=off + s, **CP_SHARD))


def request_extras(cfg, rng) -> dict:
    """A request's stub frontend output drawn from ``rng`` as the
    launchers draw it: a VLM's (n_vis, d_model) patch embeddings, an
    encoder-decoder's (enc_seq, d_model) frame embeddings; nothing, and
    no draw, for other families."""
    import numpy as np

    def draw(rows):
        return (rng.standard_normal((rows, cfg.d_model))
                * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        return {"vision_embeds": draw(cfg.n_vis)}
    if cfg.family == "audio":
        return {"enc_embeds": draw(cfg.enc_seq)}
    return {}


def on_card(torch, extras: dict) -> dict:
    """A request's extras as a batch-1 prefill's inputs on the card."""
    return {k: torch.as_tensor(v, device="cuda")[None]
            for k, v in extras.items()}


def n_vis_of(cfg) -> int:
    return cfg.n_vis if cfg.family == "vlm" else 0


def flash_per_prefill(cfg) -> int:
    """Flash launches of one prefill: one per attention layer; an
    encoder-decoder's encoder layers, and two per decoder layer (self and
    cross attention)."""
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers
    return layer_plan(cfg)[0].count("attn")


def phase_model(torch, np, cfg, model, params, seed: int, swaps,
                rtol: float, prompt_len: int = 2048) -> None:
    """A ``prompt_len``-token prefill through the kernel path (a VLM's:
    its vision prefix and prompt_len - n_vis text tokens; an
    encoder-decoder's: the tokens and its frames), then through the same
    model with each kernel's wrapper ``module.<name>`` of ``swaps``
    (``(module, name, plain)``) replaced by its plain version, here only;
    the last position's logits compared."""
    from repro_torch.models.layers import padded_vocab
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len - n_vis_of(cfg))
    batch = {"tokens": torch.as_tensor(prompt, device="cuda")[None],
             **on_card(torch, request_extras(cfg, rng))}
    t0 = time.perf_counter()
    logits_k, _ = model.prefill(params, batch)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    kernel_fns = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        logits_p, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
    finally:
        for (module, name, _), fn in zip(swaps, kernel_fns):
            setattr(module, name, fn)
    name = " and ".join(name for _, name, _ in swaps)
    lk, lp = logits_k[0, -1].float(), logits_p[0, -1].float()
    want_shape = (1, 1, padded_vocab(cfg))
    check(tuple(logits_k.shape) == want_shape,
          f"logits {tuple(logits_k.shape)}, want {want_shape}")
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    top2 = torch.topk(lp, 2).values
    print(f"model {cfg.name} prefill s={prompt_len} bf16: kernel path "
          f"{t_k * 1e3:.1f} ms (first call); plain {name} in its place: "
          f"max|dlogit|={err:.4e} vs max|logit|={scale:.4f} (tol {rtol} x "
          f"max|logit|); argmax kernel {int(lk.argmax())} plain "
          f"{int(lp.argmax())} (top-2 gap {float(top2[0] - top2[1]):.4f})")
    check(err <= rtol * scale, "kernel path logits disagree")
    check(int(lk.argmax()) == int(lp.argmax()), "argmax differs")


def layer_plan(cfg):
    """(mixer kind of every layer, number of MoE layers), as the port's
    decoder runs them: a period-1 arch builds and applies every layer as
    layer 0, a hybrid arch each position of its period as itself."""
    from repro_torch.models.transformer import layer_kind, period
    pos = [i % period(cfg) for i in range(cfg.n_layers)]
    return ([layer_kind(cfg, p) for p in pos],
            sum(cfg.is_moe_layer(p) for p in pos))


def serve_lengths(rng, lens=(128, 2049)):
    """The serve run's prompt lengths in [lo, hi), the first draw of its
    generator."""
    return rng.integers(*lens, SERVE_REQUESTS)


def phase_serve(torch, np, cfg, model, params, counters, seed: int,
                card: str, lens_range=(128, 2049), cap: int = SERVE_CAP):
    """The main path: every launch count set to 0 just before the serve
    run and read just after.  Each prefill launches the flash kernel
    ``flash_per_prefill`` times and wkv6 once per RWKV layer; moe_mlp
    runs once per MoE layer of every prefill and every decode step; no
    other kernel runs in a decode step.  A VLM's requests carry their
    vision prefix (``extras``), an encoder-decoder's its frames; each
    merged prompt with its new tokens fits the capacity ``cap``: no KV
    ring wraps.  Returns the launches, the prompt lengths and the decode
    steps' median ms."""
    from repro_torch.serve import BatchServer, Request
    rng = np.random.default_rng(seed)
    lens = serve_lengths(rng, lens_range)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)),
                    max_new_tokens=SERVE_NEW,
                    extras=request_extras(cfg, rng))
            for i, n in enumerate(lens)]
    check(max(lens) + n_vis_of(cfg) + SERVE_NEW <= cap,
          "a merged prompt and its new tokens exceed the capacity")
    srv = BatchServer(model, params, slots=SERVE_SLOTS, seq_capacity=cap,
                      device="cuda")
    in_decode = {n: 0 for n in counters}
    decode = srv._decode

    def counted(*a, **kw):
        before = {n: w.launches for n, w in counters.items()}
        out = decode(*a, **kw)
        for n, w in counters.items():
            in_decode[n] += w.launches - before[n]
        return out
    srv._decode = counted
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in counters.items()}
    check(len(done) == SERVE_REQUESTS, f"{len(done)} requests finished")
    for r in done:
        check(len(r.output) == SERVE_NEW, f"rid {r.rid}: {len(r.output)} "
                                          f"tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"rid {r.rid}: token out of vocab")
    kinds, n_moe = layer_plan(cfg)
    moe_decode = n_moe * srv.decode_steps
    want = {"flash_attention": flash_per_prefill(cfg) * SERVE_REQUESTS,
            "moe_mlp": n_moe * SERVE_REQUESTS + moe_decode,
            "quantize": 0, "wkv6": kinds.count("rwkv") * SERVE_REQUESTS}
    want_decode = {n: 0 for n in counters}
    want_decode["moe_mlp"] = moe_decode
    for n, got in launches.items():
        check(got == want[n], f"{n} launched {got} times in the {cfg.name} "
                              f"serve run, want {want[n]}")
        check(in_decode[n] == want_decode[n],
              f"{n} launched {in_decode[n]} times in the {cfg.name} decode "
              f"steps, want {want_decode[n]}")
    # the server's first token is a batch-1 prefill: reproduce one
    r0 = min(done, key=lambda r: r.rid)
    lg, _ = model.prefill(srv.params, {
        "tokens": torch.as_tensor(r0.prompt, device="cuda")[None],
        **on_card(torch, r0.extras)}, seq_capacity=cap)
    check(int(lg[0, -1].float().argmax()) == r0.output[0],
          "first token differs from a standalone prefill")
    pre = np.array(srv.prefill_seconds) * 1e3
    dec = np.array(srv.decode_seconds) * 1e3
    tokens = sum(len(r.output) for r in done)
    vis = f" + {n_vis_of(cfg)} vision tokens each" if n_vis_of(cfg) else ""
    if cfg.family == "audio":
        vis = f" + {cfg.enc_seq} encoder frames each"
    print(f"serve {cfg.name} slots={SERVE_SLOTS} cap={cap} prompts "
          f"{sorted(int(n) for n in lens)}{vis}: {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; prefill "
          f"{pre.mean():.2f} ms/request "
          f"(min {pre.min():.2f}, max {pre.max():.2f}); decode "
          f"{dec.mean():.2f} ms/step over {srv.decode_steps} steps "
          f"(median {np.median(dec):.2f}); launches {launches}, of which "
          f"in decode steps {in_decode}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB [{card}]")
    return launches, [int(n) for n in lens], float(np.median(dec))


def phase_timing(torch, ops, shape):
    """The flash kernel, its plain version and scaled_dot_product_attention
    (``enable_gqa`` where the kv heads are fewer) on one bf16 input of
    ``shape`` (b, s, h, d and, for GQA, kvh; s_kv keys, s by default),
    causal unless ``shape["causal"]`` is False."""
    import torch.nn.functional as F
    b, s, h, d = (shape[k] for k in "bshd")
    kvh, s_kv = shape.get("kvh", h), shape.get("s_kv", s)
    causal = shape.get("causal", True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s_kv, kvh, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention_plain(q, k, v, causal=causal).float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    check(bool((diff <= TOL["bfloat16"] * (1 + want.abs())).all()),
          f"main-shape kernel error {err}")
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: ops.flash_attention_plain(q, k, v,
                                                         causal=causal))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = {"enable_gqa": True} if kvh != h else {}
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         **gqa)
    check(bool((((lib.transpose(1, 2).float() - want).abs())
                <= TOL["bfloat16"] * (1 + want.abs())).all()),
          "scaled_dot_product_attention computes another function")
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, **gqa))
    flops, nbytes = ops.cost(q.shape, k.shape, q.dtype, causal)
    bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"timing b={b} s={s} s_kv={s_kv} h={h} kvh={kvh} d={d} bf16 "
          f"causal={causal}: kernel "
          f"{ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
          f"kernel at {flops / ms / 1e9:.2f} TFLOP/s; max_abs_err {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def phase_lengths(torch, ops, lens, n_layers: int, card: str) -> None:
    """The kernel alone at stablelm's heads and each served prompt length:
    what its launches (one per layer per request) cost in the serve run."""
    h, d = MAIN_SHAPE["h"], MAIN_SHAPE["d"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    per_req = []
    for s in sorted(lens):
        q, k, v = (torch.randn(1, s, h, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        per_req.append(cuda_ms(lambda: ops.flash_attention(q, k, v)))
        print(f"lengths s={s}: kernel {per_req[-1]:.4f} ms per launch, "
              f"{per_req[-1] * n_layers:.3f} ms per prefill")
    print(f"lengths: kernel {sum(per_req) * n_layers:.3f} ms over the "
          f"serve run's {len(per_req)} prefills ({n_layers} launches "
          f"each) [{card}]")


def _trace_events(prof) -> list:
    """The events of a finished profile, through its Chrome trace written
    to a temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def _busy_us(spans, lo: float, hi: float) -> float:
    """Length of the union of ``spans`` (sorted (start, end)) inside
    [lo, hi)."""
    busy, edge = 0.0, lo
    for a, b in spans:
        a, b = max(a, edge), min(b, hi)
        if b > a:
            busy += b - a
            edge = b
    return busy


def _scope_us(events, name: str) -> dict:
    """Device time of the kernels launched inside the host spans named
    ``name``, by the window kind of the launch: each launch's runtime
    call and its kernel share a correlation id."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] == name)
    corr = set()
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                "args", {}):
            if any(a <= e["ts"] < b for a, b in spans):
                corr.add(e["args"]["correlation"])
    return {"us": sum(e["dur"] for e in events
                      if e.get("cat") == "kernel"
                      and e.get("args", {}).get("correlation") in corr),
            "spans": len(spans)}


def phase_profile(torch, np, cfg, model, params, seed: int, card: str,
                  scopes=(), lens_range=(128, 2049), cap: int = SERVE_CAP):
    """Trace a serve run of PROFILE_REQUESTS requests and split its time
    into prefill and decode windows.  A window runs from the start of its
    step's span to the start of the next span, so it holds the step's host
    work and the read-back that waits for the device.  Each ``(label,
    module, name)`` of ``scopes`` wraps ``module.<name>`` in a span of its
    own for the run, and the device time of the kernels it launches is
    printed as a share of the prefill windows' busy time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serve import BatchServer, Request
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(*lens_range, PROFILE_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)),
                    max_new_tokens=PROFILE_NEW,
                    extras=request_extras(cfg, rng))
            for i, n in enumerate(lens)]
    srv = BatchServer(model, params, slots=SERVE_SLOTS, seq_capacity=cap,
                      device="cuda")

    def spanned(name, fn):
        def step(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return step
    srv._prefill = spanned("prefill", srv._prefill)
    srv._decode = spanned("decode", srv._decode)
    saved = [getattr(module, name) for _, module, name in scopes]
    for (label, module, name), fn in zip(scopes, saved):
        setattr(module, name, spanned(label, fn))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("serve"):
                srv.serve(reqs)
                torch.cuda.synchronize()
    finally:
        for (_, module, name), fn in zip(scopes, saved):
            setattr(module, name, fn)
    events = _trace_events(prof)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    check(len(dev) > 0, "the profiler saw no device activity")
    spans = sorted((e["ts"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] in ("prefill", "decode"))
    serve = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "serve"]
    check(len(serve) == 1, f"{len(serve)} serve spans in the trace")
    end = serve[0]["ts"] + serve[0]["dur"]
    n_pre = sum(1 for _, n in spans if n == "prefill")
    check(n_pre == PROFILE_REQUESTS and len(spans) == n_pre + srv.decode_steps,
          f"trace holds {len(spans)} step spans, want {PROFILE_REQUESTS} "
          f"prefills and {srv.decode_steps} decode steps")
    intervals = [(a, b) for a, b, _ in dev]
    wall = {"prefill": 0.0, "decode": 0.0}
    busy = {"prefill": 0.0, "decode": 0.0}
    by_name = {"prefill": {}, "decode": {}}
    for i, (t0, kind) in enumerate(spans):
        t1 = spans[i + 1][0] if i + 1 < len(spans) else end
        wall[kind] += t1 - t0
        busy[kind] += _busy_us(intervals, t0, t1)
        for a, b, name in dev:
            if t0 <= a < t1:
                tot, n = by_name[kind].get(name, (0.0, 0))
                by_name[kind][name] = (tot + b - a, n + 1)
    for kind, steps in (("prefill", n_pre), ("decode", srv.decode_steps)):
        share = busy[kind] / wall[kind]
        print(f"profile {kind}: {steps} steps, {wall[kind] / 1e3 / steps:.3f}"
              f" ms per step on the host clock (profiled), device busy "
              f"{busy[kind] / 1e3 / steps:.3f} ms per step = {share:.4f} of "
              f"it [{card}]")
        top = sorted(by_name[kind].items(), key=lambda kv: -kv[1][0])
        for name, (tot, n) in top[:PROFILE_TOP]:
            print(f"  {kind} device {tot / 1e3 / steps:.4f} ms per step, "
                  f"{n} launches: {name[:110]}")
        for key in ("flash", "moe_mlp", "wkv6"):
            tot = sum(t for name, (t, _) in by_name[kind].items()
                      if key in name)
            print(f"  {kind} {key} kernel {tot / 1e3 / steps:.4f} ms per "
                  f"step = {tot / max(busy[kind], 1e-9):.4f} of device busy "
                  f"time")
    for label, _, _ in scopes:
        sc = _scope_us(events, label)
        print(f"  prefill {label}: {sc['spans']} spans, device "
              f"{sc['us'] / 1e3 / n_pre:.4f} ms per prefill = "
              f"{sc['us'] / max(busy['prefill'], 1e-9):.4f} of prefill "
              f"device busy time [{card}]")
    print(f"profile {cfg.name}: prompts {sorted(int(n) for n in lens)}, "
          f"{PROFILE_NEW} new tokens each, {len(dev)} device events")


def _moe_inputs(torch, gen, g, e, c, d, f, dtype):
    x = torch.randn(g, e, c, d, generator=gen, device="cuda").to(dtype)
    wi, wg = (torch.randn(e, d, f, generator=gen, device="cuda")
              .div_(d ** 0.5).to(dtype) for _ in range(2))
    wo = torch.randn(e, f, d, generator=gen, device="cuda").div_(f ** 0.5)
    return x, wi, wg, wo.to(dtype)


def _moe_close(torch, got, want, dtype: str):
    err = (got.float() - want.float()).abs()
    lim = MOE_TOL[dtype] * (1 + want.float().abs())
    ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
    return ok, float(err.max())


def phase_moe_sweep(torch, moe_ops) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for g, e, c, d, f in MOE_SWEEP:
            args = _moe_inputs(torch, gen, g, e, c, d, f, dtype)
            got = moe_ops.expert_mlp(*args)
            want = moe_ops.expert_mlp_plain(*args)
            torch.cuda.synchronize()
            ok, err = _moe_close(torch, got, want, name)
            case = f"{name} G={g} E={e} C={c} D={d} F={f}"
            print(f"moe sweep {case}: max_abs_err={err:.3e} "
                  f"tol={MOE_TOL[name]} {'ok' if ok else 'FAIL'}")
            check(ok, f"moe_mlp kernel disagrees with its plain version "
                      f"({case})")


def _check_h_precision(torch, moe_ops, args, got, want, label: str):
    """The kernel keeps h = silu(x wi)(x wg) in f32, as the TPU kernel
    does: its bf16 outputs must differ from the plain version's (f32 h) in
    fewer places than the plain version's own would with h rounded to
    bf16 before the down projection."""
    x, wi, wg, wo = (t.float() for t in args)
    h = torch.einsum("gecd,edf->gecf", x, wi)
    h = h * torch.sigmoid(h) * torch.einsum("gecd,edf->gecf", x, wg)
    rounded = torch.einsum("gecf,efd->gecd", h.bfloat16().float(), wo)
    rounded = rounded.to(got.dtype)
    share = float((got != want).float().mean())
    r_share = float((rounded != want).float().mean())
    r_err = float((rounded.float() - want.float()).abs().max())
    print(f"moe h precision {label}: kernel outputs differing from the "
          f"plain version's: {share:.6f}; with h rounded to bf16: "
          f"{r_share:.6f} (max_abs_err {r_err:.3e})")
    check(share < r_share, f"moe_mlp {label}: the kernel's h is not kept "
                           f"in f32 ({share} >= {r_share})")


def phase_moe_timing(torch, moe_ops, shape, label: str, card: str):
    """The kernel, its plain version and three torch.bmm over the experts
    (a yardstick the port never calls) on one bf16 input; the bound is the
    larger of its flops at the bf16 peak and its bytes (the weights, x and
    out, each once) at the memory rate, both from ``moe_ops.cost``."""
    import torch.nn.functional as F
    g, e, c, d, f = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, wi, wg, wo = _moe_inputs(torch, gen, g, e, c, d, f, torch.bfloat16)

    def library():
        xe = x.transpose(0, 1).reshape(e, g * c, d)
        h = F.silu(torch.bmm(xe, wi)) * torch.bmm(xe, wg)
        return torch.bmm(h, wo).reshape(e, g, c, d).transpose(0, 1)

    got = moe_ops.expert_mlp(x, wi, wg, wo)
    want = moe_ops.expert_mlp_plain(x, wi, wg, wo)
    ok, err = _moe_close(torch, got, want, "bfloat16")
    check(ok, f"moe_mlp {label}-shape kernel error {err}")
    _check_h_precision(torch, moe_ops, (x, wi, wg, wo), got, want, label)
    lib_ok, lib_err = _moe_close(torch, library(), want, "bfloat16")
    check(lib_ok, f"the torch.bmm yardstick computes another function "
                  f"({lib_err})")
    ms = cuda_ms(lambda: moe_ops.expert_mlp(x, wi, wg, wo))
    plain_ms = cuda_ms(lambda: moe_ops.expert_mlp_plain(x, wi, wg, wo))
    lib_ms = cuda_ms(library)
    flops, nbytes = moe_ops.cost(x.shape, wi.shape, x.dtype)
    bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"moe timing {label} G={g} E={e} C={c} D={d} F={f} bf16: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB); kernel at {flops / ms / 1e9:.2f} "
          f"TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s; max_abs_err {err:.3e} "
          f"[{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def phase_moe_waves(torch, moe_ops, card: str) -> None:
    """What sets the moe_mlp kernels' pace, at olmoe's widths: (E=64,
    C=32) reads 64 experts' weights for 32 rows each; (E=13, C=320) a
    fifth of the weights for ten times the rows, its weight tiles read
    three times from L2; (E=132, C=32) twice the weights of the first.
    Times that follow the weights' bytes say device memory sets the pace;
    times that agree at all three say the blocks' own pace does."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for g, e, c in ((1, 64, 32), (1, 13, 320), (1, 132, 32)):
        args = _moe_inputs(torch, gen, g, e, c, 2048, 1024, torch.bfloat16)
        ok, err = _moe_close(torch, moe_ops.expert_mlp(*args),
                             moe_ops.expert_mlp_plain(*args), "bfloat16")
        check(ok, f"moe_mlp G={g} E={e} C={c}: error {err}")
        ms = cuda_ms(lambda: moe_ops.expert_mlp(*args))
        wbytes = 3 * e * 2048 * 1024 * 2
        print(f"moe waves G={g} E={e} C={c} D=2048 F=1024 bf16: weights "
              f"{wbytes / 1e6:.1f} MB ({wbytes / PEAK_BYTES * 1e3:.4f} ms "
              f"at the memory rate), kernel {ms:.4f} ms [{card}]")
        del args


def phase_moe_large_f(torch, moe_ops, card: str) -> list:
    """The split schedule against the plain version at jamba-v0.1-52b's
    and mixtral-8x22b's widths, in f32 and bf16, then the kernel timed at
    their prefill shapes."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for g, e, c, d, f in MOE_LARGE_F:
            args = _moe_inputs(torch, gen, g, e, c, d, f, dtype)
            got = moe_ops.expert_mlp(*args)
            want = moe_ops.expert_mlp_plain(*args)
            torch.cuda.synchronize()
            ok, err = _moe_close(torch, got, want, name)
            case = (f"{name} G={g} E={e} C={c} D={d} F={f} (d_ff tile "
                    f"{moe_ops.split_tile(f)})")
            print(f"moe large-F sweep {case}: max_abs_err={err:.3e} "
                  f"tol={MOE_TOL[name]} {'ok' if ok else 'FAIL'}")
            check(ok, f"moe_mlp kernel disagrees with its plain version "
                      f"({case})")
            del args, got, want
    times = []
    for arch, shape in MOE_LARGE_F_PREFILL.items():
        t = phase_moe_timing(torch, moe_ops, shape, f"{arch} prefill", card)
        times.append({**t, "shape": _moe_shape(shape) + f" ({arch} prefill)"})
    return times


def phase_moe_d_ff_slices(torch, moe_ops, card: str) -> dict:
    """The arithmetic of the op's d_ff layout on the card: mixtral-8x22b's
    prefill blocks (``MOE_LARGE_F_PREFILL``) through ``MOE_D_FF_SLICES``
    kernel calls, each on one slice of d_ff (wi's and wg's columns, wo's
    rows), whose outputs summed in f32 (the partial sums a mesh reduces)
    must match the whole call within the sweep's bf16 tolerance; then the
    slice's call timed (``phase_moe_timing``: its plain version, three
    torch.bmm and its bound)."""
    g, e, c, d, f = MOE_LARGE_F_PREFILL["mixtral-8x22b"]
    n = f // MOE_D_FF_SLICES
    gen = torch.Generator(device="cuda").manual_seed(10)
    x, wi, wg, wo = _moe_inputs(torch, gen, g, e, c, d, f, torch.bfloat16)
    whole = moe_ops.expert_mlp(x, wi, wg, wo)
    total = torch.zeros(whole.shape, dtype=torch.float32, device="cuda")
    for lo in range(0, f, n):
        total += moe_ops.expert_mlp(x, wi[:, :, lo:lo + n],
                                    wg[:, :, lo:lo + n],
                                    wo[:, lo:lo + n]).float()
    ok, err = _moe_close(torch, total, whole, "bfloat16")
    print(f"moe d_ff slices G={g} E={e} C={c} D={d}: the sum of "
          f"{MOE_D_FF_SLICES} calls on F={n} slices against the whole "
          f"F={f} call: max_abs_err={err:.3e} tol={MOE_TOL['bfloat16']} "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"moe_mlp: the d_ff slices' sum disagrees with the whole "
              f"call ({err})")
    del x, wi, wg, wo, whole, total
    t = phase_moe_timing(torch, moe_ops, (g, e, c, d, n),
                         "mixtral-8x22b prefill, one rank's d_ff slice", card)
    return {"slices": MOE_D_FF_SLICES, "sum_max_abs_err": err, **t,
            "shape": _moe_shape((g, e, c, d, n))
            + " (mixtral-8x22b prefill, a rank's d_ff slice on (16, 16))"}


def _wkv_inputs(torch, gen, b, s, h, n, dtype, w0_lo=-6.0, w0_hi=1.0):
    """r, k, v (b, s, h, n) in dtype; lw = -exp(w0 + 0.5 N(0, 1)) in f32
    with w0 drawn per channel on [w0_lo, w0_hi], as the model feeds it; u
    (h, n) f32; a random state0 (b, h, n, n) f32."""
    r, k, v = (torch.randn(b, s, h, n, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    w0 = torch.empty(h, n, device="cuda").uniform_(w0_lo, w0_hi,
                                                   generator=gen)
    lw = -torch.exp(w0 + 0.5 * torch.randn(b, s, h, n, generator=gen,
                                           device="cuda"))
    u = 0.5 * torch.randn(h, n, generator=gen, device="cuda")
    state0 = torch.randn(b, h, n, n, generator=gen, device="cuda")
    return r, k, v, lw, u, state0


def _wkv_close(torch, got, want, dtype: str):
    """(ok, max |err| of y, max |err| of the state, max |err| / (1 + |y|)):
    y within WKV_TOL, the final state within 5e-4, both finite, each
    relative to 1 + |value| (y grows with the state: one bf16 ulp of a
    y near 200 is 1.0)."""
    (y, st), (yw, stw) = got, want
    ey = (y.float() - yw.float()).abs()
    es = (st - stw).abs()
    rel = ey / (1 + yw.float().abs())
    ok = (bool((rel <= WKV_TOL[dtype]).all())
          and bool((es <= 5e-4 * (1 + stw.abs())).all())
          and bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()))
    return ok, float(ey.max()), float(es.max()), float(rel.max())


def phase_wkv_sweep(torch, w_ops) -> None:
    """The wkv6 kernel against its plain version (the sequential
    recurrence), y and the final state, from a zero and from a random
    state, in f32 and bf16: WKV_SWEEP; slow decay (w0 = -6: decays of
    ~0.9975 a step, so the carried state adds up over all 2048 tokens);
    s on both sides of one and two sub-chunks and chunks of the bf16
    kernel; strong decay
    (w = 1e-3) over several chunks and sub-chunks.  Then strong decay from
    a zero state within 1e-3, as tests/test_kernels.py."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(c, dtype, (-6.0, 1.0)) for c in WKV_SWEEP for dtype in dtypes]
    cases += [((1, 2048, 4, 64, 32), dtype, (-6.0, -6.0)) for dtype in dtypes]
    # s = L - 1, L + 1 and 2 L + 1 for L = 16 (the bf16 kernel's sub-chunk)
    # and 32 (its chunk)
    cases += [((1, s, 2, 64, L), dtype, (-6.0, 1.0)) for L in (16, 32)
              for s in (L - 1, L + 1, 2 * L + 1) for dtype in dtypes]
    # strong decay, w = 1e-3 (lw ~ -6.9 a token): None below
    cases += [((1, 200, 2, 64, L), dtype, None) for L in (16, 32)
              for dtype in dtypes]
    for (b, s, h, n, chunk), dtype, w0 in cases:
        name = str(dtype).split(".")[-1]
        r, k, v, lw, u, state0 = _wkv_inputs(torch, gen, b, s, h, n, dtype,
                                             *(w0 or (-6.0, 1.0)))
        if w0 is None:
            lw = torch.full_like(lw, math.log(1e-3))
        for st0 in (None, state0):
            got = w_ops.wkv6_state(r, k, v, lw, u, st0, chunk=chunk)
            want = w_ops.wkv6_state_plain(r, k, v, lw, u, st0)
            torch.cuda.synchronize()
            ok, ey, es, rel = _wkv_close(torch, got, want, name)
            decay = f"w0 in [{w0[0]}, {w0[1]}]" if w0 else "w=1e-3"
            case = (f"{name} b={b} s={s} h={h} n={n} chunk={chunk} {decay} "
                    f"state0="
                    f"{'zeros' if st0 is None else 'random'}")
            print(f"wkv6 sweep {case}: max_abs_err y={ey:.3e} (relative to "
                  f"1+|y|: {rel:.3e}) state={es:.3e} tol y={WKV_TOL[name]} "
                  f"state=5e-4 {'ok' if ok else 'FAIL'}")
            check(ok, f"wkv6 kernel disagrees with its plain version "
                      f"({case})")
    r, k, v, _, _, _ = _wkv_inputs(torch, gen, 1, 128, 1, 32, torch.float32)
    w = torch.full_like(r, 1e-3)
    u = torch.zeros(1, 32, device="cuda")
    got = w_ops.wkv6(r, k, v, w, u, chunk=64)
    want, _ = w_ops.wkv6_state_plain(r, k, v, torch.log(w), u)
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= 1e-3 * (1 + want.abs())).all())
    print(f"wkv6 sweep strong decay w=1e-3 b=1 s=128 h=1 n=32: max_abs_err "
          f"{float(err.max()):.3e} tol 1e-3 {'ok' if ok else 'FAIL'}")
    check(ok, "wkv6 kernel under strong decay")


def perturb_rwkv(torch, params, seed: int) -> None:
    """In place, from the seed: the leaves the init leaves at zero or one,
    which would hide a kernel or model that ignores them (u = 0 never runs
    the bonus term; mu = 0 never runs the token-shift mixes; w0 = 0 makes
    every decay ~e^-1 a step, so the state forgets within a few tokens):
    u ~ 0.5 N(0, 1), w0 uniform on [-6, 1], the mixes uniform on [0, 1],
    the group-norm scale 1 + 0.2 N(0, 1) and bias 0.2 N(0, 1)."""
    tm, cm = params["layers"]["mixer"], params["layers"]["ffn"]
    gen = torch.Generator(device=tm["u"].device).manual_seed(seed + 100)
    with torch.no_grad():
        tm["u"].normal_(generator=gen).mul_(0.5)
        tm["w0"].uniform_(-6.0, 1.0, generator=gen)
        for t in (tm["mu"], tm["mu_x"], cm["mu_k"], cm["mu_r"]):
            t.uniform_(0.0, 1.0, generator=gen)
        tm["ln_x_scale"].normal_(generator=gen).mul_(0.2).add_(1.0)
        tm["ln_x_bias"].normal_(generator=gen).mul_(0.2)


def phase_rwkv_handoff(torch, np, cfg, model, params, seed: int, w_ops,
                       card: str) -> None:
    """The decode state handoff at full width: a prefill of 2047 tokens
    (the kernel, from a zero state, ragged s) and one decode step (the
    one-token recurrence from the prefill's state, no kernel) against a
    prefill of all 2048 tokens."""
    prompt = np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, 2048)
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    full, _ = model.prefill(params, {"tokens": tokens})
    _, cache = model.prefill(params, {"tokens": tokens[:, :-1]})
    check(cache["wkv"].dtype == torch.float32, "the WKV state is not f32")
    n0 = w_ops.wkv6.launches
    step, _ = model.decode(params, {"tokens": tokens[:, -1:]}, cache, 2047)
    torch.cuda.synchronize()
    check(w_ops.wkv6.launches == n0, "a decode step launched wkv6")
    lf, ls = full[0, -1].float(), step[0, -1].float()
    check(bool(torch.isfinite(ls).all()), "non-finite decode logits")
    err, scale = float((lf - ls).abs().max()), float(lf.abs().max())
    top2 = torch.topk(lf, 2).values
    print(f"handoff {cfg.name}: prefill 2047 + one decode step against a "
          f"prefill of 2048: max|dlogit|={err:.4e} vs max|logit|="
          f"{scale:.4f} (tol {RWKV_LOGIT_RTOL} x max|logit|); argmax prefill "
          f"{int(lf.argmax())} decode {int(ls.argmax())} (top-2 gap "
          f"{float(top2[0] - top2[1]):.4f}) [{card}]")
    check(err <= RWKV_LOGIT_RTOL * scale, "decode after prefill disagrees")
    check(int(lf.argmax()) == int(ls.argmax()), "handoff argmax differs")


def phase_jamba_handoff(torch, np, cfg, params, seed: int, counters,
                        card: str) -> None:
    """The Mamba conv and ssm state handoff at full width: a prefill of
    2047 tokens and one decode step (the one-token recurrence and the
    KV-cache attention) against a prefill of 2048.  The MoE layers run
    dropless here (capacity C = T): at the arch's capacity factor of 1.0
    a 2048-token prefill drops tokens that a decode step, which never
    drops, keeps, a difference of routing, not of the handoff.  The gap at
    the arch's own capacity is printed beside it."""
    import dataclasses
    from repro_torch.models import build_model
    prompt = np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, 2048)
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    gaps = {}
    for label, cf in (("dropless", cfg.n_experts / cfg.top_k),
                      ("capacity factor 1.0", cfg.capacity_factor)):
        model = build_model(dataclasses.replace(cfg, capacity_factor=cf))
        full, _ = model.prefill(params, {"tokens": tokens})
        _, cache = model.prefill(params, {"tokens": tokens[:, :-1]},
                                 seq_capacity=2048)
        check(all(c["ssm"].dtype == torch.float32 for c in cache
                  if "ssm" in c), "the ssm state is not f32")
        n0 = {n: w.launches for n, w in counters.items()}
        step, _ = model.decode(params, {"tokens": tokens[:, -1:]}, cache,
                               2047)
        torch.cuda.synchronize()
        launched = {n: w.launches - n0[n] for n, w in counters.items()}
        check(launched == {**{n: 0 for n in counters},
                           "moe_mlp": layer_plan(cfg)[1]},
              f"a decode step launched {launched}")
        lf, ls = full[0, -1].float(), step[0, -1].float()
        check(bool(torch.isfinite(ls).all()), "non-finite decode logits")
        err, scale = float((lf - ls).abs().max()), float(lf.abs().max())
        top2 = torch.topk(lf, 2).values
        print(f"handoff {cfg.name} ({label}): prefill 2047 + one decode step "
              f"against a prefill of 2048: max|dlogit|={err:.4e} vs "
              f"max|logit|={scale:.4f}; argmax prefill {int(lf.argmax())} "
              f"decode {int(ls.argmax())} (top-2 gap "
              f"{float(top2[0] - top2[1]):.4f}) [{card}]")
        gaps[label] = (err, scale, int(lf.argmax()) == int(ls.argmax()))
    err, scale, same = gaps["dropless"]
    check(err <= JAMBA_LOGIT_RTOL * scale,
          f"decode after prefill disagrees ({err} > {JAMBA_LOGIT_RTOL} x "
          f"{scale})")
    check(same, "handoff argmax differs")


def phase_mamba_scan(torch, cfg, params, card: str) -> dict:
    """The plain Mamba scan of one layer at 2048 tokens and full width
    (b=1, d_inner 8192, d_state 16): its peak device memory above its
    inputs and its time.  Each 256-token chunk builds its own (1, 256,
    8192, 16) f32 decay and drive, as the JAX scan body does."""
    from repro_torch.models import mamba as mm
    p = params["layers"][0]["mixer"]
    p = {k: v[0] for k, v in p.items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    xc = torch.randn(1, 2048, cfg.d_inner, generator=gen,
                     device="cuda").bfloat16()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, h = mm.selective_scan_chunked(p, xc, cfg, remat=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all()),
          "non-finite scan output")
    del y, h
    ms = cuda_ms(lambda: mm.selective_scan_chunked(p, xc, cfg, remat=False),
                 iters=5, warmup=1)
    chunk_bytes = 256 * cfg.d_inner * cfg.d_state * 4
    print(f"mamba scan s=2048 d_inner={cfg.d_inner} d_state={cfg.d_state} "
          f"(chunks of 256, plain PyTorch): peak {peak / 2**20:.1f} MiB above "
          f"its inputs ({peak / chunk_bytes:.2f} x one chunk's f32 decay), "
          f"{ms:.3f} ms per layer [{card}]")
    return {"peak_mib": peak / 2**20, "ms": ms}


def _wkv_bound(w_ops, shape, dtype):
    """(bound ms, what bounds it, bytes, operations): ``w_ops.cost`` from
    a zero state, its operations at the rate outside the tensor cores."""
    ops, nbytes = w_ops.cost(shape, dtype)
    return (*bound_of(ops, nbytes, PEAK_F32_FLOPS), nbytes, ops)


def phase_wkv_timing(torch, w_ops, rw, card: str) -> dict:
    """The kernel at rwkv6-7b's prefill shape, bf16, the model's chunk,
    checked against its plain version (the sequential recurrence) first;
    with ``rw`` (the model's module) also the plain version and the
    model's plain chunked scan timed.  No single PyTorch call computes
    WKV6 (library: none)."""
    b, s, h, n = (RWKV_SHAPE[k] for k in "bshn")
    gen = torch.Generator(device="cuda").manual_seed(11)
    r, k, v, lw, u, _ = _wkv_inputs(torch, gen, b, s, h, n, torch.bfloat16)
    got = w_ops.wkv6_state(r, k, v, lw, u, chunk=RWKV_CHUNK)
    want = w_ops.wkv6_state_plain(r, k, v, lw, u)
    ok, err, err_st, rel = _wkv_close(torch, got, want, "bfloat16")
    check(ok, f"wkv6 main-shape kernel error {err} (state {err_st})")
    ms = cuda_ms(lambda: w_ops.wkv6_state(r, k, v, lw, u, chunk=RWKV_CHUNK))
    plain_ms = chunked_ms = None
    if rw is not None:
        plain_ms = cuda_ms(lambda: w_ops.wkv6_state_plain(r, k, v, lw, u),
                           iters=3, warmup=1)
        chunked_ms = cuda_ms(lambda: rw.wkv6_chunked_plain(
            r, k, v, lw, u, None, RWKV_CHUNK), iters=5, warmup=1)
    bound_ms, bound_by, nbytes, ops = _wkv_bound(w_ops, r.shape, r.dtype)
    plain = ("" if rw is None else
             f"plain (sequential) {plain_ms:.4f} ms, plain chunked scan "
             f"{chunked_ms:.4f} ms, library none, ")
    print(f"wkv6 timing b={b} s={s} h={h} n={n} bf16 chunk={RWKV_CHUNK}: "
          f"kernel {ms:.4f} ms, {plain}bound "
          f"{bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.3f} G operations, "
          f"{nbytes / 1e6:.2f} MB), share of the bound {bound_ms / ms:.4f}; "
          f"kernel at {ops / ms / 1e9:.2f} TFLOP/s, "
          f"{nbytes / ms / 1e9:.3f} TB/s; "
          f"max_abs_err y {err:.3e} (max |y| "
          f"{float(want[0].float().abs().max()):.1f}, relative to 1+|y| "
          f"{rel:.3e}), state {err_st:.3e} [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                plain_chunked_ms=chunked_ms,
                shape=f"b={b} s={s} h={h} n={n} bf16 chunk={RWKV_CHUNK}")


def phase_wkv_lengths(torch, w_ops, lens, n_layers: int, card: str) -> dict:
    """The kernel alone at rwkv6-7b's heads and each served prompt length,
    each checked once against its plain version: what its launches (one
    per layer per request) cost in the serve run.  Returns the time of a
    launch at each length and the serve run's total."""
    h, n = RWKV_SHAPE["h"], RWKV_SHAPE["n"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for s in sorted(int(x) for x in lens):
        r, k, v, lw, u, _ = _wkv_inputs(torch, gen, 1, s, h, n,
                                        torch.bfloat16)
        got = w_ops.wkv6_state(r, k, v, lw, u, chunk=RWKV_CHUNK)
        ok, err, err_st, rel = _wkv_close(
            torch, got, w_ops.wkv6_state_plain(r, k, v, lw, u), "bfloat16")
        check(ok, f"wkv6 s={s}: error y {err} (relative {rel}) state "
                  f"{err_st}")
        ms = cuda_ms(lambda: w_ops.wkv6_state(r, k, v, lw, u,
                                              chunk=RWKV_CHUNK))
        bound, _, _, _ = _wkv_bound(w_ops, r.shape, r.dtype)
        out[f"s={s}"] = ms
        print(f"wkv6 lengths s={s}: kernel {ms:.4f} ms per launch (bound "
              f"{bound:.4f}, share {bound / ms:.4f}), {ms * n_layers:.3f} ms "
              f"per prefill; max_abs_err y {err:.3e} (relative to 1+|y| "
              f"{rel:.3e}) state {err_st:.3e}")
    out["serve run total ms"] = sum(out.values()) * n_layers
    print(f"wkv6 lengths: kernel {out['serve run total ms']:.3f} ms over the "
          f"serve run's {len(lens)} prefills ({n_layers} launches each) "
          f"[{card}]")
    return out


def phase_rwkv_train(torch, counters, seed: int, card: str) -> dict:
    """rwkv6-7b at full width, depth cut to RWKV_TRAIN_LAYERS: the train
    mode's plain chunked scan under autograd, with the perturbed leaves."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.train import batch_to
    from repro_torch.train.step import loss_and_grads
    cfg = dataclasses.replace(get_config(RWKV_ARCH),
                              n_layers=RWKV_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model, opts, state, step, pipe = _train_setup(torch, cfg, seed)
    perturb_rwkv(torch, state["params"], seed)
    batches = [batch_to(pipe.batch(i), "cuda")
               for i in range(RWKV_TRAIN_STEPS + 1)]
    state, hist, launches, n_leaves = _run_steps(
        torch, step, state, batches[:RWKV_TRAIN_STEPS], counters)
    for i, m in enumerate(hist):
        print(f"rwkvtrain step {i + 1}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} {m['s'] * 1e3:.1f} ms")
    grads, _, _ = loss_and_grads(model, opts, state["params"], batches[-1])
    for name, g in grads["layers"]["mixer"].items():
        per_layer = g.abs().flatten(1).sum(-1)
        check(bool((per_layer > 0).all()),
              f"time mix {name}: a layer got no gradient")
    print(f"rwkvtrain {cfg.name} at {RWKV_TRAIN_LAYERS} of 32 layers, b="
          f"{TRAIN_BATCH} s={TRAIN_SEQ}: every time-mix leaf of every layer "
          f"(u and w0 included) has a gradient; {n_leaves} leaves; launches "
          f"{launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return launches


def _same_bits(torch, a, b) -> bool:
    """Equal bit for bit (f32 compared as int32, so a NaN equals itself)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def phase_quantize_sweep(torch, q_ops, quantize_plain) -> None:
    """The quantize kernel against its plain version, bit for bit: the
    padding wrapper over tests/test_kernels.py's lengths and ragged ones,
    then rows that hold exact half-quanta (x / scale = k + 0.5, rounded
    half to even), all zeros, absmax 1e-30 and 1e30."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(8)
    for block in (128, 256):
        for n in QUANT_SIZES:
            x = torch.randn(n, generator=gen, device="cuda") * 3.0
            q, s, pad = q_ops.quantize(x, block=block)
            qp, sp = quantize_plain(F.pad(x, (0, pad)).reshape(-1, block))
            ok = _same_bits(torch, q, qp) and _same_bits(torch, s, sp)
            print(f"quantize sweep n={n} block={block} nb={q.shape[0]}: "
                  f"{'bit-exact' if ok else 'FAIL'}")
            check(ok, f"quantize kernel differs from its plain version "
                      f"(n={n}, block={block})")
        x = torch.randn(4099, block, generator=gen, device="cuda")
        k = torch.arange(block - 2, device="cuda", dtype=torch.float32)
        x[0, :-2] = (k - (block // 2 - 1) + 0.5) * 0.5   # x / scale = k + .5
        x[0, -2], x[0, -1] = 63.5, 0.0                    # scale 0.5
        x[1] = 0.0
        x[2] *= 1e-30
        x[3] *= 1e30
        q, s = q_ops.quantize_blocks(x)
        qp, sp = quantize_plain(x)
        ok = (_same_bits(torch, q, qp) and _same_bits(torch, s, sp)
              and float(s[0]) == 0.5 and not bool(q[1].any()))
        print(f"quantize edge rows block={block} (half-quanta, zeros, "
              f"1e-30, 1e30, 4099 rows): {'bit-exact' if ok else 'FAIL'}")
        check(ok, f"quantize kernel edge rows (block={block})")


def _train_setup(torch, cfg, seed: int, state: bool = True):
    """The train cell's model, options, state (drawn on the card; None
    with ``state=False``), step and pipeline."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.train import (TrainOptions, build_train_step,
                                   init_train_state)
    model = build_model(cfg)                       # bf16 compute
    opts = TrainOptions(grad_compress=True, warmup=2, total_steps=TRAIN_STEPS)
    state = init_train_state(model, seed, opts, "cuda") if state else None
    pipe = SyntheticPipeline(cfg, ShapeConfig("chip_train", TRAIN_SEQ,
                                              TRAIN_BATCH, "train"), seed=seed)
    return model, opts, state, build_train_step(model, opts), pipe


def _run_steps(torch, step, state, batches, counters):
    """The steps, with every launch count set to 0 just before and read
    just after; each step's host time ends in reading its metrics."""
    import math
    from repro_torch.models.common import leaves
    for wrapper in counters.values():
        wrapper.launches = 0
    hist = []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}
        m["s"] = time.perf_counter() - t0
        hist.append(m)
    launches = {n: w.launches for n, w in counters.items()}
    for i, m in enumerate(hist):
        check(all(math.isfinite(m[k]) for k in ("loss", "grad_norm")),
              f"step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
    n_leaves = len(list(leaves(state["params"])))
    want = {"flash_attention": 0, "moe_mlp": 0, "wkv6": 0,
            "quantize": n_leaves * len(batches)}
    for n, got in launches.items():
        check(got == want[n], f"{n} launched {got} times in the train "
                              f"steps, want {want[n]}")
    return state, hist, launches, n_leaves


def _eval_loss(torch, model, params, batch) -> float:
    from repro_torch.models.layers import cross_entropy
    with torch.no_grad():
        logits, _ = model.train_logits(params, batch)
        return float(cross_entropy(logits, batch["labels"], model.cfg,
                                   mask=batch["mask"]))


def phase_train(torch, cfg, counters, seed: int, card: str):
    """The training path: 10 steps of stablelm-1.6b at full width."""
    import statistics
    from repro_torch.train import batch_to
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opts, state, step, pipe = _train_setup(torch, cfg, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(state["params"]))
    print(f"train: {cfg.name} state (f32 params, moments, error buffer) "
          f"drawn in {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} "
          f"B params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    batches = [batch_to(pipe.batch(i), "cuda") for i in range(TRAIN_STEPS)]
    held_out = batch_to(pipe.batch(TRAIN_STEPS), "cuda")
    loss0 = _eval_loss(torch, model, state["params"], held_out)
    state, hist, launches, n_leaves = _run_steps(torch, step, state, batches,
                                                 counters)
    loss1 = _eval_loss(torch, model, state["params"], held_out)
    for i, m in enumerate(hist):
        print(f"train step {i + 1}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} lr {m['lr']:.3e} {m['s'] * 1e3:.1f} ms")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss']}")
    print(f"train: loss on a batch no step has seen (pipeline step "
          f"{TRAIN_STEPS}): {loss0:.4f} before the steps, {loss1:.4f} after")
    step_ms = statistics.median(m["s"] for m in hist[1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train {cfg.name} b={TRAIN_BATCH} s={TRAIN_SEQ} bf16 compute, "
          f"grad_compress: median step {step_ms:.2f} ms (steps 2-"
          f"{TRAIN_STEPS}; step 1 {hist[0]['s'] * 1e3:.1f} ms) = "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; {n_leaves} leaves; "
          f"launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return model, opts, state, step, pipe, launches, step_ms


def phase_grads(torch, model, opts, state, batch, step_ms: float, q_ops,
                quantize_plain, card: str):
    """One more step's real gradients plus the error buffer: the kernel
    against its plain version leaf by leaf, bit for bit, on exactly the
    rows compress_gradients quantizes; then compress_gradients timed."""
    import torch.nn.functional as F
    from repro_torch.models.common import leaves
    from repro_torch.optim import compress_gradients
    from repro_torch.train.step import loss_and_grads
    grads, loss, _ = loss_and_grads(model, opts, state["params"], batch)
    rows, n = [], 0
    with torch.no_grad():
        for g, e in zip(leaves(grads), leaves(state["err"])):
            flat = (g.float() + e).reshape(-1)
            flat = F.pad(flat, (0, (-flat.numel()) % 256))
            rows.append(flat.reshape(-1, 256))
            q, s = q_ops.quantize_blocks(rows[-1])
            qp, sp = quantize_plain(rows[-1])
            check(_same_bits(torch, q, qp) and _same_bits(torch, s, sp),
                  f"quantize kernel differs from its plain version on a "
                  f"real gradient leaf {tuple(g.shape)}")
            n += g.numel()
        print(f"grads: {len(rows)} leaves, {n / 1e9:.4f} B values of "
              f"grads + error buffer (loss {float(loss):.4f}): kernel q and "
              f"scales bit-exact against the plain version")
        comp_ms = cuda_ms(lambda: compress_gradients(grads, state["err"]),
                          iters=5, warmup=1)
    print(f"grads: compress_gradients {comp_ms:.3f} ms = "
          f"{comp_ms / step_ms:.4f} of the median step ({step_ms:.2f} ms) "
          f"[{card}]")
    return rows


def _quant_bound(q_ops, nb: int):
    """(bound ms, what bounds it, bytes): ``q_ops.cost`` of ``nb`` rows of
    256, its operations at the f32 rate outside the tensor cores."""
    ops, nbytes = q_ops.cost((nb, 256))
    return (*bound_of(ops, nbytes, PEAK_F32_FLOPS), nbytes)


def phase_qtiming(torch, q_ops, quantize_plain, rows, card: str):
    """The kernel and its plain version on the largest leaf's rows and over
    every leaf's, as a step's compress_gradients quantizes them.  No
    single PyTorch call computes this function (library: none)."""
    big = max(rows, key=lambda r: r.numel())
    q, s = q_ops.quantize_blocks(big)
    qp, sp = quantize_plain(big)
    err = max(float((q.int() - qp.int()).abs().max()),
              float((s - sp).abs().max()))
    ms = cuda_ms(lambda: q_ops.quantize_blocks(big))
    plain_ms = cuda_ms(lambda: quantize_plain(big), iters=5, warmup=1)
    n, nb = big.numel(), big.shape[0]
    bound_ms, bound_by, nbytes = _quant_bound(q_ops, nb)
    print(f"qtiming largest leaf nb={nb} block=256 ({n / 1e6:.1f} M f32): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB); "
          f"kernel at {nbytes / ms / 1e9:.3f} TB/s, "
          f"{ms / bound_ms:.2f}x the bound; max_abs_err {err} [{card}]")
    all_ms = cuda_ms(lambda: [q_ops.quantize_blocks(r) for r in rows],
                     iters=5, warmup=1)
    all_plain = cuda_ms(lambda: [quantize_plain(r) for r in rows],
                        iters=3, warmup=1)
    n_all = sum(r.numel() for r in rows)
    all_bound, _, _ = _quant_bound(q_ops, sum(r.shape[0] for r in rows))
    print(f"qtiming all {len(rows)} leaves ({n_all / 1e9:.4f} B f32): kernel "
          f"{all_ms:.4f} ms, plain {all_plain:.4f} ms, bound {all_bound:.4f} "
          f"ms per step [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                shape=f"nb={nb} block=256 f32 (largest leaf)",
                per_step={"ms": all_ms, "plain_ms": all_plain,
                          "bound_ms": all_bound, "leaves": len(rows)})


def phase_train_profile(torch, step, state, batches, card: str) -> None:
    """torch.profiler over TRAIN_PROFILE_STEPS train steps: the device's
    busy share of the window, device time by step phase (the step's
    record_function spans) and by kernel."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("train"):
            for b in batches:
                state, m = step(state, b)
            float(m["loss"])
            torch.cuda.synchronize()
    events = _trace_events(prof)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    check(len(dev) > 0, "the profiler saw no device activity")
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"] == "train"]
    check(len(win) == 1, f"{len(win)} train spans in the trace")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    busy = _busy_us([(a, b) for a, b, _ in dev], t0, t1)
    n = len(batches)
    print(f"tprofile: {n} steps, {(t1 - t0) / 1e3 / n:.2f} ms per step on "
          f"the host clock (profiled), device busy {busy / 1e3 / n:.2f} ms "
          f"per step = {busy / (t1 - t0):.4f} of it [{card}]")
    # the device spans of the step's record_function phases; the backward
    # pass is launched from autograd's own thread, outside every span, so
    # it is the rest of the busy time
    phases = {"forward": 0.0, "compress": 0.0, "optimizer": 0.0}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e["name"] in phases:
            phases[e["name"]] += e["dur"]
    phases["backward (the rest)"] = busy - sum(phases.values())
    for name, dur in phases.items():
        print(f"  tprofile phase {name}: device {dur / 1e3 / n:.3f} ms per "
              f"step = {dur / busy:.4f} of device busy time")
    by_name = {}
    for a, b, name in dev:
        tot, k = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + b - a, k + 1)
    groups = {"gemm": ("gemm", "nvjet", "xmma", "cutlass"),
              "softmax": ("softmax",), "quantize": ("quantize_kernel",)}
    for g, keys in groups.items():
        tot = sum(t for name, (t, _) in by_name.items()
                  if any(k in name.lower() for k in keys))
        print(f"  tprofile {g} kernels {tot / 1e3 / n:.3f} ms per step = "
              f"{tot / busy:.4f} of device busy time")
    for name, (tot, k) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:PROFILE_TOP]:
        print(f"  tprofile device {tot / 1e3 / n:.3f} ms per step, {k} "
              f"launches: {name[:110]}")


def phase_moe_train(torch, counters, seed: int, card: str) -> dict:
    """olmoe-1b-7b at full width, depth cut to MOE_TRAIN_LAYERS: the train
    mode's einsum expert path under autograd, with the aux loss."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.train import batch_to
    from repro_torch.train.step import loss_and_grads
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model, opts, state, step, pipe = _train_setup(torch, cfg, seed)
    batches = [batch_to(pipe.batch(i), "cuda")
               for i in range(MOE_TRAIN_STEPS + 1)]
    state, hist, launches, n_leaves = _run_steps(
        torch, step, state, batches[:MOE_TRAIN_STEPS], counters)
    for i, m in enumerate(hist):
        print(f"moetrain step {i + 1}: loss {m['loss']:.4f} aux "
              f"{m['aux_loss']:.4f} grad_norm {m['grad_norm']:.4f} "
              f"{m['s'] * 1e3:.1f} ms")
        check(m["aux_loss"] > 0, f"step {i + 1}: aux loss {m['aux_loss']}")
    grads, _, _ = loss_and_grads(model, opts, state["params"], batches[-1])
    ffn = grads["layers"]["ffn"]
    for name in ("wi", "wg", "wo"):
        per_expert = ffn[name].abs().flatten(2).sum(-1)      # (layers, E)
        check(bool((per_expert > 0).all()),
              f"{name}: {int((per_expert == 0).sum())} (layer, expert) "
              f"pairs got no gradient")
    check(bool(ffn["router"].abs().sum() > 0), "the router got no gradient")
    print(f"moetrain {cfg.name} at {MOE_TRAIN_LAYERS} of 16 layers, b="
          f"{TRAIN_BATCH} s={TRAIN_SEQ}: every expert of every layer and "
          f"the router have a gradient; {n_leaves} leaves; launches "
          f"{launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return launches


def phase_fidelity_native(torch, model, params, seed: int,
                          card: str) -> float:
    """NativeBackend on the prefill step at b=1 s=2048: its ms per step,
    timed with CUDA events over FIDELITY_ITERS calls after a warm-up; the
    logits checked finite and of the right shape."""
    from repro_torch.core.fidelity import NativeBackend, StepProgram, specs_of
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serve.step import build_prefill_step
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (FIDELITY_B, FIDELITY_S), device="cuda",
                                     generator=gen)}
    prog = StepProgram(f"{cfg.name} prefill", build_prefill_step(model),
                       specs_of((params, batch)), device="cuda")
    rep = NativeBackend().run(prog, params, batch, iters=FIDELITY_ITERS)
    logits = rep.outputs[0]
    check(tuple(logits.shape) == (FIDELITY_B, 1, padded_vocab(cfg))
          and bool(torch.isfinite(logits).all()),
          f"native {prog.name}: logits {tuple(logits.shape)}")
    print(f"fidelity native {prog.name} b={FIDELITY_B} s={FIDELITY_S}: "
          f"{rep.wall_s * 1e3:.3f} ms per step (CUDA events, "
          f"{FIDELITY_ITERS} calls) [{card}]")
    return rep.wall_s * 1e3


def analytic_flops(cfg, specs, b: int, s: int, train: bool) -> float:
    """2 N tokens plus attention: N the parameters a token's products read
    (a MoE layer's experts at top_k of n_experts; the unembedding for the
    last position only in a prefill; the embedding is a gather), attention
    2 b s^2 h d an attention layer (the causal half of q k^T and p v), an
    RWKV layer's time mix 4 n^2 b s h, a Mamba layer's recurrence
    4 d_inner d_state b s (h = decay h + drive and y = h . C, two flops
    each per state element); a train step 4x that (the forward, its
    recomputation, and a backward of twice the forward).  An
    encoder-decoder: ``encdec_flops``."""
    import math
    if cfg.family == "audio":
        return encdec_flops(cfg, specs, b, s, train)
    layers = _matmul_params(cfg, specs["layers"])
    vp = specs["embed"].get("head", specs["embed"]["table"]).shape
    head = math.prod(vp)
    tokens = b * s
    total = 2 * layers * tokens + 2 * head * (tokens if train else b)
    kinds, _ = layer_plan(cfg)
    total += kinds.count("rwkv") * 4 * cfg.rwkv_head_size ** 2 * tokens \
        * cfg.n_rwkv_heads
    total += kinds.count("attn") * 2 * b * s * s * cfg.n_heads * cfg.head_dim
    total += kinds.count("mamba") * 4 * cfg.d_inner * cfg.d_state * tokens
    return total * (4 if train else 1)


def encdec_flops(cfg, specs, b: int, s: int, train: bool) -> float:
    """2 N tokens for each stack: the encoder's parameters over its b
    enc_seq frames, the decoder's over its b s tokens, except the cross
    attention's k and v projections, which read the b enc_seq frames; the
    unembedding as ``analytic_flops``; attention 4 b s_q s_kv h d a pair
    of q k^T and p v: non-causal over enc_seq^2 in the encoder and
    s enc_seq in cross attention, causal (half of s^2) in the decoder's
    self attention; a train step 4x that."""
    import math
    frames, tokens = b * cfg.enc_seq, b * s
    dec = specs["dec_layers"]
    cross_kv = sum(_matmul_params(cfg, dec["cross_attn"][w])
                   for w in ("wk", "wv"))
    head = math.prod(specs["embed"]["head"].shape)
    total = (2 * _matmul_params(cfg, specs["enc_layers"]) * frames
             + 2 * (_matmul_params(cfg, dec) - cross_kv) * tokens
             + 2 * cross_kv * frames + 2 * head * (tokens if train else b))
    hd = 4 * b * cfg.n_heads * cfg.head_dim
    total += hd * (cfg.enc_layers * cfg.enc_seq ** 2
                   + cfg.n_layers * (s * s / 2 + s * cfg.enc_seq))
    return total * (4 if train else 1)


def _matmul_params(cfg, tree) -> float:
    """Parameters of a layers tree (dicts, and a hybrid arch's tuple), a
    MoE FFN's experts (a dict with a router) at top_k of n_experts."""
    import math
    if type(tree) is tuple:                   # a TensorSpec is a leaf
        return sum(_matmul_params(cfg, t) for t in tree)
    if not isinstance(tree, dict):
        return float(math.prod(tree.shape))
    share = cfg.top_k / cfg.n_experts if "router" in tree else 1.0
    return sum(_matmul_params(cfg, v) * (share if k in ("wi", "wg", "wo")
                                         else 1.0)
               for k, v in tree.items())


def phase_fidelity_dryruns(torch, counters, seed: int, card: str):
    """DryRunBackend on fake CUDA tensors at full width, params included
    (their specs from an init on fake tensors): stablelm-1.6b's,
    olmoe-1b-7b's, rwkv6-7b's, deepseek-67b's, jamba-v0.1-52b's (all
    32 layers) and qwen2-vl-7b's (2048 - n_vis tokens and the vision
    prefix, as JAX's input specs give a VLM prefill) prefill at b=1
    s=2048, whisper-small's at its longest served prompt with its 1500
    frames, and the train cell's step (stablelm-1.6b, 4 x 2048,
    grad_compress).
    Each leaves every launch count and the card's allocated memory as
    they were, and reaches each kernel's custom op exactly once per layer
    that runs it (whisper: ``flash_per_prefill``; the train step: once
    per parameter leaf, quantize only); every prefill's ops all have a
    cost rule, and qwen2-vl-7b's and whisper-small's flops lie within 1%
    of the analytic count.  Returns the summaries by label, and each
    run's program and report by label."""
    from repro_torch.configs import get_config
    from repro_torch.core.fidelity import (DryRunBackend, StepProgram,
                                           TensorSpec, eval_shape, specs_of)
    from repro_torch.models import build_model
    from repro_torch.serve.step import build_prefill_step
    from repro_torch.train import batch_to, build_train_step, init_train_state
    runs = []
    for arch in (ARCH, MOE_ARCH, RWKV_ARCH, DENSE_67B, JAMBA_ARCH, VLM_ARCH,
                 WHISPER_ARCH):
        cfg = get_config(arch)
        n_vis = n_vis_of(cfg)
        s = WHISPER_PROMPT if cfg.family == "audio" else FIDELITY_S
        tokens = {"tokens": TensorSpec((FIDELITY_B, s - n_vis),
                                       torch.int64)}
        if n_vis:
            tokens["vision_embeds"] = TensorSpec(
                (FIDELITY_B, n_vis, cfg.d_model), torch.bfloat16)
        if cfg.family == "audio":
            tokens["enc_embeds"] = TensorSpec(
                (FIDELITY_B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        model = build_model(cfg)
        specs = eval_shape(lambda: model.load(model.init(seed, "cpu"), "cpu"))
        kinds, n_moe = layer_plan(cfg)
        want = {op: n for op, n in (("flash_attention",
                                     flash_per_prefill(cfg)),
                                    ("expert_mlp", n_moe),
                                    ("wkv6", kinds.count("rwkv"))) if n}
        runs.append((f"{arch} prefill b={FIDELITY_B} s={s}", cfg,
                     StepProgram(f"{arch} prefill", build_prefill_step(model),
                                 (specs, tokens), device="cuda"),
                     want, FIDELITY_B, s, False))
    cfg = get_config(ARCH)
    model, opts, _, _, pipe = _train_setup(torch, cfg, seed, state=False)
    state = eval_shape(lambda: init_train_state(model, seed, opts, "cpu"))
    n_leaves = len(list(_leaves(state["params"])))
    runs.append((f"{ARCH} train step b={TRAIN_BATCH} s={TRAIN_SEQ} "
                 f"grad_compress", cfg,
                 StepProgram(f"{ARCH} train", build_train_step(model, opts),
                             (state, specs_of(batch_to(pipe.batch(0), "cpu"))),
                             device="cuda"),
                 {"quantize_blocks": n_leaves}, TRAIN_BATCH, TRAIN_SEQ, True))
    out, reps = {}, {}
    for label, cfg, prog, want, b, s, train in runs:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        n0 = {n: w.launches for n, w in counters.items()}
        rep = DryRunBackend().run(prog)
        torch.cuda.synchronize()
        launched = {n: w.launches - n0[n] for n, w in counters.items()}
        check(not any(launched.values()),
              f"dry run {label} launched kernels: {launched}")
        check(torch.cuda.memory_allocated() == mem0,
              f"dry run {label} allocated device memory")
        check(rep.detail["kernels"] == want,
              f"dry run {label}: kernel ops {rep.detail['kernels']}, want "
              f"{want}")
        analytic = analytic_flops(cfg, _param_specs(prog), b, s, train)
        if not train:
            check(not rep.detail["unknown_ops"],
                  f"dry run {label}: ops with no cost rule "
                  f"{rep.detail['unknown_ops']}")
        if cfg.family in ("vlm", "audio"):
            check(abs(rep.flops / analytic - 1) <= 0.01,
                  f"dry run {label}: {rep.flops} flops, analytic {analytic}")
        k_flops = sum(f for n, f, _ in rep.detail["ops"]
                      if n.startswith("repro_torch."))
        k_bytes = sum(nb for n, _, nb in rep.detail["ops"]
                      if n.startswith("repro_torch."))
        out[label] = dict(flops=rep.flops, bytes=rep.bytes_accessed,
                          analytic_flops=analytic, kernels=want,
                          unknown_ops=rep.detail["unknown_ops"],
                          kernel_flops=k_flops, kernel_bytes=k_bytes,
                          ops=len(rep.detail["ops"]),
                          argument_bytes=rep.memory["argument_bytes"],
                          host_s=rep.wall_s)
        reps[label] = prog, rep
        print(f"fidelity dryrun {label}: {rep.flops / 1e12:.4f} TFLOP "
              f"({rep.flops / analytic:.4f} of the analytic "
              f"{analytic / 1e12:.4f}), {rep.bytes_accessed / 1e9:.3f} GB; "
              f"the kernel ops {k_flops / rep.flops:.4f} of the flops and "
              f"{k_bytes / rep.bytes_accessed:.4f} of the bytes; "
              f"{len(rep.detail['ops'])} ops, kernel ops {want}, ops with no "
              f"cost rule {rep.detail['unknown_ops']}, arguments "
              f"{rep.memory['argument_bytes'] / 2**30:.2f} GiB never "
              f"allocated; {rep.wall_s:.1f} s on the host; no launch, device "
              f"memory unchanged [{card}]")
    return out, reps


def phase_fidelity_desim(measured: dict, reps: dict, card: str) -> dict:
    """The detailed rung: ``DesimBackend`` on ``h100_card()`` (the port's
    simulator, one H100 SXM5) replays each dry run of ``reps`` named in
    ``measured`` (label -> the step's measured ms on the card), one line
    each: native ms, predicted ms, predicted/measured, the dry run's
    flops and bytes.  No bound on the ratio; the trace must hold the dry
    run's flops and bytes, and the prediction must be positive."""
    import math

    from repro_torch.core.fidelity import DesimBackend
    from repro_torch.sim import h100_card
    out = {}
    for label, native_ms in measured.items():
        prog, rep = reps[label]
        got = DesimBackend(board=h100_card()).run(prog, dryrun_report=rep)
        regions = [o for o in got.detail["trace"]["ops"]
                   if o["kind"] == "compute"]
        check(math.fsum(o["flops"] for o in regions) == rep.flops
              and math.fsum(o["bytes"] for o in regions)
              == rep.bytes_accessed,
              f"desim {label}: the trace's flops and bytes are not the dry "
              f"run's {rep.flops}, {rep.bytes_accessed}")
        pred_ms = got.predicted_step_s * 1e3
        check(pred_ms > 0, f"desim {label}: predicted {pred_ms} ms")
        out[label] = dict(native_ms=native_ms, desim_ms=pred_ms,
                          ratio=pred_ms / native_ms, flops=rep.flops,
                          bytes=rep.bytes_accessed, trace_ops=len(
                              got.detail["trace"]["ops"]),
                          host_s=got.wall_s)
        print(f"fidelity desim {label}: native {native_ms:.3f} ms, "
              f"desim-predicted {pred_ms:.3f} ms on h100_card(), "
              f"predicted/measured {pred_ms / native_ms:.4f}; dry run "
              f"{rep.flops / 1e12:.4f} TFLOP, {rep.bytes_accessed / 1e9:.3f} "
              f"GB [{card}]")
    return out


def phase_serving_sim(torch, counters, served: dict, train_trace: dict,
                      eval_trace: dict, card: str) -> dict:
    """23. Serving and sampled simulation on the card's model.

    (a) The batched decode step of phase 5's server (SERVE_SLOTS slots,
    SERVE_CAP capacity) of stablelm-1.6b and olmoe-1b-7b dry-run on fake
    CUDA tensors at full width (no launch, no device memory; olmoe's
    moe_mlp op once a MoE layer) and ``ServingCost.from_hlo_cost`` fitted
    to it at the whole static cache, ``decode_cost`` giving back the dry
    run's flops and bytes; (b) ``ServeSim`` on ``h100_card(1)`` with
    phase 5's requests (``served``: arch -> its lengths and its decode
    steps' median ms): the predicted ms a decode step, the TPOT and the
    live context it charged beside the measured median; (c) ``FleetSim``
    on ``h100_fleet(6, 1)`` with stablelm's fit and the flash crowd of
    ``examples/fleet_sim.py``, its feed replayed through a fresh
    ``FleetController`` to the same decision log; (d) the SimPoint lap
    on phase 16's train step trace chained over SIMPOINT_STEPS steps,
    every SIMPOINT_EVAL_EVERY-th of them an evaluation pass (phase 16's
    stablelm-1.6b prefill trace): full detail, a fixed-stride
    ``sampled_run``, the SimPoint plan's ``sampled_run`` (two phases, two
    regions), and its region checkpoints restored by two spawned workers,
    each within SAMPLED_BOUND of full detail, the fanout equal to a
    serial restore.  No bound on a predicted/measured ratio."""
    import statistics
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.desim.simnodes import to_ticks
    from repro_torch.core.desim.trace import HloTrace, TraceOp
    from repro_torch.launch.dryrun import decode_serving_cost
    from repro_torch.serve import FleetController, FleetPolicy
    from repro_torch.sim import (FleetSim, SamplePlan, ServeSim, Simulator,
                                 chain_steps, flash_crowd_requests,
                                 h100_card, h100_fleet, reconstruct,
                                 record_op_stream, restore_fanout,
                                 sampled_run, simpoint_plan,
                                 take_region_checkpoints, trace_requests)
    out = {"serve": {}}
    costs = {}
    ctx = SERVE_SLOTS * SERVE_CAP
    for arch in (ARCH, MOE_ARCH):
        cfg = get_config(arch)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        n0 = {n: w.launches for n, w in counters.items()}
        cost, rep, weight_bytes = decode_serving_cost(cfg, SERVE_SLOTS,
                                                      SERVE_CAP, "cuda")
        torch.cuda.synchronize()
        launched = {n: w.launches - n0[n] for n, w in counters.items()}
        check(not any(launched.values()),
              f"decode dry run {arch} launched kernels: {launched}")
        check(torch.cuda.memory_allocated() == mem0,
              f"decode dry run {arch} allocated device memory")
        _, n_moe = layer_plan(cfg)
        want = {"expert_mlp": n_moe} if n_moe else {}
        check(rep.detail["kernels"] == want,
              f"decode dry run {arch}: kernel ops {rep.detail['kernels']}, "
              f"want {want}")
        flops, nbytes = cost.decode_cost(SERVE_SLOTS, ctx)
        check(abs(flops / rep.flops - 1) <= 1e-9
              and abs(nbytes / rep.bytes_accessed - 1) <= 1e-9,
              f"decode fit {arch}: decode_cost gives {flops}, {nbytes}, the "
              f"dry run {rep.flops}, {rep.bytes_accessed}")
        costs[arch] = cost

        def serve_sim():
            return ServeSim(cost=cost, requests=trace_requests(
                [(0.0, n, SERVE_NEW) for n in served[arch]["lens"]]),
                slots=SERVE_SLOTS, seq_capacity=SERVE_CAP)
        t0 = time.perf_counter()
        srv = serve_sim()
        sim = Simulator(h100_card(1), srv, record_timeline=True)
        for _ in sim.run():
            pass
        host_s = time.perf_counter() - t0
        s = srv.summary()
        check(s["requests"] == len(served[arch]["lens"]),
              f"ServeSim {arch}: {s['requests']} requests finished")
        steps = [e["end"] - e["start"] for e in sim.result().timeline
                 if "/decode/" in e["op"]]
        pred_ms = statistics.fmean(steps) * 1e3
        # the live context each decode step was charged, from its bytes
        decodes = [op for op in record_op_stream(h100_card(1),
                                                 serve_sim()).ops
                   if "/decode/" in op.name]
        live = statistics.fmean(
            (op.bytes - cost.weight_bytes) / cost.kv_bytes_per_token
            - op.flops / cost.flops_per_token for op in decodes)
        meas_ms = served[arch]["decode_ms"]
        out["serve"][arch] = dict(
            flops=rep.flops, bytes=rep.bytes_accessed,
            weight_bytes=weight_bytes,
            flops_per_token=cost.flops_per_token,
            kv_bytes_per_token=cost.kv_bytes_per_token, fit_context=ctx,
            mean_live_context=live, kernels=want,
            decode_steps=len(steps), predicted_decode_ms=pred_ms,
            tpot_ms=s["mean_tpot_s"] * 1e3, measured_decode_ms=meas_ms,
            ratio=pred_ms / meas_ms, dryrun_host_s=rep.wall_s,
            sim_host_s=host_s)
        print(f"servesim {arch}: decode dry run {rep.flops / 1e12:.4f} "
              f"TFLOP, {rep.bytes_accessed / 1e9:.3f} GB (weights "
              f"{weight_bytes / 1e9:.3f} GB), kernel ops {want}; fit at "
              f"{ctx} context tokens: {cost.flops_per_token / 1e9:.4f} "
              f"GFLOP/token, {cost.kv_bytes_per_token / 1e3:.3f} kB/context "
              f"token; ServeSim on h100_card(1) charged "
              f"{live:.1f} live context tokens a step")
        print(f"servesim {arch}: predicted {pred_ms:.3f} ms/decode step "
              f"over {len(steps)} steps, TPOT {s['mean_tpot_s'] * 1e3:.3f} "
              f"ms, measured median {meas_ms:.3f} ms/decode step, "
              f"predicted/measured {pred_ms / meas_ms:.4f} [{card}]")

    # (c) the fleet of cards
    def policy():
        return FleetPolicy("least_loaded", min_replicas=2, max_replicas=6,
                           slots_per_replica=8,
                           cold_start_ticks=to_ticks(1.0),
                           control_period_ticks=to_ticks(0.5), seed=7)
    requests = flash_crowd_requests(420, seed=7, base_rps=15.0,
                                    crowd_rps=90.0, crowd_start_s=2.0,
                                    crowd_len_s=3.0, prefix_groups=8)
    t0 = time.perf_counter()
    fleet = FleetSim(cost=costs[ARCH], requests=requests, policy=policy(),
                     seq_capacity=1024, slo_ttft_s=0.6, slo_latency_s=4.0,
                     tenant_slo={"batch": 4.0})
    for _ in Simulator(h100_fleet(6, 1), fleet, timing="atomic").run():
        pass
    host_s = time.perf_counter() - t0
    s = fleet.summary()
    check(s["requests"] == len(requests),
          f"FleetSim: {s['requests']} of {len(requests)} requests finished")
    ctl = FleetController(policy())
    ctl.replay(fleet.feed, requests)
    check(ctl.policy.decisions == fleet.policy.decisions,
          "FleetController's replay of the feed differs from FleetSim's "
          "decision log")
    out["fleet"] = dict(
        requests=s["requests"], replicas_peak=s["replicas_peak"],
        scale_ups=s["scale_ups"], scale_downs=s["scale_downs"],
        p50_ttft_ms=s["p50_ttft_s"] * 1e3, p99_ttft_ms=s["p99_ttft_s"] * 1e3,
        goodput_rps=s["goodput_rps"], throughput_rps=s["throughput_rps"],
        decisions=len(fleet.policy.decisions), host_s=host_s)
    print(f"fleetsim {ARCH} on h100_fleet(6, 1): {int(s['requests'])} "
          f"requests, replicas peak {int(s['replicas_peak'])} "
          f"({int(s['scale_ups'])} up / {int(s['scale_downs'])} down), TTFT "
          f"p50/p99 {s['p50_ttft_s'] * 1e3:.2f} / "
          f"{s['p99_ttft_s'] * 1e3:.2f} ms, goodput "
          f"{s['goodput_rps']:.2f} rps; controller replay "
          f"{len(ctl.policy.decisions)} decisions, identical; "
          f"{host_s:.2f} s on the host [{card}]")

    # (d) the SimPoint lap on the train step's trace with evaluations
    train, evaluate = (HloTrace(tr["name"], [TraceOp(**op)
                                             for op in tr["ops"]])
                       for tr in (train_trace, eval_trace))
    chained = chain_steps(
        [evaluate if (i + 1) % SIMPOINT_EVAL_EVERY == 0 else train
         for i in range(SIMPOINT_STEPS)], name="train+eval")
    runs = {}
    t0 = time.perf_counter()
    full = h100_card().executor(timing="detailed").execute(chained)
    runs["full detail"] = (full.makespan_s, time.perf_counter() - t0)
    t0 = time.perf_counter()
    stride = sampled_run(h100_card(), chained, SIMPOINT_STEPS, SamplePlan())
    runs["sampled_run SamplePlan()"] = (stride.predicted_total_s,
                                        time.perf_counter() - t0)
    plan = simpoint_plan(chained, window=SIMPOINT_WINDOW, seed=0)
    check(len(plan.representatives) >= 2,
          f"simpoint: {plan.representatives} represent the train and "
          "evaluation phases")
    t0 = time.perf_counter()
    sp = sampled_run(h100_card(), chained, SIMPOINT_STEPS, plan)
    runs["sampled_run simpoint_plan"] = (sp.weighted_total_s,
                                         time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        lib = take_region_checkpoints(h100_card(), chained, plan,
                                      str(Path(root) / "lib"))
        # spawn, not the default fork: this process holds a CUDA context
        # and torch's threads, and a forked child of it can deadlock; the
        # workers read plain checkpoint data and touch no CUDA
        fanned = restore_fanout(lib, workers=2, mp_context="spawn")
        runs["restore_fanout(workers=2, spawn)"] = (
            reconstruct(fanned, lib=lib), time.perf_counter() - t0)
        serial = restore_fanout(lib, workers=1)
    check(fanned == serial, "the spawned fanout differs from a serial "
                            "restore")
    out["simpoint"] = {"steps": SIMPOINT_STEPS, "window": SIMPOINT_WINDOW,
                       "representatives": plan.representatives,
                       "weights": plan.weights, "runs": {}}
    for name, (total, host) in runs.items():
        err = abs(total - full.makespan_s) / full.makespan_s
        out["simpoint"]["runs"][name] = dict(total_s=total, rel_err=err,
                                             host_s=host)
        print(f"simpoint {name}: {total * 1e3:.3f} ms over "
              f"{SIMPOINT_STEPS} steps (train and evaluation), relative "
              f"error {err:.3e}, "
              f"{host:.3f} s on the host [{card}]")
        check(err <= SAMPLED_BOUND, f"simpoint {name}: relative error "
                                    f"{err} over {SAMPLED_BOUND}")
    return out


def _param_specs(prog):
    """The params of a prefill program's inputs, or of a train state's."""
    first = prog.input_specs[0]
    return first.get("params", first)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build and time the kernels")
    ap.add_argument("--path-times", action="store_true",
                    help="only time stablelm's and olmoe's serving paths")
    ap.add_argument("--decode-ab", type=Path, metavar="PARENT_SRC",
                    help="only time the plain decode step of --src against "
                         "that of the tree at PARENT_SRC, in one process")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the tree to import repro_torch from")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.kernel_times or args.path_times or args.decode_ab:
        card = card_line()
        print(f"card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        import numpy as np
        with torch.no_grad():
            if args.decode_ab:
                decode_ab(torch, np, card, src, args.decode_ab.resolve(),
                          args.seed)
            else:
                (kernel_times if args.kernel_times else path_times)(
                    torch, np, card, src, args.seed)
        print(card)
        return 0
    import gc
    import shutil

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.moe_mlp import kernel as moe_kernel
    from repro_torch.kernels.moe_mlp import ops as moe_ops
    from repro_torch.kernels.quantize import kernel as q_kernel
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize.ref import quantize_plain
    from repro_torch.kernels.rwkv6_wkv import kernel as w_kernel
    from repro_torch.kernels.rwkv6_wkv import ops as w_ops
    from repro_torch.models import build_model
    from repro_torch.models import layers, moe
    from repro_torch.models import rwkv as rw

    # 1. card
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 2. build: one nvcc per source, all started together
    phase_build(build, (kernel, moe_kernel, q_kernel, w_kernel))

    # 3. each kernel against its plain version
    phase_sweep(torch, ops)
    shard_rows = phase_shard_rows(torch, ops)
    t_shard = phase_shard_timing(torch, ops, card)
    phase_moe_sweep(torch, moe_ops)
    t_large_f = phase_moe_large_f(torch, moe_ops, card)
    t_d_ff = phase_moe_d_ff_slices(torch, moe_ops, card)
    phase_quantize_sweep(torch, q_ops, quantize_plain)
    phase_wkv_sweep(torch, w_ops)
    counters = {"flash_attention": ops.flash_attention,
                "moe_mlp": moe_ops.expert_mlp, "quantize": q_ops.quantize,
                "wkv6": w_ops.wkv6}

    # 4. full width, kernel path against plain path
    cfg = get_config(ARCH)
    model = build_model(cfg)                       # bf16 compute
    t0 = time.perf_counter()
    params = model.load(model.init(args.seed, "cuda"), "cuda")
    torch.cuda.synchronize()
    print(f"model: {ARCH} params drawn and cast to bf16 in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params")
    phase_model(torch, np, cfg, model, params, args.seed,
                [(layers, "flash_attention", ops.flash_attention_plain)],
                LOGIT_RTOL)

    # 5. serve: the main path, launches counted around it alone
    dense_launches, lens, dense_dec = phase_serve(
        torch, np, cfg, model, params, counters, args.seed, card)
    served = {ARCH: {"lens": lens, "decode_ms": dense_dec}}

    # 6. times at the main path's shape, then at each served length
    t = phase_timing(torch, ops, MAIN_SHAPE)
    phase_lengths(torch, ops, lens, cfg.n_layers, card)

    # 7. where a served request's time goes on the device
    phase_profile(torch, np, cfg, model, params, args.seed, card)
    # 16 (native half): the prefill step under NativeBackend
    native = {f"{ARCH} prefill": phase_fidelity_native(torch, model, params,
                                                        args.seed, card)}

    # 8. olmoe-1b-7b: stablelm's parameters freed first
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = get_config(MOE_ARCH)
    mmodel = build_model(mcfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mparams = mmodel.load(mmodel.init(args.seed, "cuda"), "cuda")
    torch.cuda.synchronize()
    print(f"model: {MOE_ARCH} params drawn and cast to bf16 in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(t.numel() for t in _leaves(mparams)) / 1e9:.3f} B params, "
          f"peak device memory of the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_model(torch, np, mcfg, mmodel, mparams, args.seed,
                [(moe, "expert_mlp", moe_ops.expert_mlp_plain)],
                MOE_LOGIT_RTOL)
    moe_launches, moe_lens, moe_dec = phase_serve(
        torch, np, mcfg, mmodel, mparams, counters, args.seed, card)
    served[MOE_ARCH] = {"lens": moe_lens, "decode_ms": moe_dec}
    t_olmoe = phase_timing(torch, ops, MOE_ATTN_SHAPE)
    tm = phase_moe_timing(torch, moe_ops, MOE_PREFILL, "prefill", card)
    td = phase_moe_timing(torch, moe_ops, MOE_DECODE, "decode", card)
    phase_moe_waves(torch, moe_ops, card)
    phase_profile(torch, np, mcfg, mmodel, mparams, args.seed, card)
    native[f"{MOE_ARCH} prefill"] = phase_fidelity_native(
        torch, mmodel, mparams, args.seed, card)

    # 9-12. training stablelm-1.6b: olmoe's parameters freed first
    del mparams, mmodel
    gc.collect()
    torch.cuda.empty_cache()
    model, opts, state, step, pipe, train_launches, step_ms = phase_train(
        torch, cfg, counters, args.seed, card)
    from repro_torch.train import batch_to
    extra = [batch_to(pipe.batch(TRAIN_STEPS + 1 + i), "cuda")
             for i in range(TRAIN_PROFILE_STEPS + 1)]
    rows = phase_grads(torch, model, opts, state, extra[0], step_ms, q_ops,
                       quantize_plain, card)
    tq = phase_qtiming(torch, q_ops, quantize_plain, rows, card)
    del rows
    phase_train_profile(torch, step, state, extra[1:], card)

    # 13. olmoe-1b-7b's train mode, stablelm's train state freed first
    del state, step, model, extra
    gc.collect()
    torch.cuda.empty_cache()
    moe_train_launches = phase_moe_train(torch, counters, args.seed, card)

    # 14. rwkv6-7b served, everything before freed
    gc.collect()
    torch.cuda.empty_cache()
    rcfg = get_config(RWKV_ARCH)
    rmodel = build_model(rcfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rparams = rmodel.init(args.seed, "cuda")
    perturb_rwkv(torch, rparams, args.seed)
    rparams = rmodel.load(rparams, "cuda")
    torch.cuda.synchronize()
    print(f"model: {RWKV_ARCH} params drawn, perturbed and cast to bf16 in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(t.numel() for t in _leaves(rparams)) / 1e9:.3f} B params, "
          f"peak device memory of the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def chunked(r, k, v, lw, u, state0=None, chunk=RWKV_CHUNK):
        return rw.wkv6_chunked_plain(r, k, v, lw, u, state0, chunk)
    phase_model(torch, np, rcfg, rmodel, rparams, args.seed,
                [(rw, "wkv6_state", chunked)], RWKV_LOGIT_RTOL)
    phase_rwkv_handoff(torch, np, rcfg, rmodel, rparams, args.seed, w_ops,
                       card)
    rwkv_launches, rlens, _ = phase_serve(torch, np, rcfg, rmodel, rparams,
                                          counters, args.seed, card)
    tw = phase_wkv_timing(torch, w_ops, rw, card)
    phase_wkv_lengths(torch, w_ops, rlens, rcfg.n_layers, card)
    phase_profile(torch, np, rcfg, rmodel, rparams, args.seed, card)

    # 15. rwkv6-7b's train mode, its serving parameters freed first
    del rparams, rmodel
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_train_launches = phase_rwkv_train(torch, counters, args.seed, card)

    # 16. fidelity: the dry runs on fake CUDA tensors, host-only
    gc.collect()
    torch.cuda.empty_cache()
    dryruns, dry_reps = phase_fidelity_dryruns(torch, counters, args.seed,
                                               card)
    prefill = f"prefill b={FIDELITY_B} s={FIDELITY_S}"
    train_label = f"{ARCH} train step b={TRAIN_BATCH} s={TRAIN_SEQ} " \
                  "grad_compress"
    desim = phase_fidelity_desim(
        {f"{ARCH} {prefill}": native[f"{ARCH} prefill"],
         f"{MOE_ARCH} {prefill}": native[f"{MOE_ARCH} prefill"],
         train_label: step_ms}, dry_reps, card)
    from repro_torch.core.fidelity import step_trace
    train_trace = step_trace(train_label, dry_reps[train_label][1])
    eval_trace = step_trace(f"{ARCH} {prefill}",
                            dry_reps[f"{ARCH} {prefill}"][1])
    del dry_reps
    print(json.dumps({"fidelity": {
        "native_ms": native, "dryrun": dryruns, "desim": desim,
        "shape": f"b={FIDELITY_B} s={FIDELITY_S}"}}))

    # 17. jamba-v0.1-52b served at one period, everything before freed
    gc.collect()
    torch.cuda.empty_cache()
    jcfg, jamba_launches, t_jamba, td_jamba, scan = phase_jamba(
        torch, np, counters, args.seed, card)

    # 18. qwen2-vl-7b served at full width, everything before freed
    gc.collect()
    torch.cuda.empty_cache()
    vlm_launches, t_vlm = phase_qwen2_vl(torch, np, counters, args.seed,
                                         card)

    # 19. whisper-small served at full width, everything before freed
    gc.collect()
    torch.cuda.empty_cache()
    whisper_launches, t_whisper = phase_whisper(torch, np, counters,
                                                args.seed, card)

    # 20. the Trainer loop, whisper freed; 21. the mesh, whose restore
    # reads phase 20's final checkpoint
    gc.collect()
    torch.cuda.empty_cache()
    try:
        trainer_launches, trainer = phase_trainer(torch, counters,
                                                  args.seed, card)
        print(json.dumps({"trainer": trainer}))
        gc.collect()
        torch.cuda.empty_cache()
        mesh_launches, mesh = phase_mesh(torch, np, counters, args.seed,
                                         card, ROOT / TRAINER_CKPT_DIR
                                         / "ckpt")
    finally:
        shutil.rmtree(ROOT / TRAINER_CKPT_DIR, ignore_errors=True)
    print(json.dumps({"mesh": mesh}))

    # 22. the production-mesh dry run, after phase 21's group is gone
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_launches, dryrun = phase_dryrun(torch, counters, args.seed, card)
    print(json.dumps({"dryrun": dryrun}))

    # 23. serving and sampled simulation on the card's model
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"serving_sim": phase_serving_sim(
        torch, counters, served, train_trace, eval_trace, card)}))

    by_path = {ARCH: dense_launches, MOE_ARCH: moe_launches,
               f"{ARCH} train": train_launches,
               f"{MOE_ARCH} train ({MOE_TRAIN_LAYERS} layers)":
                   moe_train_launches,
               RWKV_ARCH: rwkv_launches,
               f"{RWKV_ARCH} train ({RWKV_TRAIN_LAYERS} layers)":
                   rwkv_train_launches,
               f"{JAMBA_ARCH} ({jcfg.n_layers} layers)": jamba_launches,
               VLM_ARCH: vlm_launches, WHISPER_ARCH: whisper_launches,
               f"{ARCH} trainer ({TRAINER_LAYERS} layers)":
                   trainer_launches, **mesh_launches, **dryrun_launches}
    rows = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:37",
         "launches": sum(v["flash_attention"] for v in by_path.values()),
         "launches_by_path": {a: v["flash_attention"]
                              for a, v in by_path.items()}, **t,
         "shape": "b={b} s={s} h={h} d={d} bf16 (stablelm-1.6b prefill)"
                  .format(**MAIN_SHAPE),
         "olmoe": {**t_olmoe,
                   "shape": "b={b} s={s} h={h} d={d} bf16 (olmoe-1b-7b "
                            "prefill)".format(**MOE_ATTN_SHAPE)},
         "jamba": {**t_jamba,
                   "shape": "b={b} s={s} h={h} kvh={kvh} d={d} bf16 "
                            "(jamba-v0.1-52b prefill)"
                            .format(**JAMBA_ATTN_SHAPE)},
         "qwen2_vl": {**t_vlm,
                      "shape": "b={b} s={s} h={h} kvh={kvh} d={d} bf16 "
                               "(qwen2-vl-7b prefill)"
                               .format(**VLM_ATTN_SHAPE)},
         "q_offset": {"shard_rows": shard_rows, "qwen2_vl_cp_shard": t_shard},
         "whisper": {
             part: {**t_whisper[part],
                    "shape": "b={b} s={s} s_kv={kv} h={h} d={d} bf16 not "
                             "causal (whisper-small {part})".format(
                                 kv=shape.get("s_kv", shape["s"]),
                                 part=part, **shape)}
             for part, shape in (("encoder", WHISPER_ENC_SHAPE),
                                 ("cross", WHISPER_CROSS_SHAPE))}},
        {"name": "moe_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/moe_mlp/csrc/moe_mlp.cu",
         "replaces": "src/repro/kernels/moe_mlp/kernel.py:31",
         "launches": sum(v["moe_mlp"] for v in by_path.values()),
         "launches_by_path": {a: v["moe_mlp"] for a, v in by_path.items()},
         **tm, "shape": _moe_shape(MOE_PREFILL) + " (prefill)",
         "decode": {**td, "shape": _moe_shape(MOE_DECODE)},
         "large_d_ff": t_large_f, "d_ff_slice": t_d_ff,
         "jamba_decode": {**td_jamba,
                          "shape": _moe_shape(JAMBA_MOE_DECODE)
                          + " (jamba-v0.1-52b decode)"}},
        {"name": "quantize", "route": "cuda",
         "source": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
         "replaces": "src/repro/kernels/quantize/kernel.py:19",
         "launches": sum(v["quantize"] for v in by_path.values()),
         "launches_by_path": {a: v["quantize"] for a, v in by_path.items()},
         **tq},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:37",
         "launches": rwkv_launches["wkv6"],
         "launches_by_path": {a: v["wkv6"] for a, v in by_path.items()},
         **tw},
    ]
    print(json.dumps({"kernels": rows, "mamba_scan": scan}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_jamba(torch, np, counters, seed: int, card: str):
    """Phase 17: jamba-v0.1-52b at full width cut to JAMBA_PERIODS periods,
    drawn in f32 and cast to bf16 leaf by leaf; phases 4 (both kernels'
    wrappers swapped for their plain versions), the handoff, 5, the
    kernels at its shapes, the plain scan's memory, and 7 with the scan's
    device time.  Returns (its config, launches of the serve run, flash
    and moe_mlp decode times, the scan's peak and time)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.moe_mlp import ops as moe_ops
    from repro_torch.models import build_model, layers, mamba, moe
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_PERIODS * full.attn_every)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, "cuda")
    torch.cuda.synchronize()
    f32_peak = torch.cuda.max_memory_allocated()
    _cast_leaf_by_leaf(torch, params, torch.bfloat16)
    params = model.load(params, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {JAMBA_ARCH} at {cfg.n_layers} of {full.n_layers} layers "
          f"drawn in f32 and cast to bf16 leaf by leaf in "
          f"{time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B params "
          f"(ArchConfig.param_counts: "
          f"{cfg.param_counts()['total'] / 1e9:.3f} B), peak device memory "
          f"of the f32 draw {f32_peak / 2**30:.2f} GiB, of the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, bf16 params "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    phase_model(torch, np, cfg, model, params, seed,
                [(layers, "flash_attention", ops.flash_attention_plain),
                 (moe, "expert_mlp", moe_ops.expert_mlp_plain)],
                JAMBA_LOGIT_RTOL)
    phase_jamba_handoff(torch, np, cfg, params, seed, counters, card)
    launches, _, _ = phase_serve(torch, np, cfg, model, params, counters,
                                 seed, card)
    t_flash = phase_timing(torch, ops, JAMBA_ATTN_SHAPE)
    t_decode = phase_moe_timing(torch, moe_ops, JAMBA_MOE_DECODE,
                                f"{JAMBA_ARCH} decode", card)
    scan = phase_mamba_scan(torch, cfg, params, card)
    phase_profile(torch, np, cfg, model, params, seed, card,
                  scopes=[("mamba_scan", mamba, "selective_scan_chunked")])
    return cfg, launches, t_flash, t_decode, scan


def phase_qwen2_vl(torch, np, counters, seed: int, card: str):
    """Phase 18: qwen2-vl-7b at full width, all 28 layers, drawn in f32
    and cast to bf16 leaf by leaf; phase 4 (the plain flash in the
    kernel's place) on 256 vision and 1792 text tokens, phase 5 (exactly
    28 flash launches a request, none in a decode step), flash at its
    attention shape (GQA 28/4, d=128) against SDPA, and phase 7.  Returns
    (launches of the serve run, flash times)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model, layers
    cfg = get_config(VLM_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, "cuda")
    torch.cuda.synchronize()
    f32_peak = torch.cuda.max_memory_allocated()
    _cast_leaf_by_leaf(torch, params, torch.bfloat16)
    params = model.load(params, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {VLM_ARCH} drawn in f32 and cast to bf16 leaf by leaf in "
          f"{time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B params "
          f"(ArchConfig.param_counts: "
          f"{cfg.param_counts()['total'] / 1e9:.3f} B), peak device memory "
          f"of the f32 draw {f32_peak / 2**30:.2f} GiB, of the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, bf16 params "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    phase_model(torch, np, cfg, model, params, seed,
                [(layers, "flash_attention", ops.flash_attention_plain)],
                VLM_LOGIT_RTOL)
    launches, _, _ = phase_serve(torch, np, cfg, model, params, counters,
                                 seed, card)
    t_flash = phase_timing(torch, ops, VLM_ATTN_SHAPE)
    t_flash["prefix"] = phase_prefix_timing(torch, ops, cfg.n_vis, card)
    phase_profile(torch, np, cfg, model, params, seed, card)
    return launches, t_flash


def phase_whisper(torch, np, counters, seed: int, card: str):
    """Phase 19: whisper-small at full width and depth (12 encoder and 12
    decoder layers) in bf16; phase 4 on a WHISPER_PROMPT-token prompt and
    1500 frames (the plain flash in the kernel's place: encoder, self and
    cross attention), phase 5 at its 448-token capacity with every
    request's frames drawn from the seed (exactly 36 flash launches a
    request, none in a decode step), flash against SDPA at the encoder's
    shape (not causal, 1500 x 1500) and at cross attention's (not
    causal, WHISPER_PROMPT x 1500), and phase 7.  Returns (launches of
    the serve run, flash times at the two shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model, layers
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.load(model.init(seed, "cuda"), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {WHISPER_ARCH} drawn and cast to bf16 in "
          f"{time.perf_counter() - t0:.1f} s, {n_params / 1e6:.2f} M params "
          f"(ArchConfig.param_counts: "
          f"{cfg.param_counts()['total'] / 1e6:.2f} M: it leaves out cross "
          f"attention, the learned positions and the norms), peak device "
          f"memory of the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, bf16 params "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB [{card}]")
    phase_model(torch, np, cfg, model, params, seed,
                [(layers, "flash_attention", ops.flash_attention_plain)],
                WHISPER_LOGIT_RTOL, prompt_len=WHISPER_PROMPT)
    launches, _, _ = phase_serve(torch, np, cfg, model, params, counters,
                                 seed, card, WHISPER_LENS, WHISPER_CAP)
    times = {"encoder": phase_timing(torch, ops, WHISPER_ENC_SHAPE),
             "cross": phase_timing(torch, ops, WHISPER_CROSS_SHAPE)}
    phase_profile(torch, np, cfg, model, params, seed, card,
                  lens_range=WHISPER_LENS, cap=WHISPER_CAP)
    return launches, times


def phase_trainer(torch, counters, seed: int, card: str):
    """Phase 20: stablelm-1.6b at full width cut to TRAINER_LAYERS, trained
    by ``repro_torch.train.Trainer`` with async checkpoints every
    TRAINER_EVERY steps (keep_n=1) and a SimulatedFailure at step
    TRAINER_FAIL_AT; see the module docstring for what it checks.
    Returns (launches of the Trainer's run, the checkpoint's numbers)."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.common import (TensorSpec, leaves,
                                           leaves_with_path, map_leaves)
    from repro_torch.train import SimulatedFailure, Trainer
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAINER_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model, opts, state, step, pipe = _train_setup(torch, cfg, seed)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    n_leaves = len(list(leaves(state["params"])))
    nbytes = sum(x.numel() * x.element_size() for x in leaves(state))
    root = ROOT / TRAINER_CKPT_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        free = shutil.disk_usage(root).free
        print(f"trainer: {cfg.name} at {TRAINER_LAYERS} of 24 layers, "
              f"{n_params / 1e6:.2f} M params; a checkpoint (f32 params, "
              f"m, v, error buffer, counters) is {nbytes} bytes "
              f"({nbytes / 1e9:.3f} GB); {free / 1e9:.1f} GB free under "
              f"{root}")
        check(free >= 3 * nbytes,
              f"{free} bytes free under {root}: under three checkpoints "
              f"of {nbytes}")
        tr = Trainer(model=model, train_step=step, pipeline=pipe,
                     state=state, ckpt_interval=TRAINER_EVERY,
                     heartbeat_path=str(root / "heartbeat.json"))
        tr.ckpt = CheckpointManager(str(root / "ckpt"), keep_n=1)
        tr.instantiate()
        del state
        for wrapper in counters.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        res = tr.run(TRAINER_STEPS,
                     fail_at={TRAINER_FAIL_AT: SimulatedFailure("injected")})
        run_s = time.perf_counter() - t0
        launches = {n: w.launches for n, w in counters.items()}
        hist = res["history"]
        for h in hist:
            print(f"trainer step {h['step']}: loss {h['loss']!r} "
                  f"{h['time_s'] * 1e3:.1f} ms")
        print(tr.stats.dump_text())
        steps = [h["step"] for h in hist]
        check(int(tr.s_failures.value()) == 1,
              f"{tr.s_failures.value()} failures recovered, want 1")
        check(res["final_step"] == TRAINER_STEPS,
              f"final step {res['final_step']}, want {TRAINER_STEPS}")
        replay = TRAINER_FAIL_AT - 1
        check(steps.count(replay) == 2, f"steps run {steps}: step {replay} "
                                        f"not replayed once")
        first, again = (h["loss"] for h in hist if h["step"] == replay)
        print(f"trainer: step {replay} loss {first!r} in its first run, "
              f"{again!r} replayed from the step-{replay} checkpoint")
        check(first == again, f"the replayed step {replay}'s loss "
                              f"{again!r} differs from its first run's "
                              f"{first!r}")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"losses {[h['loss'] for h in hist]}")
        check(hist[-1]["loss"] < hist[0]["loss"],
              f"loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss']}")
        want = {"flash_attention": 0, "moe_mlp": 0, "wkv6": 0,
                "quantize": n_leaves * len(hist)}
        for n, got in launches.items():
            check(got == want[n], f"{n} launched {got} times in the "
                                  f"Trainer's run, want {want[n]}")
        check(tr.heartbeat.alive(max_age=600), "the heartbeat is stale")
        check(tr.ckpt.available_steps() == [TRAINER_STEPS],
              f"checkpoints {tr.ckpt.available_steps()} after keep_n=1")
        saves = tr.ckpt.saves
        fg_ms = tr.ckpt.snapshot_seconds / saves * 1e3
        write_s = tr.ckpt.save_seconds / saves
        # the final checkpoint into a fresh target of specs on the card
        target = map_leaves(lambda x: TensorSpec(
            tuple(x.shape), x.dtype, x.requires_grad), tr.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = tr.ckpt.restore(target, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for (key, a), b in zip(leaves_with_path(restored),
                               leaves(tr.state)):
            check(a.device.type == "cuda" and a.dtype == b.dtype
                  and a.requires_grad == b.requires_grad
                  and _same_bits(torch, a.detach(), b.detach()),
                  f"{key}: the restored final checkpoint differs from the "
                  f"trainer's final state")
        del restored
    except BaseException:
        # on success the checkpoints stay for phase 21; main removes them
        shutil.rmtree(root, ignore_errors=True)
        raise
    phase_s = time.perf_counter() - t_phase
    out = {"arch": f"{cfg.name} ({TRAINER_LAYERS} layers)",
           "params": n_params, "ckpt_bytes": nbytes, "saves": saves,
           "steps_run": steps, "replayed_loss": [first, again],
           "save_foreground_ms": fg_ms, "write_s": write_s,
           "write_gb_s": nbytes / write_s / 1e9, "restore_s": restore_s,
           "restore_gb_s": nbytes / restore_s / 1e9, "run_s": run_s,
           "phase_s": phase_s, "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "card": card}
    print(f"trainer: {saves} saves of {nbytes / 1e9:.3f} GB: foreground "
          f"(copy to host) {fg_ms:.1f} ms a save, background write "
          f"{write_s:.2f} s a save = {out['write_gb_s']:.3f} GB/s; restore "
          f"into specs on the card {restore_s:.2f} s = "
          f"{out['restore_gb_s']:.3f} GB/s; the final checkpoint restored "
          f"bit for bit; run {run_s:.1f} s, phase {phase_s:.1f} s; launches "
          f"{launches}; peak device memory {out['peak_gib']:.2f} GiB "
          f"[{card}]")
    return launches, out


def phase_mesh(torch, np, counters, seed: int, card: str, ckpt_dir: Path):
    """Phase 21: the sharded paths on a (1, 1) mesh of the card, each held
    bit for bit against the same steps on plain tensors; see the module
    docstring.  Returns (launches by path, the phase's numbers)."""
    import gc
    import torch.distributed as dist
    from repro_torch.launch.mesh import describe, make_mesh
    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        out = {"mesh": describe(mesh), "card": card}
        launches = {}
        for arch in (ARCH, MOE_ARCH):
            launches[f"{arch} mesh"], out[arch] = _mesh_serve(
                torch, np, counters, arch, seed, mesh, card)
            gc.collect()
            torch.cuda.empty_cache()
        launches[f"{ARCH} mesh train ({MESH_TRAIN_LAYERS} layers)"], \
            out["train"] = _mesh_train(torch, counters, seed, mesh, card)
        gc.collect()
        torch.cuda.empty_cache()
        out["restore"] = _mesh_restore(torch, mesh, ckpt_dir, card)
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh: phase {out['phase_s']:.1f} s [{card}]")
    return launches, out


def _mesh_serve(torch, np, counters, arch: str, seed: int, mesh, card: str):
    """``arch`` at full width served on ``mesh`` through the serving steps
    with a ``MeshSharder``, against the same steps on plain tensors: the
    prefill's and every decode step's logits bit for bit, the launches of
    the sharded prefill and decode steps, and the host ms of both paths
    in turns (plain, sharded, sharded, plain)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import MeshSharder, make_rules
    from repro_torch.models import build_model
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from torch.distributed.tensor import DTensor
    cfg = get_config(arch)
    model = build_model(cfg)
    cap = MESH_SEQ + MESH_DECODE_STEPS
    params = model.load(model.init(seed, "cuda"), "cuda")
    sh = MeshSharder(mesh, make_rules(
        cfg, ShapeConfig("mesh", cap, 1, "prefill"), mesh))
    dparams = sh.distribute(params, sh.param_shardings(model.param_specs()[1]))
    check(all(isinstance(p, DTensor) for p in _leaves(dparams)),
          f"{arch}: a param is not a DTensor on the mesh")
    rng = np.random.default_rng(seed + 21)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, MESH_SEQ)),
                             device="cuda")
    paths = {"plain": (build_prefill_step(model, seq_capacity=cap),
                       build_decode_step(model), params),
             "sharded": (build_prefill_step(model, sh, seq_capacity=cap),
                         build_decode_step(model, sh), dparams)}

    def run(name, feed=None):
        prefill, decode, p = paths[name]
        for w in counters.values():
            w.launches = 0
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(p, {"tokens": tokens})
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            pre = {n: w.launches for n, w in counters.items()}
            for w in counters.values():
                w.launches = 0
            outs, fed = [logits], []
            nxt = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
            t0 = time.perf_counter()
            for i in range(MESH_DECODE_STEPS):
                tok = feed[i] if feed is not None else nxt
                nxt, logits, cache = decode(p, {"tokens": tok, "cache": cache,
                                                "cur_len": MESH_SEQ + i})
                outs.append(logits)
                fed.append(tok)
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS
        dec = {n: w.launches for n, w in counters.items()}
        return outs, fed, pre, dec, pre_ms, dec_ms

    want, fed, _, _, p1, d1 = run("plain")
    got, _, pre, dec, s1, e1 = run("sharded", fed)
    for i, (g, w) in enumerate(zip(got, want)):
        check(isinstance(g, DTensor), f"{arch}: step {i}'s logits are not "
                                      f"a DTensor")
        check(_same_bits(torch, g.full_tensor(), w),
              f"{arch}: the sharded {'prefill' if i == 0 else 'decode'} "
              f"step {i}'s logits differ from the plain path's")
    n_attn = flash_per_prefill(cfg)
    n_moe = cfg.n_layers if cfg.n_experts else 0
    want_pre = {"flash_attention": n_attn, "moe_mlp": n_moe, "quantize": 0,
                "wkv6": 0}
    want_dec = {"flash_attention": 0, "moe_mlp": n_moe * MESH_DECODE_STEPS,
                "quantize": 0, "wkv6": 0}
    for n in counters:
        check(pre[n] == want_pre[n], f"{arch}: {n} launched {pre[n]} times "
                                     f"in the sharded prefill, want "
                                     f"{want_pre[n]}")
        check(dec[n] == want_dec[n], f"{arch}: {n} launched {dec[n]} times "
                                     f"in {MESH_DECODE_STEPS} sharded decode "
                                     f"steps, want {want_dec[n]}")
    *_, s2, e2 = run("sharded", fed)
    *_, p2, d2 = run("plain", fed)
    res = {"prefill_ms": {"plain": [p1, p2], "sharded": [s1, s2]},
           "decode_step_ms": {"plain": [d1, d2], "sharded": [e1, e2]},
           "launches": {"prefill": pre, "decode": dec},
           "bit_for_bit_steps": len(got)}
    print(f"mesh: {arch} at full width on the (1, 1) mesh: prefill (s="
          f"{MESH_SEQ}) and {MESH_DECODE_STEPS} decode steps bit for bit "
          f"against plain tensors; launches prefill {pre}, decode {dec}; "
          f"host ms in turns (plain, sharded, sharded, plain): prefill "
          f"{p1:.1f}, {s1:.1f}, {s2:.1f}, {p2:.1f}; decode step {d1:.2f}, "
          f"{e1:.2f}, {e2:.2f}, {d2:.2f} [{card}]")
    del params, dparams, paths
    return {n: pre[n] + dec[n] for n in counters}, res


def _mesh_train(torch, counters, seed: int, mesh, card: str):
    """stablelm-1.6b at MESH_TRAIN_LAYERS layers: MESH_TRAIN_STEPS steps on
    plain state, then the same steps on DTensor state with the sharder
    and the params' axes; the losses bit for bit, 15 quantize launches a
    sharded step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import MeshSharder, make_rules
    from repro_torch.train import (batch_to, build_train_step,
                                   init_train_state, train_state_specs)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=MESH_TRAIN_LAYERS)
    model, opts, state, step, pipe = _train_setup(torch, cfg, seed)
    batches = [batch_to(pipe.batch(i), "cuda")
               for i in range(MESH_TRAIN_STEPS)]
    state, hist, _, n_leaves = _run_steps(torch, step, state, batches,
                                          counters)
    del state
    sh = MeshSharder(mesh, make_rules(
        cfg, ShapeConfig("mesh_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        mesh))
    _, axes = train_state_specs(model, opts)
    dstate = sh.distribute(init_train_state(model, seed, opts, "cuda"),
                           sh.param_shardings(axes))
    dstep = build_train_step(model, opts, sh, axes["params"])
    dbatches = [sh.distribute(b, sh.batch_shardings(b)) for b in batches]
    for w in counters.values():
        w.launches = 0
    losses, ms = [], []
    for b in dbatches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dstate, m = dstep(dstate, b)
        losses.append(float(m["loss"].full_tensor()))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: w.launches for n, w in counters.items()}
    want = [h["loss"] for h in hist]
    check(losses == want, f"sharded train losses {losses}, plain {want}")
    want_l = {"flash_attention": 0, "moe_mlp": 0, "wkv6": 0,
              "quantize": n_leaves * MESH_TRAIN_STEPS}
    for n, got in launches.items():
        check(got == want_l[n], f"{n} launched {got} times in the sharded "
                                f"train steps, want {want_l[n]}")
    res = {"arch": f"{cfg.name} ({MESH_TRAIN_LAYERS} layers)",
           "losses": losses, "launches": launches,
           "step_ms": {"plain": [h["s"] * 1e3 for h in hist],
                       "sharded": ms}}
    print(f"mesh: {res['arch']} {MESH_TRAIN_STEPS} train steps on DTensor "
          f"state, losses {losses} bit for bit against plain; launches "
          f"{launches}; step ms plain {res['step_ms']['plain']}, sharded "
          f"{ms} [{card}]")
    del dstate, dbatches, batches
    return launches, res


def _mesh_restore(torch, mesh, ckpt_dir: Path, card: str):
    """Phase 20's final checkpoint restored onto ``mesh`` with shardings,
    leaf by leaf bit for bit against the plain restore."""
    import dataclasses
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import MeshSharder, make_rules
    from repro_torch.models import build_model
    from repro_torch.models.common import leaves, leaves_with_path
    from repro_torch.train import TrainOptions, train_state_specs
    from torch.distributed.tensor import DTensor
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAINER_LAYERS)
    model = build_model(cfg)
    specs, axes = train_state_specs(model, TrainOptions(grad_compress=True))
    sh = MeshSharder(mesh, make_rules(
        cfg, ShapeConfig("mesh_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        mesh))
    mgr = CheckpointManager(str(ckpt_dir))
    step = mgr.latest_step()
    want = mgr.restore(specs, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = mgr.restore(specs, shardings=sh.param_shardings(axes))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    nbytes = 0
    for (key, a), b in zip(leaves_with_path(got), leaves(want)):
        check(isinstance(a, DTensor) and a.device.type == "cuda"
              and a.requires_grad == b.requires_grad
              and _same_bits(torch, a.detach().full_tensor(), b.detach()),
              f"{key}: the checkpoint restored onto the mesh differs from "
              f"its plain restore")
        nbytes += b.numel() * b.element_size()
    res = {"step": step, "bytes": nbytes, "restore_s": restore_s,
           "restore_gb_s": nbytes / restore_s / 1e9}
    print(f"mesh: phase 20's checkpoint (step {step}, {nbytes / 1e9:.3f} "
          f"GB) restored onto the mesh bit for bit in {restore_s:.2f} s = "
          f"{res['restore_gb_s']:.3f} GB/s [{card}]")
    return res


def phase_prefix_timing(torch, ops, prefix: int, card: str) -> dict:
    """The kernel as the VLM prefill runs it, with the vision prefix, at
    VLM_ATTN_SHAPE, held against its plain version; its ms, the plain
    version's, the bound of its ``cost`` (the prefix adds prefix^2 / 2
    visible pairs) and scaled_dot_product_attention with the same mask
    as an explicit boolean ``attn_mask`` and ``enable_gqa``.  Also times
    the design the kernel's ``prefix`` spares: a causal launch, then a
    non-causal one over the prefix written into its rows."""
    import torch.nn.functional as F
    b, s, h, kvh, d = (VLM_ATTN_SHAPE[k] for k in ("b", "s", "h", "kvh", "d"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s, kvh, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    want = ops.flash_attention_plain(q, k, v, prefix=prefix).float()
    lim = TOL["bfloat16"] * (1 + want.abs())
    diff = (ops.flash_attention(q, k, v, prefix=prefix).float() - want).abs()
    err = float(diff.max())
    check(bool((diff <= lim).all()), f"prefix kernel error {err}")

    def two_launches():
        o = ops.flash_attention(q, k, v)
        o[:, :prefix] = ops.flash_attention(
            q[:, :prefix], k[:, :prefix], v[:, :prefix], causal=False)
        return o
    check(bool(((two_launches().float() - want).abs() <= lim).all()),
          "causal plus non-causal prefix launches compute another function")
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < prefix)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    check(bool(((sdpa().transpose(1, 2).float() - want).abs() <= lim).all()),
          "scaled_dot_product_attention with the prefix mask computes "
          "another function")
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, prefix=prefix))
    plain_ms = cuda_ms(
        lambda: ops.flash_attention_plain(q, k, v, prefix=prefix))
    lib_ms = cuda_ms(sdpa)
    two_ms = cuda_ms(two_launches)
    flops, nbytes = ops.cost(q.shape, k.shape, q.dtype, prefix=prefix)
    bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"timing b={b} s={s} h={h} kvh={kvh} d={d} bf16 prefix={prefix}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (attn_mask, "
          f"enable_gqa) {lib_ms:.4f} ms, causal + non-causal prefix "
          f"launches {two_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.2f} GFLOP); max_abs_err {err:.3e} [{card}]")
    return dict(prefix=prefix, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                two_launch_ms=two_ms)


def _moe_shape(shape) -> str:
    return "G={} E={} C={} D={} F={} bf16".format(*shape)


def phase_dryrun(torch, counters, seed: int, card: str):
    """Phase 22: the production-mesh dry run (``repro_torch.launch.
    dryrun``) on the card; see the module docstring.  Returns (launches
    by path of the native runs, the phase's numbers)."""
    import gc
    import torch.distributed as dist
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh
    t_phase = time.perf_counter()
    out = {"card": card, "native": {}, "cells": {}}
    launches = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for arch, name, batch in DRYRUN_NATIVE:
            label = f"{arch} {name} b={batch} (1, 1) mesh"
            launches[label], out["native"][label] = _dryrun_native(
                torch, counters, dr, arch, name, batch, mesh, seed, card)
            gc.collect()
            torch.cuda.empty_cache()
        out["loss"] = _dryrun_loss(torch, dr, mesh, seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for multi, cells in DRYRUN_CELLS:
        with dr.fake_process_group(512 if multi else 256,
                                   dr.costed_rank(multi)):
            for arch, name in cells:
                out["cells"][f"{arch} {name} {'multi' if multi else 'single'}"
                             ] = _dryrun_production(torch, dr, arch, name,
                                                    multi, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dryrun: phase {out['phase_s']:.1f} s [{card}]")
    return launches, out


def _measure(torch, rep, run, base: int):
    """``run()`` twice on the card: the first call's result, the dry run
    ``rep``'s predicted peak, the first call's peak of
    ``max_memory_allocated`` above ``base`` (the bytes its arguments
    hold), and the second call's CUDA-event ms."""
    mem = rep.memory
    predicted = (mem["argument_bytes"] + mem["output_bytes"]
                 + mem["temp_bytes"] - mem["alias_bytes"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return out, predicted, peak, start.elapsed_time(end)


def _dryrun_native(torch, counters, dr, arch: str, name: str, batch: int,
                   mesh, seed: int, card: str):
    """One production cell cut to ``batch`` on the (1, 1) mesh: its dry
    run, then the same step on real DTensors of the specs' shapes (params
    drawn from ``seed``, tokens random, a zero cache at its last slot):
    the dry run's kernel ops against the launches, its argument bytes
    against the real arguments', exactly; its peak against
    ``max_memory_allocated`` and its roofline bound against the CUDA-event
    ms, printed."""
    import dataclasses
    from repro_torch.core.fidelity import DryRunBackend
    from repro_torch.dist.sharding import MeshSharder
    from repro_torch.models import build_model
    from repro_torch.models.common import map_leaves
    shape = dataclasses.replace(dr.SHAPES[name], global_batch=batch)
    prog, rules, _ = dr.build_program(arch, name, mesh, device="cuda",
                                      shape=shape)
    rep = DryRunBackend().run(prog)
    roof = dr.roofline_terms(rep, 1)
    mem = rep.memory
    cfg = dr.get_config(arch)
    sh = MeshSharder(mesh, rules)
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def real(spec):
        if spec.shape == () and not spec.dtype.is_floating_point:
            return torch.tensor(shape.seq_len - 1, dtype=spec.dtype,
                                device="cuda")          # cur_len
        if not spec.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, spec.shape,
                                 generator=gen, device="cuda",
                                 dtype=spec.dtype)
        return torch.zeros(spec.shape, dtype=spec.dtype, device="cuda")
    params = sh.distribute(build_model(cfg).init(seed, "cuda"),
                           prog.in_shardings[0])
    batch_t = sh.distribute(map_leaves(real, prog.input_specs[1]),
                            prog.in_shardings[1])
    args = (params, batch_t)
    arg_bytes = float(sum(t.to_local().numel() * t.element_size()
                          for t in _leaves(args)))
    for w in counters.values():
        w.launches = 0

    def run():
        with torch.no_grad():
            prog.fn(*args)
        return {n: w.launches for n, w in counters.items()}
    launched, predicted, peak, ms = _measure(torch, rep, run, base)
    want = {n: rep.detail["kernels"].get(OP_OF[n], 0) for n in counters}
    check(launched == want, f"{arch} {name}: launches {launched}, the dry "
                            f"run's kernel ops {rep.detail['kernels']}")
    check(arg_bytes == mem["argument_bytes"],
          f"{arch} {name}: real arguments {arg_bytes} bytes, the dry run's "
          f"{mem['argument_bytes']}")
    _check_peak(f"{arch} {name}", predicted, peak)
    res = {"reduced": f"global batch {dr.SHAPES[name].global_batch} -> "
                      f"{batch}, the (1, 1) mesh",
           "kernel_ops": rep.detail["kernels"], "launches": launched,
           "argument_bytes": arg_bytes, "predicted_peak_bytes": predicted,
           "measured_peak_bytes": float(peak),
           "peak_ratio": predicted / peak, "peak_bound": DRYRUN_PEAK_BOUND,
           "bound_s": roof["bound_s"], "dominant": roof["dominant"],
           "measured_ms": ms, "bound_over_measured": roof["bound_s"] * 1e3
           / ms, "dryrun_host_s": rep.wall_s}
    print(f"dryrun: {arch} {name} at batch {batch} on the (1, 1) mesh: "
          f"kernel ops {rep.detail['kernels']} = launches; argument bytes "
          f"{arg_bytes / 1e9:.3f} GB exact; predicted peak "
          f"{predicted / 2**30:.2f} GiB over max_memory_allocated "
          f"{peak / 2**30:.2f} GiB = {res['peak_ratio']:.4f} (bound "
          f"{DRYRUN_PEAK_BOUND}); roofline {roof['dominant']} bound "
          f"{roof['bound_s'] * 1e3:.2f} ms over measured {ms:.2f} ms = "
          f"{res['bound_over_measured']:.4f} [{card}]")
    del args, params, batch_t
    return launched, res


def _check_peak(what: str, predicted: float, peak: float) -> None:
    """The dry run's predicted peak over ``max_memory_allocated`` within
    ``DRYRUN_PEAK_BOUND``."""
    lo, hi = DRYRUN_PEAK_BOUND
    check(lo <= predicted / peak <= hi,
          f"{what}: predicted peak {predicted / 2**30:.2f} GiB over "
          f"max_memory_allocated {peak / 2**30:.2f} GiB is outside "
          f"{DRYRUN_PEAK_BOUND}")


def _dryrun_loss(torch, dr, mesh, seed: int, card: str) -> dict:
    """The train loss (``cross_entropy``) and its gradient on logits of
    ``DRYRUN_LOSS`` split over the "model" dim of the (1, 1) ``mesh``, the
    labels over "data": dry-run, then run on DTensors drawn from
    ``seed``.  The loss and the gradient equal the plain tensors' bit for
    bit (a split of one); the predicted peak over
    ``max_memory_allocated`` and the CUDA-event ms, printed."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core.fidelity import DryRunBackend, StepProgram
    from repro_torch.dist.sharding import NamedSharding
    from repro_torch.models.common import TensorSpec
    from repro_torch.models.layers import cross_entropy, padded_vocab
    arch, b, s = DRYRUN_LOSS
    cfg = dr.get_config(arch)
    vp = padded_vocab(cfg)
    split = NamedSharding(mesh, (Replicate(), Shard(2)))
    rows = NamedSharding(mesh, (Shard(0), Replicate()))

    def step(logits, labels):
        loss = cross_entropy(logits, labels, cfg)
        return loss, torch.autograd.grad(loss, logits)[0]
    rep = DryRunBackend().run(StepProgram(
        f"{arch} loss", step, (TensorSpec((b, s, vp), torch.bfloat16, True),
                               TensorSpec((b, s), torch.int64)),
        device="cuda", mesh=mesh, in_shardings=(split, rows)))
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    logits = distribute_tensor(torch.randn(
        b, s, vp, generator=gen, device="cuda", dtype=torch.bfloat16),
        mesh, split.placements).requires_grad_()
    labels = distribute_tensor(torch.randint(
        0, cfg.vocab_size, (b, s), generator=gen, device="cuda"), mesh,
        rows.placements)
    (loss, grad), predicted, peak, ms = _measure(
        torch, rep, lambda: step(logits, labels), base)
    loss, grad = loss.detach().full_tensor(), grad.full_tensor()
    plain = logits.full_tensor().detach().requires_grad_()
    want, want_g = step(plain, labels.full_tensor())
    want = want.detach()
    check(bool(torch.isfinite(loss)) and torch.equal(loss, want)
          and torch.equal(grad, want_g),
          f"{arch} loss on the vocab-split (1, 1) mesh: {float(loss)} "
          f"against the plain tensors' {float(want)}, gradients equal "
          f"{torch.equal(grad, want_g)}")
    _check_peak(f"{arch} loss", predicted, peak)
    res = {"logits": [b, s, vp], "placements": "(Replicate(), Shard(2))",
           "loss": float(loss), "predicted_peak_bytes": predicted,
           "measured_peak_bytes": float(peak), "peak_ratio": predicted / peak,
           "peak_bound": DRYRUN_PEAK_BOUND, "measured_ms": ms,
           "collectives": rep.detail["collectives"],
           "top_bytes": rep.detail["top_bytes"][:3]}
    print(f"dryrun: {arch} train loss on ({b}, {s}, {vp}) logits split over "
          f"\"model\" of the (1, 1) mesh: loss {float(loss):.4f} and its "
          f"gradient bit for bit against plain tensors; predicted peak "
          f"{predicted / 2**30:.2f} GiB over max_memory_allocated "
          f"{peak / 2**30:.2f} GiB = {res['peak_ratio']:.4f} (bound "
          f"{DRYRUN_PEAK_BOUND}); forward and backward {ms:.2f} ms [{card}]")
    del logits, labels, plain, grad, want_g
    return res


def _dryrun_production(torch, dr, arch: str, name: str, multi: bool,
                       card: str) -> dict:
    """One production cell under the fake process group on fake CUDA
    tensors, costed as the last rank along "model": ``ok``, no kernel
    replicated, no stacked leaf moved whole; where the rules split the
    heads, the per-device flash flops times the ranks that split them
    equal the global flash flops, and where they split the query rows
    ("q_seq"), the costed rank's (the heaviest rows) are at least that
    share."""
    import math
    res = dr.dryrun_cell(arch, name, multi)
    check(res["status"] == "ok", f"dry run {arch} {name}: {res}")
    from types import SimpleNamespace
    cfg, shape = dr.get_config(arch), dr.SHAPES[name]
    axes = res["mesh_desc"]["axes"]
    rules = dr.make_rules(cfg, shape, SimpleNamespace(
        mesh_dim_names=tuple(axes), shape=tuple(axes.values())))
    if shape.kind == "prefill" and cfg.n_heads and cfg.family != "audio":
        # the ranks that split the heads (JAX's head TP) and the batch
        # each hold their share of the global flash flops; where the
        # query rows are split ("q_seq"), the costed rank holds the last
        # rows, which see the most keys
        got = res["kernel_flops"]["flash_attention"]
        want = dr.flash_global_flops(cfg, shape)
        n = dr.flash_split_ranks(cfg, shape, rules)
        if rules.size("q_seq") > 1:
            check(got * n >= want, f"dry run {arch} {name}: flash {got} "
                                   f"flops on the busiest rank x {n} "
                                   f"ranks, under the global {want}")
        else:
            check(math.isclose(got * n, want, rel_tol=1e-9),
                  f"dry run {arch} {name}: flash {got} flops a device x "
                  f"{n} ranks, global {want}")
    check(res["replicated_kernels"] == {},
          f"dry run {arch} {name}: {res['replicated_kernels']}")
    check(res["whole_stacked_moves"] == [],
          f"dry run {arch} {name}: stacked leaves moved whole "
          f"{res['whole_stacked_moves'][:4]}")
    want = {k: {"count": c["count"], "bytes": c["bytes"]}
            for k, c in res["collectives"].items()}
    check(res["trace_collectives"] == want,
          f"dry run {arch} {name}: the desim trace's collective ops "
          f"{res['trace_collectives']}, the dry run's collectives {want}")
    check(shape.kind != "decode" or res["memory"]["alias_bytes"] > 0,
          f"dry run {arch} {name}: the decode step does not return its "
          f"cache argument")
    if shape.kind == "train" and rules.size("vocab") > 1:
        from repro_torch.models.layers import padded_vocab
        whole = [n for _, n in res["top_bytes"]
                 if f", {padded_vocab(cfg)})" in n]
        check(not whole, f"dry run {arch} {name}: ops of the whole vocab "
                         f"on a rank whose logits split it: {whole}")
    mem = res["memory"]
    line = {"arch": arch, "shape": name,
            "mesh": "multi" if multi else "single",
            "per_device_gb": mem["per_device_total"] / 1e9,
            "fits_hbm": res["fits_hbm"],
            "dominant": res["roofline"]["dominant"],
            "bound_s": res["roofline"]["bound_s"],
            "useful_flops_ratio": res["useful_flops_ratio"],
            "collective_bytes": {k: v["bytes"]
                                 for k, v in res["collectives"].items()},
            "kernels": res["kernels"], "trace_s": res["trace_s"],
            "trace_ops": res["trace_ops"],
            "replicated_kernels": res["replicated_kernels"],
            "costed_coordinate": res["costed_coordinate"],
            "flash_flops": res["kernel_flops"].get("flash_attention"),
            "flops_per_device": res["roofline"]["hlo_flops_per_device"],
            "top_bytes": res["top_bytes"][:3], "card": card}
    print(json.dumps({"dryrun_cell": line}))
    return line


def _leaves(tree):
    """The leaves of dicts and plain tuples (a ``TensorSpec`` is a leaf)."""
    if isinstance(tree, dict) or type(tree) is tuple:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _cast_leaf_by_leaf(torch, tree, dtype) -> None:
    """Cast every float leaf of ``tree`` (dicts, and a hybrid arch's tuple
    of them) to ``dtype`` in its dict, one leaf at a time, so that each
    old leaf is freed once its copy exists: the peak is the tree plus one
    leaf, not the tree in both dtypes."""
    if type(tree) is tuple:
        for t in tree:
            _cast_leaf_by_leaf(torch, t, dtype)
        return
    for k, v in tree.items():
        if isinstance(v, dict) or type(v) is tuple:
            _cast_leaf_by_leaf(torch, v, dtype)
        elif v.is_floating_point():
            tree[k] = v.to(dtype)
            del v


if __name__ == "__main__":
    sys.exit(main())
