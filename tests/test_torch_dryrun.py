"""The port's production-mesh dry run (``repro_torch.launch.dryrun``)
against the JAX package's (``repro.launch.dryrun``), on the CPU.

This file imports neither JAX nor ``repro``: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when imported, so the JAX side runs in two subprocesses,
started together when the first test needs them:

* metadata of all 40 cells x both production meshes (512 forced CPU
  devices, no model run: the JAX dry run is stopped where it would build
  its step): status and ``why`` of the skipped cells, the rules, the
  model flops, and the options the dry run picks (accumulation, moment
  dtype, attention chunk);
* a smoke parity: the JAX package's ``dryrun_cell`` on smoke configs at
  small shapes, compiled for a (2, 2) mesh of 4 forced CPU devices, for
  smoke stablelm (heads split), smoke deepseek (GQA: kv heads repeated)
  and smoke olmoe (experts split), one cell of each kind, and smoke
  deepseek's prefill once more under context-parallel rules (the query
  rows over "model", ``rules_override``), smoke stablelm's train step
  under them with its vocab whole, and smoke mixtral's prefill
  and decode with its experts whole, so that "model" splits the expert
  weights' d_ff.  The port runs the same cells on a (2, 2) mesh of
  PyTorch's fake process group.

In this process: collectives on hand-computed cases, flash's DTensor
strategy on a (2, 2) fake-group mesh, the expert-MLP op's d_ff layout,
the ``replicated_kernels`` detector on a layout that replicates, and
real production cells under a 256- and a 512-rank fake process group,
each ``ok`` with local costs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import REGISTRY, SHAPES, get_config, smoke
from repro_torch.configs.base import ShapeConfig, cell_runnable
from repro_torch.core.fidelity import DryRunBackend, StepProgram
from repro_torch.dist.sharding import NamedSharding, make_rules
from repro_torch.kernels.flash_attention import ops as fo
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import TensorSpec

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}
CELLS = [(a, s) for a in sorted(REGISTRY) for s in SHAPES]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# the smoke parity's cells at small shapes: (arch, shape name, (seq,
# batch)); the batch divides the (2, 2) mesh's 2 data ranks
SMOKE_CELLS = [("stablelm-1.6b", "train_4k", (32, 8)),
               ("deepseek-67b", "prefill_32k", (32, 4)),
               ("olmoe-1b-7b", "decode_32k", (32, 4))]
# context parallelism, as the JAX dry run's ``rules_override`` sets it:
# query rows over "model", no heads split
Q_SEQ_RULES = {"heads": None, "kv_heads": None, "kv_heads_c": None,
               "q_seq": ("model",)}
Q_SEQ_CELL = ("deepseek-67b", "prefill_32k", (32, 4))
# a train step under the same rules: smoke stablelm, its vocab whole
# ("vocab" None, as minicpm's and whisper's rules leave theirs), so that
# the unembedding and the loss run on each rank's rows too
Q_SEQ_TRAIN_CELL = ("stablelm-1.6b", "train_4k", (32, 8))
Q_SEQ_TRAIN_RULES = {**Q_SEQ_RULES, "vocab": None}
# smoke mixtral (4 experts) with its experts left whole, so that "model"
# splits the expert weights' d_ff ("mlp") instead, as the production
# rules do where 8 experts do not divide 16 ranks; a prefill and a decode
D_FF_RULES = {"experts": None}
D_FF_CELLS = [("mixtral-8x22b", "prefill_32k", (32, 4)),
              ("mixtral-8x22b", "decode_32k", (32, 4))]

JAX_META = r"""
import dataclasses, json
import repro.launch.dryrun as jd
from repro.configs import REGISTRY, SHAPES, cell_runnable, get_config
from repro.launch.mesh import make_production_mesh

opts = {}
replace = dataclasses.replace
def capture(obj, **kw):
    out = replace(obj, **kw)
    if type(obj).__name__ == "TrainOptions":
        opts["last"] = out
    return out
dataclasses.replace = capture

class Stop(Exception):
    pass
def stop(*args, **kwargs):
    raise Stop
jd.train_state_specs = jd.build_prefill_step = jd.build_decode_step = stop

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in sorted(REGISTRY):
        for name, shape in SHAPES.items():
            cfg = get_config(arch)
            opts.clear()
            try:
                res = jd.dryrun_cell(arch, name, multi, mesh=mesh)
            except Stop:
                res = {"status": "ok"}
            row = {"status": res["status"], "why": res.get("why", "")}
            if cell_runnable(cfg, shape)[0]:
                o = opts["last"]
                tokens = (shape.global_batch if shape.kind == "decode"
                          else shape.global_batch * shape.seq_len)
                row.update(
                    rules=jd.make_rules(cfg, shape, mesh).describe(),
                    model_flops=cfg.model_flops(
                        tokens, backward=shape.kind == "train"),
                    options=[o.accum_steps, o.moment_dtype, o.chunk])
            out[f"{arch}|{name}|{'multi' if multi else 'single'}"] = row
print("JSON" + json.dumps(out))
"""

JAX_SMOKE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
assert len(jax.devices()) == 4          # locked before dryrun's own flag
import repro.launch.dryrun as jd
from repro.configs import ShapeConfig, smoke
from repro.launch.mesh import make_mesh

cells = json.loads(sys.argv[1])
real_get_config = jd.get_config
jd.get_config = lambda a: smoke(real_get_config(a))
shapes = {n: ShapeConfig(n, s, b, kind) for _, n, (s, b), kind, _, _ in cells}
jd.get_shape = lambda n: shapes[n]
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch, name, _, kind, label, override in cells:
    if override:
        override = {k: tuple(v) if v else None for k, v in override.items()}
    res = jd.dryrun_cell(arch, name, mesh=mesh, rules_override=override)
    out[label] = {"argument_bytes": res["memory"]["argument_bytes"],
                 "flops": res["roofline"]["hlo_flops_per_device"],
                 "collectives": res["collectives"]}
print("JSON" + json.dumps(out))
"""


def _spawn(code, *args):
    return subprocess.Popen([sys.executable, "-c", code, *args], env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def jax_runs():
    """Both JAX subprocesses, started together; their results on first
    use."""
    smoke_cells = [(a, n, sb, SHAPES[n].kind, a, None)
                   for a, n, sb in SMOKE_CELLS]
    a, n, sb = Q_SEQ_CELL
    smoke_cells.append((a, n, sb, SHAPES[n].kind, f"{a} q_seq", Q_SEQ_RULES))
    a, n, sb = Q_SEQ_TRAIN_CELL
    smoke_cells.append((a, n, sb, SHAPES[n].kind, f"{a} {n} q_seq",
                        Q_SEQ_TRAIN_RULES))
    smoke_cells += [(a, n, sb, SHAPES[n].kind, f"{a} {n} d_ff", D_FF_RULES)
                    for a, n, sb in D_FF_CELLS]
    procs = {"meta": _spawn(JAX_META),
             "smoke": _spawn(JAX_SMOKE, json.dumps(smoke_cells))}
    done = {}

    def get(name):
        if name not in done:
            done[name] = _result(procs[name])
        return done[name]
    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()


class MockMesh:
    """A mesh by axis names and sizes, as the rules read it."""

    def __init__(self, shape, names):
        import numpy as np
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


# ---------------------------------------------------------------------------
# Metadata of every cell, both meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cell_metadata_matches_jax(jax_runs, arch, mesh):
    """Status and ``why``, rules, model flops and the dry run's options
    (accumulation capped by the data-parallel ranks, bf16 moments for
    mixtral and jamba, deepseek's 4096-token train chunk) of each of the
    arch's 4 cells."""
    want = jax_runs("meta")
    mock = MockMesh(*MESHES[mesh])
    for name, shape in SHAPES.items():
        cfg = get_config(arch)
        w = want[f"{arch}|{name}|{mesh}"]
        ok, why = cell_runnable(cfg, shape)
        assert ("ok" if ok else "skipped", why) == (w["status"], w["why"])
        res = dr.dryrun_cell(arch, name, mesh == "multi") if not ok else None
        if not ok:
            assert res == {"arch": arch, "shape": name, "mesh": mesh,
                           "status": "skipped", "why": why}
            continue
        assert make_rules(cfg, shape, mock).describe() == w["rules"]
        assert dr.model_flops(cfg, shape) == w["model_flops"]
        o = dr.cell_options(cfg, shape, mock)
        assert [o.accum_steps, o.moment_dtype, o.chunk] == w["options"], \
            (name, w["options"])


def test_skipped_cells_are_the_long_500k_of_full_attention_archs():
    skipped = [(a, s) for a, s in CELLS
               if not cell_runnable(get_config(a), SHAPES[s])[0]]
    assert len(skipped) == 7 and {s for _, s in skipped} == {"long_500k"}


# ---------------------------------------------------------------------------
# The fake process group
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh4():
    """A (2, 2) ("data", "model") mesh of a 4-rank fake process group, on
    CUDA and on the CPU, for one test."""
    with dr.fake_process_group(4):
        yield {d: make_mesh((2, 2), ("data", "model"), d)
               for d in ("cuda", "cpu")}


def _sharded_spec(mesh, shape, placements):
    return TensorSpec(shape, torch.float32), NamedSharding(mesh, placements)


def test_row_parallel_linear_gives_one_all_reduce(mesh4):
    """x (8, 64) split over "model" along its contraction, w (64, 32)
    split the same way: the product is partial on each rank, and laying
    it out replicated is one all-reduce of the local (8, 32) f32 result
    over the 2 ranks of "model": 1024 bytes."""
    mesh = mesh4["cuda"]
    r, s0, s1 = Replicate(), Shard(0), Shard(1)
    (xs, xsh), (ws, wsh) = (_sharded_spec(mesh, (8, 64), (r, s1)),
                            _sharded_spec(mesh, (64, 32), (r, s0)))

    def step(x, w):
        return (x @ w).redistribute(mesh, (r, r))
    rep = DryRunBackend().run(StepProgram(
        "row-parallel", step, (xs, ws), device="cuda", mesh=mesh,
        in_shardings=(xsh, wsh)))
    assert rep.detail["collectives"] == {
        "all-reduce": {"count": 1, "bytes": 8 * 32 * 4.0,
                       "group_sizes": [2]}}
    assert rep.collective_bytes == 1024.0
    assert rep.flops == 2 * 8 * 32 * 32          # the local (8,32)@(32,32)
    assert rep.memory["argument_bytes"] == (8 * 32 + 32 * 32) * 4


def test_fsdp_param_use_gives_one_all_gather(mesh4):
    """w (64, 32) split over "data" along its rows, gathered whole before
    x (8, 64) uses it, as an FSDP layer does: one all-gather of the local
    (32, 32) f32 shard over the 2 ranks of "data": 4096 bytes."""
    mesh = mesh4["cuda"]
    r, s0 = Replicate(), Shard(0)
    (xs, xsh), (ws, wsh) = (_sharded_spec(mesh, (8, 64), (r, r)),
                            _sharded_spec(mesh, (64, 32), (s0, r)))

    def step(x, w):
        return x @ w.redistribute(mesh, (r, r))
    rep = DryRunBackend().run(StepProgram(
        "fsdp", step, (xs, ws), device="cuda", mesh=mesh,
        in_shardings=(xsh, wsh)))
    assert rep.detail["collectives"] == {
        "all-gather": {"count": 1, "bytes": 32 * 32 * 4.0,
                       "group_sizes": [2]}}
    assert rep.flops == 2 * 8 * 64 * 32
    assert rep.memory["output_bytes"] == 8 * 32 * 4


# ---------------------------------------------------------------------------
# Flash's strategy on a (2, 2) mesh
# ---------------------------------------------------------------------------

def _flash_layout(mesh, h, kvh):
    """The flash op on q (4, 8, h, 16) and k, v (4, 8, kvh, 16), each
    split over batch ("data") and heads ("model"): the output's
    placements and the local q the op was costed at."""
    s0, s2 = Shard(0), Shard(2)
    specs = [_sharded_spec(mesh, (4, 8, n, 16), (s0, s2))
             for n in (h, kvh, kvh)]
    rep = DryRunBackend().run(StepProgram(
        "flash", lambda q, k, v: fo.OP(q, k, v, True, 0, 0),
        tuple(s for s, _ in specs), device="cuda", mesh=mesh,
        in_shardings=tuple(sh for _, sh in specs)))
    (flops, _), = [(f, b) for n, f, b in rep.detail["ops"]
                   if n.startswith("repro_torch.")]
    return rep, flops


@pytest.mark.parametrize("h,kvh", [(8, 4), (6, 2)])
def test_flash_splits_heads_where_the_model_dim_divides_both(mesh4, h,
                                                             kvh):
    """Heads split over "model" (2) wherever 2 divides both counts, also
    where the whole mesh (4) does not divide them (6 and 2 heads): the op
    runs on each rank's (2, 8, h/2, 16) with no collective."""
    rep, flops = _flash_layout(mesh4["cuda"], h, kvh)
    want, _ = fo.cost((2, 8, h // 2, 16), (2, 8, kvh // 2, 16),
                      torch.float32)
    assert flops == want
    assert rep.detail["collectives"] == {}


def test_flash_replicates_heads_that_the_model_dim_does_not_divide(mesh4):
    """One kv head on 2 ranks of "model": no heads split (a rank's q heads
    would lose their kv head); the heads are gathered whole there."""
    rep, flops = _flash_layout(mesh4["cuda"], 4, 1)
    want, _ = fo.cost((2, 8, 4, 16), (2, 8, 1, 16), torch.float32)
    assert flops == want
    assert "all-gather" in rep.detail["collectives"]


def test_replicated_kernels_lists_flash_on_one_kv_head(mesh4):
    """The dry run's detector on a layout that replicates: one kv head on
    the 2 ranks of "model", where q, k and v arrive split by heads over
    it; the op has no layout for that split, so every call gathers all
    three there (and keeps the batch split over "data")."""
    rep, _ = _flash_layout(mesh4["cuda"], 4, 1)
    assert rep.detail["replicated_kernels"] == {
        "flash_attention": {"calls": 1, "gathered": {
            "q": ["model"], "k": ["model"], "v": ["model"]}}}
    split, _ = _flash_layout(mesh4["cuda"], 8, 4)
    assert split.detail["replicated_kernels"] == {}


def test_moe_layout_on_a_one_rank_mesh_keeps_every_tensor_whole():
    """On the (1, 1) mesh of a one-rank group every layout of the
    expert-MLP op costs nothing, the d_ff one too: the op keeps the
    all-replicated one (the parent's), so its output is no partial sum
    and nothing is reduced."""
    from repro_torch.kernels.moe_mlp import ops as mo
    with dr.fake_process_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        r = Replicate()
        specs = [_sharded_spec(mesh, shape, (r, r)) for shape in (
            (2, 4, 8, 64), (4, 64, 128), (4, 64, 128), (4, 128, 64))]
        out = []

        def step(*args):
            y = mo.OP(*args)
            out.append(tuple(y.placements))
            return y
        rep = DryRunBackend().run(StepProgram(
            "moe", step, tuple(sp for sp, _ in specs), device="cuda",
            mesh=mesh, in_shardings=tuple(sh for _, sh in specs)))
    assert out == [(r, r)]
    assert rep.detail["collectives"] == {}
    assert rep.detail["replicated_kernels"] == {}


def test_gqa_prefill_repeats_kv_where_only_q_heads_split(mesh4):
    """smoke deepseek-67b (4 q heads, 1 kv head) on the (2, 2) mesh: the
    rules split the q heads over "model" and not the kv head, so the
    model repeats k and v to the q heads before the kernel, whose calls
    then cost a quarter of the global flops (batch over "data", heads
    over "model"), as the JAX layout's."""
    cfg = smoke(get_config("deepseek-67b"))
    shape = ShapeConfig("prefill_32k", 32, 4, "prefill")
    rules = make_rules(cfg, shape, mesh4["cuda"])
    assert rules.size("heads") == 2 and rules.size("kv_heads") == 1
    res = _smoke_cell("deepseek-67b", "prefill_32k", (32, 4),
                      mesh4["cuda"])
    assert res["kernels"] == {"flash_attention": cfg.n_layers}
    assert dr.flash_split_ranks(cfg, shape, rules) == 4
    assert res["kernel_flops"]["flash_attention"] * 4 == \
        dr.flash_global_flops(cfg, shape)


# ---------------------------------------------------------------------------
# Smoke parity with the JAX dry run
# ---------------------------------------------------------------------------

def _smoke_cell(arch, name, seq_batch, mesh, rules_override=None):
    shape = ShapeConfig(name, *seq_batch, SHAPES[name].kind)
    real = dr.get_config, dr.SHAPES
    dr.get_config = lambda a: smoke(get_config(a))
    dr.SHAPES = {**SHAPES, name: shape}
    try:
        return dr.dryrun_cell(arch, name, mesh=mesh,
                              device=mesh.device_type,
                              rules_override=rules_override)
    finally:
        dr.get_config, dr.SHAPES = real


# per-device flops, the port's over JAX's: measured 0.94051, 0.86150 and
# 0.92083 (torch 2.13, jax 0.9.0), held within 1% of that.  The port
# counts the ops eager PyTorch dispatches with ``op_cost``'s rules, JAX
# what XLA compiled (``hlo_cost``)
SMOKE_FLOPS = {
    # the train step: the rules that put tests/test_torch_fidelity.py's
    # quickstart step at 0.98946, here on each rank's shards (more
    # elementwise ops in the eager backward).  Below JAX's: each rank's
    # attention output projection contracts its own heads (a partial
    # sum), where XLA gathers wo and contracts every head on every rank.
    # ``ac`` reduces a cotangent summed over "model" where the
    # activation was laid out, as JAX's constraint does; before it did,
    # that sum reached the last MLP's down projection, whose backward
    # then ran on the whole d_ff (1.01666; 0.94031 with the replaced
    # loss and ``ac``'s reduction)
    "stablelm-1.6b": (0.93051, 0.95051),
    # the prefill: the kernel counts causal attention as half of s x s,
    # JAX's naive attention (s = 32 < its 2048 chunk) the whole square
    "deepseek-67b": (0.85150, 0.87150),
    # a decode step: the expert FFN by the kernel's cost, JAX's as
    # einsums over every capacity slot, and routing as eager ops
    "olmoe-1b-7b": (0.91083, 0.93083),
}


@pytest.mark.parametrize("arch,name,seq_batch", SMOKE_CELLS)
def test_smoke_cell_matches_jax_per_device(jax_runs, mesh4, arch, name,
                                           seq_batch):
    want = jax_runs("smoke")[arch]
    dev = dr.default_device(SHAPES[name].kind)
    got = _smoke_cell(arch, name, seq_batch, mesh4[dev])
    assert got["status"] == "ok"
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    ratio = got["roofline"]["hlo_flops_per_device"] / want["flops"]
    lo, hi = SMOKE_FLOPS[arch]
    print(f"{arch} {name}: flops per device torch/JAX {ratio:.5f}; "
          f"collectives torch {got['collectives']} JAX "
          f"{want['collectives']}")
    assert lo <= ratio <= hi, ratio


# the context-parallel smoke prefill costed as the busiest rank (the last
# along "model"), over JAX's per-device flops: measured 0.94746 (torch
# 2.13, jax 0.9.0), held within 1% of that.  It stands above the head
# split's band (deepseek-67b's above): there each rank's attention is
# the kernel's half square against JAX's whole square (0.5 of it); here
# the last rank's rows see 3/4 of the keys that JAX computes a rank (the
# offset's full rectangle and their own half square).  The q, k and v
# projections run on the rank's rows, where XLA runs k and v on every
# row of the rank's batch; with k and v on every row the ratio was
# 0.99252
Q_SEQ_FLOPS = (0.93746, 0.95746)


def test_context_parallel_smoke_prefill_matches_jax_per_device(jax_runs):
    """smoke deepseek-67b's prefill under context-parallel rules on the
    (2, 2) mesh: costed as rank 1, the last along "model" (query rows
    [16, 32) of 32), and as rank 0.  No kernel is replicated; the flash
    op ran on the rank's rows with every key, rank 1's three times rank
    0's flops (pairs 16 (16 + 8) against 16 x 8); rank 1's flash flops
    times the ranks that split the calls are at least the global flash
    flops; per-device flops against JAX's as ``Q_SEQ_FLOPS``."""
    arch, name, sb = Q_SEQ_CELL
    want = jax_runs("smoke")[f"{arch} q_seq"]
    got = {}
    for rank in (0, 1):
        with dr.fake_process_group(4, rank):
            mesh = make_mesh((2, 2), ("data", "model"), "cuda")
            got[rank] = _smoke_cell(arch, name, sb, mesh, Q_SEQ_RULES)
    res = got[1]
    assert res["status"] == "ok" and res["costed_coordinate"] == [0, 1]
    assert res["rules"]["q_seq"] == ["model"]
    assert res["replicated_kernels"] == {}
    assert res["memory"]["argument_bytes"] == want["argument_bytes"]
    flash = [got[r]["kernel_flops"]["flash_attention"] for r in (0, 1)]
    assert flash[1] == 3 * flash[0]
    cfg = smoke(get_config(arch))
    shape = ShapeConfig(name, *sb, "prefill")
    rules = make_rules(cfg, shape, MockMesh((2, 2), ("data", "model")))
    rules.mapping.update(Q_SEQ_RULES)
    n = dr.flash_split_ranks(cfg, shape, rules)
    assert n == 4 and flash[1] * n >= dr.flash_global_flops(cfg, shape)
    assert flash[0] * n + flash[1] * n == 2 * dr.flash_global_flops(cfg,
                                                                    shape)
    ratio = res["roofline"]["hlo_flops_per_device"] / want["flops"]
    print(f"{arch} {name} q_seq: flops per device torch/JAX {ratio:.5f}")
    lo, hi = Q_SEQ_FLOPS
    assert lo <= ratio <= hi, ratio


# the context-parallel smoke train step over JAX's per-device flops:
# measured 0.91637 (torch 2.13, jax 0.9.0), held within 1% of that.  q, k
# and v, forward, recomputed and backward, on the rank's rows, the output
# projection on every row of the rank's batch, as in JAX's dots; the
# unembedding and the loss on the rank's rows (XLA runs the
# unembedding's forward and weight gradient on every row)
Q_SEQ_TRAIN_FLOPS = (0.90637, 0.92637)


def test_context_parallel_smoke_train_matches_jax_per_device(jax_runs,
                                                              mesh4):
    """smoke stablelm's train step under context-parallel rules with its
    vocab whole (``Q_SEQ_TRAIN_RULES``) on the (2, 2) mesh: the argument
    bytes JAX's, per-device flops against JAX's as ``Q_SEQ_TRAIN_FLOPS``,
    and each kind of collective's bytes a device at most JAX's."""
    arch, name, sb = Q_SEQ_TRAIN_CELL
    want = jax_runs("smoke")[f"{arch} {name} q_seq"]
    got = _smoke_cell(arch, name, sb, mesh4["cpu"], Q_SEQ_TRAIN_RULES)
    assert got["status"] == "ok", got.get("error")
    assert got["rules"]["q_seq"] == ["model"] and got["rules"]["vocab"] is None
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    ratio = got["roofline"]["hlo_flops_per_device"] / want["flops"]
    print(f"{arch} {name} q_seq: flops per device torch/JAX {ratio:.5f}; "
          f"collectives torch {got['collectives']} JAX "
          f"{want['collectives']}")
    lo, hi = Q_SEQ_TRAIN_FLOPS
    assert lo <= ratio <= hi, ratio
    for kind, c in got["collectives"].items():
        assert c["bytes"] <= want["collectives"][kind]["bytes"], kind


def _unsplit_expert_flops(arch, name, seq_batch):
    """The expert-MLP kernel's flops a device on a rank's capacity blocks
    (the batch split over the 2 ranks of "data") with the whole d_ff: the
    call each rank made before the op had a d_ff layout."""
    import math
    from repro_torch.kernels.moe_mlp import ops as mo
    from repro_torch.models.moe import MAX_GROUP_TOKENS
    cfg = smoke(get_config(arch))
    seq, batch = seq_batch
    t = 1 if SHAPES[name].kind == "decode" else seq
    sub = max(1, t // MAX_GROUP_TOKENS) if t % MAX_GROUP_TOKENS == 0 else 1
    g, t = batch * sub // 2, t // sub
    e, k = cfg.n_experts, cfg.top_k
    c = min(max(1, math.ceil(k * t * cfg.capacity_factor / e)), t * k)
    flops, _ = mo.cost((g, e, c, cfg.d_model), (e, cfg.d_model, cfg.d_ff),
                       torch.bfloat16)
    return cfg.n_layers * flops


@pytest.mark.parametrize("arch,name,seq_batch", D_FF_CELLS)
def test_expert_mlp_runs_each_ranks_d_ff_slice(mesh4, monkeypatch, arch,
                                                name, seq_batch):
    """smoke mixtral with its experts whole (``D_FF_RULES``) on the
    (2, 2) mesh: "model" splits the expert weights' d_ff, and the
    kernel runs on each rank's half of it (the op's d_ff layout, a
    partial sum reduced at the model's "moe_d" constraint): half the
    unsplit call's flops a device, no collective with an operand or
    output the size of a layer's expert weight (E, D, F) or of a rank's
    half of one, and no kernel replicated."""
    from repro_torch.core import op_cost
    cfg = smoke(get_config(arch))
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    weight = {e * d * f, e * d * f // 2}
    moved, cost = [], op_cost.op_cost

    def spy(func, args, kwargs, out):
        if func.namespace in op_cost.COLLECTIVE_NAMESPACES:
            moved.extend((str(func), tuple(t.shape))
                         for t in op_cost._tensors((args, kwargs, out))
                         if t.numel() in weight)
        return cost(func, args, kwargs, out)
    monkeypatch.setattr(op_cost, "op_cost", spy)
    res = _smoke_cell(arch, name, seq_batch, mesh4["cuda"], D_FF_RULES)
    assert res["status"] == "ok", res.get("error")
    assert res["rules"]["mlp"] == ["model"] and res["rules"]["experts"] is None
    assert res["kernels"] == {"expert_mlp": cfg.n_layers,
                              **({"flash_attention": cfg.n_layers}
                                 if name == "prefill_32k" else {})}
    assert res["kernel_flops"]["expert_mlp"] * 2 == _unsplit_expert_flops(
        arch, name, seq_batch)
    assert moved == [], moved[:4]
    assert res["replicated_kernels"] == {}
    assert "all-reduce" in res["collectives"]


# the d_ff-split smoke cells' per-device flops over JAX's (JAX's dry run
# under the same override): measured 0.89300 and 0.97657 (torch 2.13,
# jax 0.9.0), held within 1% of that.  The prefill sits below JAX's as
# deepseek-67b's does in ``SMOKE_FLOPS``: the kernel counts causal
# attention as half of s x s, JAX's naive attention the whole square.
# The decode sits nearer 1 (no attention kernel; the routing as eager
# ops).  Each rank's expert FFN is its half of d_ff in both, as JAX's
# einsums over "mlp": with the whole d_ff on every rank (the op's three
# layouts before the d_ff one) the ratios were 1.60494 and 1.78772
D_FF_FLOPS = {"prefill_32k": (0.88300, 0.90300),
              "decode_32k": (0.96657, 0.98657)}


@pytest.mark.parametrize("arch,name,seq_batch", D_FF_CELLS)
def test_d_ff_split_smoke_cell_matches_jax_per_device(jax_runs, mesh4, arch,
                                                      name, seq_batch):
    want = jax_runs("smoke")[f"{arch} {name} d_ff"]
    got = _smoke_cell(arch, name, seq_batch, mesh4["cuda"], D_FF_RULES)
    assert got["status"] == "ok"
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    ratio = got["roofline"]["hlo_flops_per_device"] / want["flops"]
    lo, hi = D_FF_FLOPS[name]
    print(f"{arch} {name} d_ff: flops per device torch/JAX {ratio:.5f}; "
          f"collectives torch {got['collectives']} JAX "
          f"{want['collectives']}")
    assert lo <= ratio <= hi, ratio


def test_train_cell_moves_no_stacked_leaf_whole(mesh4, monkeypatch):
    """smoke stablelm's train step on the (2, 2) mesh: no collective and
    no ``cat`` of the costed stream has an operand or output at the
    global shape of a stacked layer leaf that the layout splits (the
    layers' gradients are stacked on each rank's shards).  With the
    layer split's backward left to DTensor (a plain ``unbind``), the
    same check finds the gradient of the split attention output
    projection reduced whole."""
    from repro_torch.models import transformer
    arch, name, sb = SMOKE_CELLS[0]
    res = _smoke_cell(arch, name, sb, mesh4["cpu"])
    assert res["status"] == "ok"
    assert res["whole_stacked_moves"] == [], res["whole_stacked_moves"]
    monkeypatch.setattr(transformer._UnbindLayers, "apply",
                        lambda v: v.unbind(0))
    old = _smoke_cell(arch, name, sb, mesh4["cpu"])
    assert old["whole_stacked_moves"], old["collectives"]


def test_stablelm_train_loss_keeps_the_vocab_split(monkeypatch):
    """stablelm-1.6b's train_4k cell on the (16, 16) mesh of a 256-rank
    fake process group, costed as the last rank along "model" (vocab ids
    [94080, 100352) of its split logits): no op of the costed stream has
    an operand or output whose last dim is the whole padded vocab (the
    loss's pick once ran on (16, 4096, 100352) operands on every rank),
    and the cell's peak is under 30 GB a device (95.08 GB then, on this
    host's all-gathers; JAX's 24.72)."""
    from repro_torch.core import op_cost
    from repro_torch.models.layers import padded_vocab
    vp = padded_vocab(get_config("stablelm-1.6b"))
    whole, cost = [], op_cost.op_cost

    def spy(func, args, kwargs, out):
        whole.extend((str(func), tuple(t.shape))
                     for t in op_cost._tensors((args, kwargs, out))
                     if t.dim() >= 2 and t.shape[-1] == vp)
        return cost(func, args, kwargs, out)
    monkeypatch.setattr(op_cost, "op_cost", spy)
    with dr.fake_process_group(256, dr.costed_rank()):
        res = dr.dryrun_cell("stablelm-1.6b", "train_4k")
    assert res["status"] == "ok", res.get("error")
    assert res["rules"]["vocab"] == ["model"]
    assert res["costed_coordinate"] == [0, 15]
    assert whole == [], whole[:4]
    print(f"stablelm-1.6b train_4k: {res['memory']['per_device_total'] / 1e9:.2f}"
          f" GB a device; top bytes {res['top_bytes'][:3]}")
    assert res["memory"]["per_device_total"] < 30e9


# which leaves' gradients ``compress_gradients`` replicates on the
# (16, 16) mesh at train_4k (their blocks cross the shards: the dims
# after the innermost split one multiply to no multiple of 256), by arch;
# a hybrid arch's period positions written as ``*``; every other leaf is
# compressed on its local shards
COMPRESS_REPLICATED = {
    "deepseek-67b": ["embed/head", "layers/ffn/wg", "layers/ffn/wi",
                     "layers/mixer/wq"],
    "jamba-v0.1-52b": ["embed/head", "layers/*/ffn/wg", "layers/*/ffn/wi",
                       "layers/*/mixer/A_log", "layers/*/mixer/D",
                       "layers/*/mixer/conv_b", "layers/*/mixer/conv_w",
                       "layers/*/mixer/dt_bias", "layers/*/mixer/dt_proj",
                       "layers/*/mixer/in_proj", "layers/*/mixer/wq",
                       "layers/*/mixer/x_proj"],
    "minicpm-2b": ["layers/ffn/wg", "layers/ffn/wi"],
    "mixtral-8x22b": ["embed/head", "layers/ffn/wg", "layers/ffn/wi",
                      "layers/mixer/wq"],
    "nemotron-4-15b": ["embed/head", "layers/ffn/wi", "layers/mixer/wq"],
    "olmoe-1b-7b": ["embed/head", "layers/mixer/wk", "layers/mixer/wq",
                    "layers/mixer/wv"],
    "qwen2-vl-7b": ["embed/head", "layers/ffn/wg", "layers/ffn/wi"],
    "rwkv6-7b": ["embed/head", "layers/ffn/wk"],
    "stablelm-1.6b": ["embed/head", "layers/ffn/wg", "layers/ffn/wi",
                      "layers/mixer/wk", "layers/mixer/wq", "layers/mixer/wv"],
    "whisper-small": ["dec_layers/ffn/wi", "enc_layers/ffn/wi"],
}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_compress_replicates_only_leaves_whose_blocks_cross_shards(arch):
    import re
    from repro_torch.dist.sharding import MeshSharder
    from repro_torch.models import build_model
    from repro_torch.models.common import leaves_with_path
    from repro_torch.optim.compress import blocks_stay_local
    cfg, mock = get_config(arch), MockMesh(*MESHES["single"])
    sh = MeshSharder(mock, make_rules(cfg, SHAPES["train_4k"], mock))
    specs, axes = build_model(cfg).param_specs()
    got = sorted({re.sub(r"/\d+/", "/*/", p)
                  for (p, s), (_, a) in zip(leaves_with_path(specs),
                                            leaves_with_path(axes))
                  if not blocks_stay_local(s.shape,
                                           sh.sharding(a).placements)})
    assert got == COMPRESS_REPLICATED[arch]


# ---------------------------------------------------------------------------
# Production cells under the fake process group
# ---------------------------------------------------------------------------

PRODUCTION = [(256, False, [("stablelm-1.6b", "prefill_32k"),
                            ("deepseek-67b", "prefill_32k"),
                            ("deepseek-67b", "decode_32k")]),
              (512, True, [("olmoe-1b-7b", "prefill_32k")])]


@pytest.fixture(scope="module")
def production():
    """Three cells on the (16, 16) mesh of a 256-rank fake process group
    and one on the (2, 16, 16) mesh of a 512-rank one, on fake CUDA
    tensors."""
    out = {}
    for world, multi, cells in PRODUCTION:
        with dr.fake_process_group(world):
            for arch, name in cells:
                out[(arch, name, multi)] = dr.dryrun_cell(arch, name, multi)
    return out


@pytest.mark.parametrize("arch,name,multi", [
    (a, n, m) for _, m, cells in PRODUCTION for a, n in cells])
def test_production_cell_is_ok(production, arch, name, multi):
    res = production[(arch, name, multi)]
    assert res["status"] == "ok", res.get("error")
    assert res["mesh_desc"]["devices"] == (512 if multi else 256)
    assert res["device"] == "cuda" and res["xla_cost_analysis"] is None
    assert not res["unknown_ops"], res["unknown_ops"]
    mem = res["memory"]
    assert mem["per_device_total"] == (mem["argument_bytes"]
                                       + mem["output_bytes"]
                                       + mem["temp_bytes"]
                                       - mem["alias_bytes"])
    r = res["roofline"]
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"]) > 0
    assert res["hlo_flops_global"] == r["hlo_flops_per_device"] * (
        512 if multi else 256)


def test_stablelm_mlp_up_projection_costs_its_share(production):
    """Batch 32 over the 16 ranks of "data", d_ff 5632 over the 16 of
    "model": each rank's up projection is a (2 x 32768, 2048) x (2048,
    352) product, 1/256 of the global one."""
    res = production[("stablelm-1.6b", "prefill_32k", False)]
    cfg = get_config("stablelm-1.6b")
    glob = 2.0 * 32 * 32768 * cfg.d_model * cfg.d_ff
    assert [f for f, _ in res["top_dots"]].count(glob / 256) >= 2, \
        res["top_dots"]
    assert "[(1, 65536, 2048), (1, 2048, 352)]" in res["top_dots"][0][1]


@pytest.mark.parametrize("arch,multi", [("stablelm-1.6b", False),
                                        ("deepseek-67b", False),
                                        ("olmoe-1b-7b", True)])
def test_flash_flops_split_as_jax_splits_heads(production, arch, multi):
    """The per-device flash flops times the ranks that split the batch
    and the heads equal the global flash flops: heads over "model" (for
    deepseek's GQA 64/8, k and v repeated to the 64 q heads), the batch
    over "data" (and "pod")."""
    res = production[(arch, "prefill_32k", multi)]
    cfg, shape = get_config(arch), SHAPES["prefill_32k"]
    mock = MockMesh(*MESHES["multi" if multi else "single"])
    rules = make_rules(cfg, shape, mock)
    n = dr.flash_split_ranks(cfg, shape, rules)
    assert n == (512 if multi else 256)
    assert res["kernels"]["flash_attention"] == cfg.n_layers
    assert res["kernel_flops"]["flash_attention"] * n == \
        dr.flash_global_flops(cfg, shape)
    assert res["replicated_kernels"] == {}


def test_deepseek_decode_splits_its_cache_along_the_slots(production):
    """deepseek-67b's 8 kv heads do not divide "model" (16): the decode
    rules split the cache's slots over it, and the cell runs."""
    res = production[("deepseek-67b", "decode_32k", False)]
    assert res["rules"]["kv_seq"] == ["model"]
    assert res["rules"]["kv_heads"] is None
    assert res["kernels"] == {}
    assert res["collectives"]["all-reduce"]["group_sizes"] == [16]
