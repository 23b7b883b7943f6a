"""Multi-pod dry run of the port: cost every (architecture x input shape)
cell per device on the production meshes, the twin of
``repro.launch.dryrun``.

For each cell this dry run:
  1. builds the step (train_step / prefill_step / decode_step) with the
     cell's ``MeshSharder`` and the production shardings of its params,
     train state and batch (``make_rules``, ``param_shardings``,
     ``batch_shardings``, as the JAX dry run's ``in_shardings``);
  2. runs it once as one rank of the (16, 16) or (2, 16, 16) mesh under
     PyTorch's fake process group (``costed_rank``: the last rank along
     "model", the busiest of a causal context-parallel prefill), on fake
     tensors (``core.fidelity.DryRunBackend``): every input is that
     rank's local shard wrapped as a DTensor, nothing is allocated and
     nothing is launched, and DTensor emits the local ops and the
     collectives that one rank would.  Success shows that the layout is
     coherent (every op has a strategy, every redistribution resolves);
  3. records the per-device costs of that stream (``core.op_cost``): the
     flops and bytes of the local ops at their local shapes, the port's
     four kernels at their ``cost``, the collectives by kind with their
     operand bytes, the exact argument and output bytes and the peak of
     the storage the step held at once;
  4. derives the three roofline terms from the card's constants below
     and writes the JAX cell's keys as JSON.

Keys as in the JAX dry run, where the port computes them: ``status``,
``kind``, ``mesh_desc``, ``memory`` (``argument_bytes``,
``output_bytes``, ``temp_bytes``, ``alias_bytes``, ``per_device_total``),
``fits_hbm``, ``roofline`` (every key of ``roofline_terms``),
``collectives``, ``model_flops_global``, ``hlo_flops_global`` (the
per-device flops times the ranks, under JAX's name),
``useful_flops_ratio``, ``rules``.  Their twins: ``top_dots`` and
``top_bytes`` are the largest ops of the costed stream, and ``trace_s``,
the host seconds of the fake run, stands for ``lower_s`` and
``compile_s``.  ``temp_bytes`` is eager PyTorch's peak of live storage
less the outputs, not a compiled module's temp buffer.
``xla_cost_analysis`` is written as ``null``: it is XLA's own count of
the compiled module, and eager PyTorch has no compiled module to ask;
``roofline`` holds the port's count.  Keys of the port's own:
``kernels`` (each kernel's calls) and ``kernel_flops`` (their flops a
device, by kernel), ``unknown_ops``, ``options`` (the
train options the cell ran with), ``device``, ``costed_rank`` and
``costed_coordinate`` (the rank whose stream was costed, and its
coordinate on the mesh), ``whole_stacked_moves`` (the collectives and
``cat`` ops of the stream with an operand or output at the global shape
of a stacked layer leaf that the cell's layout splits: a gradient of
such a leaf reduced or rebuilt whole; ``stacked_moves_of``),
``trace_ops`` and ``trace_collectives`` (the count of the ops of the
step's desim trace, ``core.fidelity.step_trace``, and its collective
ops' count and bytes by kind, which equal ``collectives``), and
``replicated_kernels``: by kernel, the calls of the costed stream that
ran with an argument gathered over a mesh dim that the cell's layout
split it over (the kernel's strategy had no layout for that split, so
every rank of that dim ran the same call), as ``{"calls": n,
"gathered": {argument: [mesh dims]}}``
(``core.op_cost.CostMode.replicated``); empty where every kernel ran on
its shards.

Constants: one NVIDIA H100 SXM5 (dense bf16 tensor-core peak, HBM3 rate
and size, NVLink 4 rate per direction).  A 16-wide mesh axis spans two
8-GPU nodes, whose link between them is slower than NVLink, so
``collective_s`` is a lower bound on the collectives' time.

On the card the cells run on fake CUDA tensors.  On a host with no card
the prefill and decode cells do too (nothing runs), and the train cells
run on fake CPU tensors: autograd on fake CUDA tensors needs the CUDA
runtime (``core.fidelity.DryRunBackend``).  ``--device`` forces one.

Usage:
  python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all     # 40 cells x 2 meshes
  python -m repro_torch.launch.dryrun --all --single-pod-only --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import REGISTRY, SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeConfig, cell_runnable
from repro_torch.core.desim.machine import H100_SXM
from repro_torch.core.fidelity import (DryRunBackend, StepProgram,
                                       StepReport, step_trace)
from repro_torch.dist.sharding import MeshSharder, make_rules, mesh_axes
from repro_torch.kernels.flash_attention.ops import cost as flash_cost
from repro_torch.launch.mesh import (describe, make_production_mesh,
                                     production_shape)
from repro_torch.models import build_model
from repro_torch.models.common import leaves_with_path, map_leaves
from repro_torch.serve.step import build_decode_step, build_prefill_step
from repro_torch.train.step import (TrainOptions, build_train_step,
                                    default_options_for, train_state_specs)

# The card's constants, from the desim machine's catalog entry (one owner
# for the dry run's roofline and the desim replay): one NVIDIA H100 SXM5
PEAK_FLOPS = H100_SXM["peak_flops"]    # dense bf16 tensor-core peak, FLOP/s
HBM_BW = H100_SXM["hbm_bw"]            # HBM3, bytes/s
NVLINK_BW = H100_SXM["nvlink_bw"]      # NVLink 4, bytes/s per direction
HBM_BYTES = H100_SXM["hbm_bytes"]      # HBM3 capacity

# Gradient-accumulation microbatching per train cell: the JAX dry run's
# choice (src/repro/launch/dryrun.py), kept so that the two dry runs cost
# the same step.
TRAIN_ACCUM = {
    "deepseek-67b": 8,
    "jamba-v0.1-52b": 8,
    "mixtral-8x22b": 16,
    "olmoe-1b-7b": 4,
    "nemotron-4-15b": 2,
    "rwkv6-7b": 2,
    "stablelm-1.6b": 1,
    "minicpm-2b": 1,
    "qwen2-vl-7b": 1,
    "whisper-small": 1,
}
# archs whose Adam moments are bf16 (141 B and 52 B params)
BF16_MOMENTS = ("mixtral-8x22b", "jamba-v0.1-52b")


def cell_options(cfg: ArchConfig, shape: ShapeConfig, mesh: Any
                 ) -> TrainOptions:
    """The JAX dry run's options for one cell: ``TRAIN_ACCUM``, capped so
    that a microbatch still divides the data-parallel ranks; bf16 moments
    for ``BF16_MOMENTS``; a 4096-token attention chunk for deepseek-67b's
    train cell (one KV chunk at train_4k), 2048 elsewhere.  ``mesh`` may
    be a ``DeviceMesh`` or a mock with axis names and sizes."""
    sizes = mesh_axes(mesh)
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    accum = TRAIN_ACCUM.get(cfg.name, 1) if shape.kind == "train" else 1
    accum = max(1, min(accum, shape.global_batch // dp))
    return dataclasses.replace(
        default_options_for(cfg), accum_steps=accum,
        moment_dtype=("bfloat16" if cfg.name in BF16_MOMENTS
                      else "float32"),
        chunk=(4096 if cfg.name == "deepseek-67b" and shape.kind == "train"
               else 2048))


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6 N D for a train step, 2 N D forward; a decode step
    makes one token per sequence."""
    if shape.kind == "decode":
        return cfg.model_flops(shape.global_batch, backward=False)
    return cfg.model_flops(shape.global_batch * shape.seq_len,
                           backward=shape.kind == "train")


def flash_global_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """The flash kernel's flops in a decoder LM's prefill cell, at global
    shapes: one call per attention layer, causal over the whole sequence
    (the vision prefix of a VLM included), by the kernel's ``cost``."""
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    b, s, hd = shape.global_batch, shape.seq_len, cfg.head_dim
    flops, _ = flash_cost((b, s, cfg.n_heads, hd),
                          (b, s, cfg.n_kv_heads, hd), torch.bfloat16,
                          causal=True, window=cfg.sliding_window,
                          prefix=cfg.n_vis if cfg.family == "vlm" else 0)
    return n_attn * flops


def flash_split_ranks(cfg: ArchConfig, shape: ShapeConfig, rules) -> int:
    """The ranks that split a prefill's flash calls between them: its
    batch's data-parallel ranks, where the rules split the heads (JAX's
    head TP) the "heads" ranks, and where they split the query rows
    (context parallelism) the "q_seq" ranks; the ranks of the rest hold
    the same call.  A causal row split is uneven: the rank with the last
    rows does the most."""
    n = rules.size("batch") if shape.global_batch % rules.size("batch") \
        == 0 else 1
    q_seq = rules.size("q_seq") if shape.seq_len % rules.size("q_seq") \
        == 0 else 1
    return n * rules.size("heads") * q_seq


def costed_rank(multi_pod: bool = False) -> int:
    """The rank a production cell is costed as: the last along "model"
    (the mesh's innermost axis) with every other coordinate 0.  Every
    rank of a cell runs the same ops but for a causal context-parallel
    prefill ("q_seq"), whose last shard of query rows sees the most
    keys; that rank bounds the step."""
    return production_shape(multi_pod)[0][-1] - 1


def default_device(kind: str) -> str:
    """Fake CUDA tensors, except a train cell on a host with no card."""
    return "cuda" if kind != "train" or torch.cuda.is_available() else "cpu"


def roofline_terms(rep: StepReport, n_dev: int) -> Dict[str, Any]:
    """The three roofline terms of one device's step, with the JAX
    dry run's keys."""
    flops, nbytes = rep.flops, rep.bytes_accessed
    copy_bytes = rep.detail["copy_bytes"]
    coll_bytes = rep.collective_bytes
    compute = flops / PEAK_FLOPS
    memory = nbytes / HBM_BW
    memory_ex_copies = max(0.0, nbytes - copy_bytes) / HBM_BW
    coll = coll_bytes / NVLINK_BW
    dom = max(("compute", compute), ("memory", memory),
              ("collective", coll), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "memory_s_ex_copies": memory_ex_copies, "collective_s": coll,
            "dominant": dom, "bound_s": max(compute, memory, coll),
            "bound_s_ex_copies": max(compute, memory_ex_copies, coll),
            "hlo_flops_per_device": flops,
            "hlo_bytes_per_device": nbytes,
            "copy_bytes_per_device": copy_bytes,
            "collective_bytes_per_device": coll_bytes}


def split_stacked_shapes(arch: str, rules, mesh) -> set:
    """The global shapes of the arch's stacked layer leaves (under
    ``layers``, ``enc_layers`` or ``dec_layers``) that ``rules`` split
    over some mesh dim."""
    specs, axes = build_model(get_config(arch)).param_specs()
    sharder = MeshSharder(mesh, rules)
    out = set()
    for (path, spec), (_, ax) in zip(leaves_with_path(specs),
                                     leaves_with_path(axes)):
        stacked = {"layers", "enc_layers", "dec_layers"} & set(
            path.split("/"))
        if stacked and any(p.is_shard()
                           for p in sharder.sharding(ax).placements):
            out.add(tuple(spec.shape))
    return out


def stacked_moves_of(rep: StepReport, shapes: set) -> list:
    """The collectives and ``cat`` ops of a costed stream with an operand
    or output of one of ``shapes`` (``split_stacked_shapes``), as
    ``"op [shapes]"``."""
    return [f"{op} {sh}" for op, sh in rep.detail["moves"]
            if any(tuple(x) in shapes for x in sh)]


def _cast_floats(specs: Any, dtype: Optional[torch.dtype]) -> Any:
    if dtype is None:
        return specs
    return map_leaves(lambda s: s._replace(dtype=dtype)
                      if s.dtype.is_floating_point else s, specs)


def build_program(arch: str, shape_name: str, mesh, opts=None,
                  rules_override: Optional[Dict] = None,
                  serve_param_dtype: Optional[torch.dtype] = None,
                  device=None, shape: Optional[ShapeConfig] = None):
    """The cell's ``StepProgram`` on ``mesh``, its rules and its options:
    the step with the cell's sharder, the specs of its params (or train
    state) and batch, and their production shardings.  ``shape``
    replaces the cell's shape (a cell cut to fit one card)."""
    cfg, shape = get_config(arch), shape or SHAPES[shape_name]
    dev = torch.device(device or default_device(shape.kind))
    rules = make_rules(cfg, shape, mesh)
    if rules_override:
        rules.mapping.update(rules_override)
    sharder = MeshSharder(mesh, rules)
    model = build_model(cfg)
    opts = opts or cell_options(cfg, shape, mesh)
    batch_specs = model.input_specs(shape)
    batch_sh = sharder.batch_shardings(batch_specs)
    if shape.kind == "train":
        state_specs, state_axes = train_state_specs(model, opts)
        fn = build_train_step(model, opts, sharder,
                              param_axes=state_axes["params"])
        first, first_sh = state_specs, sharder.param_shardings(state_axes)
    else:
        p_specs, p_axes = model.param_specs()
        first = _cast_floats(p_specs, serve_param_dtype)
        first_sh = sharder.param_shardings(p_axes)
        fn = (build_prefill_step(model, sharder, chunk=opts.chunk,
                                 seq_capacity=shape.seq_len)
              if shape.kind == "prefill" else build_decode_step(model,
                                                                sharder))
    prog = StepProgram(f"{arch} {shape_name}", fn, (first, batch_specs),
                       device=dev, mesh=mesh,
                       in_shardings=(first_sh, batch_sh))
    return prog, rules, opts


def decode_serving_cost(cfg: ArchConfig, slots: int, seq_capacity: int,
                        device=None):
    """The batched decode step of ``BatchServer(slots=, seq_capacity=)``
    dry-run on fake tensors (bf16 params, the server's cache and per-slot
    ``cur_len``) and the ``sim.ServingCost`` fitted to it by
    ``ServingCost.from_hlo_cost``: the flops a slot, the params' bytes as
    the resident weights, the rest of the step's bytes spread over the
    whole cache (``slots * seq_capacity`` tokens: the decode step reads
    every slot's cache to its capacity, whatever its live context).
    Returns ``(cost, report, weight_bytes)``."""
    from types import SimpleNamespace

    from repro_torch.models.common import TensorSpec
    from repro_torch.sim.workloads import ServingCost
    model = build_model(cfg)
    params = _cast_floats(model.param_specs()[0], torch.bfloat16)
    batch = {"tokens": TensorSpec((slots, 1), torch.int64),
             "cache": model.cache_spec(slots, seq_capacity),
             "cur_len": TensorSpec((slots,), torch.int64)}
    prog = StepProgram(f"{cfg.name} decode slots={slots} cap={seq_capacity}",
                       build_decode_step(model), (params, batch),
                       device=device)
    rep = DryRunBackend().run(prog)
    weight_bytes = float(sum(math.prod(s.shape) * s.dtype.itemsize
                             for _, s in leaves_with_path(params)))
    cost = ServingCost.from_hlo_cost(
        SimpleNamespace(flops=rep.flops, bytes=rep.bytes_accessed),
        batch=slots, context_tokens=slots * seq_capacity,
        weight_bytes=weight_bytes)
    return cost, rep, weight_bytes


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool = False,
                opts: Optional[TrainOptions] = None,
                rules_override: Optional[Dict] = None,
                mesh=None, serve_param_dtype: Optional[torch.dtype] = None,
                device=None) -> Dict[str, Any]:
    """One cell's result dict (the JAX dry run's keys).  Without ``mesh``
    the production mesh is built over the default process group, which
    must have 256 (or, ``multi_pod``, 512) ranks: ``fake_process_group``."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    tag = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single"}
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        return {**tag, "status": "skipped", "why": why}
    dev = torch.device(device or default_device(shape.kind))
    mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                        device_type=dev.type)
    n_dev = int(mesh.size())
    t0 = time.perf_counter()
    prog, rules, opts = build_program(arch, shape_name, mesh, opts,
                                      rules_override, serve_param_dtype,
                                      dev)
    rep = DryRunBackend().run(prog)
    trace_s = time.perf_counter() - t0
    coord = mesh.get_coordinate()
    mem = {k: rep.memory[k] for k in ("argument_bytes", "output_bytes",
                                      "temp_bytes", "alias_bytes")}
    mem["per_device_total"] = (mem["argument_bytes"] + mem["output_bytes"]
                               + mem["temp_bytes"] - mem["alias_bytes"])
    mflops = model_flops(cfg, shape)
    hlo_flops_global = rep.flops * n_dev
    return {
        **tag, "mesh_desc": describe(mesh), "status": "ok",
        "kind": shape.kind, "device": dev.type, "trace_s": trace_s,
        "memory": mem, "fits_hbm": mem["per_device_total"] <= HBM_BYTES,
        "xla_cost_analysis": None,
        "roofline": roofline_terms(rep, n_dev),
        "collectives": rep.detail["collectives"],
        "model_flops_global": mflops,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": (mflops / hlo_flops_global
                               if hlo_flops_global else 0.0),
        "top_dots": [[f, n] for f, n in rep.detail["top_dots"]],
        "top_bytes": [[b, n] for b, n in rep.detail["top_bytes"]],
        "rules": rules.describe(),
        "kernels": rep.detail["kernels"],
        "kernel_flops": _kernel_flops(rep),
        "unknown_ops": rep.detail["unknown_ops"],
        "replicated_kernels": rep.detail["replicated_kernels"],
        "whole_stacked_moves": stacked_moves_of(
            rep, split_stacked_shapes(arch, rules, mesh)),
        **trace_summary(step_trace(prog.name, rep)),
        "costed_rank": dist.get_rank() if dist.is_initialized() else 0,
        "costed_coordinate": list(coord) if coord is not None else None,
        "options": {"accum_steps": opts.accum_steps,
                    "moment_dtype": opts.moment_dtype, "chunk": opts.chunk},
    }


def trace_summary(trace: Dict[str, Any]) -> Dict[str, Any]:
    """The count of a desim trace's ops (``trace_ops``) and its
    collective ops' count and bytes by kind (``trace_collectives``)."""
    kinds: Dict[str, Dict[str, float]] = {}
    for op in trace["ops"]:
        if op["kind"] != "compute":
            k = kinds.setdefault(op["kind"], {"count": 0, "bytes": 0.0})
            k["count"] += 1
            k["bytes"] += op["coll_bytes"]
    return {"trace_ops": len(trace["ops"]), "trace_collectives": kinds}


def _kernel_flops(rep: StepReport) -> Dict[str, float]:
    """Per-device flops of each kernel's calls, by kernel."""
    out: Dict[str, float] = {}
    for name, flops, _ in rep.detail["ops"]:
        if name.startswith("repro_torch."):
            k = name.split(".")[1]
            out[k] = out.get(k, 0.0) + flops
    return out


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0) -> Iterator[None]:
    """PyTorch's fake process group of ``world`` ranks, this process rank
    ``rank`` (its collectives return at once and move nothing),
    destroyed on exit.  Raises if a process group is already
    initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_matrix(single_pod_only: bool = False,
               out_dir: str = "results/dryrun_torch", archs=None,
               shapes=None, device=None, jobs: int = 1) -> list:
    """Every (arch x shape) cell on the single-pod mesh and, unless
    ``single_pod_only``, the multi-pod one, each mesh under its own fake
    process group, as its ``costed_rank``; one JSON file a cell and
    ``summary.json`` in ``out_dir``.  ``jobs`` > 1 spreads the cells over
    that many worker processes, each with its own fake process group
    (the cells share nothing).  Exits 1 if a cell FAILED."""
    os.makedirs(out_dir, exist_ok=True)
    archs = archs or sorted(REGISTRY)
    shapes = shapes or list(SHAPES)
    rows = []
    for multi in ([False] if single_pod_only else [False, True]):
        cells = [(arch, shape, multi, device, out_dir)
                 for arch in archs for shape in shapes]
        if jobs > 1:
            import concurrent.futures
            import multiprocessing
            with concurrent.futures.ProcessPoolExecutor(
                    jobs, mp_context=multiprocessing.get_context("spawn"),
                    initializer=_start_worker,
                    initargs=(512 if multi else 256,
                              costed_rank(multi))) as pool:
                rows += list(pool.map(_matrix_cell, cells))
        else:
            with fake_process_group(512 if multi else 256,
                                    costed_rank(multi)):
                rows += [_matrix_cell(c) for c in cells]
            _MESHES.clear()
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_fail = sum(r["status"] == "FAILED" for r in rows)
    print(f"\n== dry-run matrix: {n_ok} ok / {n_skip} skipped "
          f"(documented) / {n_fail} FAILED ==")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(rows, f, indent=1)
    if n_fail:
        raise SystemExit(1)
    return rows


_MESHES: Dict[str, Any] = {}        # a process's production meshes


def _start_worker(world: int, rank: int) -> None:
    """A matrix worker's fake process group, for the process's life."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _matrix_cell(cell) -> Dict[str, Any]:
    """One cell of the matrix under the process's fake process group,
    its JSON written and its line printed; an exception is the cell's
    FAILED status."""
    arch, shape, multi, device, out_dir = cell
    tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
    dev = device or default_device(SHAPES[shape].kind)
    try:
        key = f"{dev} {multi}"
        if key not in _MESHES and cell_runnable(get_config(arch),
                                                SHAPES[shape])[0]:
            _MESHES[key] = make_production_mesh(
                multi_pod=multi, device_type=torch.device(dev).type)
        res = dryrun_cell(arch, shape, multi, mesh=_MESHES.get(key),
                          device=dev)
    except Exception as e:  # a failure is a sharding bug
        res = {"arch": arch, "shape": shape,
               "mesh": "multi" if multi else "single",
               "status": "FAILED", "error": repr(e)[:500]}
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    print(summary_line(tag, res), flush=True)
    return res


def summary_line(tag: str, res: Dict[str, Any]) -> str:
    if res["status"] != "ok":
        return (f"{tag:55s} {res['status']}: "
                f"{res.get('why', res.get('error', ''))[:110]}")
    r = res["roofline"]
    return (f"{tag:55s} ok  trace={res['trace_s']:6.1f}s "
            f"mem={res['memory']['per_device_total'] / 1e9:6.2f}GB "
            f"dom={r['dominant']:10s} bound={r['bound_s']:9.4f}s "
            f"useful={res['useful_flops_ratio']:.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(REGISTRY))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for --all (default 1)")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="the fake tensors' device (default: cuda, and cpu "
                         "for train cells on a host with no card)")
    args = ap.parse_args(argv)
    if args.all:
        run_matrix(args.single_pod_only, args.out, device=args.device,
                   jobs=args.jobs)
        return
    if not args.arch or not args.shape:
        ap.error("--arch/--shape required unless --all")
    with fake_process_group(512 if args.multi_pod else 256,
                            costed_rank(args.multi_pod)):
        res = dryrun_cell(args.arch, args.shape, args.multi_pod,
                          device=args.device)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
