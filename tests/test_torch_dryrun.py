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
  and smoke olmoe (experts split), one cell of each kind.  The port runs
  the same cells on a (2, 2) mesh of PyTorch's fake process group.

In this process: collectives on hand-computed cases, flash's DTensor
strategy on a (2, 2) fake-group mesh, and real production cells under
a 256- and a 512-rank fake process group, each ``ok`` with local costs.
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
shapes = {n: ShapeConfig(n, s, b, kind) for _, n, (s, b), kind in cells}
jd.get_shape = lambda n: shapes[n]
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch, name, _, kind in cells:
    res = jd.dryrun_cell(arch, name, mesh=mesh)
    out[arch] = {"argument_bytes": res["memory"]["argument_bytes"],
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
    smoke_cells = [(a, n, sb, SHAPES[n].kind) for a, n, sb in SMOKE_CELLS]
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

def _smoke_cell(arch, name, seq_batch, mesh):
    shape = ShapeConfig(name, *seq_batch, SHAPES[name].kind)
    real = dr.get_config, dr.SHAPES
    dr.get_config = lambda a: smoke(get_config(a))
    dr.SHAPES = {**SHAPES, name: shape}
    try:
        return dr.dryrun_cell(arch, name, mesh=mesh,
                              device=mesh.device_type)
    finally:
        dr.get_config, dr.SHAPES = real


# per-device flops, the port's over JAX's: measured 1.01666, 0.86150 and
# 0.92083 (torch 2.13, jax 0.9.0), held within 1% of that.  The port
# counts the ops eager PyTorch dispatches with ``op_cost``'s rules, JAX
# what XLA compiled (``hlo_cost``)
SMOKE_FLOPS = {
    # the train step: the rules that put tests/test_torch_fidelity.py's
    # quickstart step at 0.98946, here on each rank's shards (more
    # elementwise ops in the eager backward)
    "stablelm-1.6b": (1.00666, 1.02666),
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
