"""The desim trace of a meshed step (``repro_torch.core.fidelity.
step_trace``) against ``repro.core.desim.trace.HloTrace.from_hlo_text``,
on the CPU.

The port's dry run sees each collective at its place in the op stream
(``CostMode.stream_collectives``); ``step_trace`` cuts the stream there,
as JAX's trace cuts the compiled HLO at its collectives.  Two smoke
cells under ``launch/dryrun.py``'s layouts on a (2, 2) mesh of
PyTorch's fake process group: stablelm's train step (fake CPU tensors)
and olmoe's prefill (fake CUDA tensors, the kernel path):

* the trace's collective ops sum, by kind, to the report's
  ``collectives`` in count and bytes, each with its group's size as
  ``participants``; its compute regions' flops and bytes sum to the
  report's totals; regions and collectives alternate, each op after
  the first depending on the one before;
* replayed on the port's copy of ``v5e_pod()`` (``repro_torch.sim``)
  by ``DesimBackend``, its makespan is longer than that of the same
  trace with its collectives taken out;
* JAX's trace of the same cell (a subprocess compiling the JAX dry run
  for 4 host devices, as ``tests/test_torch_dryrun.py``'s smoke
  parity): ``overlap`` and ``scope`` as the port sets them, the same
  group sizes; the per-kind op counts and bytes of both traces and
  their makespans are printed side by side.  JAX's trace holds a loop
  body's collectives once (the HLO text's instructions), its dry run's
  ``collectives`` each as many times as the loop runs: the port's
  per-kind bytes are held at or under the dry run's.
"""

import json
import math

import pytest

import test_torch_dryrun as td
from repro_torch.configs import SHAPES, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.desim.trace import HloTrace, TraceOp
from repro_torch.core.fidelity import DesimBackend, DryRunBackend, step_trace
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.sim import Simulator, v5e_pod

# (arch, shape name, (seq, batch)); the batch divides the 2 data ranks
CELLS = [("stablelm-1.6b", "train_4k", (32, 8)),
         ("olmoe-1b-7b", "prefill_32k", (32, 4))]

JAX_TRACE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
assert len(jax.devices()) == 4
import repro.launch.dryrun as jd
from repro.configs import ShapeConfig, smoke
from repro.core.desim.trace import HloTrace
from repro.launch.mesh import make_mesh
from repro.sim import Simulator, v5e_pod

cells = json.loads(sys.argv[1])
real_get_config = jd.get_config
jd.get_config = lambda a: smoke(real_get_config(a))
shapes = {n: ShapeConfig(n, s, b, kind) for _, n, (s, b), kind in cells}
jd.get_shape = lambda n: shapes[n]
hlo = {}
real_analyze = jd.analyze_hlo
def analyze(text):
    hlo["last"] = text
    return real_analyze(text)
jd.analyze_hlo = analyze
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch, name, _, _ in cells:
    res = jd.dryrun_cell(arch, name, mesh=mesh)
    r = res["roofline"]
    trace = HloTrace.from_hlo_text(
        hlo["last"], name=arch, total_flops=r["hlo_flops_per_device"],
        total_bytes=r["hlo_bytes_per_device"])
    colls = [o for o in trace.ops if o.kind != "compute"]
    kinds = {}
    for o in colls:
        k = kinds.setdefault(o.kind, {"count": 0, "bytes": 0.0})
        k["count"] += 1
        k["bytes"] += o.coll_bytes
    out[arch] = {
        "ops": len(trace.ops), "kinds": kinds,
        "participants": sorted({o.participants for o in colls}),
        "overlap": sorted({o.overlap for o in colls}),
        "scope": sorted({o.scope for o in colls}),
        "makespan_s": Simulator(v5e_pod(), trace).run_to_completion()
        .makespan_s,
        "collectives": res["collectives"]}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_traces():
    """JAX's traces of ``CELLS``, from one subprocess started with the
    port's dry runs (``port_traces``); the result on first use."""
    proc = td._spawn(JAX_TRACE, json.dumps(
        [(a, n, sb, SHAPES[n].kind) for a, n, sb in CELLS]))
    done = {}

    def get():
        if not done:
            done.update(td._result(proc))
        return done
    yield get
    if proc.poll() is None:
        proc.kill()


def _replay(trace):
    """The trace's makespan on the port's ``v5e_pod()``."""
    t = HloTrace(name=trace["name"],
                 ops=[TraceOp(**op) for op in trace["ops"]])
    return Simulator(v5e_pod(), t).run_to_completion().makespan_s


@pytest.fixture(scope="module")
def port_traces(jax_traces):
    """Each cell's program, dry-run report and trace on the (2, 2) mesh
    of a 4-rank fake process group (rank 0); the JAX subprocess runs
    meanwhile."""
    real = dr.get_config, dr.SHAPES
    dr.get_config = lambda a: smoke(get_config(a))
    out = {}
    try:
        for arch, name, sb in CELLS:
            dr.SHAPES = {**SHAPES, name: ShapeConfig(name, *sb,
                                                     SHAPES[name].kind)}
            dev = dr.default_device(SHAPES[name].kind)
            with dr.fake_process_group(4):
                mesh = make_mesh((2, 2), ("data", "model"), dev)
                prog, _, _ = dr.build_program(arch, name, mesh, device=dev)
                rep = DryRunBackend().run(prog)
            out[arch] = prog, rep, step_trace(prog.name, rep)
    finally:
        dr.get_config, dr.SHAPES = real
    return out


def _by_kind(trace):
    return dr.trace_summary(trace)["trace_collectives"]


@pytest.mark.parametrize("arch", [a for a, _, _ in CELLS])
def test_trace_cuts_the_stream_at_each_collective(port_traces, arch):
    """Per kind, the trace's collective ops are the report's
    ``collectives`` (count and operand bytes), with the group sizes as
    ``participants``; the regions hold the report's flops and bytes;
    region, collective, region, ... with each op depending on the one
    before; every op builds a ``TraceOp``."""
    _, rep, trace = port_traces[arch]
    ops = trace["ops"]
    want = rep.detail["collectives"]
    assert want, "a meshed step with no collective"
    assert _by_kind(trace) == {k: {"count": c["count"], "bytes": c["bytes"]}
                               for k, c in want.items()}
    for o in ops[1::2]:
        assert o["kind"] in want
        assert o["participants"] in want[o["kind"]]["group_sizes"]
        assert (o["overlap"], o["scope"]) == (False, "ici")
    assert sorted({o["participants"] for o in ops[1::2]}) == sorted(
        {n for c in want.values() for n in c["group_sizes"]})
    regions = ops[0::2]
    assert [o["kind"] for o in regions] == ["compute"] * len(regions)
    assert [o["name"] for o in regions] == [f"region{r}"
                                            for r in range(len(regions))]
    assert len(ops) == 2 * sum(c["count"] for c in want.values()) + 1
    assert math.fsum(o["flops"] for o in regions) == rep.flops
    assert math.fsum(o["bytes"] for o in regions) == rep.bytes_accessed
    assert "deps" not in ops[0]
    assert all(o["deps"] == (j,) for j, o in enumerate(ops[1:]))
    assert all(isinstance(TraceOp(**o), TraceOp) for o in ops)


@pytest.mark.parametrize("arch", [a for a, _, _ in CELLS])
def test_meshed_replay_is_longer_than_its_compute(port_traces, jax_traces,
                                                  arch):
    """``DesimBackend`` on the dry run's report: its trace is
    ``step_trace``'s, and its makespan on ``v5e_pod()`` is longer than
    the replay of the compute regions alone, chained.  JAX's trace of
    the same cell: collectives neither overlapping nor leaving the pod,
    on groups of the port's sizes.  The port's per-kind bytes at most
    the JAX dry run's for each kind JAX moves, and in all; the two
    traces' counts, bytes and makespans printed.  One kind is the
    port's alone: olmoe's prefill reduces partial sums over "model"
    (all-reduce, 32896 bytes a device, measured) where XLA's module
    moves its activations by all-to-all (688128 bytes)."""
    prog, rep, trace = port_traces[arch]
    got = DesimBackend(board=v5e_pod()).run(prog, dryrun_report=rep)
    assert got.detail["trace"] == trace
    regions = [dict(o) for o in trace["ops"] if o["kind"] == "compute"]
    for j, o in enumerate(regions):
        o.pop("deps", None)
        if j:
            o["deps"] = (j - 1,)
    compute = _replay({"name": "compute", "ops": regions})
    assert got.predicted_step_s > compute, (got.predicted_step_s, compute)
    want = jax_traces()[arch]
    ours = _by_kind(trace)
    print(f"{arch}: trace ops torch {len(trace['ops'])} JAX {want['ops']}; "
          f"collectives torch {ours} JAX trace {want['kinds']} JAX dry run "
          f"{want['collectives']}; makespan on v5e_pod torch "
          f"{got.predicted_step_s:.6e} s (compute alone {compute:.6e}) JAX "
          f"{want['makespan_s']:.6e} s")
    assert want["overlap"] == [False] and want["scope"] == ["ici"]
    assert want["participants"] == sorted(
        {o["participants"] for o in trace["ops"][1::2]})
    jax_kinds = want["collectives"]
    for kind, c in ours.items():
        if kind in jax_kinds:
            assert c["bytes"] <= jax_kinds[kind]["bytes"], kind
    assert sum(c["bytes"] for c in ours.values()) <= sum(
        c["bytes"] for c in jax_kinds.values())
    assert set(ours) - set(jax_kinds) <= {"all-reduce"}, ours


def test_trace_of_a_row_parallel_linear_by_hand():
    """x (8, 64) and w (64, 32) split over "model" along the contraction
    on the (2, 2) fake mesh, the partial product laid out replicated and
    doubled: region0 is the local (8, 32) @ (32, 32) product (2 * 8 *
    32 * 32 flops, its operands read and result written) and the
    all-reduce's own bytes (its (8, 32) f32 operand read and result
    written); then the all-reduce, 1024 bytes over 2 ranks; region1 the
    doubling (8 * 32 flops, read and write)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core.fidelity import StepProgram, TensorSpec
    from repro_torch.dist.sharding import NamedSharding
    r = Replicate()
    with dr.fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")

        def step(x, w):
            return (x @ w).redistribute(mesh, (r, r)) * 2
        rep = DryRunBackend().run(StepProgram(
            "row-parallel", step, (TensorSpec((8, 64), torch.float32),
                                   TensorSpec((64, 32), torch.float32)),
            device="cuda", mesh=mesh,
            in_shardings=(NamedSharding(mesh, (r, Shard(1))),
                          NamedSharding(mesh, (r, Shard(0))))))
    out = 8 * 32 * 4.0
    assert step_trace("row-parallel", rep)["ops"] == [
        {"kind": "compute", "flops": 2.0 * 8 * 32 * 32,
         "bytes": (8 * 32 + 32 * 32) * 4.0 + out + 2 * out,
         "name": "region0"},
        {"kind": "all-reduce", "coll_bytes": out, "participants": 2,
         "deps": (0,), "overlap": False, "scope": "ici",
         "name": "all-reduce.0"},
        {"kind": "compute", "flops": 8 * 32.0, "bytes": 2 * out,
         "name": "region1", "deps": (1,)}]


def test_a_collectives_wait_is_its_result():
    """The row-parallel step's peak holds the all-reduce's (8, 32) f32
    result once: the wait that follows a collective returns its argument
    (as the real op does), where a fake wait makes a new tensor.  The
    step creates the local product and the reduced result, 1024 bytes
    each, the product freed with the wait's input."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core.fidelity import StepProgram, TensorSpec
    from repro_torch.dist.sharding import NamedSharding
    r = Replicate()
    with dr.fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        rep = DryRunBackend().run(StepProgram(
            "row-parallel", lambda x, w: (x @ w).redistribute(mesh, (r, r)),
            (TensorSpec((8, 64), torch.float32),
             TensorSpec((64, 32), torch.float32)),
            device="cuda", mesh=mesh,
            in_shardings=(NamedSharding(mesh, (r, Shard(1))),
                          NamedSharding(mesh, (r, Shard(0))))))
    out = 8 * 32 * 4.0
    assert rep.memory["output_bytes"] == out
    assert rep.memory["temp_bytes"] == out, rep.memory
