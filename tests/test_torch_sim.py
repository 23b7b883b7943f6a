"""The port's simulator (``repro_torch.core.desim``, ``repro_torch.sim``)
against the reference it was copied from (``repro.core.desim``,
``repro.sim``), on the CPU.

* Each copied module's source equals its original below the module
  docstring, import lines renamed, but in ``MAY_DIFFER``: the machine
  (the card's defaults and catalog), the boards (``h100_card``,
  ``h100_fleet``; the ``v5e_*`` boards on the reference's catalog), the
  trace (no HLO parsers) and the two package ``__init__``s.  The fleet,
  sampling, SimPoint and checkpoint-library modules and the fleet's
  control plane (``serve/fleet.py``, ``serve/fleet_policy.py``) are
  copies too; only XLA's HLO cost model is not copied.
* The five golden runs of ``tests/test_golden_stats.py``, built from
  the port's copies, render ``tests/golden/*.txt`` line for line.
* ``DesimBackend(board=v5e_pod(), record_stats=True)`` equals JAX's to
  the 1 ns tick, with equal ``stats`` and ``stats_text``: on a
  one-region report through JAX's own ``DesimBackend``, and on a meshed
  smoke step's trace (its collectives) through JAX's ``Simulator``.
* ``workers=2`` on a 2-pod board equals ``workers=1`` and JAX's
  makespan (fork, in a subprocess with ``jax`` and ``repro`` blocked).
* On ``h100_card()`` one region takes ``max(flops / (989e12 * 0.85),
  bytes / (3.35e12 * 0.8))`` to the tick; ``launch/dryrun.py``'s
  roofline constants are the card's catalog entry's.
"""

import difflib
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import test_golden_stats as tg
from test_torch_isolation import _body
from repro.core import fidelity as jf
from repro.core.desim.trace import HloTrace as JaxHloTrace
from repro.core.desim.trace import TraceOp as JaxTraceOp
from repro.sim import Simulator as JaxSimulator
from repro.sim import v5e_multipod as jax_v5e_multipod
from repro.sim import v5e_pod as jax_v5e_pod
from repro_torch import sim as ps
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import fidelity as tf
from repro_torch.core.desim.machine import H100_SXM, default_cluster
from repro_torch.core.desim.simnodes import TICKS_PER_S
from repro_torch.core.desim.trace import analytic_trace
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.ft_policy import FTPolicy

ROOT = Path(__file__).resolve().parents[1]
TICK = 1.0 / TICKS_PER_S

COPIES = ["core/events.py", "core/ports.py", "core/trace.py",
          "core/desim/__init__.py", "core/desim/dtypes.py",
          "core/desim/machine.py", "core/desim/network.py",
          "core/desim/collectives.py", "core/desim/trace.py",
          "core/desim/simnodes.py", "core/desim/timing.py",
          "core/desim/executor.py", "core/desim/parallel.py",
          "sim/__init__.py", "sim/boards.py", "sim/instrument.py",
          "sim/workloads.py", "sim/serialize.py", "sim/simulator.py",
          "sim/parallel.py", "sim/fleet.py", "sim/sampling.py",
          "sim/fingerprint.py", "sim/ckptlib.py", "serve/fleet.py",
          "serve/fleet_policy.py"]
MAY_DIFFER = ["core/desim/machine.py", "sim/boards.py", "core/desim/trace.py",
              "core/desim/__init__.py", "sim/__init__.py"]
# XLA's HLO text cost model: the port has no HLO, and its dry run costs a
# step's ops with core/op_cost.py instead
NOT_COPIED = ["core/desim/hlo_cost.py"]


@pytest.mark.parametrize("rel", [r for r in COPIES if r not in MAY_DIFFER])
def test_copies_equal_their_originals(rel):
    copy = ROOT / "src" / "repro_torch" / rel
    orig = ROOT / "src" / "repro" / rel
    assert _body(copy) == _body(orig)
    mod = rel[:-3].replace("/", ".")
    assert copy.read_text().startswith(f'"""A copy of ``repro.{mod}``')


def test_listed_copies_exist_and_the_rest_are_not_copied():
    port = ROOT / "src" / "repro_torch"
    assert all((port / r).is_file() for r in COPIES)
    assert not any((port / r).exists() for r in NOT_COPIED)
    assert set(MAY_DIFFER) <= set(COPIES)


def test_sim_exports_every_name_of_the_reference():
    """``repro_torch.sim`` exports every name of ``repro.sim.__all__``,
    plus the card's boards; ``repro_torch.serve`` the fleet's control
    plane beside the server."""
    import repro.serve as jserve
    import repro.sim as jsim
    from repro_torch import serve as pserve
    assert set(ps.__all__) == set(jsim.__all__) | {"h100_card", "h100_fleet"}
    assert all(hasattr(ps, n) for n in ps.__all__)
    assert set(jserve.__all__) <= set(dir(pserve))


# --- the goldens --------------------------------------------------------

def _serve_workload(board):
    cost = ps.ServingCost.from_params(7e9, layers=32, d_model=4096,
                                      chips=board.machine.num_chips)
    reqs = ps.poisson_requests(12, 40.0, seed=7, prompt_len=(32, 128),
                               decode_len=(8, 24))
    return ps.ServeSim(cost=cost, requests=reqs, slots=4, seq_capacity=256,
                       slo_ttft_s=0.01, slo_latency_s=1.0)


def _train_workload(board):
    pol = FTPolicy(get_config("deepseek-67b"), num_steps=20,
                   ckpt_interval=5, pods=2,
                   chips_per_pod=board.machine.pod.num_chips,
                   dead_after_misses=1)
    cost = ps.TrainStepCost.from_params(1e9, tokens_per_batch=100_000,
                                        chips=board.machine.num_chips)
    return ps.TrainSim(cost=cost, policy=pol,
                       schedule=board.failure_schedule)


def _mixed_trace(tail=False):
    return analytic_trace("golden", 6, 1e12, 1e9, tg.COLLS,
                          tail_collectives=tg.DCN_TAIL if tail else ())


# ``tests/test_golden_stats.py``'s CASES, built from the port's copies
CASES = {
    "pod_torus": (lambda: ps.v5e_pod(), lambda b: _mixed_trace()),
    "multipod_dcn": (lambda: ps.v5e_multipod(2),
                     lambda b: _mixed_trace(True)),
    "straggler": (lambda: ps.v5e_straggler(2, 2.0),
                  lambda b: _mixed_trace(True)),
    "serve_sim": (lambda: ps.v5e_serving(4, 4), _serve_workload),
    "train_sim": (lambda: ps.v5e_unreliable(2, seed=5, horizon=120,
                                            mtbf=30.0, repair=(5, 15),
                                            nx=8, ny=8),
                  _train_workload),
}


def _render(name: str) -> str:
    """``test_golden_stats._render`` on the port's simulator."""
    board_fn, workload_fn = CASES[name]
    board = board_fn()
    sim = ps.Simulator(board, workload_fn(board), record_stats=True)
    res = sim.run_to_completion()
    stats = dict(res.stats)
    if sim.workload is not None:
        stats.update(sim.workload.stats.flat())
    lines = [f"case: {name}",
             f"board: {board.name}",
             f"final_tick: {int(round(res.makespan_s * TICKS_PER_S))}",
             f"events: {res.events}",
             "---------- Begin Simulation Statistics ----------"]
    for k, v in sorted(stats.items()):
        lines.append(f"{k:<48} {tg._fmt(v)}")
    lines.append("---------- End Simulation Statistics ----------")
    return "\n".join(lines) + "\n"


def test_golden_cases_are_the_references():
    assert sorted(CASES) == sorted(tg.CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_stats_of_the_copy(name):
    want = (Path(tg.GOLDEN_DIR) / f"{name}.txt").read_text()
    got = _render(name)
    assert got == want, "\n".join(difflib.unified_diff(
        want.splitlines(), got.splitlines(), "golden", "port",
        lineterm=""))


# --- DesimBackend against JAX's ------------------------------------------

@pytest.mark.parametrize("flops,nbytes", [(3.0e12, 2.0e9), (1.0e9, 5.0e9)],
                         ids=["compute-bound", "bytes-bound"])
def test_one_region_matches_jax_desim(flops, nbytes):
    """One region (a report with no collective): JAX's ``DesimBackend``
    parses one HLO instruction into one region holding the totals."""
    hlo = "ENTRY e {\n  ROOT %p = f32[8]{0} parameter(0)\n}\n"
    jrep = jf.StepReport("dryrun", "one", flops=flops, bytes_accessed=nbytes,
                         detail={"hlo": hlo})
    want = jf.DesimBackend(board=jax_v5e_pod(), record_stats=True).run(
        jf.StepProgram("one", None, None), dryrun_report=jrep)
    rep = tf.StepReport("dryrun", "one", flops=flops, bytes_accessed=nbytes)
    got = tf.DesimBackend(board=ps.v5e_pod(), record_stats=True).run(
        tf.StepProgram("one", None, ()), dryrun_report=rep)
    assert got.predicted_step_s == pytest.approx(want.predicted_step_s,
                                                 abs=TICK / 2)
    assert got.detail["stats"] == want.detail["stats"]
    assert got.detail["stats_text"] == want.detail["stats_text"]


@pytest.fixture(scope="module")
def meshed():
    """smoke(stablelm-1.6b)'s prefill at 4 x 32 tokens on the (2, 2) mesh
    of a 4-rank fake process group (rank 0): its program and report."""
    real = dr.get_config
    dr.get_config = lambda a: smoke(get_config(a))
    shape = ShapeConfig("prefill_32k", 32, 4, "prefill")
    try:
        with dr.fake_process_group(4):
            mesh = make_mesh((2, 2), ("data", "model"), "cuda")
            prog, _, _ = dr.build_program("stablelm-1.6b", "prefill_32k",
                                          mesh, device="cuda", shape=shape)
            rep = tf.DryRunBackend().run(prog)
    finally:
        dr.get_config = real
    assert rep.detail["stream_collectives"], "no collective on the mesh"
    return prog, rep


def test_meshed_trace_matches_jax_simulator(meshed):
    """The meshed step's trace, collectives included, on the port's
    ``v5e_pod()`` through ``DesimBackend`` and on JAX's through its
    ``Simulator``: the same makespan, stats and stats text."""
    prog, rep = meshed
    got = tf.DesimBackend(board=ps.v5e_pod(), record_stats=True).run(
        prog, dryrun_report=rep)
    ops = got.detail["trace"]["ops"]
    assert any(o["kind"] != "compute" for o in ops)
    sim = JaxSimulator(jax_v5e_pod(), JaxHloTrace(
        name=prog.name, ops=[JaxTraceOp(**o) for o in ops],
        meta={"total_flops": rep.flops, "total_bytes": rep.bytes_accessed}),
        record_stats=True)
    want = sim.run_to_completion()
    assert got.predicted_step_s == pytest.approx(want.makespan_s,
                                                 abs=TICK / 2)
    assert got.detail["stats"] == want.stats
    assert got.detail["stats_text"] == sim.sim_root.stats.dump_text()


def test_default_board_is_the_card_for_the_mesh(meshed):
    """With no board, the program's (2, 2) mesh gives a pod of 4 cards
    (a ring), where the collectives take time beyond the regions'."""
    prog, rep = meshed
    m = default_cluster(prog.mesh)
    assert (m.num_pods, m.pod.nx, m.pod.ny, m.num_chips) == (1, 4, 1, 4)
    assert m.pod.chip.peak_flops == 989e12 and m.pod.ici.bw == 450e9
    got = tf.get_backend("desim").run(prog, dryrun_report=rep)
    ops = got.detail["trace"]["ops"]
    compute = sum(max(o["flops"] / (989e12 * 0.85),
                      o["bytes"] / (3.35e12 * 0.8))
                  for o in ops if o["kind"] == "compute")
    assert got.predicted_step_s > compute + TICK * len(ops)
    assert got.detail["desim"].makespan_s == got.predicted_step_s


def test_default_cluster_without_a_mesh_and_with_pods():
    one = default_cluster()
    assert (one.num_pods, one.num_chips) == (1, 1)
    assert one.pod.chip.hbm_bw == 3.35e12 and one.pod.chip.hbm_bytes == 80e9
    mesh = SimpleNamespace(shape=(2, 4, 2),
                           mesh_dim_names=("pod", "data", "model"))
    two = default_cluster(mesh)
    assert (two.num_pods, two.pod.nx, two.pod.ny, two.num_chips) == (
        2, 8, 1, 16)


# --- workers ------------------------------------------------------------

WORKERS = r"""
import json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
from repro_torch.core import fidelity as tf
from repro_torch.core.desim.parallel import default_mp_context
from repro_torch.core.desim.trace import HloTrace, TraceOp
from repro_torch.sim import parallel_supported, v5e_multipod
rep, board_kw = json.loads(sys.argv[1])
rep = tf.StepReport("dryrun", "w", flops=rep["flops"],
                    bytes_accessed=rep["bytes"],
                    detail={"ops": [tuple(o) for o in rep["ops"]],
                            "stream_collectives": [
                                tuple(c) for c in rep["cuts"]]})
prog = tf.StepProgram("w", None, ())
trace = tf.step_trace("w", rep)
board = v5e_multipod(**board_kw)
par = parallel_supported(board, HloTrace("w", [TraceOp(**o)
                                               for o in trace["ops"]]))
out = {str(w): tf.DesimBackend(board=v5e_multipod(**board_kw),
                               workers=w).run(
           prog, dryrun_report=rep).predicted_step_s for w in (1, 2)}
print("JSON" + json.dumps({"makespan": out, "parallel": par,
                           "start": default_mp_context(), "trace": trace}))
"""


def test_two_workers_equal_one_and_jax():
    ops = [["mm", 2.0e12, 4.0e9], ["add", 1.0e9, 2.0e9],
           ["mm", 1.0e12, 1.0e9]]
    rep = {"flops": 3.001e12, "bytes": 7.0e9, "ops": ops,
           "cuts": [[1, "all-reduce", 2.0e8, 32],
                    [2, "all-gather", 5.0e7, 16]]}
    board_kw = {"num_pods": 2, "nx": 4, "ny": 4}
    out = subprocess.run(
        [sys.executable, "-c", WORKERS, json.dumps([rep, board_kw])],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.split("JSON", 1)[1])
    assert res["parallel"] and res["start"] == "fork"
    assert res["makespan"]["2"] == res["makespan"]["1"]
    trace = res["trace"]
    want = JaxSimulator(jax_v5e_multipod(**board_kw), JaxHloTrace(
        name="w", ops=[JaxTraceOp(**{**o, "deps": tuple(o.get("deps", ()))})
                       for o in trace["ops"]])).run_to_completion()
    assert res["makespan"]["1"] == pytest.approx(want.makespan_s,
                                                 abs=TICK / 2)


# --- the card -----------------------------------------------------------

@pytest.mark.parametrize("flops,nbytes", [(4.0e13, 1.0e9), (1.0e9, 6.0e9)],
                         ids=["compute-bound", "bytes-bound"])
def test_one_region_on_the_card_is_its_roofline(flops, nbytes):
    board = ps.h100_card()
    assert (board.name, board.algorithm, board.machine.num_chips) == (
        "h100_card_1", "ring", 1)
    rep = tf.StepReport("dryrun", "one", flops=flops, bytes_accessed=nbytes)
    got = tf.DesimBackend(board=board).run(tf.StepProgram("one", None, ()),
                                           dryrun_report=rep)
    want = max(flops / (989e12 * 0.85), nbytes / (3.35e12 * 0.8))
    assert got.predicted_step_s == pytest.approx(want, abs=TICK)
    res = ps.Simulator(ps.h100_card(), analytic_trace(
        "one", 1, flops, nbytes, [])).run_to_completion()
    assert res.makespan_s == got.predicted_step_s


def test_card_board_scales_and_overrides():
    """``h100_card(n)``: a ring of n cards on NVLink; a component override
    (doubled HBM bandwidth) halves a bytes-bound region."""
    eight = ps.h100_card(8)
    assert (eight.machine.num_chips, eight.machine.pod.nx,
            eight.machine.pod.ny) == (8, 8, 1)
    assert ps.get_board("h100_card", n=2).machine.num_chips == 2
    t = analytic_trace("b", 1, 1.0e9, 6.0e9, [])
    base = ps.h100_card().executor().execute(t).makespan_s
    fast = ps.h100_card(chip={"hbm_bw": 2 * H100_SXM["hbm_bw"]}).executor(
        ).execute(t).makespan_s
    assert fast == pytest.approx(base / 2, abs=TICK)
    ar = analytic_trace("ar", 1, 0.0, 0.0, [
        {"kind": "all-reduce", "bytes": 1.0e9, "participants": 8}])
    got = ps.h100_card(8).executor().execute(ar).makespan_s
    want = 2 * 7 / 8 * 1.0e9 / 450e9 + 2 * 7 * 1e-6
    assert got == pytest.approx(want, abs=2 * TICK)


def test_dryrun_constants_are_the_cards_catalog(meshed):
    """``launch/dryrun.py``'s roofline constants are ``H100_SXM``'s, the
    same numbers as the datasheet's, and a cell's roofline terms are
    those numbers' quotients."""
    assert (dr.PEAK_FLOPS, dr.HBM_BW, dr.NVLINK_BW, dr.HBM_BYTES) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert (H100_SXM["peak_flops"], H100_SXM["hbm_bw"],
            H100_SXM["nvlink_bw"], H100_SXM["hbm_bytes"]) == (
        dr.PEAK_FLOPS, dr.HBM_BW, dr.NVLINK_BW, dr.HBM_BYTES)
    _, rep = meshed
    r = dr.roofline_terms(rep, 4)
    assert rep.collective_bytes > 0
    assert r["compute_s"] == rep.flops / 989e12
    assert r["memory_s"] == rep.bytes_accessed / 3.35e12
    assert r["collective_s"] == rep.collective_bytes / 450e9
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"])
