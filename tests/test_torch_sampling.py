"""The port's sampled simulation, SimPoint and checkpoint library
(``repro_torch.sim.sampling``, ``fingerprint``, ``ckptlib``) against the
reference they were copied from, on the CPU.

* ``sampled_run`` on ``bursty_trace(100)`` on ``v5e_pod()``, with the
  default fixed-stride ``SamplePlan`` and with ``simpoint_plan``'s plan:
  equal plans, makespans to the 1 ns tick and equal stats.
* ``board_digest`` and ``trace_digest`` equal JAX's, so a library written
  by one package checks as valid in the other.
* ``take_region_checkpoints`` in the port, then ``restore_fanout(workers=
  2)`` in a subprocess with ``jax`` and ``repro`` blocked: its regions
  and ``reconstruct`` equal JAX's serial restore of the same library, to
  the tick; the index equals the one JAX writes for the same run.
* ``examples/dse_explore_torch.py`` prints its original's lines.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.sim as jsim
from repro_torch import sim as ps
from repro_torch.core.desim.simnodes import TICKS_PER_S
from test_torch_fleet import run_blocked, run_original

ROOT = Path(__file__).resolve().parents[1]
TICK = 1.0 / TICKS_PER_S
STEPS = 100


@pytest.fixture(scope="module")
def traces():
    return ps.bursty_trace(STEPS), jsim.bursty_trace(STEPS)


@pytest.mark.parametrize("kind", ["stride", "simpoint"])
def test_sampled_run_matches_jax(traces, kind):
    trace, jtrace = traces
    if kind == "stride":
        plan, jplan = ps.SamplePlan(), jsim.SamplePlan()
    else:
        plan = ps.simpoint_plan(trace, window=2, max_k=4, seed=0)
        jplan = jsim.simpoint_plan(jtrace, window=2, max_k=4, seed=0)
        assert len(plan.representatives) >= 2
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    got = ps.sampled_run(ps.v5e_pod(), trace, STEPS, plan)
    want = jsim.sampled_run(jsim.v5e_pod(), jtrace, STEPS, jplan)
    assert got.predicted_total_s == pytest.approx(want.predicted_total_s,
                                                  abs=TICK / 2)
    assert got.stats == want.stats
    assert got.window_step_s == want.window_step_s
    assert (got.detailed_steps, got.events, got.segments) == (
        want.detailed_steps, want.events, want.segments)
    assert got.weighted_total_s == want.weighted_total_s
    assert (got.weighted_total_s is None) == (kind == "stride")


@pytest.mark.parametrize("board", [
    ("v5e_pod", {}), ("v5e_fleet", {"max_replicas": 6, "nx": 4, "ny": 4}),
    ("v5e_multipod", {"num_pods": 2}), ("v5e_degraded", {})],
    ids=lambda b: b[0])
def test_board_digest_matches_jax(board):
    name, kw = board
    assert ps.board_digest(ps.get_board(name, **kw)) == \
        jsim.board_digest(jsim.get_board(name, **kw))


def test_trace_digest_matches_jax(traces):
    trace, jtrace = traces
    assert trace.meta["steps"] == STEPS
    assert ps.trace_digest(trace) == jsim.trace_digest(jtrace)


FANOUT = r"""
import json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
from repro_torch.core.desim.parallel import default_mp_context
from repro_torch.sim import CheckpointLibrary, reconstruct, restore_fanout
lib = CheckpointLibrary(sys.argv[1])
rows = restore_fanout(lib, workers=2)
print("JSON" + json.dumps({"rows": [r.__dict__ for r in rows],
                           "total": reconstruct(rows, lib=lib),
                           "start": default_mp_context()}))
"""


def test_region_fanout_matches_jax_serial_reconstruct(tmp_path):
    """The port writes the library, restores it with two workers in a
    process that cannot import JAX, and JAX restores the same library
    serially: the same regions and total, to the tick."""
    kw = dict(num_steps=60, burst_start=30, burst_len=12, seed=0)
    trace, jtrace = ps.bursty_trace(**kw), jsim.bursty_trace(**kw)
    plan = ps.simpoint_plan(trace, window=2, max_k=4, seed=0)
    jplan = jsim.simpoint_plan(jtrace, window=2, max_k=4, seed=0)
    lib = ps.take_region_checkpoints(ps.v5e_pod(), trace, plan,
                                     str(tmp_path / "port"))
    jsim.take_region_checkpoints(jsim.v5e_pod(), jtrace, jplan,
                                 str(tmp_path / "jax"))
    assert json.loads((tmp_path / "port" / "index.json").read_text()) == \
        json.loads((tmp_path / "jax" / "index.json").read_text())
    assert len(lib.entries) >= 2

    out = subprocess.run(
        [sys.executable, "-c", FANOUT, lib.root], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.split("JSON", 1)[1])
    assert res["start"] == "fork"

    # JAX opens the port's library: same board and trace digests
    theirs = jsim.CheckpointLibrary(lib.root)
    theirs.check_board(jsim.v5e_pod())
    assert theirs.meta["trace_digest"] == jsim.trace_digest(jtrace)
    want = jsim.restore_fanout(theirs, workers=1)
    assert res["rows"] == [r.__dict__ for r in want]
    total = jsim.reconstruct(want, lib=theirs)
    assert res["total"] == pytest.approx(total, abs=TICK / 2)


def test_dse_explore_prints_its_originals_lines(tmp_path, monkeypatch):
    got = run_blocked(ROOT / "examples" / "dse_explore_torch.py",
                      cwd=tmp_path)
    want = run_original(ROOT / "examples" / "dse_explore.py", tmp_path,
                        monkeypatch)
    assert got.splitlines() == want.splitlines()
    assert "analytic estimate" in got.splitlines()[0]
    assert got.strip().splitlines()[-1] == "dse_explore OK"
