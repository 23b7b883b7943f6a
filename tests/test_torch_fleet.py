"""The port's fleet (``repro_torch.sim.fleet``, ``repro_torch.serve.fleet``
and ``fleet_policy``) against the reference it was copied from, its
serving examples against theirs, and the card's fleet board, on the CPU.

* One seeded flash crowd (120 requests) on ``v5e_fleet(6, 4, 4)`` at
  atomic timing, once for each router, through both packages: equal
  ``summary()``, ``feed`` and decision logs; a ``FleetController`` of
  each package replays the other's feed to the same log.
* ``h100_fleet``: independent pods of H100 cards, quantum 0, the ring
  algorithm, its name in ``BOARDS``.
* ``launch.dryrun.decode_serving_cost`` on smoke(stablelm-1.6b): the
  fitted ``ServingCost`` gives back its decode dry run's flops and bytes.
* ``examples/serve_sim_torch.py`` and ``fleet_sim_torch.py``, run with
  ``jax`` and ``repro`` blocked from a temporary working directory,
  print their originals' lines; ``serve_batch_torch.py --cpu`` checks the
  batched output against a sequential greedy decode, and without
  ``--cpu`` it raises where there is no card.
"""

import contextlib
import dataclasses
import io
import math
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.serve as jserve
import repro.sim as jsim
from repro.core.desim.simnodes import to_ticks as jax_to_ticks
from repro_torch import serve as pserve
from repro_torch import sim as ps
from repro_torch.configs import get_config, smoke
from repro_torch.core.desim.simnodes import to_ticks
from repro_torch.launch import dryrun as dr
from repro_torch.serve.fleet_policy import ROUTERS

ROOT = Path(__file__).resolve().parents[1]

BLOCKED_RUN = r"""
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def run_blocked(script: Path, *args: str, cwd: Path) -> str:
    """``script`` in a subprocess with every import of ``jax`` and
    ``repro`` made to fail; its standard output."""
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(script), *args],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def run_original(script: Path, cwd: Path, monkeypatch) -> str:
    """A reference example run in this process from ``cwd``."""
    monkeypatch.chdir(cwd)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(script), run_name="__main__")
    return buf.getvalue()


# --- FleetSim against JAX's ----------------------------------------------

def _fleet(m, serve, to_ticks_, router):
    """The seeded flash crowd through package ``m``'s FleetSim."""
    def policy():
        return serve.FleetPolicy(
            router, min_replicas=2, max_replicas=6, slots_per_replica=4,
            cold_start_ticks=to_ticks_(0.5),
            control_period_ticks=to_ticks_(0.25), seed=5)
    reqs = m.flash_crowd_requests(120, seed=3, base_rps=20.0,
                                  crowd_rps=120.0, crowd_start_s=0.5,
                                  crowd_len_s=1.0, prefix_groups=4)
    cost = m.ServingCost.from_params(7e9, layers=32, d_model=4096, chips=16)
    fleet = m.FleetSim(cost=cost, requests=reqs, policy=policy(),
                       seq_capacity=1024, slo_ttft_s=0.3, slo_latency_s=2.0,
                       tenant_slo={"batch": 4.0})
    for _ in m.Simulator(m.v5e_fleet(6, 4, 4), fleet,
                         timing="atomic").run():
        pass
    return fleet, policy, reqs


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def _log(decisions):
    return [dataclasses.astuple(d) for d in decisions]


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_fleet_matches_jax_for_each_router(router):
    assert sorted(ROUTERS) == sorted(jserve.fleet_policy.ROUTERS)
    got, policy, reqs = _fleet(ps, pserve, to_ticks, router)
    want, jpolicy, jreqs = _fleet(jsim, jserve, jax_to_ticks, router)
    assert got.summary()["requests"] == 120
    assert _same(got.summary(), want.summary())
    assert got.feed == want.feed
    log = _log(got.policy.decisions)
    assert log == _log(want.policy.decisions)
    assert {"route", "finish", "scale_up"} <= {d.kind for d in
                                               got.policy.decisions}
    # each package's controller replays the other's feed
    ctl = pserve.FleetController(policy())
    ctl.replay(want.feed, jreqs)
    assert _log(ctl.policy.decisions) == log
    jctl = jserve.FleetController(jpolicy())
    jctl.replay(got.feed, reqs)
    assert _log(jctl.policy.decisions) == log


# --- the card's fleet board --------------------------------------------

def test_h100_fleet_is_pods_of_cards():
    board = ps.h100_fleet(6, 2)
    m = board.machine
    assert (board.name, board.algorithm, board.timing) == (
        "h100_fleet_6x2", "ring", "detailed")
    assert (m.num_pods, m.pod.nx, m.pod.ny, m.num_chips) == (6, 2, 1, 12)
    assert m.quantum_ns == 0
    assert m.pod.chip.peak_flops == 989e12 and m.pod.chip.hbm_bw == 3.35e12
    assert m.pod.ici.bw == 450e9
    one = ps.get_board("h100_fleet", timing="atomic")
    assert (one.name, one.machine.num_pods, one.machine.num_chips,
            one.timing) == ("h100_fleet_8x1", 8, 8, "atomic")
    assert ps.BOARDS["h100_fleet"] is ps.h100_fleet
    # one replica's pod of the fleet is the card's board
    assert m.pod.serialize() == ps.h100_card(2).machine.pod.serialize()


# --- the decode step's fit --------------------------------------------

def test_decode_fit_gives_back_its_dry_run():
    cost, rep, weight_bytes = dr.decode_serving_cost(
        smoke(get_config("stablelm-1.6b")), 4, 64, device="cpu")
    flops, nbytes = cost.decode_cost(4, 4 * 64)
    assert flops == pytest.approx(rep.flops, rel=1e-9)
    assert nbytes == pytest.approx(rep.bytes_accessed, rel=1e-9)
    assert cost.weight_bytes == weight_bytes < rep.bytes_accessed
    assert cost.kv_bytes_per_token > 0 and cost.chips == 1
    assert rep.detail["kernels"] == {}          # the CPU runs plain paths


# --- the examples -------------------------------------------------------

@pytest.mark.parametrize("name", ["serve_sim", "fleet_sim"])
def test_example_prints_its_originals_lines(name, tmp_path, monkeypatch):
    got = run_blocked(ROOT / "examples" / f"{name}_torch.py", cwd=tmp_path)
    want = run_original(ROOT / "examples" / f"{name}.py", tmp_path,
                        monkeypatch)
    assert got.splitlines() == want.splitlines()
    assert got.strip().splitlines()[-1].endswith("smoke OK")


def test_serve_batch_on_the_cpu(tmp_path):
    out = run_blocked(ROOT / "examples" / "serve_batch_torch.py", "--cpu",
                      cwd=tmp_path)
    lines = out.strip().splitlines()
    assert lines[-1] == "serve_batch OK", out
    assert "batched output == sequential greedy decode for request 0" in lines
    assert lines[0].startswith("served 7 requests") and "on cpu" in lines[0]


def test_serve_batch_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    example = runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example["main"]([])
