"""Prebuilt boards (the gem5 stdlib ``X86DemoBoard`` analogue), copied
from ``repro.sim.boards``: the port imports nothing of the JAX package.
The card's board is the port's own; the ``v5e_*`` boards are the
reference's, kept to hold the copy against it, and set the reference's
catalog (``TPU_V5E``, ``TPU_V5E_LINKS``) explicitly since the port's
machine defaults are the card's.  ``tests/test_torch_sim.py`` names this
file among the copies that may differ from their originals.

"Toward Reproducible and Standardized Computer Architecture Simulation
with gem5" (PAPERS.md) attributes much of the stdlib's usability to
*prebuilt boards*: known-good, named hardware configurations users pass
straight to ``Simulator`` instead of hand-wiring SimObjects.  The g5x
analogue is a catalog of instantiated :class:`ClusterModel`s bundled
with the software-side choices a run needs (collective algorithm,
straggler injection) — everything ``TraceExecutor`` takes beyond the
trace itself.

Boards accept per-component override dicts so DSE sweeps stay
one-liners::

    h100_card(chip={"hbm_bw": 2 * H100_SXM["hbm_bw"]})

Catalog:

* ``h100_card``     — ``n`` NVIDIA H100 SXM5 cards joined by NVLink (one
                      by default), collectives on the ring algorithm:
                      the simulator has no NVSwitch topology.
* ``h100_fleet``    — ``max_replicas`` serving replicas of ``n`` cards
                      each, the card's counterpart of ``v5e_fleet``.
* ``v5e_pod``, ``v5e_multipod``, ``v5e_straggler``, ``v5e_degraded``,
  ``v5e_serving``, ``v5e_fleet``, ``v5e_fleet_big``, ``v5e_unreliable``
                    — the reference's boards, built bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.desim.executor import TraceExecutor
from repro_torch.core.desim.machine import (TPU_V5E, TPU_V5E_LINKS,
                                            ClusterModel)


@dataclass
class Board:
    """A machine plus the run-level knobs ``Simulator`` needs.

    ``failure_schedule``: fault-injection boards (``v5e_unreliable``)
    bundle a seeded :class:`repro.train.ft_policy.FailureSchedule`;
    pass it to the workload (``TrainSim(schedule=board.
    failure_schedule, ...)``) so one board name pins the whole
    reproducible fault scenario.
    """

    machine: ClusterModel
    algorithm: str = "torus2d"
    straggler_slowdowns: Optional[List[float]] = None
    name: str = "board"
    failure_schedule: Optional[object] = None
    #: default fidelity model runs on this board start under
    #: ("detailed" | "atomic"; see repro.core.desim.timing)
    timing: str = "detailed"

    def instantiate(self) -> "Board":
        if not getattr(self.machine, "_frozen", False):
            self.machine.instantiate()
        return self

    def executor(self, **kw) -> TraceExecutor:
        """A TraceExecutor wired for this board (kw: record_stats,
        record_timeline, timing, ... pass through).  ``workers=N`` (N>1)
        returns the multiprocess :class:`~repro.core.desim.parallel.
        ParallelEngine` instead — a drop-in executor that shards the
        board's pods across N worker processes with dist-gem5
        quantum-barrier sync (bit-identical results; ``mp_context``
        picks the multiprocessing start method)."""
        self.instantiate()
        kw.setdefault("algorithm", self.algorithm)
        kw.setdefault("straggler_slowdowns", self.straggler_slowdowns)
        # the board's default timing applies unless the caller chose a
        # model — explicitly via timing=, or through the deprecated
        # contention flag (False maps to AtomicTiming in the executor;
        # an explicit True is a request for contention simulation and
        # must not be overridden by an atomic board default)
        if kw.get("timing") is None and kw.get("contention") is None:
            kw["timing"] = self.timing
        from repro_torch.sim.serialize import validate_workers
        workers = validate_workers(kw.pop("workers", None))
        mp_context = kw.pop("mp_context", None)
        if workers > 1:
            from repro_torch.core.desim.parallel import ParallelEngine
            return ParallelEngine(self.machine, workers=workers,
                                  mp_context=mp_context, **kw)
        return TraceExecutor(self.machine, **kw)


def _apply(obj, overrides: Optional[Dict]) -> None:
    for k, v in (overrides or {}).items():
        setattr(obj, k, v)


def _cluster(name: str, num_pods: int, quantum_ns: Optional[int],
             nx: int, ny: int, chip: Optional[Dict], ici: Optional[Dict],
             dcn: Optional[Dict]) -> ClusterModel:
    kw = {"num_pods": num_pods}
    if quantum_ns is not None:
        kw["quantum_ns"] = quantum_ns
    m = ClusterModel(name, **kw)
    m.pod.nx, m.pod.ny = nx, ny
    _apply(m.pod.chip, chip)
    _apply(m.pod.ici, ici)
    _apply(m.dcn, dcn)
    m.instantiate()
    return m


def _v5e_cluster(name: str, num_pods: int, quantum_ns: Optional[int],
                 nx: int, ny: int, chip: Optional[Dict],
                 ici: Optional[Dict], dcn: Optional[Dict]) -> ClusterModel:
    """``_cluster`` on the reference's chip and links, the caller's
    overrides on top."""
    return _cluster(name, num_pods, quantum_ns, nx, ny,
                    {**TPU_V5E, **(chip or {})},
                    {**TPU_V5E_LINKS["ici"], **(ici or {})},
                    {**TPU_V5E_LINKS["dcn"], **(dcn or {})})


def h100_card(n: int = 1, *, chip: Optional[Dict] = None) -> Board:
    """``n`` NVIDIA H100 SXM5 cards (the machine's defaults, ``H100_SXM``)
    in one pod joined by NVLink, a ring of ``n`` (the simulator has no
    NVSwitch topology); collectives on the ring algorithm, each card's
    NVLink bandwidth a direction."""
    m = _cluster("cluster", 1, None, n, 1, chip, None, None)
    return Board(m, algorithm="ring", name=f"h100_card_{n}")


def h100_fleet(max_replicas: int = 8, n: int = 1, *,
               chip: Optional[Dict] = None,
               timing: str = "detailed") -> Board:
    """Autoscaled serving fleet of cards: ``max_replicas`` independent
    pods of ``n`` H100 SXM5 cards each (a ring on NVLink, as
    ``h100_card``), one per replica ``FleetSim``'s policy may bring up.
    Quantum 0: replicas never speak to each other."""
    m = _cluster("cluster", max_replicas, 0, n, 1, chip, None, None)
    return Board(m, algorithm="ring", timing=timing,
                 name=f"h100_fleet_{max_replicas}x{n}")


def v5e_pod(nx: int = 16, ny: int = 16, *, chip: Optional[Dict] = None,
            ici: Optional[Dict] = None, algorithm: str = "torus2d",
            timing: str = "detailed") -> Board:
    """One TPU v5e pod: a ``nx x ny`` ICI torus of v5e chips."""
    m = _v5e_cluster("cluster", 1, None, nx, ny, chip, ici, None)
    return Board(m, algorithm=algorithm, timing=timing,
                 name=f"v5e_pod_{nx}x{ny}")


def v5e_multipod(num_pods: int = 2, quantum_ns: int = 100_000,
                 nx: int = 16, ny: int = 16, *,
                 chip: Optional[Dict] = None, ici: Optional[Dict] = None,
                 dcn: Optional[Dict] = None,
                 algorithm: str = "torus2d",
                 timing: str = "detailed") -> Board:
    """``num_pods`` v5e pods joined by DCN, synchronized in dist-gem5
    quanta of ``quantum_ns`` (0 disables the quantum error model)."""
    m = _v5e_cluster("cluster", num_pods, quantum_ns, nx, ny, chip, ici, dcn)
    return Board(m, algorithm=algorithm, timing=timing,
                 name=f"v5e_multipod_{num_pods}")


def v5e_straggler(num_pods: int = 2, slowdown: float = 2.0,
                  slow_pods: Optional[List[int]] = None,
                  quantum_ns: int = 100_000, nx: int = 16, ny: int = 16,
                  timing: str = "detailed") -> Board:
    """Multipod with straggling pods (default: the last pod runs at
    ``1/slowdown`` speed) — the fault-injection board."""
    m = _v5e_cluster("cluster", num_pods, quantum_ns, nx, ny, None, None, None)
    slow = [1.0] * num_pods
    for p in (slow_pods if slow_pods is not None else [num_pods - 1]):
        slow[p] = slowdown
    return Board(m, straggler_slowdowns=slow, timing=timing,
                 name=f"v5e_straggler_{num_pods}x{slowdown}")


def v5e_degraded(hbm_frac: float = 0.5, ici_frac: float = 0.5,
                 nx: int = 16, ny: int = 16, *,
                 timing: str = "detailed") -> Board:
    """A single pod with derated HBM and ICI bandwidth — what a step
    costs on sick hardware (capacity-planning variant)."""
    m = _v5e_cluster("cluster", 1, None, nx, ny,
                 chip={"hbm_bw": TPU_V5E["hbm_bw"] * hbm_frac},
                 ici={"bw": TPU_V5E_LINKS["ici"]["bw"] * ici_frac},
                 dcn=None)
    return Board(m, timing=timing,
                 name=f"v5e_degraded_h{hbm_frac}_i{ici_frac}")


def v5e_serving(nx: int = 8, ny: int = 8, replicas: int = 1, *,
                chip: Optional[Dict] = None,
                timing: str = "detailed") -> Board:
    """Serving deployment: ``replicas`` independent pod *slices* of
    ``nx x ny`` chips each (inference replicas are sliced much smaller
    than training pods).  With a dynamic serving workload every pod is
    one continuous-batching replica; requests load-balance round-robin
    (``repro.sim.workloads.ServeSim``)."""
    # quantum 0: serving replicas never speak DCN, so no quantum model
    m = _v5e_cluster("cluster", replicas, 0, nx, ny, chip, None, None)
    return Board(m, timing=timing, name=f"v5e_serving_{replicas}x{nx}x{ny}")


def v5e_fleet(max_replicas: int = 8, nx: int = 8, ny: int = 8, *,
              chip: Optional[Dict] = None,
              timing: str = "detailed") -> Board:
    """Autoscaled serving fleet: ``max_replicas`` independent pod
    slices of ``nx x ny`` chips each — one per replica the
    ``repro.sim.fleet.FleetSim`` workload's policy may ever bring up
    (pods above the live fleet sit idle until a scale-up warms them).
    Quantum 0: replicas never speak DCN, so no quantum model."""
    m = _v5e_cluster("cluster", max_replicas, 0, nx, ny, chip, None, None)
    return Board(m, timing=timing,
                 name=f"v5e_fleet_{max_replicas}x{nx}x{ny}")


def v5e_fleet_big(num_pods: int = 64, quantum_ns: int = 100_000,
                  nx: int = 4, ny: int = 4, *,
                  chip: Optional[Dict] = None, ici: Optional[Dict] = None,
                  dcn: Optional[Dict] = None,
                  algorithm: str = "hierarchical",
                  timing: str = "detailed") -> Board:
    """Fleet-scale multipod (64-128 pods of small ``nx x ny`` slices)
    joined by DCN under dist-gem5 quantum sync — the board the
    ``ParallelEngine`` workers=8 scaling gate runs on (``tools/ci.sh
    parallel``).  Slices are kept small so the per-pod event cost stays
    cheap enough that coordinator overhead, not compute, is what the
    benchmark measures; the default collective algorithm is
    hierarchical, exercising the ``global_num_pods`` shard cost
    context."""
    m = _v5e_cluster("cluster", num_pods, quantum_ns, nx, ny, chip, ici, dcn)
    return Board(m, algorithm=algorithm, timing=timing,
                 name=f"v5e_fleet_big_{num_pods}")


def v5e_unreliable(num_pods: int = 4, *, seed: int = 0,
                   horizon: int = 2000, mtbf: float = 400.0,
                   straggler_mtbs: float = 0.0,
                   preemption_mtbs: float = 0.0,
                   repair: tuple = (40, 120), nx: int = 16, ny: int = 16,
                   chip: Optional[Dict] = None, ici: Optional[Dict] = None,
                   timing: str = "detailed") -> Board:
    """An unreliable multipod: ``num_pods`` v5e pods plus a seeded
    :class:`~repro.train.ft_policy.FailureSchedule` (MTBF-driven pod
    failures, optional transient stragglers and preemptions, all in
    step-attempt units over ``horizon`` attempts) — the fault-injected
    training board for ``TrainSim``.  Quantum 0: the training workload
    injects its op chain on one pod, so no quantum error model."""
    from repro_torch.train.ft_policy import FailureSchedule
    m = _v5e_cluster("cluster", num_pods, 0, nx, ny, chip, ici, None)
    sched = FailureSchedule.generate(
        seed=seed, horizon=horizon, pods=num_pods, mtbf=mtbf,
        straggler_mtbs=straggler_mtbs, preemption_mtbs=preemption_mtbs,
        repair=repair)
    return Board(m, failure_schedule=sched, timing=timing,
                 name=f"v5e_unreliable_{num_pods}_s{seed}")


BOARDS: Dict[str, Callable[..., Board]] = {
    "h100_card": h100_card,
    "h100_fleet": h100_fleet,
    "v5e_pod": v5e_pod,
    "v5e_multipod": v5e_multipod,
    "v5e_straggler": v5e_straggler,
    "v5e_degraded": v5e_degraded,
    "v5e_serving": v5e_serving,
    "v5e_fleet": v5e_fleet,
    "v5e_fleet_big": v5e_fleet_big,
    "v5e_unreliable": v5e_unreliable,
}


def get_board(name: str, **kw) -> Board:
    try:
        return BOARDS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown board {name!r}; one of {list(BOARDS)}")
