"""A copy of ``repro.sim.sampling`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

SimPoint/SMARTS-style sampled simulation (gem5 §1.3, §2.7 workflow).

gem5's answer to "a detailed simulation of one minute of wall clock
takes days" is to not simulate most of it in detail: fast-forward with
a cheap functional model, run only sampled windows through the detailed
timing model (SimPoint picks representative windows; SMARTS samples
periodically).  For a steady-state training run the same trick is
almost free: every step executes the same compiled program, so a few
detailed windows pin down contention effects and the rest runs atomic.

``SampledSimulation`` reproduces the periodic (SMARTS) scheme **in the
engine**: one resumable run whose timing model is switched at segment
boundaries (the gem5 ``switch_cpus`` move, through the executor's
drain/serialize/restore path — see ``repro.core.desim.timing``):

* a ``warmup`` segment and periodic ``window``-step windows run under
  ``DetailedTiming`` (full link contention, quantum sync);
* the steps between windows run under ``AtomicTiming`` — real
  in-engine fast-forward: op ticks advance at the contention-free
  analytical rate, **stats keep accumulating** (op counts, busy
  seconds, bytes on wire), and ~zero engine events fire.  There is no
  out-of-engine extrapolation anymore: the final tick *is* the
  simulated time, checkpoints taken mid-fast-forward are real
  checkpoints, and dynamic workloads can fast-forward the same way.

Accuracy/coverage contract (test-enforced in tests/test_sampling.py and
benchmarked in benchmarks/sampled_sim.py): on a >=100-step steady-state
workload the default plan executes <= 20% of ops at detailed fidelity
and lands within 5% of the full-detail total time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.desim.simnodes import TICKS_PER_S
from repro_torch.core.desim.trace import HloTrace
from repro_torch.sim.boards import Board
from repro_torch.sim.simulator import ExitEvent, ExitEventType, repeat_trace


@dataclass
class SamplePlan:
    """Periodic sampling schedule over ``num_steps`` training steps.

    ``warmup``   : leading steps always run detailed (cold caches /
                   cold link-occupancy analogue).
    ``interval`` : period length; each period starts with ``window``
                   detailed steps, the rest is fast-forwarded.
    """

    warmup: int = 2
    interval: int = 12
    window: int = 2

    def __post_init__(self):
        if self.window < 1 or self.interval < self.window:
            raise ValueError("need 1 <= window <= interval")

    def segments(self, num_steps: int) -> List[Tuple[str, int]]:
        """Ordered ("detailed"|"ff", n_steps) segments covering the run."""
        segs: List[Tuple[str, int]] = []
        pos = 0
        if self.warmup and num_steps > 0:
            w = min(self.warmup, num_steps)
            segs.append(("detailed", w))
            pos = w
        while pos < num_steps:
            w = min(self.window, num_steps - pos)
            segs.append(("detailed", w))
            pos += w
            ff = min(self.interval - self.window, num_steps - pos)
            if ff > 0:
                segs.append(("ff", ff))
                pos += ff
        return segs

    def detailed_fraction(self, num_steps: int) -> float:
        det = sum(n for kind, n in self.segments(num_steps)
                  if kind == "detailed")
        return det / max(num_steps, 1)


@dataclass
class SimPointPlan:
    """SimPoint sampling schedule: detailed windows picked by phase
    clustering, not a fixed stride (gem5 §1.3; built automatically by
    :func:`repro.sim.fingerprint.simpoint_plan`).

    ``window``          : steps per window (the fingerprint interval).
    ``representatives`` : sorted window indices to run detailed — one
                          per cluster.
    ``weights``         : aligned with ``representatives``; each is the
                          cluster's share of all windows (sums to 1).
    ``labels``          : optional per-window cluster ids (provenance,
                          not used by the schedule).

    ``segments()`` has the same contract as :class:`SamplePlan`, with
    one extra guarantee: detailed segments are never merged, so the
    i-th detailed window of a sampled run is ``representatives[i]`` and
    its measured step time pairs with ``weights[i]`` for the weighted
    reconstruction ``total ≈ num_steps * Σ w_i * step_time_i``.
    """

    window: int = 1
    representatives: List[int] = field(default_factory=list)
    weights: List[float] = field(default_factory=list)
    labels: Optional[List[int]] = None

    def __post_init__(self):
        if self.window < 1:
            raise ValueError("need window >= 1")
        if len(self.weights) != len(self.representatives):
            raise ValueError("weights must align with representatives")
        if list(self.representatives) != sorted(set(self.representatives)):
            raise ValueError("representatives must be sorted and unique")
        if self.weights and abs(sum(self.weights) - 1.0) > 1e-9:
            raise ValueError(
                f"weights must sum to 1 (got {sum(self.weights)})")

    def segments(self, num_steps: int) -> List[Tuple[str, int]]:
        """One ("detailed"|"ff", n_steps) segment per window."""
        reps = set(self.representatives)
        segs: List[Tuple[str, int]] = []
        pos = widx = 0
        while pos < num_steps:
            n = min(self.window, num_steps - pos)
            segs.append(("detailed" if widx in reps else "ff", n))
            pos += n
            widx += 1
        return segs

    def detailed_fraction(self, num_steps: int) -> float:
        det = sum(n for kind, n in self.segments(num_steps)
                  if kind == "detailed")
        return det / max(num_steps, 1)

    def weighted_total_s(self, num_steps: int,
                         window_step_s: List[float]) -> float:
        """SimPoint reconstruction from measured per-step window times
        (aligned with ``representatives``)."""
        if len(window_step_s) != len(self.representatives):
            raise ValueError(
                f"{len(window_step_s)} window times for "
                f"{len(self.representatives)} representatives")
        return num_steps * sum(w * s for w, s
                               in zip(self.weights, window_step_s))


@dataclass
class SampledResult:
    num_steps: int
    detailed_steps: int
    predicted_total_s: float           # in-engine final tick (real time)
    detailed_op_fraction: float        # ops run at detailed fidelity
    window_step_s: List[float]         # per-step time of each window
    atomic_step_s: float               # contention-free roofline estimate
    events: int                        # engine events actually fired
    segments: List[Tuple[str, int]] = field(default_factory=list)
    stats: Optional[Dict[str, Any]] = None   # full-run gem5 stats tree
    # SimPoint reconstruction num_steps * Σ w_i * step_time_i — only
    # set when the plan carries weights (a SimPointPlan).  Unlike
    # predicted_total_s (the in-engine final tick, which times
    # non-representative regions at atomic fidelity), this estimates
    # what a FULL-DETAIL run would cost.
    weighted_total_s: Optional[float] = None

    @property
    def mean_step_s(self) -> float:
        return self.predicted_total_s / max(self.num_steps, 1)


def atomic_step_time_s(board: Board, step: HloTrace) -> float:
    """Closed-form per-step estimate at atomic fidelity: serialize every
    op at its contention-free cost (roofline compute, algorithm-model
    collectives; ``overlap`` collectives hide behind compute)."""
    board.instantiate()
    m = board.machine
    from repro_torch.core.desim.collectives import get_algorithm
    alg = get_algorithm(board.algorithm)
    total = 0.0
    for op in step.ops:
        if op.kind == "compute":
            total += m.pod.chip.compute_time_s(op.flops, op.bytes)
        elif not op.overlap:
            total += alg.time_s(op.kind, op.coll_bytes,
                                op.participants or m.pod.num_chips, m)
    return total


class SampledSimulation:
    """Drive a steady-state workload through a :class:`SamplePlan` as
    ONE in-engine run with mid-run timing-model switches.

    Generator-style like ``Simulator``: ``run()`` yields a
    ``SAMPLE_BEGIN`` exit event before each detailed window and ``DONE``
    at the end; ``result()`` returns the :class:`SampledResult` —
    including the full stats tree, which now covers the fast-forwarded
    regions too (they execute for real at atomic fidelity).

    Window boundaries follow the *pod-0* completion frontier.  On
    multipod boards lagging pods can still be mid-window at a switch:
    their in-flight ops complete under the old model (gem5 drain), but
    their deferred remainder re-times under the new one, and under
    QuantumSync the switch lands on a quantum boundary — so detailed
    windows are step-exact on single-pod boards and quantum/straggler-
    granular on multipod ones (the usual SMARTS sampling-noise caveat,
    not a correctness issue: the run's final tick is still the real
    in-engine time).
    """

    def __init__(self, board: Board, step: HloTrace, num_steps: int,
                 plan: Optional[Any] = None,
                 ff_mode: str = "atomic"):
        if ff_mode != "atomic":
            raise ValueError(
                f"ff_mode {ff_mode!r}: only 'atomic' is supported — "
                "fast-forward now runs in-engine under AtomicTiming "
                "(the analytical 'extrapolate' mode was removed; see "
                "docs/sampling.md)")
        self.board = board.instantiate()
        self.step = step
        self.num_steps = int(num_steps)
        self.plan = plan or SamplePlan()
        self.ff_mode = ff_mode
        # A pre-chained multi-step trace (repeat_trace / chain_steps
        # stamp meta["steps"]) is used as-is: non-steady-state
        # workloads have per-step differences a repeated single step
        # cannot express.  Anything else is a one-step trace repeated.
        self._full_trace = (
            self.num_steps > 1
            and int(step.meta.get("steps", 0)) == self.num_steps)
        if self._full_trace and len(step.ops) % self.num_steps:
            raise ValueError(
                f"chained trace has {len(step.ops)} ops, not divisible "
                f"into {self.num_steps} uniform steps")
        self._result: Optional[SampledResult] = None

    # ------------------------------------------------------------------
    def _switch(self, ex, timing: str):
        """gem5 switch_cpus through the drain/snapshot/restore path.

        Uses the in-memory snapshot directly (not the JSON checkpoint
        file format): a sampled run switches models dozens of times and
        the trace re-serialization would dominate the wall time the
        fast-forward saves.  Semantically identical — the file path is
        covered by ``Simulator.switch_timing`` and the cross-model
        checkpoint tests."""
        ex.drain()
        state = ex.snapshot()
        fresh = self.board.executor(record_stats=True, timing=timing,
                                    straggler_slowdowns=list(ex.slow))
        return fresh.restore(ex._trace, state)

    def run(self) -> Iterator[ExitEvent]:
        segs = self.plan.segments(self.num_steps)
        if self._full_trace:
            trace = self.step
            n_ops = len(trace.ops) // self.num_steps
            atomic = (atomic_step_time_s(self.board, trace)
                      / self.num_steps)
        else:
            n_ops = len(self.step.ops)
            trace = repeat_trace(self.step, self.num_steps)
            atomic = atomic_step_time_s(self.board, self.step)

        progress = {"ops": 0, "detailed_ops": 0, "last_end": 0,
                    "model": "detailed" if segs and segs[0][0] == "detailed"
                             else "atomic"}

        def hook(op, idx, start, end):
            progress["ops"] += 1
            if progress["model"] == "detailed":
                progress["detailed_ops"] += 1
            if end > progress["last_end"]:
                progress["last_end"] = end

        ex = self.board.executor(record_stats=True,
                                 timing=progress["model"])
        ex.op_hook = hook
        ex.begin(trace)

        window_step_s: List[float] = []
        detailed = 0
        pos = 0
        for kind, n in segs:
            want = "detailed" if kind == "detailed" else "atomic"
            # span starts BEFORE any switch: the drain completes the
            # boundary ops already in flight (the next step's compute,
            # issued the moment the previous sinks landed) under the
            # old model — compute costs are model-identical, and those
            # ops belong to THIS segment, so charging them here keeps
            # window_step_s honest (the SimPoint reconstruction
            # multiplies these by cluster weights)
            seg_start = progress["last_end"]
            if want != progress["model"]:
                ex = self._switch(ex, want)
                progress["model"] = want
                ex.op_hook = hook
            if kind == "detailed":
                yield ExitEvent(
                    ExitEventType.SAMPLE_BEGIN,
                    tick=progress["last_end"],
                    cause=f"window @ step {pos} ({n} steps)",
                    payload={"step": pos, "steps": n})
            target = (pos + n) * n_ops
            ex.advance(stop_check=lambda: progress["ops"] >= target)
            if kind == "detailed":
                window_step_s.append(
                    (progress["last_end"] - seg_start) / TICKS_PER_S / n)
                detailed += n
            pos += n
        ex.advance()                 # lagging pods finish the last step
        res = ex.result()

        weighted = None
        if getattr(self.plan, "weights", None):
            weighted = self.plan.weighted_total_s(self.num_steps,
                                                  window_step_s)
        self._result = SampledResult(
            num_steps=self.num_steps,
            detailed_steps=detailed,
            predicted_total_s=res.makespan_s,
            detailed_op_fraction=progress["detailed_ops"] /
            max(self.num_steps * n_ops, 1),
            window_step_s=window_step_s,
            atomic_step_s=atomic,
            events=res.events,
            segments=segs,
            stats=res.stats,
            weighted_total_s=weighted)
        yield ExitEvent(ExitEventType.DONE,
                        tick=res.final_tick,
                        cause=f"sampled {detailed}/{self.num_steps} steps")

    def result(self) -> SampledResult:
        if self._result is None:
            raise RuntimeError("iterate run() to completion first")
        return self._result


def sampled_run(board: Board, step: HloTrace, num_steps: int,
                plan: Optional[Any] = None,
                ff_mode: str = "atomic") -> SampledResult:
    """One-shot sampled simulation (drains the exit-event stream).
    ``plan``: a :class:`SamplePlan` (fixed stride) or
    :class:`SimPointPlan` (phase-clustered; adds ``weighted_total_s``
    to the result)."""
    sim = SampledSimulation(board, step, num_steps, plan, ff_mode)
    for _ in sim.run():
        pass
    return sim.result()
