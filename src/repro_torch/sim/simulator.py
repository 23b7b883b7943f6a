"""A copy of ``repro.sim.simulator`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

gem5-stdlib-style ``Simulator`` front-end with typed exit events.

The gem5 standard library (PAPERS.md: "Toward Reproducible and
Standardized Computer Architecture Simulation with gem5") made gem5
usable at scale with one object: ``Simulator(board, workload)`` owns
``m5.instantiate()``, drives the event loop, and turns simulation-exit
causes into typed ``ExitEvent``s the user scripts against in plain
Python — checkpoint here, switch CPU models there, stop at max-tick.
Before it, every config hand-rolled the instantiate/run/exit plumbing;
exactly the state of our desim drivers after PR 1.

g5x reproduction::

    sim = Simulator(v5e_multipod(2), trace)
    sim.schedule_max_tick(5_000_000)
    sim.schedule_checkpoint(20_000_000)
    for ev in sim.run():                      # generator of ExitEvents
        if ev.kind is ExitEventType.MAX_TICK:
            print("warmed up at", ev.tick)    # ... then keep iterating
        elif ev.kind is ExitEventType.CHECKPOINT:
            path = ev.payload["path"]         # restore later / elsewhere
    res = sim.result()                        # ExecResult of the run

Exit-event semantics:

* ``MAX_TICK``     — a ``schedule_max_tick`` point was reached; the sim
                     is paused (no event at tick <= point pending).
* ``CHECKPOINT``   — the run was gem5-drained, serialized (see
                     ``repro.sim.serialize``), and resumed *through the
                     restore path* (resume == restore, so every
                     checkpoint is exercised end-to-end).
* ``WORK_BEGIN`` / ``WORK_END`` — a trace op named ``work_begin*`` /
                     ``work_end*`` completed on pod 0 (gem5 work items,
                     §2.7: delimit the region of interest in the
                     workload itself).  Under QuantumSync these are
                     delivered at the next quantum boundary — the only
                     points where global state is observable in
                     dist-gem5.
* ``SAMPLE_BEGIN`` — a sampled-simulation window starts (emitted by
                     ``repro.sim.sampling``, not by ``Simulator``).
* ``SLO_VIOLATION`` — a dynamic serving workload finished a request
                     over its TTFT/latency SLO (``repro.sim.workloads.
                     ServeSim`` with ``exit_on_slo=True``).
* ``POD_FAILED``   — a dynamic training workload declared a pod dead
                     (``repro.sim.workloads.TrainSim`` with
                     ``exit_on_fault=True``).
* ``RESHARD``      — the training workload's FT policy replanned the
                     elastic mesh (after a death or a rejoin).
* ``SCALE_UP`` / ``SCALE_DOWN`` — the fleet workload's autoscaler
                     brought a replica up (warming starts; it serves
                     after its cold start) or retired an idle one
                     (``repro.sim.fleet.FleetSim``).
* ``DONE``         — the workload completed; ``result()`` is available.

Dynamic workloads (``repro.sim.workloads.DynamicWorkload``) generate
ops *while the simulation runs* — ``Simulator`` co-simulates them:
advance the engine to the workload's next external event, ``poll`` the
workload, repeat.  See ``docs/serving.md``.
"""

from __future__ import annotations

import enum
import os
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core import trace as dbg
from repro_torch.core.desim.executor import ExecResult, TraceExecutor
from repro_torch.core.desim.machine import ClusterModel
from repro_torch.core.desim.simnodes import TICKS_PER_S
from repro_torch.core.desim.trace import HloTrace
from repro_torch.sim import instrument as inst
from repro_torch.sim.boards import Board
from repro_torch.sim.workloads import DynamicWorkload


class ExitEventType(enum.Enum):
    MAX_TICK = "max_tick"
    CHECKPOINT = "checkpoint"
    WORK_BEGIN = "work_begin"
    WORK_END = "work_end"
    SAMPLE_BEGIN = "sample_begin"
    SLO_VIOLATION = "slo_violation"
    POD_FAILED = "pod_failed"
    RESHARD = "reshard"
    SCALE_UP = "scale_up"
    SCALE_DOWN = "scale_down"
    STAT_DUMP = "stat_dump"
    DONE = "done"


@dataclass(frozen=True)
class ExitEvent:
    """One typed simulation exit (gem5 ``ExitEvent`` analogue)."""

    kind: ExitEventType
    tick: int
    cause: str = ""
    payload: Dict[str, Any] = field(default_factory=dict)

    @property
    def time_s(self) -> float:
        return self.tick / TICKS_PER_S

    def __str__(self) -> str:
        return (f"ExitEvent({self.kind.value} @ {self.tick} "
                f"[{self.time_s:.6f}s] {self.cause})")


WORK_BEGIN_PREFIX = "work_begin"
WORK_END_PREFIX = "work_end"


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def repeat_trace(step: HloTrace, num_steps: int,
                 name: Optional[str] = None) -> HloTrace:
    """Chain ``num_steps`` copies of a one-step trace: each step's root
    ops depend on the previous step's sink ops (steady-state training:
    step N+1 cannot start before step N's last collective lands)."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    n = len(step.ops)
    has_dependent = [False] * n
    for op in step.ops:
        for d in op.deps:
            has_dependent[d] = True
    sinks = tuple(i for i in range(n) if not has_dependent[i])
    out = HloTrace(name or f"{step.name}x{num_steps}",
                   meta=dict(step.meta, steps=num_steps))
    for rep in range(num_steps):
        off = rep * n
        for idx, op in enumerate(step.ops):
            deps = tuple(d + off for d in op.deps)
            if not deps and rep > 0:
                deps = tuple(s + off - n for s in sinks)
            out.ops.append(replace(
                op, deps=deps,
                name=f"step{rep}/{op.name}" if op.name else ""))
    return out


@dataclass
class SteadyStateWorkload:
    """``num_steps`` repetitions of one step trace (a training run)."""

    step: HloTrace
    num_steps: int

    def trace(self) -> HloTrace:
        return repeat_trace(self.step, self.num_steps)


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

class Simulator:
    """Owns instantiate/startup and the exit-event loop of one run.

    ``board``    : a :class:`repro.sim.boards.Board` (or a bare
                   ``ClusterModel``, wrapped with default knobs).
    ``workload`` : an :class:`HloTrace`, or anything with ``.trace()``
                   (e.g. ``SteadyStateWorkload``).
    ``checkpoint_dir`` : when set, CHECKPOINT exits also write
                   ``ckpt_tick<T>.json`` there (see serialize.py).
    ``timing``   : fidelity model to start under ("detailed" |
                   "atomic"; default: the board's).  Switch mid-run
                   with :meth:`switch_timing` — the gem5 ``switch_cpus``
                   move.
    ``workers``  : shard the board's pods across N worker processes
                   (dist-gem5 multiprocess simulation, §2.17 — see
                   ``repro.core.desim.parallel``).  Results and
                   checkpoints are bit-identical to ``workers=1``.
                   Dynamic workloads co-simulate in-process (their
                   injected ops couple the run to host code every
                   event), so ``workers`` is coerced to 1 for them.
    """

    def __init__(self, board, workload, *,
                 checkpoint_dir: Optional[str] = None,
                 record_stats: bool = True, record_timeline: bool = False,
                 contention: Optional[bool] = None,
                 timing: Optional[str] = None,
                 workers: int = 1, mp_context: Optional[str] = None,
                 outdir: Optional[str] = None, trace_events: bool = False,
                 verbose: bool = False):
        if isinstance(board, ClusterModel):
            board = Board(machine=board)
        self.board = board.instantiate()     # Simulator owns instantiate()
        if isinstance(workload, DynamicWorkload):
            # dynamic workloads inject their ops into a live run; the
            # run begins from an empty trace that grows as events fire
            self._dyn: Optional[DynamicWorkload] = workload
            self._trace = HloTrace(f"dynamic:{getattr(workload, 'name', '')}")
        else:
            self._dyn = None
            self._trace = (workload if isinstance(workload, HloTrace)
                           else workload.trace())
        if self._dyn is not None:
            workers = 1        # co-simulation is inherently in-process
        # m5out-style instrumentation (repro.sim.instrument): the
        # recorder rides _ex_cfg so every executor this Simulator builds
        # (initial, checkpoint restores, parallel spawns) records into
        # the same merged timeline
        self.outdir = inst.OutDir(outdir) if outdir else None
        self._recorder = (inst.TraceEventRecorder() if trace_events
                          else None)
        self.verbose = bool(verbose)
        self._host_t0: Optional[float] = None
        self._host_seconds = 0.0
        self._final_tick: Optional[int] = None
        self._stat_dump_period: Optional[int] = None
        self._stat_dump_reset = False
        self._ex_cfg = dict(record_stats=record_stats,
                            record_timeline=record_timeline,
                            contention=contention, timing=timing,
                            workers=int(workers or 1),
                            mp_context=mp_context,
                            instrument=self._recorder)
        self._ex = board.executor(**self._ex_cfg)
        # pin the resolved model: checkpoints/switches restore under it
        self._ex_cfg["timing"] = self._ex.timing.name
        self._ex_cfg.pop("contention")
        self._has_markers = any(
            (op.name or "").rpartition("/")[2].startswith(
                (WORK_BEGIN_PREFIX, WORK_END_PREFIX))
            for op in self._trace.ops)
        self._marker_exits: deque = deque()
        self._scheduled: List[Tuple[int, int, ExitEventType]] = []
        self._sched_seq = 0
        self._started = False
        self._result: Optional[ExecResult] = None
        self.checkpoint_dir = checkpoint_dir
        self.last_checkpoint: Optional[Dict[str, Any]] = None
        self.checkpoint_paths: List[str] = []
        if self.outdir is not None:
            # gem5 writes config.json/config.ini at instantiate time:
            # the run's full configuration as a versioned artifact
            self.outdir.write_config(self._config_doc())

    # -- construction from a checkpoint ---------------------------------
    @classmethod
    def from_checkpoint(cls, source, board: Optional[Board] = None, *,
                        workload=None, timing: Optional[str] = None,
                        checkpoint_dir: Optional[str] = None,
                        workers: int = 1,
                        mp_context: Optional[str] = None,
                        outdir: Optional[str] = None,
                        trace_events: bool = False,
                        verbose: bool = False) -> "Simulator":
        """Resume a serialized simulation, optionally onto a
        re-parameterized ``board`` (the checkpoint-once, sweep-hardware
        workflow).  ``source`` is a path or a checkpoint dict.

        ``timing`` restores under a *different* fidelity model than the
        checkpoint was taken under (gem5 ``switch_cpus`` through the
        checkpoint file: atomic fast-forward elsewhere, restore here
        under "detailed" for the region of interest).

        A checkpoint of a *dynamic* workload stores the workload's
        state but not its construction (request streams are code, not
        data): pass an equivalently-built ``workload`` (same requests /
        seed / knobs) and its state is restored into it.
        """
        from repro_torch.sim import serialize as ser
        ckpt = (ser.load_checkpoint(source) if isinstance(source, str)
                else source)
        cfg = ckpt["executor"]
        explicit_board = board is not None
        if board is None:
            board = Board(machine=ser.machine_from_dict(ckpt["machine"]),
                          algorithm=cfg["algorithm"],
                          straggler_slowdowns=cfg["straggler_slowdowns"])
        if ser.WORKLOAD_KEY in ckpt \
                and not isinstance(workload, DynamicWorkload):
            raise ser.CheckpointError(
                "checkpoint carries dynamic-workload state; pass the "
                "rebuilt DynamicWorkload object (same request stream) "
                "via workload=")
        want_kind = ckpt.get(ser.WORKLOAD_KIND_KEY)
        if want_kind is not None and isinstance(workload, DynamicWorkload) \
                and type(workload).__name__ != want_kind:
            raise ser.CheckpointError(
                f"checkpoint carries {want_kind} state but a "
                f"{type(workload).__name__} was passed via workload=")
        if workload is not None and ser.WORKLOAD_KEY not in ckpt:
            # a static checkpoint resumes its own serialized trace; a
            # passed workload would be silently ignored — refuse instead
            raise ser.CheckpointError(
                "a workload was passed but the checkpoint has no "
                "workload state (it was taken of a static trace run, "
                "which restores its own trace)")
        sim = cls(board, workload if workload is not None
                  else ser.trace_from_checkpoint(ckpt),
                  checkpoint_dir=checkpoint_dir,
                  record_stats=cfg["record_stats"],
                  record_timeline=cfg["record_timeline"],
                  timing=(timing if timing is not None
                          else cfg.get("timing")),
                  contention=(None if timing is not None
                              or cfg.get("timing") is not None
                              else cfg.get("contention")),
                  workers=workers, mp_context=mp_context,
                  outdir=outdir, trace_events=trace_events,
                  verbose=verbose)
        overrides = dict(sim._ex_cfg)
        if explicit_board:
            # an explicitly-passed board wins wholesale: it bundles the
            # run knobs (algorithm, stragglers), not just the machine —
            # a board-based DSE re-sweep must actually apply them
            overrides.update(
                algorithm=board.algorithm,
                straggler_slowdowns=board.straggler_slowdowns)
        sim._ex = ser.restore_executor(ckpt, machine=board.machine,
                                       **overrides)
        sim._trace = sim._ex._trace
        sim._install_hook()
        if sim._dyn is not None:
            sim._dyn.bind(sim._ex)
            sim._dyn.load_state_dict(ckpt[ser.WORKLOAD_KEY])
        sim._started = True
        return sim

    # -- exit scheduling --------------------------------------------------
    def _schedule(self, tick: int, kind: ExitEventType) -> None:
        self._scheduled.append((int(tick), self._sched_seq, kind))
        self._sched_seq += 1
        self._scheduled.sort()

    def schedule_max_tick(self, tick: int) -> None:
        """Pause and yield ``MAX_TICK`` once no event at tick <= ``tick``
        remains (gem5 ``simulate(ticks)``)."""
        self._schedule(tick, ExitEventType.MAX_TICK)

    def schedule_checkpoint(self, tick: int) -> None:
        """Drain + serialize at the first pause point >= ``tick`` and
        yield ``CHECKPOINT`` (gem5 checkpoint exit event)."""
        self._schedule(tick, ExitEventType.CHECKPOINT)

    def schedule_stat_dump(self, period: int, reset: bool = False) -> None:
        """Dump statistics every ``period`` ticks (gem5
        ``m5.stats.periodicStatDump``): the run pauses at each cadence
        point exactly like a ``schedule_max_tick`` (so the dump cannot
        perturb event order), renders a ``stats.txt`` section to the
        outdir (or just yields ``STAT_DUMP`` when there is none), and
        reschedules.  ``reset=True`` also zeroes the stats after each
        dump (per-interval sections, gem5's dump-and-reset)."""
        period = int(period)
        if period <= 0:
            raise ValueError("stat-dump period must be positive")
        self._stat_dump_period = period
        self._stat_dump_reset = bool(reset)
        self._schedule(self._ex.now + period, ExitEventType.STAT_DUMP)

    # -- internals --------------------------------------------------------
    def _install_hook(self) -> None:
        self._ex.op_hook = self._on_op if self._has_markers else None

    def _on_op(self, op, idx, start, end) -> None:
        base = (op.name or "").rpartition("/")[2]
        if base.startswith(WORK_BEGIN_PREFIX):
            kind = ExitEventType.WORK_BEGIN
        elif base.startswith(WORK_END_PREFIX):
            kind = ExitEventType.WORK_END
        else:
            return
        self._marker_exits.append(
            ExitEvent(kind, tick=end, cause=op.name,
                      payload={"op_idx": idx, "start": start}))

    def _stop_check(self) -> bool:
        # pause the engine as soon as there is something to yield: a
        # work-item marker, or a workload-raised exit (SLO violation,
        # pod death, reshard) — exits must surface at the tick they
        # happen, not after the run completes
        return bool(self._marker_exits) or (
            self._dyn is not None and bool(self._dyn.pending_exits))

    def _do_checkpoint(self, requested_tick: int,
                       save: bool = True) -> ExitEvent:
        self._ex.drain()
        from repro_torch.sim import serialize as ser
        ckpt = ser.checkpoint_executor(self._ex)
        if self._dyn is not None:
            ckpt[ser.WORKLOAD_KEY] = self._dyn.state_dict()
            ckpt[ser.WORKLOAD_KIND_KEY] = type(self._dyn).__name__
        self.last_checkpoint = ckpt
        path = None
        if save and self.checkpoint_dir:
            path = os.path.join(self.checkpoint_dir,
                                f"ckpt_tick{ckpt['tick']}.json")
            ser.save_checkpoint(ckpt, path)
            self.checkpoint_paths.append(path)
        # resume == restore: rebuild the executor from the checkpoint we
        # just took, so serialization is exercised on every checkpoint
        self._ex = ser.restore_executor(ckpt, machine=self.board.machine,
                                        **self._ex_cfg)
        self._trace = self._ex._trace
        self._install_hook()
        if self._dyn is not None:
            # the workload resumes through its own serialization too
            self._dyn.bind(self._ex)
            self._dyn.load_state_dict(ckpt[ser.WORKLOAD_KEY])
        return ExitEvent(ExitEventType.CHECKPOINT, tick=requested_tick,
                         cause="checkpoint",
                         payload={"checkpoint": ckpt, "path": path,
                                  "drained_tick": ckpt["tick"]})

    def _ensure_started(self) -> None:
        if self._host_t0 is None:
            self._host_t0 = time.perf_counter()
        if not self._started:
            self._ex.begin(self._trace)
            self._install_hook()
            if self._dyn is not None:
                self._dyn.bind(self._ex)
                self._dyn.start()
            self._started = True

    def _all_done(self) -> bool:
        return self._ex.done() and (self._dyn is None or self._dyn.done())

    # -- the exit-event loop ----------------------------------------------
    def run(self, verbose: Optional[bool] = None) -> Iterator[ExitEvent]:
        """Generator of :class:`ExitEvent`s; drive multi-phase
        simulations by iterating (and scheduling further exits between
        yields).

        Dynamic workloads run as a co-simulation: the engine advances
        to the workload's next external event (e.g. a request arrival),
        then ``poll`` lets the workload inject ops before the engine
        continues.  Workload-raised exits (SLO violations) yield like
        any other exit event.

        ``verbose`` (default: the constructor's ``verbose`` knob) prints
        the gem5 exit banner — ``Exiting @ tick N because <reason>`` —
        for every yielded event, plus the host-performance line
        (simSeconds/hostSeconds/simRate) at DONE.  Nothing is printed
        otherwise: all narration goes through the DPRINTF layer
        (``repro.core.trace``), so stdout stays silent unless a debug
        flag or the verbosity knob is explicitly enabled.
        """
        v = self.verbose if verbose is None else bool(verbose)
        for ev in self._run_events():
            dbg.dprintf("Sim", "simulator", "exiting because %s",
                        ev.cause, tick=ev.tick)
            if ev.kind is ExitEventType.DONE:
                self._finalize(ev)
            if v:
                print(f"Exiting @ tick {ev.tick} because {ev.cause}")
                if ev.kind is ExitEventType.DONE:
                    print(inst.format_host_banner(self.host_record()))
            yield ev

    def _finalize(self, done_ev: ExitEvent) -> None:
        """Close out the run's artifacts at DONE: host clock, final
        stats section, telemetry record, Perfetto trace."""
        if self._host_t0 is not None:
            self._host_seconds = time.perf_counter() - self._host_t0
        self._final_tick = done_ev.tick
        if self.outdir is not None:
            self.dump_stats(reason="final")
            self.outdir.write_json(inst.OutDir.TELEMETRY,
                                   self.host_record())
            if self._recorder is not None:
                self.write_trace()

    def _run_events(self) -> Iterator[ExitEvent]:
        self._ensure_started()
        stop = (self._stop_check
                if self._has_markers or self._dyn is not None else None)
        while True:
            if self._marker_exits:
                yield self._marker_exits.popleft()
                continue
            if self._dyn is not None and self._dyn.pending_exits:
                e = self._dyn.pending_exits.popleft()
                # workloads tag their exits with a "kind" (POD_FAILED,
                # RESHARD, ...); untagged entries are SLO violations
                # (the original ServeSim contract)
                kind = ExitEventType(
                    e.get("kind", ExitEventType.SLO_VIOLATION.value))
                yield ExitEvent(kind, tick=int(e["tick"]),
                                cause=e["cause"],
                                payload=dict(e.get("payload", {})))
                continue
            if self._all_done():
                if self._result is None:
                    self._result = self._ex.result()
                # makespan tick, not queue tick: a restored run's queues
                # restart at 0 but the simulated time does not
                yield ExitEvent(
                    ExitEventType.DONE,
                    tick=self._result.final_tick,
                    cause="workload complete")
                return
            sched_tick = self._scheduled[0][0] if self._scheduled else None
            dyn_tick = (self._dyn.next_event_tick()
                        if self._dyn is not None else None)
            if dyn_tick is not None and (sched_tick is None
                                         or dyn_tick <= sched_tick):
                # advance to the workload's next external event, then
                # let it react (submit arrivals, wake idle replicas)
                self._ex.advance(max_tick=dyn_tick, stop_check=stop)
                if self._stop_check():
                    continue     # deliver first; poll on the next pass
                self._dyn.poll(dyn_tick)
                continue
            if sched_tick is not None:
                tick, _, kind = self._scheduled[0]
                self._ex.advance(max_tick=tick, stop_check=stop)
                if self._stop_check():
                    continue                 # scheduled exit stays queued
                if self._all_done():
                    # workload ended before the exit point: drop it
                    self._scheduled.pop(0)
                    continue
                self._scheduled.pop(0)
                if kind is ExitEventType.CHECKPOINT:
                    yield self._do_checkpoint(tick)
                elif kind is ExitEventType.STAT_DUMP:
                    self.dump_stats(reason=f"periodic @ tick {tick}")
                    if self._stat_dump_reset:
                        self.reset_stats()
                    if self._stat_dump_period:
                        self._schedule(tick + self._stat_dump_period,
                                       ExitEventType.STAT_DUMP)
                    yield ExitEvent(kind, tick=tick, cause="stat dump")
                else:
                    yield ExitEvent(kind, tick=tick, cause="max tick")
            else:
                finished = self._ex.advance(stop_check=stop)
                if self._stop_check():
                    continue
                if self._dyn is not None:
                    if (not self._dyn.done()
                            and self._dyn.next_event_tick() is None
                            and not self._dyn.pending_exits):
                        raise RuntimeError(
                            "dynamic workload stalled: engine idle, no "
                            "pending arrivals, workload not done")
                    continue
                if not finished:
                    self._ex.result()        # raises the deadlock error
        # not reached

    def run_to_completion(self,
                          verbose: Optional[bool] = None) -> ExecResult:
        """Drain every exit event and return the final ExecResult."""
        for _ in self.run(verbose=verbose):
            pass
        return self.result()

    # -- mid-run fidelity switching ---------------------------------------
    def switch_timing(self, timing) -> str:
        """Switch the run to another fidelity model *now* — the gem5
        ``switch_cpus`` move (§1.3.1): drain the in-flight work,
        serialize, and restore the very same state under ``timing``
        ("atomic" | "detailed").  Call between ``run()`` yields (at any
        exit event) or before the first; subsequent checkpoints resume
        under the new model.  Returns the resolved model name.

        The canonical sampled-simulation loop::

            sim = Simulator(board, trace, timing="atomic")
            sim.schedule_max_tick(region_of_interest_start)
            for ev in sim.run():
                if ev.kind is ExitEventType.MAX_TICK:
                    sim.switch_timing("detailed")   # warmed up: go O3
        """
        from repro_torch.core.desim.timing import get_timing_model
        name = get_timing_model(timing).name       # validate early
        self._ensure_started()
        if name == self._ex.timing.name:
            return name                            # already there
        self._ex_cfg["timing"] = name
        self._do_checkpoint(self._ex.now, save=False)
        return name

    # -- results / checkpoint API ----------------------------------------
    def save_checkpoint(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Checkpoint *now* (between ``run()`` yields, or before the
        first — a tick-0 checkpoint of a never-run simulation is
        valid): drain, serialize (to ``path`` if given), resume through
        restore.  Returns the checkpoint dict."""
        self._ensure_started()
        ev = self._do_checkpoint(self._ex.now)
        if path is not None:
            from repro_torch.sim import serialize as ser
            ser.save_checkpoint(ev.payload["checkpoint"], path)
            self.checkpoint_paths.append(path)
        return ev.payload["checkpoint"]

    def result(self) -> ExecResult:
        if self._result is None:
            raise RuntimeError("simulation has not completed; iterate "
                               "run() until DONE (or run_to_completion())")
        return self._result

    # -- observability (repro.sim.instrument) -----------------------------
    def _stat_groups(self) -> List[Any]:
        groups = []
        if self._ex.sim_root is not None:
            groups.append(self._ex.sim_root.stats)
        dyn_stats = getattr(self._dyn, "stats", None)
        if dyn_stats is not None:
            groups.append(dyn_stats)
        return groups

    def dump_stats(self, reason: str = "manual") -> str:
        """Render one gem5-format stats section (engine tree + dynamic-
        workload tree) — appended to ``<outdir>/stats.txt`` when the
        Simulator owns an outdir, returned either way.  Callable at any
        exit event, like gem5's ``m5.stats.dump()``."""
        self._ensure_started()
        now = self._ex.now
        extra = {"simTicks": now, "simSeconds": now / TICKS_PER_S}
        groups = self._stat_groups()
        if self.outdir is not None:
            return self.outdir.dump_stats(groups, extra=extra,
                                          reason=reason)
        return inst.render_stats_txt(groups, extra=extra, reason=reason)

    def reset_stats(self) -> None:
        """Zero every stat (gem5 ``m5.stats.reset()``): subsequent dumps
        cover only the interval since this call.  Reads of simulation
        *timing* state are untouched — resetting cannot perturb."""
        for g in self._stat_groups():
            g.reset()

    def host_record(self) -> Dict[str, Any]:
        """The machine-readable exit record (final tick, simSeconds,
        hostSeconds, simRate, events fired) — gem5's end-of-run banner
        as data.  Available once the run is DONE."""
        res = self.result()
        tick = (self._final_tick if self._final_tick is not None
                else res.final_tick)
        return inst.host_record(tick, self._host_seconds, res.events)

    def write_trace(self, path: Optional[str] = None) -> str:
        """Write the Perfetto/Chrome trace-event timeline (requires
        ``trace_events=True``).  Defaults to ``<outdir>/trace.json``;
        open at https://ui.perfetto.dev.  Under ``workers>1`` the
        worker lanes merge at result/snapshot collection, so call this
        after the run (run() does it automatically with an outdir)."""
        if self._recorder is None:
            raise RuntimeError("Simulator(trace_events=True) required "
                               "for write_trace()")
        if path is None:
            if self.outdir is None:
                raise ValueError("no path given and no outdir set")
            path = self.outdir.file(inst.OutDir.TRACE)
        return self._recorder.write(path)

    @property
    def trace_recorder(self):
        """The live TraceEventRecorder (None without trace_events)."""
        return self._recorder

    def _config_doc(self) -> Dict[str, Any]:
        """The run's full configuration as a JSON-able artifact
        (gem5 ``config.json``: defensible runs dump what they ran)."""
        ex_cfg = {k: v for k, v in self._ex_cfg.items()
                  if k != "instrument"}
        if self._dyn is not None:
            wl: Dict[str, Any] = {"kind": type(self._dyn).__name__}
            ser = getattr(self._dyn, "serialize", None)
            if callable(ser):
                wl["config"] = ser()
        else:
            wl = {"kind": "trace", "name": self._trace.name,
                  "ops": len(self._trace.ops),
                  "meta": dict(getattr(self._trace, "meta", {}) or {})}
        return {
            "format": "g5x-config",
            "version": 1,
            "board": {"name": self.board.name,
                      "algorithm": self.board.algorithm,
                      "straggler_slowdowns":
                          self.board.straggler_slowdowns,
                      "timing": self.board.timing},
            "machine": self.board.machine.serialize(),
            "executor": ex_cfg,
            "workload": wl,
            "debug_flags": dbg.enabled_flags(),
            "trace_events": self._recorder is not None,
        }

    @property
    def tick(self) -> int:
        return self._ex.now

    @property
    def sim_root(self):
        """Root of the run's SimObject tree (stats live on it)."""
        return self._ex.sim_root

    @property
    def workload(self):
        """The dynamic workload driving this run (None for traces)."""
        return self._dyn

    @property
    def machine(self) -> ClusterModel:
        return self.board.machine

    @property
    def timing(self) -> str:
        """Name of the fidelity model currently driving the run."""
        return self._ex.timing.name
