"""A copy of ``repro.core.desim.executor`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Event-driven trace replay on a machine model.

This is where the pillars meet (the gem5 'detailed CPU + Ruby + Garnet'
configuration): an elastic trace (trace.py) is replayed on a
parameterized cluster (machine.py) through pluggable collective
algorithms (collectives.py), driven by the deterministic event engine
(core/events.py), with dist-gem5 quantum synchronization between pods
(§2.17) and straggler injection (per-chip ``slowdown``).

Every run builds a SimObject tree (simnodes.py) — one :class:`ChipSim`
and :class:`WireSim` per pod plus one shared :class:`DcnSim`, wired
through ports — and replays the trace as events on per-pod
``EventQueue``s (1 tick = 1 ns).  There are no float resource clocks:
all arbitration happens in integer ticks on the queue.

Timing is **pluggable** (``repro.core.desim.timing`` — the gem5
CPU-model fidelity ladder): ``DetailedTiming`` gives the semantics
below; ``AtomicTiming`` costs ops contention-free with batch-resolved
completions (the fast-forward model), and a drained run may be
restored under the *other* model — gem5's ``switch_cpus``.

Detailed timing semantics per chip:

* ``compute`` ops serialize on the chip's compute resource at the
  roofline time ``max(flops/peak, bytes/hbm_bw) * slowdown``.
* intra-pod collectives occupy the concrete torus links of their
  ``region`` (default: the whole pod) on the pod's wire; collectives
  whose regions share a link serialize, disjoint regions run in
  parallel (the Garnet contention model, §2.13).  An ``overlap=True``
  collective occupies the wire but its time is not counted as exposed —
  this models async collectives / comm-compute overlap, the
  distributed-optimization trick the train step is structured around.
* cross-pod (dcn) collectives rendezvous on the shared fabric and
  complete at a quantum boundary delivered through ``QuantumSync``,
  reproducing dist-gem5's quantum-based synchronization error model.

Execution is **resumable** (gem5 §2.7 checkpoint/restore): ``execute``
is sugar for ``begin`` / ``advance`` / ``result``, and a paused run can
be gem5-style **drained** (in-flight events complete, newly-ready ops
are deferred instead of issued), snapshotted to a plain dict, and
**restored** — on the same machine or a re-parameterized one — with
``TraceExecutor.restore``.  The ``repro.sim`` front-end builds the
checkpoint file format and the exit-event loop on top of these hooks.

The trace is **not frozen**: ``inject_op`` appends ops to a live run
(dynamic workloads — gem5's "full application" mode, used by
``repro.sim.workloads.ServeSim`` for request-level serving).  Injected
ops execute on one pod, report completion through ``injection_hook``,
and ride the same drain/snapshot/restore path as static ops.

Pass ``record_stats=True`` to get the gem5-style statistics tree of the
run in ``ExecResult.stats`` (flat ``sim.chip0.ops_executed`` keys; the
full tree object is on ``TraceExecutor.sim_root`` after ``execute``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import trace as dbg
from repro_torch.core.desim.collectives import get_algorithm
from repro_torch.core.desim.machine import ClusterModel
from repro_torch.core.desim.simnodes import (ChipSim, ClusterSim, DcnSim,
                                       TICKS_PER_S, WireSim)
from repro_torch.core.desim.timing import (AtomicTiming, DetailedTiming,
                                     TimingModel, get_timing_model)
from repro_torch.core.desim.trace import HloTrace, TraceOp
from repro_torch.core.events import EventQueue, QuantumSync


@dataclass
class ExecResult:
    makespan_s: float
    compute_s: float
    collective_s: float
    exposed_collective_s: float     # collective time NOT hidden by overlap
    per_chip_busy_s: List[float]
    events: int                     # == engine events_fired (all queues)
    timeline: List[Dict] = field(default_factory=list)
    stats: Optional[Dict[str, Any]] = None   # flat gem5-style stats dump
    # exact integer makespan tick: makespan_s is this / TICKS_PER_S, and
    # round-tripping the float back to ticks can drift by ±1 on long runs
    final_tick: int = 0

    def summary(self) -> Dict[str, float]:
        return {
            "makespan_s": self.makespan_s,
            "compute_s": self.compute_s,
            "collective_s": self.collective_s,
            "exposed_collective_s": self.exposed_collective_s,
            "overlap_efficiency": (
                1.0 - self.exposed_collective_s / self.collective_s
                if self.collective_s > 0 else 1.0),
        }


# hook invoked on pod-0 op completion: (op, op_idx, start, end) -> None
OpHook = Callable[[TraceOp, int, int, int], None]

# hook invoked when an *injected* op completes on its owning pod:
# (op, op_idx, pod, start, end) -> None
InjectionHook = Callable[[TraceOp, int, int, int, int], None]


class TraceExecutor:
    """Replays an HloTrace on a ClusterModel.

    The model is SPMD: every chip executes the same trace (that is what
    a pjit program is), so we simulate one *representative chip per pod*
    plus shared wire resources, with stragglers making pods
    heterogeneous.  This keeps the DES cost O(ops x pods), which is what
    lets DSE sweeps run thousands of variants (the gem5 use case).

    ``timing`` selects the fidelity model (gem5's CPU-model ladder):
    ``"detailed"`` (default — link contention, quantum sync, engine
    events) or ``"atomic"`` (contention-free analytical costing, the
    fast-forward model; see ``repro.core.desim.timing``).  The old
    ``contention=False`` ablation is deprecated and maps to
    ``AtomicTiming`` — the contention-free baseline for measuring how
    much of a makespan is queueing.

    Lifecycle::

        ex.execute(trace)                    # one-shot (begin+advance+result)

        ex.begin(trace)                      # resumable
        while not ex.advance(max_tick=t):    # pause at tick boundaries
            t += ...
        res = ex.result()

        ex.drain(); state = ex.snapshot()    # gem5 drain-then-serialize
        ex2 = TraceExecutor(machine2, **cfg).restore(trace, state)
    """

    def __init__(self, machine: ClusterModel, algorithm: str = "torus2d",
                 record_timeline: bool = False,
                 straggler_slowdowns: Optional[List[float]] = None,
                 record_stats: bool = False,
                 contention: Optional[bool] = None, timing=None,
                 pod_labels: Optional[List[int]] = None,
                 dcn_capture: Optional[Callable[[dict], None]] = None,
                 instrument=None):
        self.machine = machine
        self.algorithm = algorithm
        self.alg = get_algorithm(algorithm)
        self.dcn_alg = get_algorithm("hierarchical")
        self.record_timeline = record_timeline
        self.record_stats = record_stats
        # fidelity selection: an explicit ``timing`` wins; the legacy
        # ``contention=False`` ablation maps to AtomicTiming (which has
        # the same contention-free op costs, minus the quantum error
        # model and the per-op engine events)
        if timing is None:
            if contention is False:
                warnings.warn(
                    "TraceExecutor(contention=False) is deprecated; use "
                    "timing='atomic' (the contention-free fidelity model)",
                    DeprecationWarning, stacklevel=2)
                timing = "atomic"
            else:
                timing = "detailed"
        self.timing: TimingModel = get_timing_model(timing)
        # legacy attribute: True iff link contention is simulated
        self.contention = self.timing.detailed
        pods = machine.num_pods
        self.slow = (straggler_slowdowns or [1.0] * pods)[:pods]
        while len(self.slow) < pods:
            self.slow.append(1.0)
        # Shard support (repro.core.desim.parallel): a worker process
        # simulates a SLICE of a larger machine, so its local pod p is
        # globally ``pod_labels[p]`` — SimObject/queue names use the
        # global label (stats subtrees land at their global path), and
        # run-wide accounting (totals/timeline/op_hook, once per static
        # op) happens on whichever local pod carries global label 0.
        if pod_labels is None:
            pod_labels = list(range(pods))
        if len(pod_labels) != pods:
            raise ValueError(f"pod_labels has {len(pod_labels)} entries "
                             f"for a {pods}-pod machine")
        self.pod_labels = [int(g) for g in pod_labels]
        self._account_local = (self.pod_labels.index(0)
                               if 0 in self.pod_labels else -1)
        # When set, cross-pod (dcn) arrivals are handed to this callback
        # instead of the in-process rendezvous — the parallel engine's
        # coordinator owns the shared fabric.
        self._dcn_capture = dcn_capture
        # Optional timeline recorder (repro.sim.instrument.
        # TraceEventRecorder duck-type): ``op_event`` fires once per
        # completed op per pod; read-only — tracing on vs off is
        # bit-identical (test-enforced)
        self.instrument = instrument
        self.sim_root: Optional[ClusterSim] = None
        self.op_hook: Optional[OpHook] = None
        self.injection_hook: Optional[InjectionHook] = None
        self._trace: Optional[HloTrace] = None

    # ------------------------------------------------------------------
    def _build(self, queues: List[EventQueue],
               sync: Optional[QuantumSync]) -> ClusterSim:
        """Assemble and wire the per-run SimObject tree."""
        m = self.machine
        root = ClusterSim("sim", num_pods=m.num_pods,
                          quantum_ns=m.quantum_ns)
        dcn = DcnSim("dcn", m, self.dcn_alg, queues, sync,
                     num_pods=m.num_pods, contention=self.contention,
                     capture=self._dcn_capture)
        root.dcn = dcn
        chips: List[ChipSim] = []
        wires: List[WireSim] = []
        for p in range(m.num_pods):
            g = self.pod_labels[p]
            chip = ChipSim(f"chip{g}", m.pod.chip, queues[p],
                           pod_id=p, slowdown=self.slow[p])
            wire = WireSim(f"wire{g}", m, self.alg, queues[p],
                           pod_id=p, contention=self.contention)
            chip.coll_port.connect(wire.chip_port)
            wire.dcn_port.connect(dcn.pod_ports[p])
            setattr(root, f"chip{g}", chip)
            setattr(root, f"wire{g}", wire)
            chips.append(chip)
            wires.append(wire)
        root.instantiate()
        self._chips, self._wires, self._dcn = chips, wires, dcn
        return root

    def _routes_dcn(self, op) -> bool:
        chips_per_pod = self.machine.pod.num_chips
        participants = op.participants or chips_per_pod
        return op.kind != "compute" and (op.scope == "dcn"
                                         or participants > chips_per_pod)

    # -- lifecycle: begin ------------------------------------------------
    def _setup(self, trace: HloTrace) -> None:
        """Common state for begin() and restore()."""
        m = self.machine
        pods = m.num_pods
        nops = len(trace.ops)
        self._trace = trace
        self._queues = [EventQueue(f"pod{self.pod_labels[p]}")
                        for p in range(pods)]
        self.timing.reset(self)
        needs_dcn = any(self._routes_dcn(op) for op in trace.ops)
        # quantum_ns == 0 means "no quantum error model": dcn ops then
        # complete at their exact tick instead of a sync boundary.
        # AtomicTiming never applies the quantum model (dcn ops complete
        # at their exact analytical tick).
        self._sync = (QuantumSync(self._queues, m.quantum_ns)
                      if needs_dcn and m.quantum_ns > 0
                      and self.timing.detailed else None)
        if self._sync is not None:
            # read-only barrier observer (Quantum DPRINTF + Perfetto
            # barrier track); runs after every queue reached the
            # boundary, so it cannot perturb event order
            self._sync.observer = self._sync_observe
        self.sim_root = self._build(self._queues, self._sync)
        # dependency bookkeeping (per pod: SPMD replicas diverge only
        # through stragglers and the shared dcn fabric)
        self._dependents: List[List[int]] = [[] for _ in range(nops)]
        for idx, op in enumerate(trace.ops):
            for d in op.deps:
                self._dependents[d].append(idx)
        self._remaining = [[len(op.deps) for op in trace.ops]
                           for _ in range(pods)]
        self._op_end: List[List[int]] = [[-1] * nops for _ in range(pods)]
        self._ncomplete = 0
        self._totals = {"compute": 0.0, "coll": 0.0, "exposed": 0.0}
        self._timeline: List[Dict] = []
        self._draining = False
        self._deferred: List[Tuple[int, int, int]] = []
        # dynamically injected ops: op_idx -> owning pod.  An injected op
        # runs on ONE pod only (the trace stops being SPMD there); the
        # other pods' rows are marked complete at injection time so the
        # done()/dependents bookkeeping stays uniform.
        self._injected: Dict[int, int] = {}
        # op_idx -> requested ready floor, for injected ops still
        # waiting on deps at injection time
        self._inject_floor: Dict[int, int] = {}

    def begin(self, trace: HloTrace) -> "TraceExecutor":
        """Build the SimObject tree and issue the trace's root ops.
        Call ``advance`` to make progress, ``result`` when done."""
        self._setup(trace)
        # roots of the DAG start at tick 0, in trace order per pod
        for p in range(self.machine.num_pods):
            for idx, op in enumerate(trace.ops):
                if not op.deps:
                    self._issue(p, idx, 0)
        return self

    # -- dynamic workloads: op injection into a live run ------------------
    def inject_op(self, op: TraceOp, ready: int, pod: int = 0) -> int:
        """Append ``op`` to the live trace and issue it on ``pod`` at tick
        >= ``ready`` (dynamic workloads: ops generated in *response to*
        events, not frozen up front — the gem5 'full application' mode).

        Unlike the static trace, an injected op executes on exactly one
        pod; its deps may reference any earlier op (static or injected)
        but must resolve on the owning pod.  Completion is reported
        through :attr:`injection_hook` as ``(op, idx, pod, start, end)``.
        Injection while draining defers the issue like any newly-ready
        op, so checkpoints taken mid-serving restore exactly.
        Returns the op's trace index.
        """
        if self._trace is None:
            raise RuntimeError("inject_op() before begin()/restore()")
        pods = self.machine.num_pods
        if not 0 <= pod < pods:
            raise ValueError(f"pod {pod} out of range (machine has {pods})")
        if self._routes_dcn(op):
            raise ValueError(
                f"cannot inject dcn-routed op {op.name or op.kind!r}: it "
                "would rendezvous on pods that never issue it (injected "
                "ops run on exactly one pod)")
        idx = len(self._trace.ops)
        for d in op.deps:
            if not 0 <= d < idx:
                raise ValueError(f"injected op dep {d} out of range")
            owner = self._injected.get(d)
            if owner is not None and owner != pod:
                raise ValueError(
                    f"injected op dep {d} belongs to pod {owner}, not {pod}")
        self._trace.ops.append(op)
        self._dependents.append([])
        for d in op.deps:
            self._dependents[d].append(idx)
        rem = sum(1 for d in op.deps if self._op_end[pod][d] < 0)
        ready = int(ready)
        for p in range(pods):
            self._op_end[p].append(-1)
            self._remaining[p].append(rem)
        self._injected[idx] = pod
        if dbg._ACTIVE:
            dbg.dprintf("Exec", self._queues[pod], "inject %s op=%d",
                        op.name or op.kind, idx, tick=ready)
        for p in range(pods):
            if p != pod:
                # non-owning pods never run the op: mark complete now
                self._op_end[p][idx] = ready
                self._ncomplete += 1
        if rem == 0:
            at = max([ready] + [self._op_end[pod][d] for d in op.deps])
            self._issue(pod, idx, at)
        else:
            # deps still in flight: remember the requested floor so the
            # dependent-issue path honors ``ready`` (dep end ticks alone
            # could issue the op earlier than asked)
            self._inject_floor[idx] = ready
        return idx

    # -- issue / completion ---------------------------------------------
    def _payload(self, p: int, idx: int, ready: int) -> dict:
        op = self._trace.ops[idx]
        payload = {"pod": p, "op_idx": idx, "ready": ready,
                   "name": op.name or op.kind, "done": self._on_done}
        if op.kind != "compute":
            payload.update(kind=op.kind, nbytes=op.coll_bytes,
                           participants=(op.participants
                                         or self.machine.pod.num_chips),
                           region=op.region,
                           dcn=self._routes_dcn(op))
        return payload

    def _sync_observe(self, t: int, delivered: int) -> None:
        if dbg._ACTIVE:
            dbg.dprintf("Quantum", "sync", "barrier delivered=%d",
                        delivered, tick=t)
        ins = self.instrument
        if ins is not None:
            ins.barrier_event(t)

    def _issue(self, p: int, idx: int, ready: int) -> None:
        if self._draining:
            # gem5 drain(): newly-ready work is deferred, in-flight
            # events complete.  The deferred frontier is what snapshot()
            # serializes and restore() re-schedules.
            self._deferred.append((p, idx, int(ready)))
            if dbg._ACTIVE:
                dbg.dprintf("Ckpt", self._queues[p],
                            "defer op=%d (draining)", idx, tick=ready)
            return
        if dbg._ACTIVE:
            op = self._trace.ops[idx]
            dbg.dprintf("Exec", self._queues[p], "issue %s op=%d kind=%s",
                        op.name or op.kind, idx, op.kind, tick=ready)
        self.timing.issue(self, p, idx, ready)

    def _on_done(self, start: int, end: int, payload: dict) -> None:
        p, idx = payload["pod"], payload["op_idx"]
        op = self._trace.ops[idx]
        ins = self.instrument
        if ins is not None:
            ins.op_event(self.pod_labels[p], payload, start, end)
        if dbg._ACTIVE:
            dbg.dprintf("Exec", self._queues[p], "complete %s op=%d",
                        payload.get("name", op.kind), idx, tick=end)
        if self._op_end[p][idx] < 0:
            self._ncomplete += 1
        self._op_end[p][idx] = end
        # snapshot the dependent list BEFORE any hook runs: a hook may
        # inject_op() a new op depending on this one, which appends to
        # _dependents[idx] — but inject_op already saw op_end >= 0 and
        # excluded this op from the new op's remaining count, so
        # processing the appended entry here would double-decrement
        dependents = list(self._dependents[idx])
        # totals/timeline count each op once: on pod 0 for static SPMD
        # ops (every pod runs a replica; in a parallel shard, on the
        # local pod carrying global label 0 — other shards skip), on
        # the owning pod for injected ops (they run exactly once)
        owner = self._injected.get(idx)
        if p == (self._account_local if owner is None else owner):
            dur = payload.get("dur")
            dur_s = (dur if dur is not None else end - start) \
                / TICKS_PER_S
            if op.kind == "compute":
                self._totals["compute"] += dur_s
            else:
                self._totals["coll"] += dur_s
                if not op.overlap:
                    # exposed = time the compute resource sat idle
                    # waiting for this collective
                    idle_from = max(self._chips[p].free_tick,
                                    payload["ready"])
                    self._totals["exposed"] += max(0, end - idle_from) \
                        / TICKS_PER_S
            if self.record_timeline:
                self._timeline.append({"op": op.name or op.kind,
                                       "kind": op.kind,
                                       "start": start / TICKS_PER_S,
                                       "end": end / TICKS_PER_S})
            if self.op_hook is not None and owner is None:
                # work-item markers are a static-trace concept; injected
                # ops report through injection_hook below
                self.op_hook(op, idx, start, end)
        if owner is not None and self.injection_hook is not None \
                and p == owner:
            self.injection_hook(op, idx, p, start, end)
        for dep_idx in dependents:
            if self._op_end[p][dep_idx] >= 0:
                # injected op owned by another pod: this pod's row was
                # marked complete at injection time — nothing to issue
                continue
            self._remaining[p][dep_idx] -= 1
            if self._remaining[p][dep_idx] == 0:
                ready = max(self._op_end[p][d]
                            for d in self._trace.ops[dep_idx].deps)
                floor = self._inject_floor.pop(dep_idx, None)
                if floor is not None:
                    ready = max(ready, floor)
                self._issue(p, dep_idx, ready)

    # -- lifecycle: advance ----------------------------------------------
    @property
    def now(self) -> int:
        """Latest tick any pod queue has reached."""
        if self._trace is None:
            return 0
        return max(q.now for q in self._queues)

    def done(self) -> bool:
        return (self._trace is not None and self._ncomplete ==
                len(self._trace.ops) * self.machine.num_pods)

    def advance(self, max_tick: Optional[int] = None,
                stop_check: Optional[Callable[[], bool]] = None) -> bool:
        """Fire events until the run completes, no event at tick
        <= ``max_tick`` remains, or ``stop_check()`` returns True
        (checked at quantum boundaries under QuantumSync, per event
        otherwise).  Returns ``done()``; call again to resume."""
        if self._trace is None:
            raise RuntimeError("advance() before begin()/restore()")
        self.timing.advance(self, max_tick, stop_check)
        return self.done()

    def _advance_nosync(self, max_tick: Optional[int],
                        stop_check: Optional[Callable[[], bool]]) -> None:
        """Globally tick-ordered merge over the pod queues (without a
        quantum model the queues are one logical timeline; cross-pod
        dcn deliveries land at their exact tick).  Ties break on pod
        index — deterministic."""
        queues = self._queues
        while True:
            if stop_check is not None and stop_check():
                return
            best_q = None
            best_nt = None
            for q in queues:
                nt = q.next_tick()
                if nt is None:
                    continue
                if best_nt is None or nt < best_nt:
                    best_nt, best_q = nt, q
            if best_q is None:
                return
            if max_tick is not None and best_nt > max_tick:
                return
            best_q.step()

    # -- lifecycle: drain / snapshot / restore ----------------------------
    def drain(self) -> bool:
        """gem5-style drain: suppress new issues, run until no in-flight
        event or cross-queue message remains.  After drain() the run is
        quiescent — ``snapshot()`` can serialize it.  A drained executor
        does not resume in place: rebuild with ``restore`` (the drain
        may have advanced pods far past the deferred frontier's ready
        ticks, and only a rebuild replays the frontier at its true
        ticks).  Returns ``done()``."""
        dbg.dprintf("Ckpt", "executor", "drain begin", tick=self.now)
        self._draining = True
        done = self.advance()
        dbg.dprintf("Ckpt", "executor", "drain complete deferred=%d",
                    len(self._deferred), tick=self.now)
        return done

    def drained(self) -> bool:
        return (self._trace is not None and self._draining
                and all(q.empty() for q in self._queues)
                and self.timing.quiescent(self)
                and (self._sync is None
                     or self._sync.pending_messages == 0))

    def snapshot(self) -> Dict[str, Any]:
        """Serializable (plain JSON-able dict) state of a drained run.
        See ``repro.sim.serialize`` for the versioned on-disk format."""
        if not self.drained():
            raise RuntimeError("snapshot() requires drain() first "
                               "(gem5: drain-then-serialize)")
        wires = []
        for w in self._wires:
            wires.append([[x, y, d, l.busy_until, l.bytes_carried,
                           l.transfers]
                          for (x, y, d), l in sorted(w._net.links.items())])
        rendezvous = self.timing.rendezvous_state(self)
        return {
            "tick": self.now,
            "timing": self.timing.name,
            "pod_dims": [self.machine.pod.nx, self.machine.pod.ny],
            "queues": [q.snapshot() for q in self._queues],
            "op_end": [list(row) for row in self._op_end],
            "deferred": [list(t) for t in self._deferred],
            "injected": sorted([idx, pod]
                               for idx, pod in self._injected.items()),
            "inject_floor": sorted([idx, f] for idx, f
                                   in self._inject_floor.items()),
            "rendezvous": rendezvous,
            "chip_free": [c.free_tick for c in self._chips],
            "wires": wires,
            "wire_busy": [w.busy_tick() for w in self._wires],
            "dcn_uplinks": [[l.busy_until, l.bytes_carried, l.transfers]
                            for l in self._dcn.uplinks],
            "stats": self.sim_root.stats.state_dict(),
            "totals": dict(self._totals),
            "timeline": list(self._timeline),
        }

    def restore(self, trace: HloTrace,
                state: Dict[str, Any]) -> "TraceExecutor":
        """Rebuild a drained run from ``snapshot()`` state and resume.

        The machine this executor wraps may be *re-parameterized*
        relative to the one the snapshot was taken on (the gem5 DSE
        trick: checkpoint once, sweep hardware from the checkpoint) —
        pod count must match (the trace is per-pod state); torus link
        occupancy transfers only when the pod dimensions match too.
        On the *same* machine, a restored run's final tick and stats
        tree are identical to one that never paused: the deferred
        frontier is re-scheduled at its exact ready ticks on fresh
        queues, so event order replays deterministically.

        The executor's ``timing`` model may also differ from the one
        the snapshot was taken under — the gem5 ``switch_cpus`` move:
        atomic fast-forward to a checkpoint, restore under detailed
        for the region of interest (``Simulator.switch_timing`` wraps
        this).  Switching detailed→atomic discards link-occupancy
        state (atomic does not model it).
        """
        pods = self.machine.num_pods
        if pods != len(state["op_end"]):
            raise ValueError(
                f"cannot restore a {len(state['op_end'])}-pod snapshot "
                f"onto a {pods}-pod machine (re-parameterize speeds, "
                "not the pod count)")
        self._setup(trace)
        nops = len(trace.ops)
        self._injected = {int(idx): int(p)
                          for idx, p in state.get("injected", [])}
        self._inject_floor = {int(idx): int(f)
                              for idx, f in state.get("inject_floor", [])}
        self._op_end = [[int(e) for e in row] for row in state["op_end"]]
        self._ncomplete = sum(1 for row in self._op_end
                              for e in row if e >= 0)
        for p in range(pods):
            for idx, op in enumerate(trace.ops):
                self._remaining[p][idx] = sum(
                    1 for d in op.deps if self._op_end[p][d] < 0)
        self._totals = {k: float(v) for k, v in state["totals"].items()}
        self._timeline = list(state.get("timeline", []))
        # carry the event accounting across the checkpoint: a restored
        # run's ExecResult.events then counts pre-pause + post-restore
        # firings (plus one re-issue event per deferred frontier op —
        # the only events a never-paused run does not have)
        for q, qsnap in zip(self._queues, state.get("queues", [])):
            q.events_fired = int(qsnap["events_fired"])
        self.sim_root.stats.load_state_dict(state["stats"])
        for p, free in enumerate(state["chip_free"]):
            self._chips[p]._free = int(free)
        same_dims = (list(state.get("pod_dims", [])) ==
                     [self.machine.pod.nx, self.machine.pod.ny])
        if same_dims and self.timing.detailed:
            for p, rows in enumerate(state["wires"]):
                net = self._wires[p]._net
                for x, y, d, busy, nbytes, transfers in rows:
                    link = net._link(int(x), int(y), d)
                    link.busy_until = busy
                    link.bytes_carried = nbytes
                    link.transfers = int(transfers)
        # wire-occupancy high-water mark: keeps per_chip_busy_s honest
        # across restores that cannot carry link state (atomic runs,
        # cross-model switches, re-dimensioned pods)
        for p, busy in enumerate(state.get("wire_busy", [])):
            if p < len(self._wires):
                self._wires[p]._busy_hwm = int(busy)
        for i, (busy, nbytes, transfers) in enumerate(state["dcn_uplinks"]):
            if i < len(self._dcn.uplinks):
                link = self._dcn.uplinks[i]
                link.busy_until = busy
                link.bytes_carried = nbytes
                link.transfers = int(transfers)
        # partial cross-pod rendezvous: re-arrive the pods that had
        # already reached the fabric (the transaction completes when
        # the remaining pods arrive)
        for r in state["rendezvous"]:
            idx = int(r["op_idx"])
            for p, ready in r["arrivals"]:
                self.timing.restore_arrival(self, int(p), idx, int(ready))
        # the deferred frontier replays at its exact ready ticks:
        # arbitration order interleaves with post-restore completions
        # exactly as in an uninterrupted run
        for p, idx, ready in state["deferred"]:
            self.timing.restore_issue(self, int(p), int(idx), int(ready))
        dbg.dprintf("Ckpt", "executor",
                    "restored deferred=%d rendezvous=%d timing=%s",
                    len(state["deferred"]), len(state["rendezvous"]),
                    self.timing.name, tick=int(state["tick"]))
        return self

    # -- lifecycle: result -------------------------------------------------
    def result(self) -> ExecResult:
        trace = self._trace
        if trace is None:
            raise RuntimeError("result() before begin()")
        pods = self.machine.num_pods
        nops = len(trace.ops)
        if not self.done():
            incomplete = [idx for idx in range(nops)
                          if any(self._op_end[p][idx] < 0
                                 for p in range(pods))]
            raise RuntimeError(
                f"trace deadlock: ops {incomplete[:5]} never completed "
                "(cyclic or dangling deps)")
        makespan_tick = max((max(ends) for ends in self._op_end),
                            default=0) if nops else 0
        per_pod_end = [max(self._chips[p].free_tick,
                           self._wires[p].busy_tick())
                       / TICKS_PER_S for p in range(pods)]
        return ExecResult(
            final_tick=makespan_tick,
            makespan_s=makespan_tick / TICKS_PER_S,
            compute_s=self._totals["compute"],
            collective_s=self._totals["coll"],
            exposed_collective_s=min(self._totals["exposed"],
                                     self._totals["coll"]),
            per_chip_busy_s=per_pod_end,
            events=sum(q.events_fired for q in self._queues),
            timeline=self._timeline,
            stats=(self.sim_root.stats.flat()
                   if self.record_stats else None),
        )

    # ------------------------------------------------------------------
    def execute(self, trace: HloTrace) -> ExecResult:
        self.begin(trace)
        self.advance()
        return self.result()


def predict_step_time(machine: ClusterModel, trace: HloTrace,
                      algorithm: str = "torus2d",
                      straggler_slowdowns: Optional[List[float]] = None
                      ) -> float:
    return TraceExecutor(machine, algorithm=algorithm,
                         straggler_slowdowns=straggler_slowdowns
                         ).execute(trace).makespan_s
