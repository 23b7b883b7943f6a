"""A copy of ``repro.core.desim.parallel`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

dist-gem5-style multiprocess pod sharding (gem5-20 paper §2.17, §4).

The paper credits dist-gem5 — partitioning the simulated system across
parallel gem5 processes that exchange network traffic only at
synchronization quanta — as what makes cluster-scale simulation
practical.  Our engine has the exact decomposition dist-gem5 needs (one
``EventQueue`` per pod, all cross-pod traffic batched onto quantum
boundaries by ``QuantumSync``, a drain/serialize cut with no in-flight
messages), so :class:`ParallelEngine` shards the machine's pods across
N worker processes:

* Each **worker** owns a contiguous pod range and runs a real
  :class:`TraceExecutor` over a shard-sized copy of the machine
  (``pod_labels`` keeps the global pod identities).  Between quantum
  barriers the worker advances its local queues with zero coordination.
* The **coordinator** (this process) owns the one true DCN fabric: it
  mirrors ``QuantumSync.run_until_drained``'s boundary arithmetic
  bit-for-bit (the shared helpers in ``repro.core.events``), collects
  cross-pod arrivals that workers capture via the ``DcnSim`` capture
  hook, replays the rendezvous/uplink/stat updates in the serial
  engine's canonical order, and broadcasts completion deliveries back —
  pipes carry only rendezvous metadata, never simulation objects.
* **Batched barriers + lookahead elision** (dist-gem5's quantum
  batching, gem5-20 §4): one message per worker per *grant* carries all
  of the shard's arrivals (one row per clone class, expanded by the
  coordinator) plus per-queue next-event ticks, and the coordinator
  grants multi-quantum advances across rendezvous-free gaps — a queue
  free-runs until it either captures a new DCN arrival (it then stops
  on its own) or reaches the safe horizon protecting queues with
  undelivered completions (``rendezvous_horizon``).  Dense-quantum
  configs collapse from one barrier per quantum to ~two per DCN
  collective; ``ParallelEngine.sync_stats`` exports barrier/message
  counters so the win is observable and test-assertable.
* **SPMD clone folding**: within a shard, pods whose straggler slowdown
  (and, on restore, whole serialized per-pod state) are identical evolve
  identically — per-pod evolution is a pure function of (trace, machine,
  slowdown, dcn completion schedule), and the completion schedule is
  broadcast to every pod.  Each class is simulated once and its results
  replicated, so a homogeneous 16-pod board costs 16/N pod-simulations
  across N workers.  This is what delivers wall-clock speedup even on a
  single core; on multicore the processes additionally run concurrently.

Exactness (test-enforced, see docs/parallel.md): with detailed timing
and a positive quantum, final tick, full stats tree, checkpoint dicts
and decision logs are bit-identical to the serial engine.  The engine
falls back to the in-process serial path when sharding cannot be exact:
dynamic workloads (``inject_op`` feedback couples pods through the
host), dcn traffic under atomic timing or ``quantum_ns == 0`` (exact-
tick delivery needs the global tick-ordered merge), or fewer than 2
pods/workers.  The ``hierarchical`` collective algorithm shards too:
shard machines carry ``global_num_pods`` so its intra-pod RS/AG and
DCN-ring phases cost identically to the full machine.

Checkpoints are worker-count-agnostic: collection loads worker state
into a dormant serial facade executor and calls its ``snapshot()``
verbatim, so a ``workers=4`` checkpoint restores under ``workers=1``
and vice versa (the restore path slices the same serial format).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import trace as dbg
from repro_torch.core.desim.executor import ExecResult, TraceExecutor
from repro_torch.core.desim.machine import ClusterModel
from repro_torch.core.desim.simnodes import TICKS_PER_S, to_ticks
from repro_torch.core.desim.trace import HloTrace
from repro_torch.core.events import (quantum_boundary, quantum_delivery,
                               rendezvous_horizon)
from repro_torch.core.stats import StatGroup

__all__ = ["ParallelEngine", "default_mp_context", "plan_shards",
           "fold_pods", "PARALLEL_PROTOCOL"]

#: wire-protocol version of the coordinator<->worker pipe messages and
#: of the parallel checkpoint layout.  v1: one barrier per quantum, one
#: arrival row per member pod.  v2: batched grants with lookahead
#: elision, one arrival row per clone class.  Embedded in checkpoint
#: documents (``repro.sim.serialize``) for forensics — checkpoints
#: themselves stay serial-format and protocol-agnostic.
PARALLEL_PROTOCOL = 2


def default_mp_context() -> str:
    """Start method for simulation worker processes.

    fork is cheap (~ms/worker) and preferred where available — but
    fork()ing a process whose JAX runtime is initialized deadlocks its
    multithreaded backend (CPython warns ``os.fork() was called ...
    likely lead to a deadlock``), and any benchmark or test that
    imported a kernel module has JAX loaded.  Spawn is fully supported
    here (init payloads are plain data, worker entry points are
    module-level), so pick it automatically whenever ``jax`` is in
    ``sys.modules``; an explicit ``mp_context=`` always wins.
    """
    if "jax" in sys.modules:
        return "spawn"
    return ("fork" if "fork" in mp.get_all_start_methods()
            else "spawn")


# ---------------------------------------------------------------------------
# shard planning / clone folding
# ---------------------------------------------------------------------------

def plan_shards(num_pods: int, workers: int) -> List[List[int]]:
    """Contiguous, balanced pod ranges — one per worker (clamped to
    ``num_pods``: a worker needs at least one pod)."""
    workers = max(1, min(int(workers), int(num_pods)))
    base, extra = divmod(num_pods, workers)
    shards, lo = [], 0
    for w in range(workers):
        size = base + (1 if w < extra else 0)
        shards.append(list(range(lo, lo + size)))
        lo += size
    return shards


def fold_pods(shard: List[int], keys: Dict[int, Any]
              ) -> Tuple[List[int], List[List[int]]]:
    """Group a shard's pods into SPMD clone classes by fold key.

    Returns ``(reps, members)``: ``reps[i]`` is the representative
    (first) pod of class ``i`` — the one actually simulated — and
    ``members[i]`` the ascending global pod ids its results replicate
    to.  Pods with distinct keys (different slowdown, or different
    restored state) never fold."""
    reps: List[int] = []
    members: List[List[int]] = []
    index: Dict[Any, int] = {}
    for g in shard:
        k = keys[g]
        i = index.get(k)
        if i is None:
            index[k] = len(reps)
            reps.append(g)
            members.append([g])
        else:
            members[i].append(g)
    return reps, members


def _pod_state_key(state: Dict[str, Any], g: int) -> str:
    """Canonical fingerprint of pod ``g``'s slice of a serial snapshot —
    pods may fold on restore only when their entire state matches."""
    children = state.get("stats", {}).get("children", {})
    row = {
        "op_end": state["op_end"][g],
        "queue": state["queues"][g],
        "chip_free": state["chip_free"][g],
        "wires": state["wires"][g] if g < len(state.get("wires", [])) else [],
        "wire_busy": state.get("wire_busy", [0] * (g + 1))[g],
        "deferred": [[idx, r] for p, idx, r in state.get("deferred", [])
                     if p == g],
        "rendezvous": [[r["op_idx"], a[1]] for r in state.get("rendezvous", [])
                       for a in r["arrivals"] if a[0] == g],
        "chip_stats": children.get(f"chip{g}"),
        "wire_stats": children.get(f"wire{g}"),
    }
    return json.dumps(row, sort_keys=True)


def _slice_state(state: Dict[str, Any], reps: List[int],
                 owns0: bool) -> Dict[str, Any]:
    """Shard-shaped serial snapshot holding only the representative
    pods' rows (the worker restores it through the ordinary
    ``TraceExecutor.restore``).  Run-wide accumulators (totals,
    timeline) go to the worker owning global pod 0; the shared-fabric
    state (dcn uplinks, rendezvous metadata, dcn stats) stays with the
    coordinator."""
    local = {g: i for i, g in enumerate(reps)}
    children = state.get("stats", {}).get("children", {})
    out: Dict[str, Any] = {
        "tick": state["tick"],
        "timing": state["timing"],
        "pod_dims": list(state.get("pod_dims", [])),
        "queues": [dict(state["queues"][g]) for g in reps],
        "op_end": [list(state["op_end"][g]) for g in reps],
        "deferred": [[local[p], int(idx), int(r)]
                     for p, idx, r in state.get("deferred", [])
                     if p in local],
        "injected": [],
        "inject_floor": [],
        "rendezvous": [],
        "chip_free": [state["chip_free"][g] for g in reps],
        "wires": [state["wires"][g] for g in reps],
        "wire_busy": [int(state["wire_busy"][g]) for g in reps]
        if state.get("wire_busy") else [],
        "dcn_uplinks": [],
        "stats": {"stats": {},
                  "children": {f"{kind}{g}": children[f"{kind}{g}"]
                               for g in reps for kind in ("chip", "wire")
                               if f"{kind}{g}" in children}},
        "totals": (dict(state["totals"]) if owns0
                   else {"compute": 0.0, "coll": 0.0, "exposed": 0.0}),
        "timeline": list(state.get("timeline", [])) if owns0 else [],
    }
    for r in state.get("rendezvous", []):
        arr = [[local[p], int(rd)] for p, rd in r["arrivals"] if p in local]
        if arr:
            out["rendezvous"].append({"op_idx": r["op_idx"],
                                      "arrivals": arr})
    return out


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

class _WorkerRecorder:
    """Worker-side timeline recorder: same op-row layout as
    ``repro.sim.instrument.TraceEventRecorder`` (which merges these rows
    at collect time), but defined here so ``repro.core`` never imports
    ``repro.sim``.  Rows are keyed by representative pod label; the
    coordinator expands SPMD clones."""

    def __init__(self):
        self.rows: List[list] = []

    def op_event(self, pod: int, payload: dict, start: int,
                 end: int) -> None:
        self.rows.append([
            pod, payload.get("op_idx", -1), payload.get("name", "op"),
            payload.get("kind", "compute"), payload.get("ready", start),
            start, end, bool(payload.get("dcn")), payload.get("dur"),
        ])

    def barrier_event(self, tick: int) -> None:
        pass   # barriers belong to the coordinator's lane


class _ShardRuntime:
    """Worker-side state: a shard TraceExecutor plus the capture/report
    bookkeeping that turns it into a dist-gem5 node."""

    def __init__(self, init: Dict[str, Any]):
        labels: List[int] = list(init["labels"])
        self.members: List[List[int]] = [list(m) for m in init["members"]]
        self.labels = labels
        self.barrier_mode: bool = bool(init["barrier_mode"])
        self.seq = 0                      # worker-local event sequence
        self.outbox: List[Dict[str, Any]] = []
        self.markers: List[List[int]] = []
        self.stash: Dict[Tuple[int, int], dict] = {}
        self.defer_tags: List[Tuple[int, int]] = []
        self._suppress = False            # restored arrivals: stash only
        self.hwm = 0                      # max tick actually *fired*
        # per-local-pod count of captured-but-undelivered dcn arrivals:
        # a queue with outstanding arrivals must respect the grant
        # horizon; one with none may free-run to its next capture
        self._outstanding: List[int] = []
        self._hit: List[bool] = []        # "captured a NEW arrival" latch
        # debug flags don't inherit under spawn: re-apply the parent's
        self._flags = list(init.get("debug_flags") or [])
        if self._flags:
            dbg.enable(self._flags)
        self.recorder = _WorkerRecorder() if init.get("instrument") \
            else None

        m = ClusterModel(init["machine"].get("name", "cluster"))
        m.load_serialized(init["machine"], strict=False)
        m.num_pods = len(labels)          # shard-sized machine
        # cost context: collective algorithms that read the pod count
        # (hierarchical) must see the *global* machine, not the shard
        m.global_num_pods = int(init["global_pods"])
        m.instantiate()
        self.quantum = int(m.quantum_ns)
        self.ex = TraceExecutor(
            m, algorithm=init["algorithm"],
            record_timeline=init["record_timeline"],
            straggler_slowdowns=list(init["slowdowns"]),
            record_stats=init["record_stats"],
            timing=init["timing"],
            pod_labels=labels,
            dcn_capture=self._capture,
            instrument=self.recorder)
        if 0 in labels:
            # run-wide markers fire on the pod carrying global label 0;
            # the coordinator replays them into the real op_hook
            self.ex.op_hook = (lambda op, idx, start, end:
                               self.markers.append([idx, start, end]))
        self._outstanding = [0] * len(labels)
        self._hit = [False] * len(labels)
        # tag deferred-frontier entries as they are appended, so the
        # coordinator can reassemble the serial engine's chronological
        # deferred order.  Under barriers the serial engine defers in
        # (barrier round, pod, order) order; the round of a deferral is
        # the quantum boundary of the event that triggered it, which is
        # computable locally even when a lookahead grant spans many
        # rounds.  Free-run mode uses the raw tick (the serial no-sync
        # merge is globally tick-ordered).
        orig_issue = self.ex._issue

        def tagged_issue(p: int, idx: int, ready: int) -> None:
            before = len(self.ex._deferred)
            orig_issue(p, idx, ready)
            if len(self.ex._deferred) > before:
                now = self.ex._queues[p].now
                mark = quantum_boundary(now, self.quantum) \
                    if self.barrier_mode else now
                self.defer_tags.append((int(mark), self.seq))
                self.seq += 1

        self.ex._issue = tagged_issue

        trace = HloTrace.from_json(init["trace"])
        state = init.get("restore")
        if state is None:
            self.ex.begin(trace)
        else:
            self._suppress = True
            try:
                self.ex.restore(trace, state)
            finally:
                self._suppress = False

    # -- dcn capture -----------------------------------------------------
    def _capture(self, payload: dict) -> None:
        p = payload["pod"]
        self.stash[(payload["op_idx"], p)] = payload
        self._outstanding[p] += 1
        if self._suppress:
            return                        # restored arrival: the
            # coordinator already holds it in its rendezvous map
        self._hit[p] = True               # lookahead stop-at-arrival
        # ONE row per clone class — the coordinator expands it to the
        # member pods (it planned the folding), keeping pipe traffic
        # O(classes) instead of O(pods)
        self.outbox.append({
            "op": payload["op_idx"], "rep": p,
            "ready": payload["ready"], "seq": self.seq,
            "kind": payload.get("kind"),
            "name": payload.get("name"),
            "nbytes": payload.get("nbytes"),
            "participants": payload.get("participants")})
        self.seq += 1

    # -- reporting -------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        ex = self.ex
        nts = [q.next_tick() for q in ex._queues]
        nt = min((t for t in nts if t is not None), default=None)
        rep = {
            "ok": True,
            "arrivals": self.outbox,
            "markers": self.markers,
            "next_tick": nt,
            "nexts": nts,                 # per clone class, for lookahead
            "nows": [q.now for q in ex._queues],
            "hwm": self.hwm,              # max tick actually fired
            "done": ex.done(),
            "now": max(q.now for q in ex._queues),
            "idle": (all(q.empty() for q in ex._queues)
                     and ex.timing.quiescent(ex)),
        }
        self.outbox, self.markers = [], []
        return rep

    # -- commands --------------------------------------------------------
    def _deliver(self, completions: List[Dict[str, Any]]) -> None:
        """Schedule due dcn completion deliveries at their exact
        delivery ticks (mirrors ``QuantumSync._advance_to``; the grant
        horizon guarantees no recipient queue has run past them)."""
        for c in completions:
            for p in range(len(self.labels)):
                w = self.stash.pop((c["op"], p), None)
                if w is None:
                    continue
                self._outstanding[p] -= 1
                w.update(start=c["start"], dur=c["dur"])
                q = self.ex._queues[p]
                done = w["done"]
                at = max(int(c["deliver"]), q.now)
                q.schedule(
                    (lambda w=w, q=q, done=done, start=c["start"]:
                     done(start, q.now, w)),
                    at, name=w.get("name", "dcn"))

    def _step_to(self, q, limit: Optional[int]) -> None:
        """Fire events without pushing ``q.now`` past them (unlike
        ``run_until``), so a queue stopped mid-grant reports its true
        position and later deliveries land at their exact ticks."""
        while True:
            nt = q.next_tick()
            if nt is None or (limit is not None and nt > limit):
                return
            q.step()
            if q.now > self.hwm:
                self.hwm = q.now

    def cmd_advance(self, cmd: Dict[str, Any]) -> Dict[str, Any]:
        """One batched grant: deliver due completions, then either run
        every queue to an explicit barrier tick (``align`` — the classic
        serial-schedule barrier, also used for the final queue-position
        alignment) or free-run each queue under lookahead: a queue stops
        on its own when it captures a NEW dcn arrival, queues holding
        undelivered arrivals additionally respect ``horizon``, and
        ``limit`` (advance's max_tick) caps everyone."""
        self._deliver(cmd["completions"])
        align = cmd.get("align")
        if align is not None:
            t = int(align)
            for q in self.ex._queues:
                self._step_to(q, t)       # fire (tracking hwm) ...
                q.run_until(t)            # ... then clamp now = t
            return self.report()
        horizon = cmd.get("horizon")
        limit = cmd.get("limit")
        for p, q in enumerate(self.ex._queues):
            lim = limit
            if self._outstanding[p] > 0 and horizon is not None:
                lim = horizon if lim is None else min(lim, horizon)
            self._hit[p] = False
            while True:
                nt = q.next_tick()
                if nt is None or (lim is not None and nt > lim):
                    break
                q.step()
                if q.now > self.hwm:
                    self.hwm = q.now
                if self._hit[p]:
                    break                 # stopped at a fresh arrival
        return self.report()

    def cmd_advance_free(self, cmd: Dict[str, Any]) -> Dict[str, Any]:
        """No-dcn mode: advance the shard independently (exact — pods
        in different workers cannot interact without dcn traffic)."""
        self.ex.advance(max_tick=cmd["max_tick"])
        return self.report()

    def cmd_drain(self, cmd: Dict[str, Any]) -> Dict[str, Any]:
        self.ex._draining = True
        return {"ok": True}

    def cmd_collect(self, cmd: Dict[str, Any]) -> Dict[str, Any]:
        """Everything the coordinator needs to reassemble the serial
        engine's snapshot/result, per representative pod."""
        ex = self.ex
        wires = []
        for w in ex._wires:
            wires.append([[x, y, d, l.busy_until, l.bytes_carried,
                           l.transfers]
                          for (x, y, d), l in sorted(w._net.links.items())])
        children = ex.sim_root.stats.state_dict()["children"]
        return {
            "ok": True,
            "labels": self.labels,
            "members": self.members,
            "op_end": [list(row) for row in ex._op_end],
            "chip_free": [c.free_tick for c in ex._chips],
            "wires": wires,
            "wire_busy": [w.busy_tick() for w in ex._wires],
            "queues": [q.snapshot() for q in ex._queues],
            "chip_stats": [children.get(f"chip{g}") for g in self.labels],
            "wire_stats": [children.get(f"wire{g}") for g in self.labels],
            "deferred": [list(t) for t in ex._deferred],
            "defer_tags": [list(t) for t in self.defer_tags],
            "totals": dict(ex._totals),
            "timeline": list(ex._timeline),
            "trace_rows": (self.recorder.rows if self.recorder is not None
                           else []),
        }


def _worker_main(conn) -> None:
    """Worker process entry point (module-level: spawn-safe).

    Processes stay warm across laps: an ``init`` command rebuilds the
    shard runtime in place (spawn-context startup re-imports heavy
    modules once, not once per ``begin()``/``restore()``)."""
    rt = None
    try:
        while True:
            cmd = conn.recv()
            op = cmd.get("cmd")
            if op == "exit":
                break
            if op == "init":
                rt = _ShardRuntime(cmd["init"])
                conn.send(rt.report())
            else:
                conn.send(getattr(rt, f"cmd_{op}")(cmd))
    except EOFError:
        pass
    except BaseException:
        try:
            conn.send({"error": traceback.format_exc()})
        except Exception:
            pass
    finally:
        try:
            conn.close()
        except Exception:
            pass


def _shutdown(conns, procs) -> None:
    for conn in conns:
        try:
            conn.send({"cmd": "exit"})
        except Exception:
            pass
        try:
            conn.close()
        except Exception:
            pass
    for p in procs:
        try:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------

class ParallelEngine:
    """Multiprocess drop-in for :class:`TraceExecutor` (``workers=N``).

    Wraps a dormant serial *facade* executor over the full machine: the
    facade's SimObject tree carries the run's stats/fabric state, and
    ``snapshot()``/``result()`` are the facade's own — which is what
    makes parallel results and checkpoints bit-identical to serial ones
    and worker-count-agnostic.  When sharding cannot be exact (see
    module docstring) the facade simply runs the workload itself
    (``serial`` mode) and every call delegates.
    """

    def __init__(self, machine: ClusterModel, workers: int = 2,
                 mp_context: Optional[str] = None,
                 algorithm: str = "torus2d",
                 record_timeline: bool = False,
                 straggler_slowdowns: Optional[List[float]] = None,
                 record_stats: bool = False,
                 contention: Optional[bool] = None, timing=None,
                 instrument=None):
        self._facade = TraceExecutor(
            machine, algorithm=algorithm,
            record_timeline=record_timeline,
            straggler_slowdowns=straggler_slowdowns,
            record_stats=record_stats,
            contention=contention, timing=timing,
            instrument=instrument)
        self.workers = max(1, int(workers))
        if mp_context is None:
            mp_context = default_mp_context()
        self.mp_context = mp_context
        self._mode: Optional[str] = None   # "serial" | "sync" | "free"
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._winfo: List[Dict[str, Any]] = []
        self._pending: List[Tuple[int, Dict[str, Any]]] = []
        self._t_now = 0
        self._draining = False
        self._collected: Optional[List[Dict[str, Any]]] = None
        self._finalizer: Optional[weakref.finalize] = None
        # lookahead bookkeeping (sync mode)
        self._hwm = 0                      # max tick fired by any worker
        self._aligned_to = 0               # last alignment barrier tick
        self._align_goal = 0               # serial end-of-advance position
        self._wmembers: List[List[List[int]]] = []   # per worker: members
        self._owner: Dict[int, Tuple[int, int]] = {}  # pod -> (widx, rep)
        self._reset_lap_stats()

    def _reset_lap_stats(self) -> None:
        """Coordinator-local counters + phase timers, fresh per lap.
        Deliberately NOT part of the facade stats tree: barrier counts
        are a property of the parallel schedule, and the facade tree
        must stay bit-identical to a serial run."""
        s = StatGroup("parallel")
        self.st_barriers = s.scalar(
            "barriers", "coordinator round trips (grants + alignments)")
        self.st_grants = s.scalar(
            "lookahead_grants", "multi-quantum lookahead grants")
        self.st_aligns = s.scalar(
            "alignment_barriers", "classic run_until-style barriers")
        self.st_msgs_out = s.scalar(
            "pipe_msgs_sent", "messages coordinator -> workers")
        self.st_msgs_in = s.scalar(
            "pipe_msgs_recv", "messages workers -> coordinator")
        self.st_arrival_rows = s.scalar(
            "arrival_rows", "dcn arrival rows received (per clone class)")
        self.st_completions = s.scalar(
            "completion_rows", "dcn completion rows delivered")
        self.st_elided = s.scalar(
            "quanta_elided", "quantum boundaries crossed without a barrier")
        self.sync_stats = s
        #: wall-clock seconds per coordination phase (benchmark probe)
        self.phase_wall: Dict[str, float] = {
            "spawn": 0.0, "barrier_wait": 0.0, "collect": 0.0}

    def sync_counters(self) -> Dict[str, int]:
        """Plain-dict view of ``sync_stats`` (benchmarks, CI asserts)."""
        return {name: int(st.value())
                for name, st in self.sync_stats.stats().items()}

    # -- facade delegation ----------------------------------------------
    def __getattr__(self, name: str):
        facade = self.__dict__.get("_facade")
        if facade is None or name.startswith("__"):
            raise AttributeError(name)
        return getattr(facade, name)

    @property
    def op_hook(self):
        return self._facade.op_hook

    @op_hook.setter
    def op_hook(self, fn) -> None:
        self._facade.op_hook = fn

    @property
    def injection_hook(self):
        return self._facade.injection_hook

    @injection_hook.setter
    def injection_hook(self, fn) -> None:
        self._facade.injection_hook = fn

    @property
    def instrument(self):
        return self._facade.instrument

    @instrument.setter
    def instrument(self, rec) -> None:
        # must be set before begin()/restore(): workers learn whether to
        # record at spawn time (serial-fallback mode uses it directly)
        self._facade.instrument = rec

    @property
    def now(self) -> int:
        if self._mode in (None, "serial"):
            return self._facade.now
        return max([self._t_now] + [w["now"] for w in self._winfo])

    # -- mode selection ---------------------------------------------------
    def _parallel_plan(self, trace: HloTrace,
                       state: Optional[Dict[str, Any]]) -> Optional[str]:
        """Return "sync"/"free" when sharding is exact, None for the
        serial fallback."""
        f = self._facade
        n = f.machine.num_pods
        if self.workers <= 1 or n < 2:
            return None
        if state is not None and (state.get("injected")
                                  or state.get("inject_floor")):
            return None                   # dynamic workload checkpoint
        needs_dcn = any(f._routes_dcn(op) for op in trace.ops)
        if not needs_dcn:
            return "free"
        if f.timing.parallel_dcn_ok and f.machine.quantum_ns > 0:
            return "sync"
        return None                       # exact-tick dcn delivery

    # -- lifecycle: begin / restore ---------------------------------------
    def _reset_lap(self) -> None:
        """Per-lap coordinator state (the warm worker pool survives)."""
        self._winfo = []
        self._pending = []
        self._t_now = 0
        self._hwm = 0
        self._aligned_to = 0
        self._align_goal = 0
        self._draining = False
        self._collected = None
        self._reset_lap_stats()

    def begin(self, trace: HloTrace) -> "ParallelEngine":
        self._reset_lap()
        mode = self._parallel_plan(trace, None)
        if mode is None:
            self._mode = "serial"
            self._facade.begin(trace)
            return self
        self._mode = mode
        self._facade._setup(trace)        # dormant: never issues ops
        self._spawn(trace, None)
        return self

    def restore(self, trace: HloTrace,
                state: Dict[str, Any]) -> "ParallelEngine":
        self._reset_lap()
        mode = self._parallel_plan(trace, state)
        if mode is None:
            self._mode = "serial"
            self._facade.restore(trace, state)
            return self
        f = self._facade
        if f.machine.num_pods != len(state["op_end"]):
            raise ValueError(
                f"cannot restore a {len(state['op_end'])}-pod snapshot "
                f"onto a {f.machine.num_pods}-pod machine "
                "(re-parameterize speeds, not the pod count)")
        self._mode = mode
        f._setup(trace)
        # the coordinator owns the shared fabric: uplink occupancy, dcn
        # stats and partial rendezvous.  Per-pod (chip/wire) stat
        # subtrees are NOT loaded here — the workers continue them from
        # the sliced restore state and merge them back at collect time,
        # and a merge into untouched stats is what stays bit-exact
        for i, (busy, nbytes, transfers) in enumerate(state["dcn_uplinks"]):
            if i < len(f._dcn.uplinks):
                link = f._dcn.uplinks[i]
                link.busy_until = busy
                link.bytes_carried = nbytes
                link.transfers = int(transfers)
        sd = state["stats"]
        f.sim_root.stats.load_state_dict(
            {"stats": sd.get("stats", {}),
             "children": {k: v for k, v in sd.get("children", {}).items()
                          if not (k.startswith("chip")
                                  or k.startswith("wire"))}})
        for r in state.get("rendezvous", []):
            arr = r["arrivals"]
            f._dcn._rendezvous[int(r["op_idx"])] = {
                "arrived": len(arr),
                "first": min(rd for _, rd in arr),
                "last": max(rd for _, rd in arr),
                "waiters": [{"pod": int(p), "ready": int(rd)}
                            for p, rd in arr],
            }
        self._spawn(trace, state)
        return self

    def _ensure_pool(self, nworkers: int) -> None:
        """Spawn (or reuse) the warm worker pool: processes persist
        across ``begin()``/``restore()`` laps — an ``init`` command
        rebuilds the shard runtime in the existing process, skipping
        the spawn-context interpreter+import cost per lap."""
        if self._procs and len(self._procs) == nworkers \
                and all(p.is_alive() for p in self._procs):
            return
        self.close()
        ctx = mp.get_context(self.mp_context)
        for _ in range(nworkers):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker_main, args=(child,),
                               daemon=True)
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._finalizer = weakref.finalize(self, _shutdown,
                                           self._conns, self._procs)

    def _spawn(self, trace: HloTrace, state: Optional[Dict[str, Any]]
               ) -> None:
        t0 = time.perf_counter()
        f = self._facade
        n = f.machine.num_pods
        if state is None:
            keys: Dict[int, Any] = {g: repr(f.slow[g]) for g in range(n)}
        else:
            keys = {g: (repr(f.slow[g]), _pod_state_key(state, g))
                    for g in range(n)}
        machine_dict = f.machine.serialize()
        trace_json = trace.to_json()
        shards = plan_shards(n, self.workers)
        self._ensure_pool(len(shards))
        self._wmembers = []
        self._owner = {}
        for widx, shard in enumerate(shards):
            reps, members = fold_pods(shard, keys)
            init = {
                "machine": machine_dict,
                "trace": trace_json,
                "labels": reps,
                "members": members,
                "global_pods": n,
                "slowdowns": [f.slow[g] for g in reps],
                "algorithm": f.algorithm,
                "timing": f.timing.name,
                "record_stats": f.record_stats,
                "record_timeline": f.record_timeline,
                "barrier_mode": self._mode == "sync",
                "instrument": f.instrument is not None,
                "debug_flags": dbg.enabled_flags(),
            }
            if state is not None:
                init["restore"] = _slice_state(state, reps,
                                               owns0=0 in shard)
            self._conns[widx].send({"cmd": "init", "init": init})
            self.st_msgs_out.inc()
            self._wmembers.append([list(m) for m in members])
            for i, mm in enumerate(members):
                for g in mm:
                    self._owner[g] = (widx, i)
        for i, conn in enumerate(self._conns):
            self._winfo.append(self._recv(conn, i))
        self.phase_wall["spawn"] += time.perf_counter() - t0
        dbg.dprintf("Parallel", "engine", "launched %d workers mode=%s",
                    len(self._conns), self._mode, tick=self._t_now)

    def _recv(self, conn, i: int) -> Dict[str, Any]:
        try:
            rep = conn.recv()
        except EOFError:
            raise RuntimeError(f"parallel worker {i} died "
                               "(pipe closed mid-run)") from None
        if "error" in rep:
            raise RuntimeError(
                f"parallel worker {i} failed:\n{rep['error']}")
        self.st_msgs_in.inc()
        return rep

    def _broadcast(self, cmd: Dict[str, Any],
                   phase: str = "barrier_wait") -> List[Dict[str, Any]]:
        t0 = time.perf_counter()
        for conn in self._conns:
            conn.send(cmd)
        self.st_msgs_out.inc(len(self._conns))
        replies = [self._recv(conn, i)
                   for i, conn in enumerate(self._conns)]
        self.phase_wall[phase] += time.perf_counter() - t0
        return replies

    # -- advance ----------------------------------------------------------
    def _merge_reply(self, i: int, rep: Dict[str, Any],
                     rows: List[Dict[str, Any]]) -> None:
        w = self._winfo[i]
        w.update(next_tick=rep["next_tick"], done=rep["done"],
                 now=rep["now"], idle=rep["idle"],
                 nexts=rep.get("nexts"), nows=rep.get("nows"))
        hwm = int(rep.get("hwm", 0))
        if hwm > self._hwm:
            self._hwm = hwm
        # expand per-clone-class arrival rows to their member pods (the
        # wire carries one row per class; members share tick and seq)
        self.st_arrival_rows.inc(len(rep["arrivals"]))
        members = self._wmembers[i] if self._wmembers else None
        for a in rep["arrivals"]:
            for g in members[a["rep"]]:
                row = dict(a)
                row["pod"] = g
                rows.append(row)
        if rep["markers"] and self._facade.op_hook is not None:
            ops = self._facade._trace.ops
            for idx, start, end in rep["markers"]:
                self._facade.op_hook(ops[idx], idx, start, end)

    def _after_barrier(self, replies: List[Dict[str, Any]]) -> None:
        rows: List[Dict[str, Any]] = []
        for i, rep in enumerate(replies):
            self._merge_reply(i, rep, rows)
        if rows:
            self._process_arrivals(rows)

    def _process_arrivals(self, rows: List[Dict[str, Any]]) -> None:
        """Replay ``DcnSim._on_arrive`` on the facade's fabric, in the
        serial engine's canonical order: serially, an arrival at tick
        ``e`` happens in barrier round ``quantum_boundary(e)``, and
        within a round ``_advance_to`` runs queue 0 fully, then queue 1,
        ... — i.e. arrivals ordered by (round, global pod, per-pod event
        sequence).  The round key matters under lookahead: one batched
        grant can span many serial rounds, and two in-flight rendezvous
        must complete in the serial (chronological) order because uplink
        contention arithmetic is order-dependent."""
        f = self._facade
        dcn = f._dcn
        quantum = f.machine.quantum_ns
        for a in sorted(rows, key=lambda a: (
                quantum_boundary(a["ready"], quantum), a["pod"], a["seq"])):
            r = dcn._rendezvous.setdefault(
                a["op"], {"arrived": 0, "first": a["ready"], "last": 0,
                          "waiters": []})
            r["arrived"] += 1
            r["first"] = min(r["first"], a["ready"])
            r["last"] = max(r["last"], a["ready"])
            r["waiters"].append({"pod": a["pod"], "ready": a["ready"]})
            r["kind"] = a["kind"]
            r["name"] = a.get("name") or a["kind"]
            r["nbytes"] = a["nbytes"]
            r["participants"] = a["participants"]
            if r["arrived"] < f.machine.num_pods:
                continue
            del dcn._rendezvous[a["op"]]
            dur = to_ticks(f.dcn_alg.time_s(r["kind"], r["nbytes"],
                                            r["participants"], f.machine))
            if dcn.contention:
                start = max([r["last"]]
                            + [int(l.busy_until) for l in dcn.uplinks])
            else:
                start = r["last"]
            end = start + dur
            for l in dcn.uplinks:
                l.busy_until = max(l.busy_until, end)
                l.bytes_carried += r["nbytes"] / len(dcn.uplinks)
                l.transfers += 1
            dcn.st_colls.inc()
            dcn.st_bytes.inc(r["nbytes"])
            dcn.st_busy.inc(dur / TICKS_PER_S)
            dcn.st_skew.sample((r["last"] - r["first"]) / TICKS_PER_S)
            deliver = quantum_delivery(r["last"], end - r["last"], quantum)
            if dbg._ACTIVE:
                dbg.dprintf("Dcn", "coordinator",
                            "%s op=%d fire start=%d dur=%d deliver=%d",
                            r["name"], a["op"], start, dur, deliver,
                            tick=end)
            ins = f.instrument
            if ins is not None:
                ins.dcn_event(a["op"], r["name"], start, dur, deliver,
                              [(w["pod"], w["ready"])
                               for w in r["waiters"]])
            self._pending.append((deliver, {"op": a["op"], "start": start,
                                            "dur": dur,
                                            "deliver": deliver}))

    def _due(self, t: Optional[int]) -> List[Dict[str, Any]]:
        """Pop pending completion deliveries with deliver <= t."""
        if t is None:
            due = [c for _, c in self._pending]
            self._pending = []
        else:
            due = [c for d, c in self._pending if d <= t]
            self._pending = [(d, c) for d, c in self._pending if d > t]
        self.st_completions.inc(len(due))
        return due

    def _safe_horizon(self) -> Optional[int]:
        """Largest tick every queue *holding undelivered arrivals* may
        safely reach: the min over (a) exact pending delivery ticks and
        (b) ``rendezvous_horizon`` of each incomplete rendezvous, seeded
        with a lower bound on its final arrival (its last arrival so
        far, and each missing pod's next event tick).  Every bound is an
        under-estimate of the true delivery tick, so no bounded queue
        can ever run past a delivery it has not seen.  ``None`` =
        unbounded (no rendezvous in flight at all)."""
        f = self._facade
        quantum = f.machine.quantum_ns
        pend_min = min((d for d, _ in self._pending), default=None)
        bounds: List[int] = [] if pend_min is None else [pend_min]
        for r in f._dcn._rendezvous.values():
            arrived = {w["pod"] for w in r["waiters"]}
            lb = r["last"]
            for g in range(f.machine.num_pods):
                if g in arrived:
                    continue
                widx, rep = self._owner[g]
                w = self._winfo[widx]
                nt = (w.get("nexts") or [None] * (rep + 1))[rep]
                if nt is None:
                    now = (w.get("nows") or [w["now"]] * (rep + 1))[rep]
                    nt = now if pend_min is None else max(now, pend_min)
                if nt > lb:
                    lb = nt
            bounds.append(rendezvous_horizon(lb, quantum))
        return min(bounds) if bounds else None

    def _grant(self, horizon: Optional[int],
               limit: Optional[int]) -> bool:
        """One batched lookahead round trip: ship due completions, let
        every queue free-run (stop-at-arrival; ``horizon`` bounds
        stash-holders, ``limit`` bounds everyone).  Returns whether any
        simulation progress happened (events fired, arrivals captured,
        or completions delivered)."""
        cap = horizon
        if limit is not None:
            cap = limit if cap is None else min(cap, limit)
        due = self._due(cap)
        before = self._hwm
        arrivals0 = int(self.st_arrival_rows.value())
        replies = self._broadcast({"cmd": "advance", "completions": due,
                                   "horizon": horizon, "limit": limit})
        self.st_barriers.inc()
        self.st_grants.inc()
        self._after_barrier(replies)
        if dbg._ACTIVE:
            dbg.dprintf("Parallel", "engine",
                        "grant horizon=%s limit=%s delivered=%d",
                        horizon, limit, len(due), tick=self._hwm)
        return (bool(due) or self._hwm > before
                or int(self.st_arrival_rows.value()) > arrivals0)

    def _align(self, t: int) -> None:
        """Classic barrier: deliver due completions and run every queue
        to ``t`` (the serial engine's ``_advance_to``) — used as the
        no-progress fallback and to land queues on the exact serial
        end-of-advance position before drain/snapshot."""
        due = self._due(t)
        replies = self._broadcast({"cmd": "advance", "completions": due,
                                   "align": t})
        self.st_barriers.inc()
        self.st_aligns.inc()
        self._t_now = max(self._t_now, t)
        self._after_barrier(replies)
        if dbg._ACTIVE:
            dbg.dprintf("Parallel", "engine", "barrier delivered=%d",
                        len(due), tick=t)
        ins = self._facade.instrument
        if ins is not None:
            ins.barrier_event(t)

    def _advance_sync(self, max_tick: Optional[int],
                      stop_check: Optional[Callable[[], bool]]) -> None:
        """Coordinator-as-clock with dist-gem5 lookahead elision.

        Instead of mirroring ``QuantumSync.run_until_drained`` barrier
        for barrier, the coordinator issues multi-quantum *grants*: each
        queue free-runs until it captures a new DCN arrival (at which
        point it stops on its own — every rendezvous it could be party
        to needs its arrival, and the delivery lands at least one
        quantum later), bounded by ``_safe_horizon`` while it holds
        undelivered traffic.  Exactness argument in docs/parallel.md:
        every event fires at the same tick as serially, arrivals are
        replayed in (round, pod, seq) order, and a final alignment
        barrier lands all queues on the serial end-of-advance position
        ``quantum_boundary(last fired tick)`` (clamped by the max_tick
        of the advance call that fired it, exactly as the serial clamp
        does)."""
        quantum = self._facade.machine.quantum_ns
        hwm0, bar0 = self._hwm, int(self.st_barriers.value())
        while True:
            if stop_check is not None and stop_check():
                self._update_align_goal(max_tick, quantum)
                return                    # paused: no alignment yet
            upcoming = [w["next_tick"] for w in self._winfo
                        if w["next_tick"] is not None]
            if self._pending:
                upcoming.append(min(d for d, _ in self._pending))
            if not upcoming:
                break
            target = min(upcoming)
            if max_tick is not None and target > max_tick:
                break
            if not self._grant(self._safe_horizon(), max_tick):
                # conservative horizon pinned every queue below its next
                # event: take one classic serial-schedule barrier.  It
                # fires at least the earliest event, and it is always
                # delivery-safe: any not-yet-computed completion's last
                # arrival is an unfired event >= target, so its delivery
                # lands >= quantum_boundary(target) + quantum > t.
                self._align(quantum_boundary(target, quantum))
        self._update_align_goal(max_tick, quantum)
        if self._align_goal > self._aligned_to:
            self._align(self._align_goal)
            self._aligned_to = self._align_goal
        crossed = (self._aligned_to - (hwm0 // quantum) * quantum) \
            // quantum
        executed = int(self.st_barriers.value()) - bar0
        if crossed > executed:
            self.st_elided.inc(crossed - executed)

    def _update_align_goal(self, max_tick: Optional[int],
                           quantum: int) -> None:
        """Track the serial engine's end-of-advance queue position:
        ``quantum_boundary(max tick fired)``, clamped by the max_tick of
        the call in which those events fired (the serial loop's final
        ``_advance_to(max_tick)`` clamp)."""
        if self._hwm <= 0:
            return
        goal = quantum_boundary(self._hwm, quantum)
        if max_tick is not None:
            goal = min(goal, max_tick)
        if goal > self._align_goal:
            self._align_goal = goal

    def _advance_free(self, max_tick: Optional[int],
                      stop_check: Optional[Callable[[], bool]]) -> None:
        if stop_check is not None and stop_check():
            return
        replies = self._broadcast({"cmd": "advance_free",
                                   "max_tick": max_tick})
        self._after_barrier(replies)

    def advance(self, max_tick: Optional[int] = None,
                stop_check: Optional[Callable[[], bool]] = None) -> bool:
        if self._mode is None:
            raise RuntimeError("advance() before begin()/restore()")
        if self._mode == "serial":
            return self._facade.advance(max_tick, stop_check)
        if self._collected is not None:
            if self.done() or self._draining:
                return self.done()
            raise RuntimeError("cannot advance a collected parallel run "
                               "(restore from its checkpoint instead)")
        if self._mode == "sync":
            self._advance_sync(max_tick, stop_check)
        else:
            self._advance_free(max_tick, stop_check)
        return self.done()

    def done(self) -> bool:
        if self._mode in (None, "serial"):
            return self._facade.done()
        return all(w["done"] for w in self._winfo)

    # -- drain / snapshot / result ----------------------------------------
    def drain(self) -> bool:
        if self._mode == "serial":
            return self._facade.drain()
        self._draining = True
        self._facade._draining = True
        if self._collected is None:
            self._broadcast({"cmd": "drain"})
            return self.advance()
        return self.done()

    def drained(self) -> bool:
        if self._mode == "serial":
            return self._facade.drained()
        return (self._mode is not None and self._draining
                and not self._pending
                and all(w.get("idle") for w in self._winfo))

    def snapshot(self) -> Dict[str, Any]:
        if self._mode == "serial":
            return self._facade.snapshot()
        if not self.drained():
            raise RuntimeError("snapshot() requires drain() first "
                               "(gem5: drain-then-serialize)")
        self._collect()
        return self._facade.snapshot()

    def result(self) -> ExecResult:
        if self._mode == "serial":
            return self._facade.result()
        self._collect()
        return self._facade.result()

    def _collect(self) -> None:
        """Pull worker shard state into the facade executor (expanding
        folded clones), after which the facade's own ``snapshot()`` /
        ``result()`` produce serial-format, serial-identical output.
        The warm worker pool survives — a collected engine answers any
        number of snapshot/result calls, cannot advance, but its next
        ``begin()``/``restore()`` reuses the live processes."""
        if self._collected is not None:
            return
        # a run can end mid-grant (stop_check fired on the advance that
        # fired the last event): land the deferred alignment barrier so
        # collected queue positions match the serial engine's
        if self._mode == "sync" and self._align_goal > self._aligned_to:
            self._align(self._align_goal)
            self._aligned_to = self._align_goal
        replies = self._broadcast({"cmd": "collect"}, phase="collect")
        f = self._facade
        ins = f.instrument
        if ins is not None:
            for widx, rep in enumerate(replies):
                ins.add_worker(widx, rep["labels"], rep["members"],
                               rep.get("trace_rows", []))
        dbg.dprintf("Parallel", "engine", "collected %d workers",
                    len(replies), tick=self.now)
        deferred: List[Tuple[Tuple[int, int], int, int, int]] = []
        for rep in replies:
            members = rep["members"]
            for i in range(len(rep["labels"])):
                for g in members[i]:
                    f._op_end[g] = list(rep["op_end"][i])
                    f._chips[g]._free = int(rep["chip_free"][i])
                    net = f._wires[g]._net
                    for x, y, d, busy, nbytes, transfers in rep["wires"][i]:
                        link = net._link(int(x), int(y), d)
                        link.busy_until = busy
                        link.bytes_carried = nbytes
                        link.transfers = int(transfers)
                    f._wires[g]._busy_hwm = int(rep["wire_busy"][i])
                    q = f._queues[g]
                    q.events_fired = int(rep["queues"][i]["events_fired"])
                    q.run_until(int(rep["queues"][i]["now"]))
                    # per-pod stats subtrees are disjoint across pods, so
                    # this merge is exact (merge into untouched == adopt)
                    for kind, sds in (("chip", rep["chip_stats"]),
                                      ("wire", rep["wire_stats"])):
                        if sds[i] is not None:
                            f.sim_root.stats.merge_state_dict(
                                {"children": {f"{kind}{g}": sds[i]}})
            for (p, idx, ready), tag in zip(rep["deferred"],
                                            rep["defer_tags"]):
                for g in members[p]:
                    deferred.append(((int(tag[0]), int(tag[1])),
                                     g, int(idx), int(ready)))
            if any(0 in mm for mm in members):
                f._totals = {k: float(v) for k, v in rep["totals"].items()}
                f._timeline = list(rep["timeline"])
        # serial chronological order: (barrier era | tick, pod, seq)
        deferred.sort(key=lambda e: (e[0][0], e[1], e[0][1]))
        f._deferred = [(g, idx, ready) for _, g, idx, ready in deferred]
        f._ncomplete = sum(1 for row in f._op_end for e in row if e >= 0)
        self._collected = replies

    # -- teardown ----------------------------------------------------------
    def close(self) -> None:
        """Shut worker processes down (idempotent; the facade and any
        collected state stay usable)."""
        conns, procs = self._conns, self._procs
        self._conns, self._procs = [], []
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        if conns or procs:
            _shutdown(conns, procs)

    # -- one-shot ----------------------------------------------------------
    def execute(self, trace: HloTrace) -> ExecResult:
        """Run a trace to completion.  Workers stay warm afterwards so
        back-to-back laps on one engine skip the spawn cost; call
        ``close()`` (or let ``run_parallel``'s finally do it) to tear
        the pool down."""
        self.begin(trace)
        self.advance()
        return self.result()

    # -- dynamic workloads -------------------------------------------------
    def inject_op(self, op, ready: int, pod: int = 0) -> int:
        if self._mode == "serial":
            return self._facade.inject_op(op, ready, pod)
        raise RuntimeError(
            "inject_op() on a sharded parallel run: dynamic workloads "
            "run serially (repro.sim.Simulator arranges this)")
