"""A copy of ``repro.core.desim.timing`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Pluggable timing models: the gem5 CPU-model fidelity ladder (§1.3.1).

gem5's hallmark is that one system description runs under
interchangeable CPU models spanning a fidelity/speed spectrum — atomic
for fast-forward, detailed (timing/O3) for the region of interest —
with mid-run switching (``switch_cpus``) making sampled simulation
practical.  This module is the desim analogue: a :class:`TimingModel`
decides *how an issued op turns into completion ticks*, and the rest of
the stack (dependency bookkeeping, hooks, drain/snapshot/restore, the
``repro.sim`` front-end) is model-agnostic.

Two models:

* :class:`DetailedTiming` — today's full-contention semantics, bit-for-
  bit: compute serializes on the chip, intra-pod collectives occupy the
  concrete torus ``LinkState`` links of their region (shared links
  serialize), cross-pod collectives rendezvous on the DCN fabric and
  complete through ``QuantumSync`` at a quantum boundary.  Every
  completion is an engine event on a pod ``EventQueue``.

* :class:`AtomicTiming` — contention-free analytical op costing
  (gem5's atomic mode): compute still serializes on the chip resource
  (a chip is one instruction stream even without contention), but
  collectives start at their ready tick with the closed-form algorithm
  cost — no link state is touched, no quantum model applies, and
  completions are resolved on the model's own batch heap instead of
  engine events.  A full static-trace run fires ~zero engine events;
  wall time drops by the whole link-arbitration + event-dispatch cost.

Exactness: on a *contention-free* trace (chain dependencies — no two
collectives in flight on shared links, no quantum rounding, i.e. single
pod or ``quantum_ns=0``), atomic and detailed produce identical op
ticks and identical stats, which is what makes mid-run switching exact
there and a controlled approximation elsewhere (see
``docs/fidelity.md``).

Switching: a drained run snapshots to a plain dict
(``TraceExecutor.snapshot``) and may be **restored under a different
model** — the gem5 ``switch_cpus`` move, surfaced as
``repro.sim.Simulator.switch_timing``.  Both models therefore speak the
same snapshot vocabulary: the deferred issue frontier and partial DCN
rendezvous re-enter through :meth:`TimingModel.restore_issue` /
:meth:`TimingModel.restore_arrival`.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import trace as dbg


class TimingModel:
    """How issued ops turn into completion ticks (one instance per
    executor run — models are stateful between ``reset`` calls)."""

    name = "abstract"
    #: True when link-level contention and the quantum error model are
    #: simulated (the ``Detailed`` end of the fidelity ladder)
    detailed = True
    #: True when cross-pod (dcn) traffic under this model is exchanged
    #: only at quantum boundaries — the property that lets the
    #: multiprocess engine (repro.core.desim.parallel) shard pods across
    #: workers bit-exactly.  Models that deliver dcn completions at
    #: exact ticks (atomic) need the global tick-ordered merge and fall
    #: back to the serial path when the trace has dcn ops.
    parallel_dcn_ok = False

    # -- lifecycle -------------------------------------------------------
    def reset(self, ex) -> None:
        """Clear per-run state (called from begin()/restore() setup)."""

    def issue(self, ex, p: int, idx: int, ready: int) -> None:
        """Cost op ``idx`` on pod ``p``, ready at tick ``ready``, and
        arrange for ``ex._on_done(start, end, payload)`` to run at its
        completion tick."""
        raise NotImplementedError

    def advance(self, ex, max_tick: Optional[int],
                stop_check: Optional[Callable[[], bool]]) -> None:
        """Fire pending completions up to ``max_tick`` (or until
        ``stop_check()`` pauses the run)."""
        raise NotImplementedError

    def quiescent(self, ex) -> bool:
        """True when the model holds no pending completions/issues
        (required for ``drained()``)."""
        return True

    # -- checkpointing ----------------------------------------------------
    def rendezvous_state(self, ex) -> List[Dict[str, Any]]:
        """Partial cross-pod rendezvous, as ``{"op_idx", "arrivals":
        [[pod, ready], ...]}`` rows (the snapshot format both models
        share, so a checkpoint restores under either)."""
        return []

    def restore_arrival(self, ex, p: int, idx: int, ready: int) -> None:
        """Re-arrive one pod of a partially-complete DCN rendezvous."""
        raise NotImplementedError

    def restore_issue(self, ex, p: int, idx: int, ready: int) -> None:
        """Re-schedule one deferred-frontier issue at its exact ready
        tick (arbitration must interleave with post-restore completions
        exactly as in an uninterrupted run)."""
        raise NotImplementedError


class DetailedTiming(TimingModel):
    """Full-contention timing through SimObject ports and engine events
    (bit-identical to the pre-refactor executor)."""

    name = "detailed"
    detailed = True
    parallel_dcn_ok = True

    def issue(self, ex, p, idx, ready):
        op = ex._trace.ops[idx]
        payload = ex._payload(p, idx, ready)
        if op.kind == "compute":
            # service time is end - start (wait precedes start)
            ex._chips[p].exec_compute(ready, op.flops, op.bytes, payload)
        else:
            ex._chips[p].issue_collective(payload)

    def advance(self, ex, max_tick, stop_check):
        if ex._sync is not None:
            ex._sync.run_until_drained(max_tick=max_tick,
                                       stop_check=stop_check)
        else:
            ex._advance_nosync(max_tick, stop_check)

    def rendezvous_state(self, ex):
        out = []
        for key in sorted(ex._dcn._rendezvous):
            r = ex._dcn._rendezvous[key]
            out.append({
                "op_idx": key,
                "arrivals": [[w["pod"], w["ready"]] for w in r["waiters"]],
            })
        return out

    def restore_arrival(self, ex, p, idx, ready):
        ex._chips[p].issue_collective(ex._payload(p, idx, ready))

    def restore_issue(self, ex, p, idx, ready):
        ex._queues[p].schedule(
            lambda: ex._issue(p, idx, ready), ready,
            name=f"issue:{ex._trace.ops[idx].name or idx}")


class AtomicTiming(TimingModel):
    """Contention-free analytical costing with batch-resolved
    completions (gem5's atomic fidelity).

    Ops are granted their resources at issue time — compute serializes
    on the chip's integer free tick exactly like detailed; collectives
    start at ``ready`` with the closed-form algorithm cost — and the
    completion is pushed onto a model-private ``(tick, seq)`` heap.
    ``advance`` drains that heap in tick order, so hooks, dependent
    issues, and dynamic-workload injections observe the same causal
    order as detailed, without one engine event per op: pod queues are
    only fast-forwarded (``run_until``), never scheduled on.

    Cross-pod (dcn) collectives still rendezvous (all pods must issue
    the op) but complete at ``last_arrival + cost`` exactly — no uplink
    serialization, no quantum rounding.
    """

    name = "atomic"
    detailed = False
    parallel_dcn_ok = False   # dcn completes at exact ticks, not quanta

    def reset(self, ex):
        self._heap: List[Tuple[int, int, str, tuple]] = []
        self._seq = 0
        self._rendezvous: Dict[int, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    def _push(self, tick: int, kind: str, data: tuple) -> None:
        heapq.heappush(self._heap, (int(tick), self._seq, kind, data))
        self._seq += 1

    def issue(self, ex, p, idx, ready):
        op = ex._trace.ops[idx]
        payload = ex._payload(p, idx, ready)
        if op.kind == "compute":
            start, end = ex._chips[p].acquire(ready, op.flops, op.bytes)
            self._push(end, "done", (start, end, payload))
        elif payload.get("dcn"):
            self._arrive(ex, payload)
        else:
            from repro_torch.core.desim.simnodes import to_ticks
            dur = to_ticks(ex.alg.time_s(op.kind, op.coll_bytes,
                                         payload["participants"],
                                         ex.machine))
            start = int(ready)
            end = start + dur
            payload.update(start=start, end=end, dur=dur)
            ex._wires[p].record_atomic(op.coll_bytes, dur, end)
            self._push(end, "done", (start, end, payload))

    def _arrive(self, ex, payload):
        from repro_torch.core.desim.simnodes import to_ticks
        key = payload["op_idx"]
        if dbg._ACTIVE:
            # atomic dcn arrivals bypass DcnSim._on_arrive, so trace here
            dbg.dprintf("Dcn", "atomic", "%s op=%d arrive pod=%d",
                        payload.get("name", payload.get("kind", "dcn")),
                        key, payload.get("pod", -1), tick=payload["ready"])
        r = self._rendezvous.setdefault(
            key, {"first": payload["ready"], "last": 0, "waiters": []})
        r["first"] = min(r["first"], payload["ready"])
        r["last"] = max(r["last"], payload["ready"])
        r["waiters"].append(payload)
        if len(r["waiters"]) < ex.machine.num_pods:
            return
        del self._rendezvous[key]
        dur = to_ticks(ex.dcn_alg.time_s(payload["kind"], payload["nbytes"],
                                         payload["participants"],
                                         ex.machine))
        start = r["last"]
        end = start + dur
        ex._dcn.record_atomic(payload["nbytes"], dur, r["last"] - r["first"])
        for w in r["waiters"]:
            w.update(start=start, end=end, dur=dur)
            self._push(end, "done", (start, end, w))

    # ------------------------------------------------------------------
    def advance(self, ex, max_tick, stop_check):
        heap = self._heap
        while heap:
            if stop_check is not None and stop_check():
                return
            if max_tick is not None and heap[0][0] > max_tick:
                return
            tick, _, kind, data = heapq.heappop(heap)
            if kind == "done":
                start, end, payload = data
                q = ex._queues[payload["pod"]]
                if end > q.now:
                    q.run_until(end)     # clock only: the queue is empty
                ex._on_done(start, end, payload)
            else:                        # deferred-frontier issue
                p, idx, ready = data
                q = ex._queues[p]
                if ready > q.now:
                    q.run_until(ready)
                ex._issue(p, idx, ready)

    def quiescent(self, ex):
        return not self._heap

    # -- checkpointing ----------------------------------------------------
    def rendezvous_state(self, ex):
        out = []
        for key in sorted(self._rendezvous):
            r = self._rendezvous[key]
            out.append({
                "op_idx": key,
                "arrivals": [[w["pod"], w["ready"]] for w in r["waiters"]],
            })
        return out

    def restore_arrival(self, ex, p, idx, ready):
        self._arrive(ex, ex._payload(p, idx, ready))

    def restore_issue(self, ex, p, idx, ready):
        self._push(ready, "issue", (p, idx, ready))


TIMING_MODELS = {
    DetailedTiming.name: DetailedTiming,
    AtomicTiming.name: AtomicTiming,
}


def get_timing_model(spec) -> TimingModel:
    """Resolve a model name / class / instance to a fresh-enough
    instance (instances are stateful: one per executor)."""
    if isinstance(spec, TimingModel):
        return spec
    if isinstance(spec, type) and issubclass(spec, TimingModel):
        return spec()
    try:
        return TIMING_MODELS[spec]()
    except (KeyError, TypeError):
        raise ValueError(f"unknown timing model {spec!r}; "
                         f"one of {list(TIMING_MODELS)}")
