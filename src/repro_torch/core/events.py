"""A copy of ``repro.core.events`` (pure Python): the port imports nothing
of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Deterministic discrete-event simulation engine.

This is the g5x analogue of gem5's event-driven simulation core
(gem5-20 paper §1.3.1: "At its core, gem5 contains an event-driven
simulation engine").  Every timing model in ``repro.core.desim`` is built
on top of this engine.

Design goals, mirroring gem5:

* **Determinism** — events scheduled for the same tick execute in
  (priority, insertion-sequence) order, so a simulation is a pure
  function of its inputs.  gem5 relies on this for reproducible research
  results; we rely on it for reproducible roofline/DSE numbers and for
  the quantum-based multi-pod synchronization of dist-gem5 (§2.17).
* **Cheap scheduling** — a binary heap keyed by ``(tick, priority,
  seq)``; O(log n) insert/pop.
* **Multiple queues** — dist-gem5 runs one event queue per process and
  synchronizes them on quantum boundaries.  ``QuantumSync`` reproduces
  that: each pod owns an ``EventQueue`` and queues may only diverge by
  at most one quantum.

Ticks are integers (like gem5, which uses picosecond ticks).  The desim
layer uses 1 tick = 1 nanosecond, which comfortably resolves both ICI
hop latencies (~1 us) and multi-second training steps.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

# gem5-style well-known priorities (smaller runs first at equal tick).
PRI_MAXTICK = -100          # simulation-control events
PRI_STAT_DUMP = -50
PRI_DEFAULT = 0
PRI_PROGRESS = 50


def quantum_boundary(tick: int, quantum: int) -> int:
    """First quantum boundary >= ``tick`` (ceiling to a multiple).

    Shared by :class:`QuantumSync` and the multiprocess coordinator in
    :mod:`repro.core.desim.parallel`, which must agree bit-for-bit on
    barrier placement for parallel runs to be tick-exact."""
    return -(-int(tick) // quantum) * quantum


def quantum_delivery(src_now: int, latency: int, quantum: int) -> int:
    """Delivery tick for a cross-queue message sent at ``src_now``:
    the first quantum boundary >= ``src_now + max(latency, quantum)``.
    The one-quantum floor is what makes quantum sync correct — within a
    quantum no queue can observe another queue's events (dist-gem5
    §2.17), so nothing may be delivered sooner."""
    return quantum_boundary(src_now + max(int(latency), quantum), quantum)


def rendezvous_horizon(last_arrival_lb: int, quantum: int) -> int:
    """Earliest tick an *incomplete* rendezvous could possibly deliver,
    given a lower bound on its final arrival tick.

    ``quantum_delivery`` floors every delivery at one quantum past the
    last arrival, so any queue position ``<= rendezvous_horizon(lb)`` is
    provably safe: the eventual delivery lands strictly later.  This is
    the lookahead bound ``ParallelEngine`` uses to grant multi-quantum
    advances (dist-gem5 barrier elision) without ever letting a queue
    with undelivered traffic run past a delivery it has not seen."""
    return quantum_delivery(int(last_arrival_lb), 0, quantum)


class SimExit(Exception):
    """Raised by an event to stop the simulation (gem5's exit event)."""

    def __init__(self, cause: str = "exit", code: int = 0):
        super().__init__(cause)
        self.cause = cause
        self.code = code


@dataclass(order=True)
class _HeapEntry:
    tick: int
    priority: int
    seq: int
    callback: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)
    name: str = field(default="", compare=False)


class Event:
    """Handle for a scheduled event; supports gem5-style ``squash()``."""

    __slots__ = ("_entry",)

    def __init__(self, entry: _HeapEntry):
        self._entry = entry

    @property
    def tick(self) -> int:
        return self._entry.tick

    @property
    def name(self) -> str:
        return self._entry.name

    def scheduled(self) -> bool:
        return not self._entry.cancelled

    def squash(self) -> None:
        """Cancel the event (it stays in the heap but will not fire)."""
        self._entry.cancelled = True


class EventQueue:
    """A single deterministic event queue.

    >>> q = EventQueue("main")
    >>> order = []
    >>> _ = q.schedule(lambda: order.append("b"), 10)
    >>> _ = q.schedule(lambda: order.append("a"), 10, priority=-1)
    >>> q.run()
    >>> order
    ['a', 'b']
    """

    def __init__(self, name: str = "main"):
        self.name = name
        self._heap: list[_HeapEntry] = []
        self._seq = 0
        self._now = 0
        self.events_fired = 0

    # ------------------------------------------------------------------
    @property
    def now(self) -> int:
        return self._now

    def empty(self) -> bool:
        # Lazily drop cancelled heads (like next_tick) instead of scanning
        # the whole heap: the executor's drain loop polls empty() per
        # queue pass, so an O(n) scan goes quadratic in squashed events.
        return self.next_tick() is None

    def next_tick(self) -> Optional[int]:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0].tick if self._heap else None

    def pending(self) -> int:
        """Heap entries still stored (cancelled included) — leak probe."""
        return len(self._heap)

    def snapshot(self) -> dict:
        """Tick snapshot for checkpointing (repro.sim.serialize).

        Only bookkeeping is captured — scheduled callbacks are Python
        closures and cannot be serialized, which is why checkpointing
        *drains* the simulation first (gem5 ``drain()`` then
        ``serialize()``): a drained queue has no pending events, so
        ``now`` + ``events_fired`` fully describe it.
        """
        return {"now": self._now, "events_fired": self.events_fired}

    # ------------------------------------------------------------------
    def schedule(self, callback: Callable[[], None], tick: int,
                 priority: int = PRI_DEFAULT, name: str = "") -> Event:
        """Schedule ``callback`` at absolute ``tick`` (>= ``now`` and
        never negative — an event in the past would violate the
        tick-ordered merge the executor runs over its pod queues)."""
        if tick < 0:
            raise ValueError(
                f"cannot schedule event {name!r} at negative tick {tick} "
                "(ticks are absolute simulation time, >= 0)")
        if tick < self._now:
            raise ValueError(
                f"cannot schedule event {name!r} in the past: "
                f"tick={tick} < now={self._now}")
        entry = _HeapEntry(int(tick), priority, self._seq, callback,
                           name=name)
        self._seq += 1
        heapq.heappush(self._heap, entry)
        return Event(entry)

    def schedule_after(self, callback: Callable[[], None], delay: int,
                       priority: int = PRI_DEFAULT, name: str = "") -> Event:
        """Schedule ``callback`` ``delay`` ticks from ``now`` (delay
        must be >= 0: negative delays would land the event in the
        past)."""
        if delay < 0:
            raise ValueError(
                f"cannot schedule event {name!r} with negative delay "
                f"{delay} (use a tick >= now via schedule())")
        return self.schedule(callback, self._now + int(delay), priority, name)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Fire the next event.  Returns False when the queue is empty."""
        while self._heap:
            entry = heapq.heappop(self._heap)
            if entry.cancelled:
                continue
            if entry.tick < self._now:  # pragma: no cover - invariant
                raise RuntimeError("event queue time went backwards")
            self._now = entry.tick
            self.events_fired += 1
            entry.callback()
            return True
        return False

    def run(self, max_tick: Optional[int] = None,
            max_events: Optional[int] = None) -> str:
        """Run until empty / ``SimExit`` / ``max_tick``.  Returns the cause."""
        fired = 0
        try:
            while True:
                nt = self.next_tick()
                if nt is None:
                    return "queue empty"
                if max_tick is not None and nt > max_tick:
                    # never rewind: a max_tick already behind ``now``
                    # must not move simulation time backwards
                    self._now = max(self._now, max_tick)
                    return "max tick"
                if max_events is not None and fired >= max_events:
                    return "max events"
                self.step()
                fired += 1
        except SimExit as e:
            return e.cause

    def run_until(self, tick: int) -> None:
        """Advance exactly to ``tick`` (fires all events with t <= tick)."""
        while True:
            nt = self.next_tick()
            if nt is None or nt > tick:
                break
            self.step()
        self._now = max(self._now, tick)


class QuantumSync:
    """dist-gem5-style quantum-based synchronization of several queues.

    Each queue simulates one pod (gem5 process).  Queues run
    independently inside a quantum and barrier at quantum boundaries —
    the same scheme dist-gem5 uses over TCP (§2.17), here in-process.
    Cross-queue messages (e.g. DCN packets) are delivered with at least
    one quantum of latency, which is what makes the parallel simulation
    correct: within a quantum no queue can observe another queue's
    in-quantum events.
    """

    def __init__(self, queues: Iterable[EventQueue], quantum: int):
        self.queues = list(queues)
        if quantum <= 0:
            raise ValueError("quantum must be positive")
        self.quantum = int(quantum)
        self.barriers = 0
        self._pending: list[tuple[int, EventQueue, Callable[[], None]]] = []
        #: read-only observer called as ``observer(t, delivered)`` after
        #: each barrier step (instrumentation: Quantum DPRINTF, Perfetto
        #: barrier track).  Must not mutate queues — it runs after every
        #: queue has reached ``t``, so a pure read cannot perturb.
        self.observer: Optional[Callable[[int, int], None]] = None

    @property
    def pending_messages(self) -> int:
        """Cross-queue messages not yet delivered (0 when drained)."""
        return len(self._pending)

    def send(self, src_now: int, dst: EventQueue, callback: Callable[[], None],
             latency: int) -> None:
        """Cross-queue message: delivered at the first quantum boundary
        >= src_now + latency (models dist-gem5 packet forwarding)."""
        deliver = quantum_delivery(src_now, latency, self.quantum)
        self._pending.append((deliver, dst, callback))

    def _advance_to(self, t: int) -> None:
        """One barrier step: deliver due messages, run all queues to ``t``."""
        due = [p for p in self._pending if p[0] <= t]
        self._pending = [p for p in self._pending if p[0] > t]
        for deliver, dst, cb in due:
            dst.schedule(cb, max(deliver, dst.now))
        for q in self.queues:
            q.run_until(t)
        self.barriers += 1
        if self.observer is not None:
            self.observer(t, len(due))

    def run(self, max_tick: int) -> int:
        """Run all queues to ``max_tick`` in lockstep quanta.

        Returns the number of barrier synchronizations performed.
        """
        t = 0
        while t < max_tick:
            t = min(t + self.quantum, max_tick)
            self._advance_to(t)
        return self.barriers

    def run_until_drained(self, max_tick: Optional[int] = None,
                          stop_check: Optional[Callable[[], bool]] = None
                          ) -> int:
        """Run lockstep quanta until every queue is empty and no cross-
        queue message is pending.  Returns the final synchronized tick.

        Unlike :meth:`run`, empty quanta are skipped (the boundary jumps
        straight to the next quantum containing work), so ``barriers``
        counts only synchronizations that had something to do.  The
        quantum *semantics* are identical: no queue observes another
        queue's in-quantum events, and deliveries land exactly on the
        boundary ``send`` computed for them.

        ``stop_check`` is evaluated at every quantum boundary (the only
        points where global state is observable in dist-gem5); returning
        True pauses the run there — the caller may resume by calling
        ``run_until_drained`` again.  This is how ``repro.sim.Simulator``
        delivers exit events without breaking quantum semantics.
        """
        t = (max(q.now for q in self.queues) // self.quantum) * self.quantum
        while True:
            if stop_check is not None and stop_check():
                return t
            upcoming = [nt for nt in (q.next_tick() for q in self.queues)
                        if nt is not None]
            if self._pending:
                upcoming.append(min(p[0] for p in self._pending))
            if not upcoming:
                return t
            target = min(upcoming)
            # next boundary that covers ``target`` (and is ahead of us)
            t = max(quantum_boundary(target, self.quantum), t + self.quantum)
            if max_tick is not None and t > max_tick:
                # clamp like run(): fire everything due by max_tick,
                # leave later events unfired
                if target <= max_tick:
                    self._advance_to(max_tick)
                return max_tick
            self._advance_to(t)
