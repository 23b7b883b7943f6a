"""A copy of ``repro.serve.fleet_policy`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Pure fleet routing + autoscaling policy (the FleetSim tentpole).

This module factors the *control plane* of a serving fleet — which
replica gets each request, and when replicas are brought up or torn
down — into one pure, tick-indexed state machine, exactly the way
``repro.serve.policy`` factored the slot scheduler out of
``BatchServer`` and ``repro.train.ft_policy`` factored recovery out of
``Trainer``:

* **Routing** — four deterministic routers over the currently-serving
  replica set: ``round_robin``, ``least_loaded`` (fewest outstanding
  requests), ``p2c`` (power-of-two-choices: two candidates drawn by a
  stateless hash of ``(seed, rid)``, the less-loaded one wins), and
  ``prefix_affinity`` (requests sharing a prefix group stick to the
  replica that holds the prefix cache, unless it is overloaded).
* **Autoscaling** — at every control boundary (each
  ``control_period_ticks``) the policy compares outstanding load and
  the window's SLO-violation fraction against its watermarks and
  brings replicas up (they serve only after ``cold_start_ticks`` — the
  cold start is a first-class cost) or retires *idle* replicas after a
  streak of quiet windows.  Retiring only idle replicas means a
  scaled-down replica never holds work, so no drain protocol exists to
  diverge between drivers.
* **Cold start** — ``scale_up`` marks a replica *warming*; it is
  routable immediately (queued work is how the cold start surfaces in
  TTFT) but only *live* — promoted at ``ready = decision_tick +
  cold_start_ticks`` — replicas execute.

Every action is logged as a :class:`FleetDecision`, so "the DES fleet
(``repro.sim.fleet.FleetSim``) and the real controller
(``repro.serve.fleet.FleetController``) scale and route identically"
is a pure list-equality assertion (tests/test_fleet_sim.py) — no
timing, no jax, no event engine in this module.

Driver contract (both drivers follow it verbatim)::

    policy.start()                            # min_replicas live at tick 0
    r = policy.route(tick, rid, tenant=..., prefix=...)   # request arrives
    policy.finish(tick, rid, ok=...)          # request completed on r
    policy.observe(tick)                      # idle clock advance

The policy's clock is the integer tick of the *events fed to it*: on
every call it first catches up all internal triggers (warming→live
promotions, control boundaries) with trigger tick <= the event tick,
in tick order (promotions before boundaries at equal ticks).  Because
the internal schedule is a pure function of the decision history, two
drivers feeding the same tick-stamped event stream produce identical
decision logs — the property the identity tests enforce.
``next_wake()`` tells a driver the next internal trigger so it never
sleeps past one.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

ROUTERS = ("round_robin", "least_loaded", "p2c", "prefix_affinity")

#: replica lifecycle states
DOWN, WARMING, LIVE = "down", "warming", "live"


@dataclass(frozen=True)
class FleetDecision:
    """One control-plane action, in decision order (the comparable log).

    ``tick`` is the simulated/wall tick the action logically happened
    at: route/finish carry the event tick, ``scale_up``/``scale_down``
    the control boundary, ``replica_up`` the promotion (ready) tick.
    """

    kind: str          # "replica_up" | "scale_up" | "scale_down" |
    #                    "route" | "finish"
    tick: int
    rid: int = -1
    replica: int = -1
    note: str = ""

    def to_row(self) -> List[Any]:
        return [self.kind, self.tick, self.rid, self.replica, self.note]

    @classmethod
    def from_row(cls, r: Sequence[Any]) -> "FleetDecision":
        return cls(r[0], int(r[1]), int(r[2]), int(r[3]), r[4])


class FleetPolicy:
    """Deterministic router + autoscaler over ``max_replicas`` slots.

    Pure: consumes tick-stamped request events, produces replica
    choices and an ordered :class:`FleetDecision` log.  The driver owns
    all side effects (executing requests, actually provisioning
    replicas, advancing time).

    Autoscaler rule, evaluated at each control boundary over the
    window since the previous boundary:

    * scale **up** to ``ceil(outstanding / slots_per_replica)`` (at
      least one new replica) when outstanding work exceeds
      ``up_queue_frac`` x current capacity, or when more than
      ``up_viol_frac`` of the window's finishes violated their SLO;
    * scale **down** one *idle* (zero outstanding) replica after
      ``down_windows`` consecutive windows with no violations and
      outstanding work under ``down_queue_frac`` of the capacity that
      would remain — never below ``min_replicas``.
    """

    def __init__(self, router: str = "least_loaded", *,
                 min_replicas: int, max_replicas: int,
                 slots_per_replica: int, cold_start_ticks: int,
                 control_period_ticks: int, seed: int = 0,
                 up_queue_frac: float = 1.0, up_viol_frac: float = 0.1,
                 down_queue_frac: float = 0.5, down_windows: int = 3,
                 affinity_overload: float = 2.0):
        if router not in ROUTERS:
            raise ValueError(f"unknown router {router!r}; one of {ROUTERS}")
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if slots_per_replica < 1:
            raise ValueError("slots_per_replica must be >= 1")
        if cold_start_ticks < 0 or control_period_ticks < 1:
            raise ValueError("cold_start_ticks >= 0 and "
                             "control_period_ticks >= 1 required")
        self.router = router
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.slots_per_replica = slots_per_replica
        self.cold_start_ticks = int(cold_start_ticks)
        self.control_period_ticks = int(control_period_ticks)
        self.seed = seed
        self.up_queue_frac = up_queue_frac
        self.up_viol_frac = up_viol_frac
        self.down_queue_frac = down_queue_frac
        self.down_windows = down_windows
        self.affinity_overload = affinity_overload
        # mutable state
        self._state: Dict[int, str] = {r: DOWN
                                       for r in range(max_replicas)}
        self._ready: Dict[int, int] = {}      # warming replica -> ready tick
        self._out: Dict[int, int] = {r: 0 for r in range(max_replicas)}
        self._rid_to_rep: Dict[int, int] = {}
        self._prefix: Dict[int, int] = {}     # prefix group -> home replica
        self._rr = 0
        self._next_boundary = self.control_period_ticks
        self._idle_streak = 0
        self._w_finished = 0                  # window accumulators
        self._w_viol = 0
        self._started = False
        self.decisions: List[FleetDecision] = []

    # -- views ------------------------------------------------------------
    def state(self, replica: int) -> str:
        return self._state[replica]

    def serving_replicas(self) -> List[int]:
        """Routable replicas (live + warming), ascending."""
        return [r for r in range(self.max_replicas)
                if self._state[r] != DOWN]

    def live_replicas(self) -> List[int]:
        return [r for r in range(self.max_replicas)
                if self._state[r] == LIVE]

    def outstanding(self, replica: int) -> int:
        return self._out[replica]

    def next_wake(self) -> int:
        """Earliest unprocessed internal trigger (boundary or
        promotion) — a driver must feed an event (or ``observe``) at or
        after this tick or the control plane falls behind."""
        return min([self._next_boundary] + list(self._ready.values()))

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Bring up the floor fleet: ``min_replicas`` live at tick 0
        (the deployment's steady-state floor is assumed pre-warmed)."""
        if self._started:
            return
        self._started = True
        for r in range(self.min_replicas):
            self._state[r] = LIVE
            self._log("replica_up", 0, replica=r, note="initial")

    def route(self, tick: int, rid: int, *, tenant: str = "",
              prefix: int = -1) -> int:
        """Pick the replica for request ``rid`` arriving at ``tick``.
        Routes to live *and warming* replicas — queueing on a warming
        replica is how the cold start shows up in that request's TTFT.
        """
        self._require_started()
        self._catch_up(int(tick))
        serving = self.serving_replicas()
        r = self._pick(serving, rid, prefix)
        self._out[r] += 1
        self._rid_to_rep[rid] = r
        self._log("route", tick, rid=rid, replica=r, note=tenant)
        return r

    def finish(self, tick: int, rid: int, *, ok: bool = True) -> int:
        """Request ``rid`` completed at ``tick`` (``ok``: met its SLO).
        Returns the replica it ran on."""
        self._require_started()
        self._catch_up(int(tick))
        r = self._rid_to_rep.pop(rid)
        self._out[r] -= 1
        self._w_finished += 1
        if not ok:
            self._w_viol += 1
        self._log("finish", tick, rid=rid, replica=r,
                  note="ok" if ok else "slo")
        return r

    def observe(self, tick: int) -> None:
        """Advance the control-plane clock with no request event
        (process boundaries/promotions due by ``tick``)."""
        self._require_started()
        self._catch_up(int(tick))

    # -- internals --------------------------------------------------------
    def _require_started(self) -> None:
        if not self._started:
            raise RuntimeError("call start() before feeding events")

    def _log(self, kind: str, tick: int, *, rid: int = -1,
             replica: int = -1, note: str = "") -> None:
        self.decisions.append(
            FleetDecision(kind, int(tick), rid, replica, note))

    def _catch_up(self, t: int) -> None:
        """Process internal triggers due by ``t`` in tick order
        (promotion before boundary at equal ticks: the boundary sees
        the replica live)."""
        while True:
            due = [(rt, r) for r, rt in self._ready.items() if rt <= t]
            promo = min(due) if due else None
            boundary = self._next_boundary if self._next_boundary <= t \
                else None
            if promo is not None and (boundary is None
                                      or promo[0] <= boundary):
                rt, r = promo
                del self._ready[r]
                self._state[r] = LIVE
                self._log("replica_up", rt, replica=r,
                          note=f"warm after {self.cold_start_ticks}")
            elif boundary is not None:
                self._control(boundary)
                self._next_boundary = boundary + self.control_period_ticks
            else:
                return

    def _control(self, b: int) -> None:
        """One autoscaler evaluation at boundary tick ``b``."""
        up = self.serving_replicas()
        cap = len(up) * self.slots_per_replica
        out = sum(self._out[r] for r in up)
        pressure = out > self.up_queue_frac * cap
        slo_bad = (self._w_finished > 0
                   and self._w_viol > self.up_viol_frac * self._w_finished)
        if (pressure or slo_bad) and len(up) < self.max_replicas:
            want = min(self.max_replicas,
                       max(len(up) + 1,
                           math.ceil(out / self.slots_per_replica)))
            why = (f"queue {out}/{cap}" if pressure
                   else f"slo {self._w_viol}/{self._w_finished}")
            for _ in range(want - len(up)):
                r = next(i for i in range(self.max_replicas)
                         if self._state[i] == DOWN)
                self._state[r] = WARMING
                self._ready[r] = b + self.cold_start_ticks
                self._log("scale_up", b, replica=r, note=why)
            self._idle_streak = 0
        elif (not pressure and self._w_viol == 0
              and len(up) > self.min_replicas
              and out <= self.down_queue_frac
              * (len(up) - 1) * self.slots_per_replica):
            self._idle_streak += 1
            if self._idle_streak >= self.down_windows:
                idle = [r for r in up if self._state[r] == LIVE
                        and self._out[r] == 0]
                if idle:
                    r = max(idle)        # retire the newest replica
                    self._state[r] = DOWN
                    self._prefix = {g: h for g, h in self._prefix.items()
                                    if h != r}
                    self._log("scale_down", b, replica=r,
                              note=f"idle x{self._idle_streak}")
                    self._idle_streak = 0
        else:
            self._idle_streak = 0
        self._w_finished = 0
        self._w_viol = 0

    def _pick(self, serving: List[int], rid: int, prefix: int) -> int:
        if self.router == "round_robin":
            r = serving[self._rr % len(serving)]
            self._rr += 1
            return r
        if self.router == "p2c":
            a = serving[self._hash(rid, 0) % len(serving)]
            b = serving[self._hash(rid, 1) % len(serving)]
            return min(a, b, key=lambda r: (self._out[r], r))
        if self.router == "prefix_affinity" and prefix >= 0:
            home = self._prefix.get(prefix)
            if (home is not None and self._state[home] != DOWN
                    and self._out[home] < self.affinity_overload
                    * self.slots_per_replica):
                return home
            r = self._least_loaded(serving)
            self._prefix[prefix] = r
            return r
        return self._least_loaded(serving)

    def _least_loaded(self, serving: List[int]) -> int:
        return min(serving, key=lambda r: (self._out[r], r))

    def _hash(self, rid: int, salt: int) -> int:
        """Stateless candidate draw: no RNG object to checkpoint, and
        both drivers get the same candidates for the same request."""
        h = hashlib.sha1(f"{self.seed}:{rid}:{salt}".encode()).digest()
        return int.from_bytes(h[:8], "big")

    # -- checkpointing ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "router": self.router,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "slots_per_replica": self.slots_per_replica,
            "cold_start_ticks": self.cold_start_ticks,
            "control_period_ticks": self.control_period_ticks,
            "seed": self.seed,
            "state": [self._state[r] for r in range(self.max_replicas)],
            "ready": sorted([r, t] for r, t in self._ready.items()),
            "out": [self._out[r] for r in range(self.max_replicas)],
            "rid_to_rep": sorted([rid, r] for rid, r
                                 in self._rid_to_rep.items()),
            "prefix": sorted([g, r] for g, r in self._prefix.items()),
            "rr": self._rr,
            "next_boundary": self._next_boundary,
            "idle_streak": self._idle_streak,
            "w_finished": self._w_finished,
            "w_viol": self._w_viol,
            "started": self._started,
            "decisions": [d.to_row() for d in self.decisions],
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        for key in ("router", "min_replicas", "max_replicas",
                    "slots_per_replica", "cold_start_ticks",
                    "control_period_ticks", "seed"):
            if d[key] != getattr(self, key):
                raise ValueError(
                    f"policy shape mismatch: checkpoint {key}={d[key]!r}, "
                    f"this policy {getattr(self, key)!r} — rebuild with "
                    "the same configuration")
        self._state = {r: s for r, s in enumerate(d["state"])}
        self._ready = {int(r): int(t) for r, t in d["ready"]}
        self._out = {r: int(o) for r, o in enumerate(d["out"])}
        self._rid_to_rep = {int(rid): int(r) for rid, r in d["rid_to_rep"]}
        self._prefix = {int(g): int(r) for g, r in d["prefix"]}
        self._rr = int(d["rr"])
        self._next_boundary = int(d["next_boundary"])
        self._idle_streak = int(d["idle_streak"])
        self._w_finished = int(d["w_finished"])
        self._w_viol = int(d["w_viol"])
        self._started = bool(d["started"])
        self.decisions = [FleetDecision.from_row(r) for r in d["decisions"]]
