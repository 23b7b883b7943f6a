"""A copy of ``repro.serve.fleet`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

FleetController: the real-deployment face of ``FleetPolicy``.

The production-shaped wrapper around the pure fleet policy — the exact
counterpart of how ``repro.serve.server.BatchServer`` wraps
``SlotScheduler`` and ``repro.train.trainer.Trainer.run_ft`` wraps
``FTPolicy``.  A deployment wires its event sources to the three
callbacks and its provisioning system to ``on_scale``:

    ctl = FleetController(policy, on_scale=provisioner.apply)
    r = ctl.on_request(tick, rid, tenant="interactive", prefix=7)
    ...dispatch the request to replica r...
    ctl.on_finish(tick, rid, replica=r, ok=met_slo)   # from replica r
    ctl.on_tick(tick)                                 # control heartbeat

All decisions come from the policy; the controller owns only the side
effects (surfacing scale actions to the provisioner) and a safety
cross-check: a finish reported from a replica the policy never routed
that request to is a routing divergence and raises immediately.

Because the policy is pure and tick-indexed, a controller fed the
event stream a ``repro.sim.fleet.FleetSim`` run recorded (its
``feed``) reproduces the DES decision log *bit for bit* — the identity
tests/test_fleet_sim.py enforces.  jax-free by design: the simulator
stack imports this module's package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.serve.fleet_policy import FleetDecision, FleetPolicy

#: decision kinds the provisioner must act on
SCALE_KINDS = ("replica_up", "scale_up", "scale_down")


class FleetController:
    """Drives a :class:`FleetPolicy` from deployment events."""

    def __init__(self, policy: FleetPolicy,
                 on_scale: Optional[Callable[[FleetDecision], None]] = None):
        self.policy = policy
        self.on_scale = on_scale
        self._assigned: Dict[int, int] = {}
        self._cursor = 0
        policy.start()
        self._fire_scale_actions()

    # -- event callbacks --------------------------------------------------
    def on_request(self, tick: int, rid: int, *, tenant: str = "",
                   prefix: int = -1) -> int:
        """A request arrived: returns the replica to dispatch it to."""
        r = self.policy.route(tick, rid, tenant=tenant, prefix=prefix)
        self._assigned[rid] = r
        self._fire_scale_actions()
        return r

    def on_finish(self, tick: int, rid: int, *, replica: int,
                  ok: bool = True) -> None:
        """Replica ``replica`` reports ``rid`` done (``ok``: met SLO)."""
        expected = self._assigned.pop(rid, None)
        if expected is None:
            raise RuntimeError(f"finish for rid {rid} never routed")
        if replica != expected:
            raise RuntimeError(
                f"rid {rid} finished on replica {replica} but was routed "
                f"to {expected} — routing diverged")
        self.policy.finish(tick, rid, ok=ok)
        self._fire_scale_actions()

    def on_tick(self, tick: int) -> None:
        """Control heartbeat: lets boundaries/promotions fire during
        request lulls.  Call at least as often as
        ``policy.next_wake()`` comes due."""
        self.policy.observe(tick)
        self._fire_scale_actions()

    # -- provisioning -----------------------------------------------------
    def _fire_scale_actions(self) -> None:
        new = self.policy.decisions[self._cursor:]
        self._cursor = len(self.policy.decisions)
        if self.on_scale is None:
            return
        for d in new:
            if d.kind in SCALE_KINDS:
                self.on_scale(d)

    # -- replay (the identity-test driver) --------------------------------
    def replay(self, feed: List[List[Any]],
               requests: Optional[List[Any]] = None) -> None:
        """Drive the controller from a recorded event feed (the
        ``FleetSim.feed`` format): ``["route", tick, rid]``,
        ``["finish", tick, rid, replica, ok]``, ``["tick", tick]``.
        ``requests`` (rid-indexed, with ``tenant``/``prefix_group``)
        recovers routing inputs for route rows."""
        for row in feed:
            kind = row[0]
            if kind == "route":
                _, tick, rid = row
                req = requests[rid] if requests is not None else None
                self.on_request(
                    int(tick), int(rid),
                    tenant=getattr(req, "tenant", ""),
                    prefix=getattr(req, "prefix_group", -1))
            elif kind == "finish":
                _, tick, rid, replica, ok = row
                self.on_finish(int(tick), int(rid), replica=int(replica),
                               ok=bool(ok))
            elif kind == "tick":
                self.on_tick(int(row[1]))
            else:
                raise ValueError(f"unknown feed row kind {kind!r}")
