"""A copy of ``repro.core.desim.simnodes`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

SimObject components of the event-driven trace executor.

This is where the four core layers of the engine meet, the way they do
in gem5 itself (paper §1.3.1): ``SimObject``s with typed ``Param``s and
``StatGroup`` counters, wired through the ``Port`` API, scheduling their
completion events on the deterministic ``EventQueue``:

* :class:`ChipSim`  — one representative chip per pod; serializes
  compute regions on the chip's compute resource at roofline time.
* :class:`WireSim`  — the pod's ICI torus; collectives occupy concrete
  directed :class:`~repro.core.desim.network.LinkState` links
  (dimension-ordered routing, Garnet-style contention §2.13): two
  collectives whose regions share a link serialize, disjoint regions
  proceed in parallel.
* :class:`DcnSim`   — the shared inter-pod fabric; cross-pod collectives
  rendezvous here and complete through ``QuantumSync`` at a quantum
  boundary (dist-gem5 §2.17).
* :class:`ClusterSim` — the root of the per-run SimObject tree; its
  ``stats`` group is the gem5-style stats tree ``record_stats=True``
  dumps.

Topology is port-connected: each chip's ``coll`` requestor port plugs
into its wire's ``chip_in`` responder; each wire's ``dcn_out`` requestor
plugs into one ``DcnSim`` pod-side responder.  The port hop is gem5's
*atomic* protocol (synchronous arbitration); timing is realized by the
events the responder schedules (the *timing* protocol layered on top).

All resource bookkeeping is in integer ticks (1 tick = 1 ns), never
float seconds: determinism comes from the tick engine, not float
rounding order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import trace as dbg
from repro_torch.core.desim.collectives import CollectiveAlgorithm
from repro_torch.core.desim.machine import ClusterModel
from repro_torch.core.desim.network import LinkState, TorusNetwork
from repro_torch.core.events import EventQueue, QuantumSync
from repro_torch.core.ports import PortError, PortSet
from repro_torch.core.simobject import Param, SimObject

TICKS_PER_S = 1_000_000_000  # 1 tick = 1 ns (gem5 uses 1 ps)


def to_ticks(seconds: float) -> int:
    return int(round(seconds * TICKS_PER_S))


# completion callback: (start_tick, end_tick, payload) -> None
DoneFn = Callable[[int, int, dict], None]


class ChipSim(SimObject):
    """One representative chip of a pod (SPMD: every chip in the pod
    executes the same trace, so one chip + shared wires is exact for
    timing while keeping DES cost O(ops x pods))."""

    pod_id = Param(int, 0, "which pod this chip represents")
    slowdown = Param(float, 1.0, "straggler multiplier",
                     check=lambda v: v > 0)

    def __init__(self, name: str, model, queue: EventQueue, **params):
        super().__init__(name, **params)
        self._model = model          # machine.ChipModel (shared, frozen)
        self._eq = queue
        self._free = 0               # compute resource free tick
        self.ports = PortSet(self)
        self.coll_port = self.ports.requestor("coll", "collective")
        s = self.stats
        self.st_ops = s.scalar("ops_executed", "compute regions run")
        self.st_busy = s.scalar("busy_seconds", "compute busy time", "s")
        self.st_wait = s.distribution("queue_wait_seconds",
                                      "wait for the compute resource", "s")

    def startup(self) -> None:
        if self.ports.unconnected():
            raise PortError(f"{self.path}: unconnected ports "
                            f"{self.ports.unconnected()}")

    # ------------------------------------------------------------------
    def acquire(self, ready: int, flops: float,
                nbytes: float) -> Tuple[int, int]:
        """Arbitrate the compute resource: serialize at roofline time
        on the chip's integer free tick, record stats, and return
        ``(start, end)``.  Shared by both timing models — a chip is one
        instruction stream even at atomic fidelity."""
        dur = to_ticks(self._model.compute_time_s(flops, nbytes)
                       * self.slowdown)
        start = max(ready, self._free)
        end = start + dur
        self._free = end
        self.st_ops.inc()
        self.st_busy.inc(dur / TICKS_PER_S)
        self.st_wait.sample((start - ready) / TICKS_PER_S)
        if dbg._ACTIVE:
            dbg.dprintf("Chip", self,
                        "compute flops=%.3e start=%d dur=%d wait=%d",
                        flops, start, dur, start - ready, tick=end)
        return start, end

    def exec_compute(self, ready: int, flops: float, nbytes: float,
                     payload: dict) -> None:
        """Arbitrate the compute resource and schedule the completion
        (``payload['done']`` — same handoff as the wire/fabric path)."""
        done: DoneFn = payload["done"]
        start, end = self.acquire(ready, flops, nbytes)
        self._eq.schedule(lambda: done(start, end, payload), end,
                          name=payload.get("name", "compute"))

    def issue_collective(self, payload: dict) -> None:
        """Hand a collective to the wire through the port."""
        self.coll_port.send(payload)

    @property
    def free_tick(self) -> int:
        return self._free


class WireSim(SimObject):
    """The pod's ICI torus wire, with per-link occupancy.

    A collective's ring occupies the four directed links of every chip
    in its ``region`` (default: the whole pod) for the duration the
    collective algorithm predicts; ``collective-permute`` additionally
    walks a dimension-ordered route between the region's corners.  Link
    arbitration is ``max(busy_until)`` over the footprint — exactly the
    Garnet serialization rule at message granularity.
    """

    pod_id = Param(int, 0, "which pod this wire belongs to")
    contention = Param(bool, True, "serialize on shared links")

    def __init__(self, name: str, machine: ClusterModel,
                 algorithm: CollectiveAlgorithm, queue: EventQueue,
                 **params):
        super().__init__(name, **params)
        self._machine = machine
        self._alg = algorithm
        self._eq = queue
        self._busy_hwm = 0   # atomic-mode wire-occupancy high-water tick
        pod = machine.pod
        self._net = TorusNetwork(pod.nx, pod.ny, pod.ici.bw,
                                 pod.ici.latency_s)
        # region -> link list; LinkState objects are created once per
        # link, so caching keeps arbitration O(footprint hits) instead
        # of O(nx*ny) dict lookups per collective (the DSE hot path)
        self._footprints: Dict[Optional[Tuple[int, int, int, int]],
                               List[LinkState]] = {}
        self.ports = PortSet(self)
        self.chip_port = self.ports.responder("chip_in", "collective",
                                              handler=self._on_request)
        self.dcn_port = self.ports.requestor("dcn_out", "dcn")
        s = self.stats
        self.st_colls = s.scalar("collectives", "intra-pod collectives")
        self.st_bytes = s.scalar("bytes_on_wire", "payload bytes", "B")
        self.st_busy = s.scalar("busy_seconds", "wire occupancy", "s")
        self.st_wait = s.distribution("link_wait_seconds",
                                      "wait for contended links", "s")
        s.formula("links_used", lambda: float(len(self._net.links)),
                  "distinct directed links touched")

    def startup(self) -> None:
        if self.ports.unconnected():
            raise PortError(f"{self.path}: unconnected ports "
                            f"{self.ports.unconnected()}")

    # ------------------------------------------------------------------
    def _footprint(self, region: Optional[Tuple[int, int, int, int]]
                   ) -> List[LinkState]:
        """Directed links a ring collective over ``region`` occupies."""
        if region is not None:
            region = tuple(region)  # JSON-style lists must hash too
        cached = self._footprints.get(region)
        if cached is not None:
            return cached
        net = self._net
        x0, y0, w, h = region or (0, 0, net.nx, net.ny)
        links: List[LinkState] = []
        for dx in range(w):
            for dy in range(h):
                x, y = x0 + dx, y0 + dy
                for d in ("+x", "-x", "+y", "-y"):
                    links.append(net._link(x, y, d))
        self._footprints[region] = links
        return links

    def _on_request(self, payload: dict) -> dict:
        if payload.get("dcn"):
            # cross-pod: forward to the fabric through the dcn port
            return self.dcn_port.send(payload)

        ready = payload["ready"]
        kind, nbytes = payload["kind"], payload["nbytes"]
        region = payload.get("region")
        dur = to_ticks(self._alg.time_s(kind, nbytes,
                                        payload["participants"],
                                        self._machine))
        links = self._footprint(region)
        if kind == "collective-permute" and region:
            # point-to-point: dimension-ordered route between corners
            # (copy first — the footprint list is cached per region)
            x0, y0, w, h = region
            links = list(links)
            for hop in self._net.route((x0, y0),
                                       (x0 + w - 1, y0 + h - 1)):
                links.append(self._net._link(*hop))
        if self.contention:
            start = max([ready] + [int(l.busy_until) for l in links])
        else:
            start = ready
        end = start + dur
        share = nbytes / max(len(links), 1)
        for l in links:
            # never rewind occupancy: with contention off, transfers may
            # complete out of order and busy_until is a high-water mark
            l.busy_until = max(l.busy_until, end)
            l.bytes_carried += share
            l.transfers += 1
        payload.update(start=start, end=end, dur=dur)
        self.st_colls.inc()
        self.st_bytes.inc(nbytes)
        self.st_busy.inc(dur / TICKS_PER_S)
        self.st_wait.sample((start - ready) / TICKS_PER_S)
        if dbg._ACTIVE:
            if start > ready:
                dbg.dprintf("Wire.Contention", self,
                            "%s waited %d ticks on contended links",
                            payload.get("name", kind), start - ready,
                            tick=start)
            dbg.dprintf("Wire", self,
                        "%s kind=%s nbytes=%g links=%d start=%d dur=%d",
                        payload.get("name", kind), kind, nbytes,
                        len(links), start, dur, tick=end)
        done = payload["done"]
        self._eq.schedule(lambda: done(start, end, payload), end,
                          name=payload.get("name", kind))
        return payload

    def record_atomic(self, nbytes: float, dur: int, end: int) -> None:
        """Account a contention-free (AtomicTiming) collective: same
        counters as the detailed path, zero link wait, no link state."""
        self.st_colls.inc()
        self.st_bytes.inc(nbytes)
        self.st_busy.inc(dur / TICKS_PER_S)
        self.st_wait.sample(0.0)
        self._busy_hwm = max(self._busy_hwm, int(end))
        if dbg._ACTIVE:
            dbg.dprintf("Wire", self, "atomic collective nbytes=%g dur=%d",
                        nbytes, dur, tick=end)

    def busy_tick(self) -> int:
        if not self._net.links:
            return self._busy_hwm
        return max(self._busy_hwm,
                   int(max(l.busy_until for l in self._net.links.values())))


class DcnSim(SimObject):
    """Shared inter-pod fabric driven by ``QuantumSync``.

    A cross-pod collective is ONE fabric transaction: each pod's replica
    arrives through its wire's ``dcn_out`` port; when the last pod has
    arrived the transaction claims every pod uplink (serializing with
    any other in-flight cross-pod collective) and its completion is
    delivered to every pod's event queue via ``QuantumSync.send`` — i.e.
    at the first quantum boundary the dist-gem5 error model allows, at
    least one quantum after the last arrival.
    """

    num_pods = Param(int, 1, "pods on the fabric", check=lambda v: v >= 1)
    contention = Param(bool, True, "serialize on the pod uplinks")

    def __init__(self, name: str, machine: ClusterModel,
                 algorithm: CollectiveAlgorithm,
                 queues: List[EventQueue], sync: Optional[QuantumSync],
                 capture: Optional[Callable[[dict], None]] = None,
                 **params):
        super().__init__(name, **params)
        self._machine = machine
        self._alg = algorithm
        self._queues = queues
        self._sync = sync
        # parallel-shard mode: arrivals are forwarded to the capture
        # callback (and on to the coordinator process, which owns the
        # one true fabric) instead of rendezvousing locally
        self._capture = capture
        self.uplinks = [LinkState() for _ in range(len(queues))]
        self._rendezvous: Dict[int, dict] = {}
        self.ports = PortSet(self)
        self.pod_ports = [self.ports.responder(f"pod{p}", "dcn",
                                               handler=self._on_arrive)
                          for p in range(len(queues))]
        s = self.stats
        self.st_colls = s.scalar("collectives", "cross-pod collectives")
        self.st_bytes = s.scalar("bytes_on_fabric", "payload bytes", "B")
        self.st_busy = s.scalar("busy_seconds", "fabric occupancy", "s")
        self.st_skew = s.distribution("arrival_skew_seconds",
                                      "first-to-last pod arrival skew", "s")

    # ------------------------------------------------------------------
    def _on_arrive(self, payload: dict) -> dict:
        if dbg._ACTIVE:
            dbg.dprintf("Dcn", self, "%s op=%d arrive pod=%d",
                        payload.get("name", payload.get("kind", "dcn")),
                        payload["op_idx"], payload.get("pod", -1),
                        tick=payload["ready"])
        if self._capture is not None:
            self._capture(payload)
            return payload
        key = payload["op_idx"]
        r = self._rendezvous.setdefault(
            key, {"arrived": 0, "first": payload["ready"], "last": 0,
                  "waiters": []})
        r["arrived"] += 1
        r["first"] = min(r["first"], payload["ready"])
        r["last"] = max(r["last"], payload["ready"])
        r["waiters"].append(payload)
        if r["arrived"] < self.num_pods:
            return payload
        del self._rendezvous[key]

        dur = to_ticks(self._alg.time_s(payload["kind"], payload["nbytes"],
                                        payload["participants"],
                                        self._machine))
        if self.contention:
            start = max([r["last"]]
                        + [int(l.busy_until) for l in self.uplinks])
        else:
            start = r["last"]
        end = start + dur
        for l in self.uplinks:
            l.busy_until = max(l.busy_until, end)
            l.bytes_carried += payload["nbytes"] / len(self.uplinks)
            l.transfers += 1
        self.st_colls.inc()
        self.st_bytes.inc(payload["nbytes"])
        self.st_busy.inc(dur / TICKS_PER_S)
        self.st_skew.sample((r["last"] - r["first"]) / TICKS_PER_S)
        if dbg._ACTIVE:
            dbg.dprintf("Dcn", self,
                        "%s op=%d fire start=%d dur=%d skew=%d waiters=%d",
                        payload.get("name", payload.get("kind", "dcn")),
                        key, start, dur, r["last"] - r["first"],
                        len(r["waiters"]), tick=end)

        for w in r["waiters"]:
            w.update(start=start, dur=dur)
            q = self._queues[w["pod"]]
            done = w["done"]
            if self._sync is not None:
                # delivered at a quantum boundary >= end (dist-gem5)
                self._sync.send(
                    r["last"], q,
                    (lambda w=w, q=q, done=done, start=start:
                     done(start, q.now, w)),
                    latency=end - r["last"])
            else:
                # no quantum model: deliver at the exact tick — unless
                # that queue already drained past it (the executor runs
                # unsynchronized queues to completion one at a time)
                at = max(end, q.now)
                q.schedule(lambda w=w, done=done, start=start, at=at:
                           done(start, at, w), at,
                           name=w.get("name", "dcn"))
        return payload

    def record_atomic(self, nbytes: float, dur: int, skew: int) -> None:
        """Account a contention-free (AtomicTiming) cross-pod
        collective: same counters as the detailed path, no uplink
        state, no quantum rounding."""
        self.st_colls.inc()
        self.st_bytes.inc(nbytes)
        self.st_busy.inc(dur / TICKS_PER_S)
        self.st_skew.sample(skew / TICKS_PER_S)
        if dbg._ACTIVE:
            dbg.dprintf("Dcn", self,
                        "atomic transaction nbytes=%g dur=%d skew=%d",
                        nbytes, dur, skew)

    def busy_tick(self) -> int:
        if not self.uplinks:
            return 0
        return int(max(l.busy_until for l in self.uplinks))


class ClusterSim(SimObject):
    """Root of the per-run simulation tree (``sim`` in stats dumps)."""

    num_pods = Param(int, 1, "pods simulated", check=lambda v: v >= 1)
    quantum_ns = Param(int, 100_000, "dist-gem5 sync quantum (ticks)")
