"""A copy of ``repro.core.desim.network`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

ICI torus + DCN topology with link occupancy (the Garnet analogue).

gem5's Garnet models router microarchitecture, link contention and flow
control at cycle level (§2.13).  The TPU analogue is the 2-D ICI torus
inside a pod and the DCN between pods.  We model:

* explicit links with per-direction bandwidth and occupancy windows —
  two transfers crossing the same link serialize (contention),
* dimension-ordered routing on the torus (X then Y, shortest wrap),
* a bisection model for all-to-all style traffic,
* DCN as a per-host bottleneck link (dist-gem5's TCP forwarding).

The collective *algorithms* (repro.core.desim.collectives) produce
phases; this module answers "how long does phase X take given who else
is on the wire", which is what turns a cost model into a network model.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core.desim.machine import ClusterModel


@dataclass
class LinkState:
    """Occupancy bookkeeping for one directed link."""

    busy_until: float = 0.0
    bytes_carried: float = 0.0
    transfers: int = 0

    def acquire(self, now: float, duration: float, nbytes: float) -> float:
        """Serialize on the link; returns completion time."""
        start = max(now, self.busy_until)
        self.busy_until = start + duration
        self.bytes_carried += nbytes
        self.transfers += 1
        return self.busy_until


class TorusNetwork:
    """2-D torus of (nx, ny) chips; 4 directed links per chip."""

    def __init__(self, nx: int, ny: int, link_bw: float, hop_latency: float):
        self.nx, self.ny = nx, ny
        self.link_bw = link_bw
        self.hop_latency = hop_latency
        self.links: Dict[Tuple[int, int, str], LinkState] = {}

    def _link(self, x: int, y: int, direction: str) -> LinkState:
        key = (x % self.nx, y % self.ny, direction)
        if key not in self.links:
            self.links[key] = LinkState()
        return self.links[key]

    def route(self, src: Tuple[int, int], dst: Tuple[int, int]
              ) -> List[Tuple[int, int, str]]:
        """Dimension-ordered (X then Y) shortest-wrap route."""
        (sx, sy), (dx, dy) = src, dst
        hops: List[Tuple[int, int, str]] = []
        # X dimension
        fwd = (dx - sx) % self.nx
        bwd = (sx - dx) % self.nx
        step, d = (1, "+x") if fwd <= bwd else (-1, "-x")
        x = sx
        for _ in range(min(fwd, bwd)):
            hops.append((x, sy, d))
            x = (x + step) % self.nx
        # Y dimension
        fwd = (dy - sy) % self.ny
        bwd = (sy - dy) % self.ny
        step, d = (1, "+y") if fwd <= bwd else (-1, "-y")
        y = sy
        for _ in range(min(fwd, bwd)):
            hops.append((x, y, d))
            y = (y + step) % self.ny
        return hops

    def send(self, now: float, src: Tuple[int, int], dst: Tuple[int, int],
             nbytes: float) -> float:
        """Point-to-point transfer; returns completion time (contention-
        aware store-and-forward at message granularity)."""
        t = now
        for (x, y, d) in self.route(src, dst):
            link = self._link(x, y, d)
            dur = self.hop_latency + nbytes / self.link_bw
            t = link.acquire(t, dur, nbytes)
        return t

    def occupancy_report(self) -> Dict[str, float]:
        if not self.links:
            return {"links_used": 0, "max_busy_s": 0.0, "total_bytes": 0.0}
        return {
            "links_used": len(self.links),
            "max_busy_s": max(l.busy_until for l in self.links.values()),
            "total_bytes": sum(l.bytes_carried for l in self.links.values()),
        }


class DcnFabric:
    """Inter-pod fabric: per-pod uplink bottleneck (dist-gem5 TCP model)."""

    def __init__(self, num_pods: int, bw: float, latency: float,
                 hosts_per_pod: int = 64):
        self.num_pods = num_pods
        self.bw = bw * hosts_per_pod   # pod aggregate uplink
        self.latency = latency
        self.uplinks: List[LinkState] = [LinkState() for _ in range(num_pods)]

    def exchange(self, now: float, nbytes_per_pod: float) -> float:
        """All pods exchange ``nbytes_per_pod`` (e.g. cross-pod AR shard).
        Returns completion time of the slowest pod."""
        done = now
        for link in self.uplinks:
            dur = self.latency + nbytes_per_pod / self.bw
            done = max(done, link.acquire(now, dur, nbytes_per_pod))
        return done


def build_networks(machine: ClusterModel
                   ) -> Tuple[TorusNetwork, DcnFabric]:
    pod = machine.pod
    torus = TorusNetwork(pod.nx, pod.ny, pod.ici.bw, pod.ici.latency_s)
    dcn = DcnFabric(machine.num_pods, machine.dcn.bw, machine.dcn.latency_s)
    return torus, dcn
