"""A copy of ``repro.core.desim.collectives`` (pure Python): the port
imports nothing of the JAX package.  Its source below this docstring
equals the original's, imports renamed, and a test holds the two in
step.

Pluggable collective-algorithm models (the Ruby/SLICC analogue).

gem5's Ruby lets researchers swap *cache-coherence protocols* without
touching the rest of the system (§2.12); the protocol determines how
bytes move between caches.  On a TPU pod the analogous protocol is the
*collective algorithm*: how all-reduce / all-gather / reduce-scatter /
all-to-all bytes move over the ICI torus and the DCN.  g5x makes the
algorithm a plug-in: each is a small class with a closed-form cost
model plus an event-level phase generator, registered by name and
selectable per simulation — exactly how SLICC protocols are selected
per build/config.

Cost-model conventions (n participants, payload S bytes = the *global*
logical tensor size, link bandwidth B per direction, per-hop latency L):

* ring all-reduce        : 2(n-1)/n * S / B        + 2(n-1) L
* ring all-gather        :  (n-1)/n * S / B        +  (n-1) L
* ring reduce-scatter    :  (n-1)/n * S / B        +  (n-1) L
* bidirectional ring     : ring / 2 (both directions used)
* 2-D torus (v5e)        : reduce-scatter along x then y, all-gather
                           back; each phase uses both axis directions.
* hierarchical (pods)    : intra-pod reduce-scatter, inter-pod
                           all-reduce over DCN on 1/n_pod shard,
                           intra-pod all-gather (dist-gem5 layering).
* all-to-all             : each chip sends S/n to n-1 peers; torus
                           bisection-limited.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core.desim.machine import ClusterModel


@dataclass
class Phase:
    """One timed phase of a collective (for the event executor)."""

    name: str
    time_s: float
    bytes_on_wire: float


class CollectiveAlgorithm:
    """Base plug-in.  ``kind`` names the HLO op it models."""

    name = "abstract"

    def time_s(self, kind: str, nbytes: float, participants: int,
               machine: ClusterModel) -> float:
        return sum(p.time_s for p in self.phases(kind, nbytes, participants,
                                                 machine))

    def phases(self, kind: str, nbytes: float, participants: int,
               machine: ClusterModel) -> List[Phase]:
        raise NotImplementedError


def _ring(kind: str, S: float, n: int, bw: float, lat: float,
          bidir: bool = False) -> List[Phase]:
    if n <= 1 or S <= 0:
        return [Phase(kind, 0.0, 0.0)]
    eff_bw = bw * (2 if bidir else 1)
    if kind == "all-reduce":
        t = 2 * (n - 1) / n * S / eff_bw + 2 * (n - 1) * lat
        wire = 2 * (n - 1) / n * S
    elif kind in ("all-gather", "reduce-scatter"):
        t = (n - 1) / n * S / eff_bw + (n - 1) * lat
        wire = (n - 1) / n * S
    elif kind == "all-to-all":
        # ring a2a: each step shifts S/n; n-1 steps; bisection-limited
        t = (n - 1) / n * S / eff_bw + (n - 1) * lat
        wire = (n - 1) / n * S
    elif kind == "collective-permute":
        t = S / eff_bw + lat
        wire = S
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    return [Phase(f"{kind}/ring", t, wire)]


class RingAlgorithm(CollectiveAlgorithm):
    name = "ring"

    def phases(self, kind, nbytes, participants, machine):
        ici = machine.pod.ici
        return _ring(kind, nbytes, participants, ici.bw, ici.latency_s)


class BidirRingAlgorithm(CollectiveAlgorithm):
    name = "bidir-ring"

    def phases(self, kind, nbytes, participants, machine):
        ici = machine.pod.ici
        return _ring(kind, nbytes, participants, ici.bw, ici.latency_s,
                     bidir=True)


class Torus2DAlgorithm(CollectiveAlgorithm):
    """v5e-native: phase per torus axis, both directions per axis.

    For an all-reduce over n chips arranged ~sqrt(n) x ~sqrt(n):
    reduce-scatter along x (payload S), then along y (payload S/nx),
    then all-gather y, all-gather x.  Each axis ring is bidirectional.
    """

    name = "torus2d"

    def phases(self, kind, nbytes, participants, machine):
        n = participants
        if n <= 1 or nbytes <= 0:
            return [Phase(kind, 0.0, 0.0)]
        pod = machine.pod
        nx = min(pod.nx, n)
        ny = max(1, n // nx)
        ici = pod.ici
        out: List[Phase] = []
        if kind == "all-reduce":
            out += _ring("reduce-scatter", nbytes, nx, ici.bw,
                         ici.latency_s, bidir=True)
            out += _ring("all-reduce", nbytes / nx, ny, ici.bw,
                         ici.latency_s, bidir=True)
            out += _ring("all-gather", nbytes, nx, ici.bw,
                         ici.latency_s, bidir=True)
        elif kind in ("all-gather", "reduce-scatter"):
            out += _ring(kind, nbytes, nx, ici.bw, ici.latency_s, bidir=True)
            if ny > 1:
                out += _ring(kind, nbytes, ny, ici.bw, ici.latency_s,
                             bidir=True)
        elif kind == "all-to-all":
            # bisection-limited: S/2 bytes must cross the bisection
            bis = pod.bisection_bw() * (n / pod.num_chips)
            t = (nbytes / 2) / max(bis, 1.0) + math.sqrt(n) * ici.latency_s
            out = [Phase("all-to-all/torus", t, nbytes / 2)]
        elif kind == "collective-permute":
            out = _ring(kind, nbytes, n, ici.bw, ici.latency_s, bidir=True)
        else:
            raise ValueError(kind)
        return out


class HierarchicalAlgorithm(CollectiveAlgorithm):
    """Cross-pod: intra-pod RS (ICI) -> inter-pod AR (DCN) -> intra-pod AG.

    The dist-gem5 layering: fast local interconnect inside a node
    (pod), slow TCP (DCN) between nodes, synchronized at quanta.
    """

    name = "hierarchical"

    def phases(self, kind, nbytes, participants, machine):
        # total_pods, not num_pods: on a dist-gem5 shard machine the DCN
        # ring spans the *global* pod count (ParallelEngine sets
        # machine.global_num_pods), so shard and serial cost identically
        pods = getattr(machine, "total_pods", None) or machine.num_pods
        per_pod = max(1, participants // max(pods, 1))
        ici = machine.pod.ici
        dcn = machine.dcn
        if pods <= 1:
            return Torus2DAlgorithm().phases(kind, nbytes, participants,
                                             machine)
        out: List[Phase] = []
        if kind == "all-reduce":
            out += _ring("reduce-scatter", nbytes, per_pod, ici.bw,
                         ici.latency_s, bidir=True)
            # DCN AR on the 1/per_pod shard; hosts move bytes in parallel,
            # so the shard is further split over the hosts of a pod.
            shard = nbytes / per_pod
            out += _ring("all-reduce", shard, pods, dcn.bw, dcn.latency_s)
            out += _ring("all-gather", nbytes, per_pod, ici.bw,
                         ici.latency_s, bidir=True)
        else:
            out += Torus2DAlgorithm().phases(kind, nbytes, per_pod, machine)
            shard = nbytes / max(per_pod, 1)
            out += _ring(kind, shard, pods, dcn.bw, dcn.latency_s)
        return out


ALGORITHMS: Dict[str, CollectiveAlgorithm] = {
    a.name: a for a in (RingAlgorithm(), BidirRingAlgorithm(),
                        Torus2DAlgorithm(), HierarchicalAlgorithm())
}


def get_algorithm(name: str) -> CollectiveAlgorithm:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown collective algorithm {name!r}; one of {list(ALGORITHMS)}")


def best_algorithm(kind: str, nbytes: float, participants: int,
                   machine: ClusterModel) -> Tuple[str, float]:
    """Auto-select (what XLA's collective scheduler would pick)."""
    best = None
    for name, alg in ALGORITHMS.items():
        t = alg.time_s(kind, nbytes, participants, machine)
        if best is None or t < best[1]:
            best = (name, t)
    return best
