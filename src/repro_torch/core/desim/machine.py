"""Parameterized machine models of the card (gem5's CPU/DRAM model
analogue), copied from ``repro.core.desim.machine`` with the card's
constants: the port imports nothing of the JAX package.  Below the
catalog its source is the original's but for the defaults, their
descriptions and ``default_cluster``; ``tests/test_torch_sim.py`` names
this file among the copies that may differ.

gem5 ships "parameterized models for a wide number of components"; the
user configures them from Python and the event engine gives timing.
Here the components are cards, pods of cards joined by NVLink, and
clusters of pods joined by the inter-node network.  Every number is a
``Param`` so design-space exploration over hardware (the canonical gem5
use case) works: double HBM bandwidth, re-run the trace, read the new
step time -- no recompilation (elastic traces, gem5-20 §2.8).

The defaults describe one NVIDIA H100 SXM5 (the NVIDIA H100 Tensor Core
GPU datasheet), held once in the ``H100_SXM`` catalog entry:
  dense bf16 tensor-core peak 989 TFLOP/s; HBM3 3.35 TB/s and 80 GB;
  NVLink 4 at 450 GB/s a direction (900 GB/s both ways).
``launch/dryrun.py`` reads its roofline constants from that entry, so
the dry run's roofline and the desim replay share one owner.

A pod of cards is a ring on the torus model (``nx`` cards, ``ny`` 1):
the simulator has no NVSwitch topology, so a multi-card board times
its collectives with the ring algorithm over each card's NVLink rate.
``TPU_V5E`` and ``TPU_V5E_LINKS`` are the reference's own catalog,
which the port's copies of the ``v5e_*`` boards set explicitly so that
they build the reference's machines bit for bit; no prediction of the
port is made on them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.simobject import Param, SimObject

# Catalog entry for the card (like gem5's DDR3_1600_8x8 etc.): one NVIDIA
# H100 SXM5.  ``vmem_bytes`` is its on-chip shared memory, 228 KiB on each
# of 132 SMs (the TPU's VMEM analogue); ``nvlink_bw`` a card's NVLink 4
# bandwidth a direction, the pod's link.
H100_SXM = dict(peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9,
                vmem_bytes=132 * 228 * 1024, nvlink_bw=450e9)

class ChipModel(SimObject):
    """One card (the 'CPU core model'); ``mxu_efficiency`` keeps the
    reference's name for the tensor cores' achievable fraction."""

    peak_flops = Param(float, H100_SXM["peak_flops"],
                       "dense bf16 tensor-core peak FLOP/s")
    hbm_bw = Param(float, H100_SXM["hbm_bw"], "HBM bandwidth B/s")
    hbm_bytes = Param(float, H100_SXM["hbm_bytes"], "HBM capacity bytes")
    vmem_bytes = Param(float, H100_SXM["vmem_bytes"],
                       "on-chip shared memory bytes, all SMs")
    # derates: achievable fraction of peak (gem5 models expose similar
    # efficiency knobs, e.g. DRAM bus utilization)
    mxu_efficiency = Param(float, 0.85,
                           "achievable tensor-core fraction for big GEMMs")
    hbm_efficiency = Param(float, 0.8, "achievable HBM fraction")
    # clock-skew multiplier used for straggler injection (1.0 = nominal)
    slowdown = Param(float, 1.0, "straggler multiplier", check=lambda v: v > 0)

    def compute_time_s(self, flops: float, bytes_accessed: float) -> float:
        """Roofline execution time of one fused region on this chip."""
        tc = flops / (self.peak_flops * self.mxu_efficiency)
        tm = bytes_accessed / (self.hbm_bw * self.hbm_efficiency)
        return max(tc, tm) * self.slowdown


class LinkModel(SimObject):
    """One link: a card's NVLink inside a pod, or the inter-node network
    between pods (``DcnModel``)."""

    bw = Param(float, H100_SXM["nvlink_bw"], "bandwidth B/s per direction")
    latency_s = Param(float, 1e-6, "per-hop latency seconds")

    def transfer_time_s(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bw


class PodModel(SimObject):
    """A 2-D torus of cards; a pod of the card's boards is a ring of
    ``nx`` cards (``ny`` 1), one card by default."""

    nx = Param(int, 1, "torus x dimension")
    ny = Param(int, 1, "torus y dimension")

    def __init__(self, name: str = "pod", chip: Optional[ChipModel] = None,
                 ici: Optional[LinkModel] = None, **kw):
        super().__init__(name, **kw)
        self.chip = chip or ChipModel("chip")
        self.ici = ici or LinkModel("ici")

    @property
    def num_chips(self) -> int:
        return self.nx * self.ny

    def axis_links(self) -> int:
        """Usable torus links per chip (4 for a 2-D torus: +-x, +-y)."""
        return 4

    def bisection_bw(self) -> float:
        """Pod bisection bandwidth (B/s) of the 2-D torus."""
        # cutting a 2-D torus in half crosses 2*min(nx,ny) links,
        # times 2 for the wraparound
        return 2 * 2 * min(self.nx, self.ny) * self.ici.bw


class DcnModel(LinkModel):
    """Inter-node network between pods (dist-gem5's TCP analogue)."""

    bw = Param(float, 50e9, "inter-node bandwidth a card, B/s (one 400 "
               "Gb/s InfiniBand NDR port a card, as in a DGX H100)")
    latency_s = Param(float, 10e-6, "cross-pod latency seconds")


class ClusterModel(SimObject):
    """Pods x PodModel joined by DCN."""

    num_pods = Param(int, 1, "number of pods", check=lambda v: v >= 1)
    # dist-gem5 quantum for multi-pod DES synchronization (ns ticks)
    quantum_ns = Param(int, 100_000, "sync quantum in ns")
    # cost context for sharded simulation: a dist-gem5 shard machine
    # carries only its own pods (num_pods = shard size) but collective
    # cost models must price the *global* topology; 0 = "I am the whole
    # machine" (the default for every non-shard machine)
    global_num_pods = Param(int, 0, "global pod count when this machine "
                            "is a shard of a larger one (0 = not a shard)",
                            check=lambda v: v >= 0)

    def __init__(self, name: str = "cluster", pod: Optional[PodModel] = None,
                 dcn: Optional[DcnModel] = None, **kw):
        super().__init__(name, **kw)
        self.pod = pod or PodModel("pod")
        self.dcn = dcn or DcnModel("dcn")

    @property
    def num_chips(self) -> int:
        return self.num_pods * self.pod.num_chips

    @property
    def total_pods(self) -> int:
        """Pod count of the machine this model *represents*: the global
        count for a shard (``global_num_pods`` set by ParallelEngine),
        ``num_pods`` otherwise.  Collective cost models must use this so
        a shard prices DCN phases identically to the full machine."""
        return self.global_num_pods or self.num_pods

    # -- roofline terms (per step, whole machine) -----------------------
    def roofline_terms(self, total_flops: float, total_bytes: float,
                       collective_bytes: float) -> dict:
        """The three §Roofline terms, in seconds.

        Definitions follow the assignment exactly:
          compute    = HLO_FLOPs / (chips * peak)
          memory     = HLO_bytes / (chips * HBM_bw)
          collective = collective_bytes / (chips * link_bw)

        where the per-chip totals are whole-program sums divided evenly
        over chips (the dry-run cost model is per-device already; callers
        pass per-device totals with chips=1, or global totals).
        """
        chips = self.num_chips
        compute = total_flops / (chips * self.pod.chip.peak_flops)
        memory = total_bytes / (chips * self.pod.chip.hbm_bw)
        coll = collective_bytes / (chips * self.pod.ici.bw)
        dominant = max(("compute", compute), ("memory", memory),
                       ("collective", coll), key=lambda kv: kv[1])[0]
        return {"compute_s": compute, "memory_s": memory,
                "collective_s": coll, "dominant": dominant,
                "bound_s": max(compute, memory, coll)}


# The reference's catalog entries (its chip, and its pod and inter-pod
# links), for the copies of its ``v5e_*`` boards only.
TPU_V5E = dict(peak_flops=197e12, hbm_bw=819e9, hbm_bytes=16e9,
               vmem_bytes=128e6)
TPU_V5E_LINKS = dict(ici=dict(bw=50e9, latency_s=1e-6),
                     dcn=dict(bw=12.5e9, latency_s=10e-6))


def default_cluster(mesh=None) -> ClusterModel:
    """The card's machine for a program's ``DeviceMesh``: one card with no
    mesh; else the mesh's cards, in pods of its "pod" axis (one pod when
    it has none), each pod a ring of its cards."""
    num_pods, cards = 1, 1
    if mesh is not None:
        shape = tuple(mesh.shape)
        names = tuple(mesh.mesh_dim_names or ())
        cards = math.prod(shape)
        if "pod" in names:
            num_pods = shape[names.index("pod")]
    c = ClusterModel("cluster", num_pods=num_pods)
    c.pod.nx = cards // num_pods
    c.instantiate()
    return c


@dataclass
class MachineSnapshot:
    """Plain-dict view used by benchmarks and JSON dumps."""

    chips: int
    peak_flops: float
    hbm_bw: float
    ici_bw: float
    dcn_bw: float

    @classmethod
    def of(cls, m: ClusterModel) -> "MachineSnapshot":
        return cls(chips=m.num_chips, peak_flops=m.pod.chip.peak_flops,
                   hbm_bw=m.pod.chip.hbm_bw, ici_bw=m.pod.ici.bw,
                   dcn_bw=m.dcn.bw)
