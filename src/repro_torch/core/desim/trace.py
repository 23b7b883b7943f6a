"""Elastic execution traces (gem5-20 §2.8), copied from
``repro.core.desim.trace``: the port imports nothing of the JAX package.

gem5's elastic traces capture *dependency-carrying* instruction traces
from the detailed O3 model once, then replay them under different
memory-system parameters without re-running the expensive model.  The
g5x analogue: record the op-level structure of a step once (compute
regions, collectives with byte counts, dependencies) and replay that
trace on any parameterized machine model (``core.desim.machine``)
without re-running the step -- change HBM bandwidth, the link speed, or
the collective algorithm and re-run the trace in milliseconds.  The
trace respects true dependencies (program order per partition +
collective barriers) while timing comes from the machine model under
test.

The port has no HLO: the reference's parsers of XLA's HLO text
(``parse_hlo_instructions``, ``collectives_from_hlo`` and their
summaries, ``HloTrace.from_hlo_text``) are left out, and
``core.fidelity.step_trace`` builds a step's trace from the dry run's op
stream instead.  The rest equals the original; ``tests/test_torch_sim.py``
names this file among the copies that may differ.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.desim.dtypes import shape_bytes  # noqa: F401 (re-export)

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


# ---------------------------------------------------------------------------
# Elastic trace
# ---------------------------------------------------------------------------

@dataclass
class TraceOp:
    """One node of the elastic trace.

    kind      : 'compute' | one of COLLECTIVE_OPS
    flops     : FLOPs of a compute region (per participating chip)
    bytes     : HBM bytes touched by a compute region (per chip)
    coll_bytes: global payload bytes of a collective
    participants : chips taking part in the collective
    deps      : indices of TraceOps that must complete first
    overlap   : collective may overlap the *next* compute region
                (models async collectives / comm-compute overlap)
    scope     : 'ici' (intra-pod) or 'dcn' (inter-pod) for collectives
    region    : optional (x0, y0, w, h) sub-grid of the torus the
                collective's ring occupies.  None = the whole pod (every
                collective contends for the same links, the conservative
                default).  Disjoint regions can proceed in parallel;
                overlapping regions serialize on the shared links.
    """

    kind: str
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    participants: int = 1
    deps: Tuple[int, ...] = ()
    overlap: bool = False
    scope: str = "ici"
    name: str = ""
    region: Optional[Tuple[int, int, int, int]] = None


@dataclass
class HloTrace:
    """A dependency-carrying, machine-independent trace of one step."""

    name: str
    ops: List[TraceOp] = field(default_factory=list)
    meta: Dict[str, float] = field(default_factory=dict)

    # -- persistence -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"name": self.name, "meta": self.meta,
                           "ops": [asdict(o) for o in self.ops]})

    @classmethod
    def from_json(cls, s: str) -> "HloTrace":
        d = json.loads(s)
        ops = [TraceOp(**{**o, "deps": tuple(o["deps"]),
                          "region": (tuple(o["region"])
                                     if o.get("region") else None)})
               for o in d["ops"]]
        return cls(name=d["name"], ops=ops, meta=d.get("meta", {}))

    # -- stats -------------------------------------------------------------
    def collective_bytes(self) -> float:
        return sum(o.coll_bytes for o in self.ops if o.kind != "compute")

    def compute_flops(self) -> float:
        return sum(o.flops for o in self.ops)


def analytic_trace(name: str, layers: int, layer_flops: float,
                   layer_bytes: float, layer_collectives: Iterable[Dict],
                   tail_collectives: Iterable[Dict] = (),
                   overlap: bool = False) -> HloTrace:
    """Build a trace from a *model-level* cost description.

    This is the gem5 'parameterized model' path: when we know the math
    of a layer (flops, bytes, the collectives its sharding implies) we
    can synthesize the trace directly — useful for DSE sweeps over
    configs that were never compiled (and for testing the executor).
    ``layer_collectives``/``tail_collectives``: dicts with keys
    kind/bytes/participants/scope.
    """
    t = HloTrace(name=name)
    prev = -1
    for l in range(layers):
        t.ops.append(TraceOp(kind="compute", flops=layer_flops,
                             bytes=layer_bytes,
                             deps=(prev,) if prev >= 0 else (),
                             name=f"layer{l}"))
        prev = len(t.ops) - 1
        for c in layer_collectives:
            region = c.get("region")
            t.ops.append(TraceOp(kind=c["kind"], coll_bytes=c["bytes"],
                                 participants=c.get("participants", 0),
                                 scope=c.get("scope", "ici"),
                                 region=tuple(region) if region else None,
                                 deps=(prev,), overlap=overlap,
                                 name=f"layer{l}/{c['kind']}"))
            prev = len(t.ops) - 1
    for c in tail_collectives:
        region = c.get("region")
        t.ops.append(TraceOp(kind=c["kind"], coll_bytes=c["bytes"],
                             participants=c.get("participants", 0),
                             scope=c.get("scope", "dcn"),
                             region=tuple(region) if region else None,
                             deps=(prev,), overlap=overlap,
                             name=f"tail/{c['kind']}"))
        prev = len(t.ops) - 1
    return t
