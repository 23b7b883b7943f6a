"""A copy of ``repro.sim.fingerprint`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

SimPoint-style phase fingerprinting + clustering (gem5 §1.3, §2.7).

SimPoint's bargain: program execution is phasic, so cluster fixed-size
intervals by their basic-block vectors (BBVs), simulate one
representative per cluster in detail, and reconstruct the whole run as
the weighted sum.  Our traces have no basic blocks, but they have the
exact analogue of a BBV — the **op-mix vector** of a window of steps:
how many compute ops and of which collective kinds, how many flops,
how many payload bytes on ICI vs DCN.  Two windows with the same op-mix
cost the same under any timing model, so clustering op-mix vectors
finds the phases that matter for *timing* (a flash-crowd burst of
contending collectives looks nothing like a calm step, and lands in its
own cluster).

Pipeline (all dependency-free, deterministic under a seed):

* :func:`fingerprint_trace` — slice a chained multi-step trace (or any
  op stream) into fixed windows, one feature vector per window.
* :func:`cluster_fingerprint` — seeded k-means++ over max-normalized
  vectors with BIC-based choice of k (the SimPoint recipe: pick the
  smallest k whose BIC is within ``bic_threshold`` of the best).
* :func:`simpoint_plan` — representatives + weights as a
  :class:`~repro.sim.sampling.SimPointPlan` that plugs into
  ``SampledSimulation`` next to the fixed-stride ``SamplePlan``.
* :func:`record_op_stream` — run a dynamic workload once at atomic
  fidelity and return its injected op stream as a static trace, so
  ServeSim/TrainSim/FleetSim runs can be fingerprinted the same way.

``bursty_trace`` builds the seeded non-steady-state reference workload
(calm steps punctuated by a flash-crowd-like burst phase whose parallel
collectives contend for shared links) used by the ``simpoint`` CI tier
and ``benchmarks/simpoint_sweep.py``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.desim.trace import COLLECTIVE_OPS, HloTrace, TraceOp

__all__ = [
    "FEATURE_NAMES", "Fingerprint", "fingerprint_trace",
    "cluster_fingerprint", "kmeans", "simpoint_plan",
    "record_op_stream", "chain_steps", "bursty_trace",
]

# Fixed feature ordering — NEVER derived from dict iteration, so the
# vectors (and everything clustered from them) are identical across
# interpreters regardless of PYTHONHASHSEED.
FEATURE_NAMES: Tuple[str, ...] = (
    ("n_compute", "flops", "hbm_bytes")
    + tuple(f"n_{k}" for k in COLLECTIVE_OPS)
    + ("ici_coll_bytes", "dcn_coll_bytes", "n_overlap")
)

_KIND_SLOT = {k: 3 + i for i, k in enumerate(COLLECTIVE_OPS)}


def op_mix_vector(ops: Sequence[TraceOp]) -> List[float]:
    """The BBV analogue: op-mix feature vector of one window of ops."""
    v = [0.0] * len(FEATURE_NAMES)
    for op in ops:
        if op.kind == "compute":
            v[0] += 1.0
            v[1] += op.flops
            v[2] += op.bytes
        else:
            slot = _KIND_SLOT.get(op.kind)
            if slot is not None:
                v[slot] += 1.0
            if op.scope == "dcn":
                v[-2] += op.coll_bytes
            else:
                v[-3] += op.coll_bytes
        if op.overlap:
            v[-1] += 1.0
    return v


@dataclass
class Fingerprint:
    """Per-window op-mix vectors of a sliced trace.

    ``window``  : steps per window (the SimPoint interval size).
    ``step_ops``: ops per step (uniform across steps — the slicing
                  contract ``SampledSimulation`` also relies on).
    ``vectors`` : one row per window, columns = :data:`FEATURE_NAMES`;
                  the final window may cover fewer steps (remainder).
    """

    window: int
    num_steps: int
    step_ops: int
    vectors: List[List[float]] = field(default_factory=list)

    @property
    def num_windows(self) -> int:
        return len(self.vectors)

    def window_steps(self, widx: int) -> int:
        """Steps covered by window ``widx`` (the last may be partial)."""
        full = self.num_steps - widx * self.window
        return max(0, min(self.window, full))


def fingerprint_trace(trace: HloTrace, num_steps: Optional[int] = None,
                      window: int = 1) -> Fingerprint:
    """Slice a chained multi-step trace into ``window``-step windows.

    ``num_steps`` defaults to ``trace.meta["steps"]`` (set by
    ``repeat_trace``/``chain_steps``); the trace must divide evenly
    into that many steps.  A remainder of steps smaller than ``window``
    becomes a final partial window.
    """
    if window < 1:
        raise ValueError("window must be >= 1 step")
    if num_steps is None:
        num_steps = int(trace.meta.get("steps", 0))
    if num_steps < 1:
        raise ValueError(
            "num_steps must be >= 1 (pass it explicitly, or fingerprint "
            "a trace built by repeat_trace/chain_steps which stamp "
            "meta['steps'])")
    n = len(trace.ops)
    if n % num_steps:
        raise ValueError(
            f"trace has {n} ops, not divisible into {num_steps} "
            "uniform steps")
    step_ops = n // num_steps
    fp = Fingerprint(window=window, num_steps=num_steps,
                     step_ops=step_ops)
    for lo in range(0, num_steps, window):
        hi = min(lo + window, num_steps)
        fp.vectors.append(
            op_mix_vector(trace.ops[lo * step_ops:hi * step_ops]))
    return fp


# ---------------------------------------------------------------------------
# dependency-free k-means (seeded, deterministic)
# ---------------------------------------------------------------------------

def _normalize(vectors: List[List[float]]) -> List[List[float]]:
    """Per-dimension max normalization onto [0, 1] — flop counts are
    ~1e12 and op counts ~1e1; unnormalized distance would only see
    flops."""
    if not vectors:
        return []
    dims = len(vectors[0])
    mx = [max(abs(v[d]) for v in vectors) or 1.0 for d in range(dims)]
    return [[v[d] / mx[d] for d in range(dims)] for v in vectors]


def _dist2(a: Sequence[float], b: Sequence[float]) -> float:
    return sum((x - y) * (x - y) for x, y in zip(a, b))


def kmeans(vectors: List[List[float]], k: int, seed: int = 0,
           iters: int = 50) -> Tuple[List[int], List[List[float]]]:
    """Seeded k-means++ (Lloyd iterations, deterministic tie-breaks).

    Returns ``(labels, centroids)``.  All arithmetic is plain Python
    floats over stable orderings, so the same (vectors, k, seed) gives
    the same clustering in any interpreter.
    """
    n = len(vectors)
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= {n} windows, got k={k}")
    rng = random.Random(seed)
    # k-means++ seeding: first centroid uniform, rest D^2-weighted
    centroids = [list(vectors[rng.randrange(n)])]
    d2 = [_dist2(v, centroids[0]) for v in vectors]
    for _ in range(1, k):
        total = sum(d2)
        if total <= 0.0:        # all points coincide with a centroid
            centroids.append(list(centroids[0]))
            continue
        r = rng.random() * total
        acc = 0.0
        pick = n - 1
        for i, w in enumerate(d2):
            acc += w
            if acc >= r:
                pick = i
                break
        centroids.append(list(vectors[pick]))
        d2 = [min(a, _dist2(v, centroids[-1]))
              for a, v in zip(d2, vectors)]
    labels = [0] * n
    for it in range(iters):
        # assign (ties break to the lowest cluster id)
        new_labels = []
        for v in vectors:
            best, best_d = 0, _dist2(v, centroids[0])
            for c in range(1, k):
                d = _dist2(v, centroids[c])
                if d < best_d:
                    best, best_d = c, d
            new_labels.append(best)
        if new_labels == labels and it > 0:
            break
        labels = new_labels
        # update (empty clusters keep their centroid)
        for c in range(k):
            members = [vectors[i] for i in range(n) if labels[i] == c]
            if members:
                dims = len(members[0])
                centroids[c] = [
                    sum(m[d] for m in members) / len(members)
                    for d in range(dims)]
    return labels, centroids


def _bic(vectors: List[List[float]], labels: List[int],
         centroids: List[List[float]]) -> float:
    """Spherical-Gaussian BIC (the x-means/SimPoint model-selection
    score): log-likelihood under per-cluster spherical Gaussians minus
    the parameter-count penalty."""
    import math
    n = len(vectors)
    k = len(centroids)
    d = len(vectors[0])
    rss = sum(_dist2(v, centroids[labels[i]])
              for i, v in enumerate(vectors))
    sigma2 = max(rss / max(n - k, 1), 1e-12)
    ll = 0.0
    for c in range(k):
        nc = sum(1 for l in labels if l == c)
        if nc <= 0:
            continue
        ll += (nc * math.log(nc / n)
               - nc * d / 2.0 * math.log(2.0 * math.pi * sigma2))
    ll -= rss / (2.0 * sigma2)
    params = k * (d + 1)
    return ll - params / 2.0 * math.log(n)


def cluster_fingerprint(fp: Fingerprint, max_k: int = 8, seed: int = 0,
                        bic_threshold: float = 0.9
                        ) -> Tuple[List[int], int]:
    """Cluster windows; choose k by the SimPoint BIC rule.

    Runs k-means for k = 1..min(max_k, windows), scores each clustering
    with BIC, and picks the *smallest* k whose min-max-normalized BIC
    reaches ``bic_threshold`` of the best — SimPoint's bias toward few
    representatives.  Returns ``(labels, k)``.
    """
    norm = _normalize(fp.vectors)
    n = len(norm)
    if n == 0:
        raise ValueError("empty fingerprint")
    kmax = max(1, min(max_k, n))
    runs: List[Tuple[List[int], float]] = []
    for k in range(1, kmax + 1):
        labels, cents = kmeans(norm, k, seed=seed)
        runs.append((labels, _bic(norm, labels, cents)))
    scores = [b for _, b in runs]
    lo, hi = min(scores), max(scores)
    span = (hi - lo) or 1.0
    for k0, (labels, b) in enumerate(runs):
        if (b - lo) / span >= bic_threshold:
            return labels, k0 + 1
    return runs[-1][0], kmax


def simpoint_plan(trace: HloTrace, num_steps: Optional[int] = None,
                  window: int = 1, max_k: int = 8, seed: int = 0,
                  bic_threshold: float = 0.9):
    """fingerprint → cluster → :class:`~repro.sim.sampling.SimPointPlan`.

    Representative of a cluster = the window closest to its centroid in
    normalized feature space (earliest window on ties); weight = the
    cluster's share of all windows.
    """
    from repro_torch.sim.sampling import SimPointPlan
    fp = fingerprint_trace(trace, num_steps=num_steps, window=window)
    labels, k = cluster_fingerprint(fp, max_k=max_k, seed=seed,
                                    bic_threshold=bic_threshold)
    norm = _normalize(fp.vectors)
    n = len(norm)
    reps: Dict[int, int] = {}
    sizes: Dict[int, int] = {}
    for c in range(k):
        members = [i for i in range(n) if labels[i] == c]
        if not members:
            continue
        dims = len(norm[0])
        cent = [sum(norm[i][d] for i in members) / len(members)
                for d in range(dims)]
        best = min(members, key=lambda i: (_dist2(norm[i], cent), i))
        reps[c] = best
        sizes[c] = len(members)
    order = sorted(reps.values())
    weight_of = {reps[c]: sizes[c] / n for c in reps}
    return SimPointPlan(window=fp.window,
                        representatives=order,
                        weights=[weight_of[w] for w in order],
                        labels=list(labels))


# ---------------------------------------------------------------------------
# op-stream recording (dynamic workloads) + reference workloads
# ---------------------------------------------------------------------------

def record_op_stream(board, workload, timing: str = "atomic") -> HloTrace:
    """Run a dynamic workload once (cheaply, at ``timing`` fidelity) and
    return the op stream it injected as a static, replayable trace —
    the elastic-trace record pass that makes ServeSim/TrainSim/FleetSim
    runs fingerprintable like any static trace.

    The stream is *not* stamped with ``meta["steps"]``: injected ops
    have no step structure, so fingerprint it with an explicit op-count
    window via :func:`fingerprint_ops`-style slicing (pass
    ``num_steps=len(ops)`` and a step-sized ``window``), or replay it
    as a whole.
    """
    from repro_torch.sim.simulator import Simulator
    sim = Simulator(board, workload, timing=timing)
    for _ in sim.run():
        pass
    src = sim._ex._trace
    rec = HloTrace(name=f"recorded:{src.name}",
                   ops=[replace(op) for op in src.ops],
                   meta={"recorded": 1.0})
    return rec


def chain_steps(steps: List[HloTrace], name: str = "chained") -> HloTrace:
    """Chain *heterogeneous* per-step traces into one multi-step trace
    (``repeat_trace`` for non-steady-state workloads): each step's root
    ops depend on the previous step's sink ops, and ``meta["steps"]``
    is stamped so ``SampledSimulation``/``fingerprint_trace`` recognize
    the step structure.  Every step must have the same op count (the
    uniform-step contract window accounting relies on)."""
    if not steps:
        raise ValueError("need at least one step")
    n = len(steps[0].ops)
    if any(len(s.ops) != n for s in steps):
        raise ValueError("all steps must have the same op count "
                         f"(got {sorted({len(s.ops) for s in steps})})")
    out = HloTrace(name, meta=dict(steps[0].meta, steps=len(steps)))
    prev_sinks: Tuple[int, ...] = ()
    for rep, step in enumerate(steps):
        off = rep * n
        has_dependent = [False] * n
        for op in step.ops:
            for d in op.deps:
                has_dependent[d] = True
        for idx, op in enumerate(step.ops):
            deps = tuple(d + off for d in op.deps)
            if not deps and rep > 0:
                deps = prev_sinks
            out.ops.append(replace(
                op, deps=deps,
                name=f"step{rep}/{op.name}" if op.name else ""))
        prev_sinks = tuple(off + i for i in range(n)
                           if not has_dependent[i])
    return out


def bursty_trace(num_steps: int = 100, burst_start: int = 55,
                 burst_len: int = 20, fan: int = 4,
                 calm_bytes: float = 2e6, burst_bytes: float = 240e6,
                 layer_flops: float = 4e12, layer_bytes: float = 1.2e9,
                 seed: int = 0, name: str = "bursty") -> HloTrace:
    """The seeded non-steady-state reference workload: a flash-crowd-
    like phase schedule over a static trace.

    Every step has the identical op *count* (1 compute + ``fan``
    collectives — the uniform-step contract), but the burst phase's
    ``fan`` collectives are large and **parallel** (all depend only on
    the step's compute op, whole-pod region), so under
    ``DetailedTiming`` they contend for the same ICI links and
    serialize ~``fan``-fold, while ``AtomicTiming`` overlaps them at
    the contention-free cost.  Calm steps carry tiny payloads either
    way.  That detailed-vs-atomic gap exists *only* inside the burst —
    exactly the phase a fixed-stride sample plan misses unless a window
    happens to land there, and the phase a SimPoint fingerprint finds
    from the op-mix (burst windows have ~100x the ici_coll_bytes).

    ``seed`` jitters per-step payload bytes ±10% so the trace is
    non-degenerate but fully reproducible.
    """
    if not (0 <= burst_start and burst_start + burst_len <= num_steps):
        raise ValueError("burst must lie inside [0, num_steps)")
    rng = random.Random(seed)
    steps: List[HloTrace] = []
    for s in range(num_steps):
        burst = burst_start <= s < burst_start + burst_len
        base = burst_bytes if burst else calm_bytes
        t = HloTrace(f"{name}/step{s}")
        t.ops.append(TraceOp(kind="compute", flops=layer_flops,
                             bytes=layer_bytes, name="fwdbwd"))
        for f in range(fan):
            jitter = 1.0 + 0.1 * (2.0 * rng.random() - 1.0)
            t.ops.append(TraceOp(
                kind="all-reduce", coll_bytes=base * jitter,
                participants=0, deps=(0,), scope="ici",
                name=f"grad{f}"))
        steps.append(t)
    return chain_steps(steps, name=name)
