"""A copy of ``repro.core.stats`` (pure Python): the port imports nothing of
the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Hierarchical statistics database (gem5-20 paper §2.21.1).

gem5's new statistics API introduced *statistics groups*: stats are
bound to their SimObject's group and the groups form a tree matching
the SimObject graph, enabling subtree dumps and structured (HDF5)
output.  g5x reproduces that design:

* ``Scalar`` / ``Vector`` / ``Distribution`` / ``Formula`` stat kinds
  (the gem5 kinds used by virtually every model).
* ``StatGroup`` trees with dotted-path resolution and subtree dumps —
  "the ability to dump statistics for a subset of the object graph".
* Time-series sampling into an N-dimensional structure dumped as JSON
  (the container has no HDF5; JSON with the same time-major layout is
  the stand-in, and the writer is pluggable).
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional


class Stat:
    kind = "stat"

    def __init__(self, name: str, desc: str = "", unit: str = ""):
        self.name = name
        self.desc = desc
        self.unit = unit

    def value(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name, "desc": self.desc,
                "unit": self.unit, "value": self.value()}

    # -- checkpointing (repro.sim.serialize) ---------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Internal accumulator state, not just the rendered value —
        restoring it and continuing must be bit-identical to never
        having paused (gem5 serializes stats the same way)."""
        return {}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        pass

    # -- merging (repro.core.desim.parallel, sweep shards) -------------
    def merge(self, other: "Stat") -> None:
        """Fold ``other``'s accumulators into this stat, as if both
        sample streams had been fed to one stat.  Counts, sums, bins
        and extrema combine exactly; a ``Distribution``'s mean/m2 use
        the parallel Welford (Chan) update, which is exact in count and
        equal up to float rounding in mean/variance.  Merging into an
        *empty* stat adopts ``other``'s state verbatim (bit-exact) —
        the property the parallel engine's disjoint per-pod subtrees
        rely on."""
        if type(other) is not type(self):
            raise TypeError(f"cannot merge {type(other).__name__} into "
                            f"{type(self).__name__} stat {self.name!r}")


class Scalar(Stat):
    kind = "scalar"

    def __init__(self, name: str, desc: str = "", unit: str = ""):
        super().__init__(name, desc, unit)
        self._v = 0.0

    def inc(self, by: float = 1.0) -> None:
        self._v += by

    def set(self, v: float) -> None:
        self._v = float(v)

    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        self._v = 0.0

    def state_dict(self) -> Dict[str, Any]:
        return {"v": self._v}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self._v = float(d["v"])

    def merge(self, other: "Stat") -> None:
        super().merge(other)
        self._v += other._v


class Vector(Stat):
    kind = "vector"

    def __init__(self, name: str, size: int, desc: str = "", unit: str = "",
                 labels: Optional[List[str]] = None):
        super().__init__(name, desc, unit)
        self._v = [0.0] * size
        self.labels = labels or [str(i) for i in range(size)]

    def inc(self, idx: int, by: float = 1.0) -> None:
        self._v[idx] += by

    def set(self, idx: int, v: float) -> None:
        self._v[idx] = float(v)

    def value(self) -> List[float]:
        return list(self._v)

    def total(self) -> float:
        return sum(self._v)

    def reset(self) -> None:
        self._v = [0.0] * len(self._v)

    def state_dict(self) -> Dict[str, Any]:
        return {"v": list(self._v)}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if len(d["v"]) != len(self._v):
            raise ValueError(f"vector {self.name}: size mismatch "
                             f"{len(d['v'])} != {len(self._v)}")
        self._v = [float(x) for x in d["v"]]

    def merge(self, other: "Stat") -> None:
        super().merge(other)
        if len(other._v) != len(self._v):
            raise ValueError(f"vector {self.name}: size mismatch "
                             f"{len(other._v)} != {len(self._v)}")
        self._v = [a + b for a, b in zip(self._v, other._v)]


class Distribution(Stat):
    """Streaming distribution: count/mean/var/min/max (Welford)."""

    kind = "distribution"

    def __init__(self, name: str, desc: str = "", unit: str = ""):
        super().__init__(name, desc, unit)
        self.reset()

    def sample(self, v: float, n: int = 1) -> None:
        for _ in range(n):
            self._count += 1
            d = v - self._mean
            self._mean += d / self._count
            self._m2 += d * (v - self._mean)
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def stddev(self) -> float:
        return math.sqrt(self._m2 / self._count) if self._count else 0.0

    def value(self) -> Dict[str, float]:
        return {"count": self._count, "mean": self._mean,
                "stddev": self.stddev,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0}

    def reset(self) -> None:
        self._count = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def state_dict(self) -> Dict[str, Any]:
        # Welford accumulators, so a restored run keeps streaming into
        # the same distribution (mean/m2 continue exactly).  min/max of
        # an empty distribution are +-inf sentinels, which are not
        # RFC 8259 JSON — store None instead so checkpoint files stay
        # strictly parseable everywhere.
        return {"count": self._count, "mean": self._mean, "m2": self._m2,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self._count = int(d["count"])
        self._mean = float(d["mean"])
        self._m2 = float(d["m2"])
        self._min = float("inf") if d["min"] is None else float(d["min"])
        self._max = float("-inf") if d["max"] is None else float(d["max"])

    def merge(self, other: "Stat") -> None:
        super().merge(other)
        if other._count == 0:
            return
        if self._count == 0:
            # adopt verbatim: merging into an empty stat is bit-exact
            self._count = other._count
            self._mean = other._mean
            self._m2 = other._m2
            self._min = other._min
            self._max = other._max
            return
        # Chan et al. parallel Welford update
        na, nb = self._count, other._count
        delta = other._mean - self._mean
        n = na + nb
        self._mean += delta * nb / n
        self._m2 += other._m2 + delta * delta * na * nb / n
        self._count = n
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)


class Percentiles(Stat):
    """Streaming quantile sketch (bounded-memory, serializable).

    DDSketch-style logarithmic binning: a sample ``v > 0`` lands in bin
    ``ceil(log_gamma(v))`` with ``gamma = (1 + rel_err)/(1 - rel_err)``,
    which guarantees every reported quantile is within ``rel_err``
    *relative* error of the exact sample quantile — the right error
    model for latency tails, where p99 may be 100x p50 and a fixed
    absolute-bin histogram would need millions of buckets.

    The accumulator state (sparse bin counts + count/sum/min/max) is a
    plain dict, so ``state_dict``/``load_state_dict`` round-trips through
    JSON checkpoints and a restored run keeps streaming into the same
    sketch bit-identically (the serving checkpoint test enforces this).
    Non-positive samples are clamped into a dedicated zero bin (serving
    metrics are non-negative; a 0.0 TTFT is representable).
    """

    kind = "percentiles"

    def __init__(self, name: str, desc: str = "", unit: str = "",
                 rel_err: float = 0.01):
        super().__init__(name, desc, unit)
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self.reset()

    # -- accumulation ---------------------------------------------------
    def _key(self, v: float) -> int:
        return int(math.ceil(math.log(v) / self._log_gamma))

    def sample(self, v: float, n: int = 1) -> None:
        # clamp applies to ALL accumulators (sum/min/max too), so the
        # reported mean/min never drop below every quantile
        v = max(float(v), 0.0)
        if v == 0.0:
            self._zero += n
        else:
            k = self._key(v)
            self._bins[k] = self._bins.get(k, 0) + n
        self._count += n
        self._sum += v * n
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    # -- queries --------------------------------------------------------
    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], within ``rel_err`` relative
        error of the exact sample quantile (0.0 on an empty sketch)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._count == 0:
            return 0.0
        rank = q * (self._count - 1)
        seen = self._zero
        if rank < seen:
            return 0.0
        for k in sorted(self._bins):
            seen += self._bins[k]
            if rank < seen:
                # midpoint of the bin (gamma^(k-1), gamma^k]
                return (2.0 * self._gamma ** k) / (self._gamma + 1.0)
        return self._max

    def value(self) -> Dict[str, float]:
        return {"count": self._count, "mean": self.mean,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p95": self.quantile(0.95), "p99": self.quantile(0.99)}

    def reset(self) -> None:
        self._bins: Dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    # -- checkpointing (repro.sim.serialize) ----------------------------
    def state_dict(self) -> Dict[str, Any]:
        # JSON object keys must be strings; bin keys are ints.  min/max
        # of an empty sketch are +-inf sentinels — stored as None to
        # keep checkpoint JSON strictly RFC 8259 (no Infinity literals).
        return {"rel_err": self.rel_err,
                "bins": {str(k): n for k, n in self._bins.items()},
                "zero": self._zero, "count": self._count, "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if float(d["rel_err"]) != self.rel_err:
            raise ValueError(
                f"percentiles {self.name}: rel_err mismatch "
                f"{d['rel_err']} != {self.rel_err} (bins not comparable)")
        self._bins = {int(k): int(n) for k, n in d["bins"].items()}
        self._zero = int(d["zero"])
        self._count = int(d["count"])
        self._sum = float(d["sum"])
        self._min = float("inf") if d["min"] is None else float(d["min"])
        self._max = float("-inf") if d["max"] is None else float(d["max"])

    def merge(self, other: "Stat") -> None:
        super().merge(other)
        if other.rel_err != self.rel_err:
            raise ValueError(
                f"percentiles {self.name}: rel_err mismatch "
                f"{other.rel_err} != {self.rel_err} (bins not comparable)")
        if other._count == 0:
            return
        if self._count == 0:
            self._bins = dict(other._bins)
            self._zero = other._zero
            self._count = other._count
            self._sum = other._sum
            self._min = other._min
            self._max = other._max
            return
        for k, n in other._bins.items():
            self._bins[k] = self._bins.get(k, 0) + n
        self._zero += other._zero
        self._count += other._count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)


class Formula(Stat):
    """Lazily-evaluated derived stat (gem5 ``Formula``)."""

    kind = "formula"

    def __init__(self, name: str, fn: Callable[[], float], desc: str = "",
                 unit: str = ""):
        super().__init__(name, desc, unit)
        self._fn = fn

    def value(self) -> float:
        try:
            return self._fn()
        except ZeroDivisionError:
            return 0.0

    def reset(self) -> None:
        pass


def _rehydrate(like: Stat, sd: Dict[str, Any]) -> Stat:
    """Build a scratch stat of ``like``'s kind holding ``sd``'s state."""
    if isinstance(like, Vector):
        tmp: Stat = Vector(like.name, len(sd["v"]))
    elif isinstance(like, Percentiles):
        tmp = Percentiles(like.name, rel_err=float(sd["rel_err"]))
    else:
        tmp = type(like)(like.name)
    tmp.load_state_dict(sd)
    return tmp


class StatGroup:
    """A named group of stats; groups form a tree mirroring SimObjects."""

    def __init__(self, name: str):
        self.name = name
        self._stats: Dict[str, Stat] = {}
        self._children: List[StatGroup] = []

    # -- construction ---------------------------------------------------
    def scalar(self, name: str, desc: str = "", unit: str = "") -> Scalar:
        return self._add(Scalar(name, desc, unit))

    def vector(self, name: str, size: int, desc: str = "", unit: str = "",
               labels: Optional[List[str]] = None) -> Vector:
        return self._add(Vector(name, size, desc, unit, labels))

    def distribution(self, name: str, desc: str = "",
                     unit: str = "") -> Distribution:
        return self._add(Distribution(name, desc, unit))

    def percentiles(self, name: str, desc: str = "", unit: str = "",
                    rel_err: float = 0.01) -> Percentiles:
        return self._add(Percentiles(name, desc, unit, rel_err=rel_err))

    def formula(self, name: str, fn: Callable[[], float], desc: str = "",
                unit: str = "") -> Formula:
        return self._add(Formula(name, fn, desc, unit))

    def _add(self, stat: Stat) -> Any:
        if stat.name in self._stats:
            raise ValueError(f"duplicate stat {stat.name!r} in {self.name}")
        self._stats[stat.name] = stat
        return stat

    def add_child(self, group: "StatGroup") -> None:
        if group not in self._children:
            self._children.append(group)

    # -- access -----------------------------------------------------------
    def __getitem__(self, dotted: str) -> Stat:
        parts = dotted.split(".")
        grp: StatGroup = self
        for p in parts[:-1]:
            match = [c for c in grp._children if c.name == p]
            if not match:
                raise KeyError(f"no stat group {p!r} under {grp.name!r}")
            grp = match[0]
        return grp._stats[parts[-1]]

    def stats(self) -> Dict[str, Stat]:
        return dict(self._stats)

    # -- dumping -----------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "stats": {k: s.as_dict() for k, s in self._stats.items()},
            "children": [c.as_dict() for c in self._children],
        }

    def flat(self, prefix: str = "") -> Dict[str, Any]:
        """Flatten to ``path.stat -> value`` (gem5 stats.txt style)."""
        path = f"{prefix}{self.name}"
        out = {f"{path}.{k}": s.value() for k, s in self._stats.items()}
        for c in self._children:
            out.update(c.flat(prefix=f"{path}."))
        return out

    def dump_text(self) -> str:
        lines = ["---------- Begin Simulation Statistics ----------"]
        for k, v in self.flat().items():
            lines.append(f"{k:<60} {v}")
        lines.append("---------- End Simulation Statistics ----------")
        return "\n".join(lines)

    def dump_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.as_dict(), indent=1, default=str)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    def reset(self) -> None:
        for s in self._stats.values():
            s.reset()
        for c in self._children:
            c.reset()

    # -- checkpointing (repro.sim.serialize) ----------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Recursive accumulator snapshot keyed by stat/child name.
        Child names must be unique within a group (they are: the stats
        tree mirrors the SimObject tree, whose children are attributes).
        """
        return {
            "stats": {k: s.state_dict() for k, s in self._stats.items()},
            "children": {c.name: c.state_dict() for c in self._children},
        }

    def load_state_dict(self, d: Dict[str, Any],
                        strict: bool = False) -> None:
        """Restore a ``state_dict``.  Stats/children present in the dict
        but missing from this tree (or vice versa) are skipped unless
        ``strict`` — restoring onto a re-parameterized machine keeps the
        overlap."""
        for k, sd in d.get("stats", {}).items():
            if k in self._stats:
                self._stats[k].load_state_dict(sd)
            elif strict:
                raise KeyError(f"no stat {k!r} in group {self.name!r}")
        by_name = {c.name: c for c in self._children}
        for k, cd in d.get("children", {}).items():
            if k in by_name:
                by_name[k].load_state_dict(cd, strict=strict)
            elif strict:
                raise KeyError(f"no child group {k!r} under {self.name!r}")

    # -- merging (repro.core.desim.parallel, sweep shards) --------------
    def merge(self, other: "StatGroup", strict: bool = False) -> "StatGroup":
        """Fold ``other``'s tree into this one, matching stats and child
        groups by name and calling :meth:`Stat.merge` on each pair.  The
        result is as if both trees had accumulated one combined sample
        stream: counts/sums/bins combine exactly, Welford mean/m2 via the
        parallel (Chan) update.  Disjoint subtrees — the parallel
        engine's per-pod shards — merge bit-exactly, because merging into
        an untouched (zero/empty) stat adopts the source verbatim.
        Names present on only one side are skipped unless ``strict``.
        ``Formula`` stats carry no accumulator state and are ignored.
        Returns ``self`` so merges chain across sweep shards."""
        for k, st in other._stats.items():
            mine = self._stats.get(k)
            if mine is None:
                if strict:
                    raise KeyError(f"no stat {k!r} in group {self.name!r}")
                continue
            if isinstance(st, Formula):
                continue
            mine.merge(st)
        by_name = {c.name: c for c in self._children}
        for c in other._children:
            mine = by_name.get(c.name)
            if mine is None:
                if strict:
                    raise KeyError(
                        f"no child group {c.name!r} under {self.name!r}")
                continue
            mine.merge(c, strict=strict)
        return self

    def merge_state_dict(self, d: Dict[str, Any],
                         strict: bool = False) -> "StatGroup":
        """:meth:`merge`, but the right-hand side is a ``state_dict``
        (the wire format workers ship across process pipes) instead of a
        live tree.  Each entry is rehydrated into a scratch stat of the
        matching kind and merged, so the exactness guarantees of
        :meth:`Stat.merge` apply unchanged."""
        for k, sd in d.get("stats", {}).items():
            st = self._stats.get(k)
            if st is None:
                if strict:
                    raise KeyError(f"no stat {k!r} in group {self.name!r}")
                continue
            if isinstance(st, Formula):
                continue
            st.merge(_rehydrate(st, sd))
        by_name = {c.name: c for c in self._children}
        for k, cd in d.get("children", {}).items():
            mine = by_name.get(k)
            if mine is None:
                if strict:
                    raise KeyError(
                        f"no child group {k!r} under {self.name!r}")
                continue
            mine.merge_state_dict(cd, strict=strict)
        return self


class TimeSeries:
    """Sampled time-series store (the paper's HDF5 backend stand-in).

    Stores one row per ``sample()`` call; each row is the flat stat dict
    of the attached group.  Layout is time-major like gem5's HDF5 files
    ("we use one dimension for time and the remaining dimensions for the
    statistic").
    """

    def __init__(self, group: StatGroup):
        self.group = group
        self.times: List[float] = []
        self.rows: List[Dict[str, Any]] = []

    def sample(self, t: float) -> None:
        self.times.append(t)
        self.rows.append(self.group.flat())

    def column(self, key: str) -> List[Any]:
        return [r.get(key) for r in self.rows]

    def dump_json(self, path: Optional[str] = None) -> str:
        s = json.dumps({"time": self.times, "rows": self.rows}, default=str)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s
