"""A copy of ``repro.train.ft`` (pure Python): the port imports nothing of
the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Fault-tolerance machinery for 1000+-node operation.

* ``StragglerWatchdog`` — per-step wall-time monitor flagging outliers
  (the DES injects the same effect via per-pod ``slowdown``); at pod
  scale the mitigation is re-sharding around the slow host.
* ``Heartbeat`` — liveness file; a cluster controller (or test) detects
  a dead trainer by staleness.
* ``ElasticPlanner`` — pure function choosing a new (data, model) mesh
  factorization from a surviving chip count, respecting the model's
  divisibility constraints; with the resharding restore in
  ``repro.checkpoint`` this implements elastic scaling: fail -> plan
  new mesh -> restore last checkpoint onto it -> continue.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.configs.base import ArchConfig


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.flagged: List[Tuple[int, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler.

        Flagged samples are kept OUT of the rolling median window
        (``self.times``): a burst of stragglers must not inflate the
        median and desensitize later detection — with the old
        behaviour, enough flagged steps raised the median until equally
        slow steps stopped being flagged at all
        (tests/test_checkpoint_ft.py regression).
        """
        hist = self.times[-self.window:]
        if len(hist) >= 4:
            med = sorted(hist)[len(hist) // 2]
            if seconds > self.threshold * med:
                self.flagged.append((step, seconds))
                return True
        self.times.append(seconds)
        return False

    def reset_window(self) -> None:
        """Forget the learned baseline after an *intended* regime
        change (elastic reshard to fewer chips, hardware swap): every
        step is legitimately slower now, and without a reset the frozen
        old median would flag all of them forever.  The next 4 samples
        re-learn the baseline unflagged (``record``'s warm-up)."""
        self.times.clear()

    def median(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]


class Heartbeat:
    """Liveness file.  Staleness is measured on the **monotonic** clock:
    wall-clock (``time.time``) deltas go negative under NTP steps /
    admin clock changes, which made a freshly-beating trainer look
    either immortal (negative age) or dead (forward step) — exactly the
    clock discipline problem 1000-node fleets hit in practice.
    ``CLOCK_MONOTONIC`` is per-boot and system-wide, so ages are
    comparable across processes on the same host (the controller and
    the trainer); wall time is still recorded, but as informational
    metadata only."""

    def __init__(self, path: str):
        self.path = path

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "mono": time.monotonic(),
                       "wall_time": time.time()}, f)
        os.replace(tmp, self.path)

    def age(self) -> Optional[float]:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        if "mono" in data:
            delta = time.monotonic() - data["mono"]
            if delta >= 0:
                return delta
            # a negative monotonic delta is impossible within one boot:
            # the file predates a reboot (CLOCK_MONOTONIC restarted at
            # 0), so the beat is at best wall-clock old — fall through
        # legacy files, or pre-reboot files: wall clock, clamped so a
        # backwards clock step cannot produce a negative age
        legacy = data.get("time", data.get("wall_time"))
        if legacy is None:
            return None
        return max(0.0, time.time() - legacy)

    def alive(self, max_age: float = 60.0) -> bool:
        age = self.age()
        return age is not None and age < max_age


@dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    chips: int
    note: str = ""


def plan_elastic_mesh(cfg: ArchConfig, surviving_chips: int,
                      prefer_model: int = 16) -> MeshPlan:
    """Choose (data, model) for the surviving chip count.

    Keeps the model axis as close to ``prefer_model`` as possible
    (weights must keep fitting) while requiring d_model % data == 0 and
    d_ff % model == 0.  Returns the largest usable power-of-two mesh
    (excess chips idle until the next full re-shard window).
    """
    best: Optional[MeshPlan] = None
    chips = surviving_chips
    # largest power-of-two <= chips
    usable = 1
    while usable * 2 <= chips:
        usable *= 2
    for model in sorted({prefer_model, 8, 4, 2, 1}, reverse=True):
        if model > usable or cfg.d_ff % model:
            continue
        data = usable // model
        if data == 0 or cfg.d_model % data:
            continue
        plan = MeshPlan((data, model), ("data", "model"), data * model,
                        note=f"{chips - data * model} chips idle")
        if best is None or plan.chips > best.chips:
            best = plan
    if best is None:
        best = MeshPlan((1, 1), ("data", "model"), 1, "degenerate fallback")
    return best
