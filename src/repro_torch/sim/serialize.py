"""A copy of ``repro.sim.serialize`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

gem5-style drain-then-serialize checkpointing (paper §2.7).

gem5 checkpoints by *draining* the system (every SimObject finishes its
in-flight transactions) and then serializing the SimObject tree to a
checkpoint directory; restoring may target a *differently configured*
system — the canonical workflow is "checkpoint after OS boot once,
restore onto every cache hierarchy you want to sweep".  g5x reproduces
that for trace replay:

* ``checkpoint_executor`` — a drained :class:`TraceExecutor` becomes a
  versioned, plain-JSON dict: the machine description (``SimObject.
  serialize``, gem5's config.ini analogue), the executor config, the
  elastic trace, and the drained run state (completed-op ticks, the
  deferred frontier, partial DCN rendezvous, per-link occupancy, the
  full stats-tree accumulator state, per-pod queue tick snapshots).
* ``restore_executor`` — rebuilds a ready-to-``advance`` executor from
  a checkpoint, optionally onto a **re-parameterized machine** (sweep
  HBM/ICI/DCN speeds from one checkpoint; pod count must match).
  Restored on the same machine, the resumed run's final tick and stats
  tree are identical to a run that never paused (test-enforced in
  ``tests/test_sim_checkpoint.py``).

The file format is one JSON document, ``version``-stamped so future
layouts can migrate old checkpoints instead of mis-reading them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from repro_torch.core.desim.executor import TraceExecutor
from repro_torch.core.desim.machine import ClusterModel
from repro_torch.core.desim.trace import HloTrace

CHECKPOINT_VERSION = 2
#: versions this reader still restores.  v2 is additive over v1 (new
#: optional ``parallel_protocol`` header key recording which
#: coordinator/worker wire protocol wrote the document — checkpoints
#: themselves stay serial-format and worker-count-agnostic), so v1
#: documents restore unchanged.
SUPPORTED_CHECKPOINT_VERSIONS = (1, 2)
CHECKPOINT_FORMAT = "repro.sim.checkpoint"

# optional top-level key carrying a dynamic workload's state (pending
# arrivals, scheduler state, percentile accumulators — see
# ``repro.sim.workloads``).  Static-trace checkpoints omit it; the key
# is additive, so the format version is unchanged.
WORKLOAD_KEY = "workload"

# optional sibling key naming the workload class the state belongs to
# (``ServeSim``, ``TrainSim``, ...): restoring a TrainSim checkpoint
# into a rebuilt ServeSim would otherwise fail deep inside
# ``load_state_dict`` with an opaque KeyError.  Additive, like
# WORKLOAD_KEY (older checkpoints without it restore unchecked).
WORKLOAD_KIND_KEY = "workload_kind"


class CheckpointError(RuntimeError):
    pass


def validate_workers(workers: Optional[int]) -> int:
    """``None`` means "serial" (1); anything else must be an int >= 1.

    ``workers=0`` used to be silently coerced to 1 via ``int(x or 1)``
    — a config typo that *looked* parallel but ran serial.  Reject it
    the way :class:`~repro.core.events.EventQueue` rejects negative
    ticks: loudly, at the call site.
    """
    if workers is None:
        return 1
    w = int(workers)
    if w < 1:
        raise ValueError(
            f"cannot build an executor with workers={workers!r} "
            "(worker count is a process count, >= 1; omit it or pass "
            "None for the serial engine)")
    return w


# ---------------------------------------------------------------------------
# machine description
# ---------------------------------------------------------------------------

def machine_to_dict(machine: ClusterModel) -> Dict[str, Any]:
    return machine.serialize()


def machine_from_dict(d: Dict[str, Any]) -> ClusterModel:
    """Rebuild an instantiated ClusterModel from ``machine_to_dict``.

    Construction is shape-specific (a ClusterModel always owns
    pod/chip/ici/dcn children), parameter application is generic
    (``SimObject.load_serialized``).
    """
    m = ClusterModel(d.get("name", "cluster"))
    m.load_serialized(d, strict=False)
    m.instantiate()
    return m


# ---------------------------------------------------------------------------
# checkpoint build / save / load / restore
# ---------------------------------------------------------------------------

def checkpoint_executor(ex: TraceExecutor) -> Dict[str, Any]:
    """Serialize a drained executor (call ``ex.drain()`` first)."""
    from repro_torch.core.desim.parallel import PARALLEL_PROTOCOL
    state = ex.snapshot()          # raises unless drained
    return {
        "format": CHECKPOINT_FORMAT,
        "version": CHECKPOINT_VERSION,
        "parallel_protocol": PARALLEL_PROTOCOL,
        "tick": state["tick"],
        "machine": machine_to_dict(ex.machine),
        "executor": {
            "algorithm": ex.algorithm,
            "straggler_slowdowns": list(ex.slow),
            "timing": ex.timing.name,
            "contention": ex.contention,      # legacy (== timing.detailed)
            "record_timeline": ex.record_timeline,
            "record_stats": ex.record_stats,
        },
        "trace": json.loads(ex._trace.to_json()),
        "state": state,
    }


def save_checkpoint(ckpt: Dict[str, Any], path: str) -> str:
    _check_header(ckpt)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ckpt, f)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path) as f:
        ckpt = json.load(f)
    _check_header(ckpt)
    return ckpt


def _check_header(ckpt: Dict[str, Any]) -> None:
    if ckpt.get("format") != CHECKPOINT_FORMAT:
        raise CheckpointError(
            f"not a {CHECKPOINT_FORMAT} document "
            f"(format={ckpt.get('format')!r})")
    if ckpt.get("version") not in SUPPORTED_CHECKPOINT_VERSIONS:
        raise CheckpointError(
            f"checkpoint version {ckpt.get('version')!r} not in "
            f"{SUPPORTED_CHECKPOINT_VERSIONS} (no migration registered)")


def trace_from_checkpoint(ckpt: Dict[str, Any]) -> HloTrace:
    return HloTrace.from_json(json.dumps(ckpt["trace"]))


def restore_executor(ckpt: Dict[str, Any],
                     machine: Optional[ClusterModel] = None,
                     **overrides) -> TraceExecutor:
    """A ready-to-``advance`` executor from a checkpoint dict.

    ``machine``: restore onto this (instantiated) machine instead of
    rebuilding the checkpointed one — the DSE re-parameterization hook.
    ``overrides``: TraceExecutor kwargs overriding the checkpointed
    config (e.g. ``record_stats=True``, or ``timing="detailed"`` — the
    gem5 ``switch_cpus`` move: a checkpoint taken under one timing
    model restores under another).  ``workers=N`` (N>1) restores into
    the multiprocess :class:`~repro.core.desim.parallel.ParallelEngine`
    — checkpoints are worker-count-agnostic, so a snapshot taken under
    any worker count restores under any other.
    """
    _check_header(ckpt)
    trace = trace_from_checkpoint(ckpt)
    if machine is None:
        machine = machine_from_dict(ckpt["machine"])
    cfg = dict(ckpt["executor"])
    # a None override must not shadow the checkpointed timing model
    cfg.update({k: v for k, v in overrides.items()
                if not (k in ("timing", "contention") and v is None)})
    workers = validate_workers(cfg.pop("workers", None))
    mp_context = cfg.pop("mp_context", None)
    if workers > 1:
        from repro_torch.core.desim.parallel import ParallelEngine
        eng = ParallelEngine(machine, workers=workers,
                             mp_context=mp_context, **cfg)
        return eng.restore(trace, ckpt["state"])
    ex = TraceExecutor(machine, **cfg)
    return ex.restore(trace, ckpt["state"])
