"""A copy of ``repro.sim.ckptlib`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Versioned checkpoint library for SimPoint regions (gem5 §2.7).

gem5's sampled workflow is checkpoint-*centric*: SimPoint picks the
representative regions once, one checkpoint is taken per region in a
single cheap pass, and every detailed experiment thereafter restores
those checkpoints — onto whatever CPU/cache configuration is under
study.  "Toward Reproducible and Standardized Computer Architecture
Simulation with gem5" (PAPERS.md) adds the reproducibility requirement:
the checkpoint artifacts must be versioned and indexed (what board,
what trace, what tick, what weight) or results built on them are not
portable.

:class:`CheckpointLibrary` is that artifact: a directory of
``repro.sim.checkpoint`` JSON files plus one ``index.json``::

    {
      "format": "repro.sim.ckptlib", "version": 1,
      "board": "<board name>",
      "board_digest": "<sha1 of the serialized machine>",
      "trace_digest": "<sha1 of the trace JSON>",
      "timing": "<capture fidelity>",
      "window": <steps per window>, "num_steps": <total steps>,
      "step_ops": <ops per step>,
      "entries": [
        {"id": "region-0007", "file": "region-0007.ckpt.json",
         "window": 7, "step": 14, "steps": 2, "tick": 123456789,
         "weight": 0.22},
        ...
      ]
    }

* :func:`take_region_checkpoints` — ONE atomic fast-forward pass over
  the chained trace, drain + checkpoint at each representative window
  boundary (gem5: one functional pass, N checkpoints).
* :func:`restore_fanout` — restore every region in parallel worker
  processes (the parallel-engine spawn conventions: plain-data init
  payloads, module-level entry point, ``default_mp_context()``), each
  timing only its window at detailed fidelity — optionally onto a
  **re-parameterized board** or a **different timing model** than the
  capture pass: the checkpoint-once / sweep-everything DSE move.
* :func:`reconstruct` — the SimPoint weighted total from the fanout's
  per-region step times.

Digests mismatching at restore raise loudly (a checkpoint restored
onto a silently different board is the least debuggable failure mode a
sampled methodology has); re-parameterization is explicit via
``board=``.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.desim.parallel import default_mp_context
from repro_torch.core.desim.simnodes import TICKS_PER_S
from repro_torch.core.desim.trace import HloTrace
from repro_torch.sim import serialize as ser
from repro_torch.sim.boards import Board

__all__ = [
    "INDEX_FORMAT", "INDEX_VERSION", "CheckpointLibrary", "RegionTime",
    "board_digest", "trace_digest", "take_region_checkpoints",
    "restore_fanout", "reconstruct",
]

INDEX_FORMAT = "repro.sim.ckptlib"
INDEX_VERSION = 1
INDEX_NAME = "index.json"


def board_digest(board: Board) -> str:
    """sha1 of the board's serialized machine (config.ini identity)."""
    board.instantiate()
    blob = json.dumps(board.machine.serialize(), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()


def trace_digest(trace: HloTrace) -> str:
    """sha1 of the trace JSON (dataclass field order is fixed, so the
    digest is stable across interpreters)."""
    return hashlib.sha1(trace.to_json().encode()).hexdigest()


class CheckpointLibrary:
    """A directory of versioned region checkpoints + ``index.json``."""

    def __init__(self, root: str):
        self.root = root
        self.meta: Dict[str, Any] = {}
        self.entries: List[Dict[str, Any]] = []
        path = os.path.join(root, INDEX_NAME)
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            if doc.get("format") != INDEX_FORMAT:
                raise ser.CheckpointError(
                    f"not a {INDEX_FORMAT} index "
                    f"(format={doc.get('format')!r})")
            if doc.get("version") != INDEX_VERSION:
                raise ser.CheckpointError(
                    f"index version {doc.get('version')!r} != "
                    f"{INDEX_VERSION} (no migration registered)")
            self.entries = list(doc.get("entries", []))
            self.meta = {k: v for k, v in doc.items()
                         if k not in ("format", "version", "entries")}

    # -- write ---------------------------------------------------------
    def add(self, ckpt: Dict[str, Any], entry: Dict[str, Any]) -> Dict:
        """Save one checkpoint file and register its index entry
        (``entry`` needs at least ``id``; ``file``/``tick`` are
        filled in)."""
        eid = entry["id"]
        fname = entry.setdefault("file", f"{eid}.ckpt.json")
        ser.save_checkpoint(ckpt, os.path.join(self.root, fname))
        entry.setdefault("tick", int(ckpt["state"]["tick"]))
        self.entries = [e for e in self.entries if e["id"] != eid]
        self.entries.append(entry)
        return entry

    def save_index(self) -> str:
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, INDEX_NAME)
        doc = {"format": INDEX_FORMAT, "version": INDEX_VERSION,
               **self.meta, "entries": self.entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path

    # -- read ----------------------------------------------------------
    def get(self, eid: str) -> Dict[str, Any]:
        for e in self.entries:
            if e["id"] == eid:
                return e
        raise KeyError(f"no checkpoint {eid!r} in {self.root} "
                       f"(have {[e['id'] for e in self.entries]})")

    def load(self, eid: str) -> Dict[str, Any]:
        """The full checkpoint document of one entry."""
        return ser.load_checkpoint(
            os.path.join(self.root, self.get(eid)["file"]))

    def check_board(self, board: Board) -> None:
        """Refuse a silent board mismatch (re-parameterization must be
        an explicit ``board=`` at restore time, not an accident)."""
        want = self.meta.get("board_digest")
        if want and board_digest(board) != want:
            raise ser.CheckpointError(
                f"board digest mismatch: library {self.root} was "
                f"captured on {self.meta.get('board')!r} "
                f"({want[:12]}…); pass this board explicitly via "
                "restore_fanout(..., board=) to re-parameterize")


# ---------------------------------------------------------------------------
# capture: one atomic pass, N region checkpoints
# ---------------------------------------------------------------------------

def take_region_checkpoints(board: Board, trace: HloTrace, plan,
                            root: str, timing: str = "atomic",
                            name: Optional[str] = None
                            ) -> CheckpointLibrary:
    """Capture one checkpoint per representative window of ``plan`` (a
    :class:`~repro.sim.sampling.SimPointPlan`) in a single ``timing``-
    fidelity fast-forward pass over the chained ``trace``.

    At each window boundary the run is drained and serialized (the ops
    already in flight — the boundary step's compute, whose cost is
    model-identical — complete into the checkpoint), then the pass
    resumes from the in-memory state.  Region step times measured after
    restore are therefore computed from per-op end ticks, not wall
    spans (see :func:`restore_fanout`).
    """
    board = board.instantiate()
    num_steps = int(trace.meta.get("steps", 0))
    if num_steps < 1:
        raise ValueError("trace must be chained with meta['steps'] "
                         "(repeat_trace / chain_steps)")
    n_ops = len(trace.ops) // num_steps
    lib = CheckpointLibrary(root)
    lib.meta = {
        "board": name or board.name,
        "board_digest": board_digest(board),
        "trace_digest": trace_digest(trace),
        "timing": timing,
        "window": plan.window,
        "num_steps": num_steps,
        "step_ops": n_ops,
    }

    progress = {"ops": 0}

    def hook(op, idx, start, end):
        progress["ops"] += 1

    ex = board.executor(record_stats=True, timing=timing)
    ex.op_hook = hook
    ex.begin(trace)
    for widx, weight in zip(plan.representatives, plan.weights):
        lo_step = widx * plan.window
        steps = min(plan.window, num_steps - lo_step)
        target = lo_step * n_ops
        ex.advance(stop_check=lambda: progress["ops"] >= target)
        ex.drain()
        ckpt = ser.checkpoint_executor(ex)
        lib.add(ckpt, {
            "id": f"region-{widx:04d}",
            "window": widx,
            "step": lo_step,
            "steps": steps,
            "weight": weight,
        })
        # a drained executor cannot resume in place — rebuild from the
        # snapshot we just took and continue the pass
        fresh = board.executor(record_stats=True, timing=timing,
                               straggler_slowdowns=list(ex.slow))
        ex = fresh.restore(trace, ckpt["state"])
        ex.op_hook = hook
    lib.save_index()
    return lib


# ---------------------------------------------------------------------------
# restore: parallel fanout
# ---------------------------------------------------------------------------

@dataclass
class RegionTime:
    """One region's detailed measurement out of the fanout."""

    id: str
    window: int
    steps: int
    weight: float
    step_s: float        # measured per-step time of the region
    start_tick: int      # max op-end tick before the window (t0)
    end_tick: int        # max op-end tick inside the window  (t1)


def _measure_region(ckpt: Dict[str, Any], entry: Dict[str, Any],
                    step_ops: int, machine_dict: Optional[Dict],
                    timing: Optional[str]) -> RegionTime:
    """Restore one region checkpoint and run ONLY its window.

    Step time comes from per-op end ticks — ``t0`` = latest end among
    ops before the window (from the checkpoint), ``t1`` = latest end
    among the window's ops — so the boundary compute op that drained
    into the checkpoint is charged to the window it belongs to (its
    cost is identical under either timing model).
    """
    machine = (ser.machine_from_dict(machine_dict)
               if machine_dict is not None else None)
    ex = ser.restore_executor(ckpt, machine=machine, timing=timing,
                              record_stats=False)
    lo = entry["step"] * step_ops
    hi = (entry["step"] + entry["steps"]) * step_ops

    def window_done() -> bool:
        ends = ex._op_end[0]
        return all(ends[i] >= 0 for i in range(lo, hi))

    ex.advance(stop_check=window_done)
    if not window_done():
        raise RuntimeError(
            f"{entry['id']}: window ops [{lo}, {hi}) did not complete "
            "(truncated trace or corrupt checkpoint?)")
    pods = range(ex.machine.num_pods)
    t0 = max((ex._op_end[p][i] for p in pods for i in range(lo)
              if ex._op_end[p][i] >= 0), default=0)
    t1 = max(ex._op_end[p][i] for p in pods for i in range(lo, hi))
    return RegionTime(
        id=entry["id"], window=int(entry["window"]),
        steps=int(entry["steps"]), weight=float(entry["weight"]),
        step_s=(t1 - t0) / TICKS_PER_S / max(int(entry["steps"]), 1),
        start_tick=int(t0), end_tick=int(t1))


def _fanout_worker(conn) -> None:
    """Worker entry point (module-level: spawn-safe, like the parallel
    engine's ``_worker_main``; init payloads are plain data)."""
    try:
        init = conn.recv()
        out = []
        for eid in init["ids"]:
            lib = CheckpointLibrary(init["root"])
            rt = _measure_region(lib.load(eid), lib.get(eid),
                                 init["step_ops"], init["machine"],
                                 init["timing"])
            out.append(rt.__dict__)
        conn.send({"regions": out})
    except BaseException:
        try:
            conn.send({"error": traceback.format_exc()})
        except Exception:
            pass
    finally:
        try:
            conn.close()
        except Exception:
            pass


def restore_fanout(lib: CheckpointLibrary, *,
                   board: Optional[Board] = None,
                   timing: Optional[str] = "detailed",
                   workers: int = 1,
                   mp_context: Optional[str] = None
                   ) -> List[RegionTime]:
    """Restore every region of the library and time its window —
    in parallel across ``workers`` processes (regions are independent,
    so this is embarrassingly parallel, unlike the quantum-synced
    ParallelEngine).

    ``timing``: fidelity to re-time the windows under (default
    detailed — the SimPoint measurement pass; ``None`` keeps each
    checkpoint's own model).  ``board``: restore onto a
    re-parameterized board instead of the captured machine (pod count
    must match — the gem5 checkpoint-once/sweep-everything move).
    Returns :class:`RegionTime` rows sorted by window index.
    """
    workers = ser.validate_workers(workers)
    entries = sorted(lib.entries, key=lambda e: int(e["window"]))
    if not entries:
        return []
    machine_dict = None
    if board is not None:
        board.instantiate()
        machine_dict = board.machine.serialize()
    step_ops = int(lib.meta["step_ops"])

    if workers <= 1 or len(entries) == 1:
        return [_measure_region(lib.load(e["id"]), e, step_ops,
                                machine_dict, timing)
                for e in entries]

    ctx = mp.get_context(mp_context or default_mp_context())
    shards: List[List[str]] = [[] for _ in range(min(workers,
                                                    len(entries)))]
    for i, e in enumerate(entries):
        shards[i % len(shards)].append(e["id"])
    conns, procs = [], []
    for ids in shards:
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_fanout_worker, args=(child,),
                           daemon=True)
        proc.start()
        child.close()
        parent.send({"root": lib.root, "ids": ids,
                     "step_ops": step_ops, "machine": machine_dict,
                     "timing": timing})
        conns.append(parent)
        procs.append(proc)
    rows: List[RegionTime] = []
    errors: List[str] = []
    for parent in conns:
        try:
            reply = parent.recv()
        except EOFError:
            errors.append("fanout worker died without a reply")
            continue
        if "error" in reply:
            errors.append(reply["error"])
        else:
            rows.extend(RegionTime(**r) for r in reply["regions"])
        parent.close()
    for proc in procs:
        proc.join()
    if errors:
        raise RuntimeError("restore_fanout worker failed:\n"
                           + "\n".join(errors))
    return sorted(rows, key=lambda r: r.window)


def reconstruct(regions: Sequence[RegionTime],
                num_steps: Optional[int] = None,
                lib: Optional[CheckpointLibrary] = None) -> float:
    """SimPoint weighted total: ``num_steps * Σ w_i * step_time_i``."""
    if num_steps is None:
        if lib is None:
            raise ValueError("pass num_steps or the library")
        num_steps = int(lib.meta["num_steps"])
    return num_steps * sum(r.weight * r.step_s for r in regions)
