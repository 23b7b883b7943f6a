"""A copy of ``repro.sim.parallel`` (pure Python): the port imports nothing
of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

User-facing helpers for multiprocess (dist-gem5-style) simulation.

The engine itself lives in :mod:`repro.core.desim.parallel`; the normal
entry points are the ``workers=N`` knobs on :class:`repro.sim.Simulator`
and :meth:`repro.sim.boards.Board.executor`.  This module adds the
one-shot convenience wrapper and the stats-combination helper sweep
drivers use when they shard *independent* runs across processes
themselves.

Exactness contract (test-enforced in ``tests/test_parallel_engine.py``
and documented in ``docs/parallel.md``): a parallel run's final tick,
full stats tree, checkpoints and decision logs are bit-identical to the
serial engine's, and a checkpoint taken under any worker count restores
under any other.
"""

from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.core.desim.executor import ExecResult
from repro_torch.core.desim.parallel import ParallelEngine
from repro_torch.core.desim.trace import HloTrace
from repro_torch.core.stats import StatGroup
from repro_torch.sim.boards import Board

__all__ = ["ParallelEngine", "run_parallel", "merge_stat_trees",
           "parallel_supported"]


def run_parallel(board: Board, trace: HloTrace, workers: int = 2,
                 mp_context: Optional[str] = None, **kw) -> ExecResult:
    """One-shot parallel trace replay on a board: shard the board's
    pods across ``workers`` processes, run to completion, return the
    :class:`ExecResult` (bit-identical to ``board.executor().
    execute(trace)``)."""
    ex = board.executor(workers=workers, mp_context=mp_context, **kw)
    try:
        return ex.execute(trace)
    finally:
        close = getattr(ex, "close", None)
        if close is not None:
            close()


def parallel_supported(board: Board, trace: HloTrace,
                       timing: Optional[str] = None) -> bool:
    """True when a run of ``trace`` on ``board`` would actually shard
    across workers (rather than taking the exact-by-construction serial
    fallback — see the rules in ``repro.core.desim.parallel``)."""
    eng = ParallelEngine(board.machine, workers=2,
                         algorithm=board.algorithm,
                         straggler_slowdowns=board.straggler_slowdowns,
                         timing=timing or board.timing)
    return eng._parallel_plan(trace, None) is not None


def merge_stat_trees(trees: Iterable[StatGroup]) -> StatGroup:
    """Fold several runs' stats trees into one combined tree via
    :meth:`StatGroup.merge` — the sweep-sharding helper: when a driver
    farms *independent* simulations out to processes, this merges their
    gem5-style stats databases as if one run had accumulated all
    samples.  Merges into (and returns) the **first** tree; pass a
    throwaway ordering if the originals must stay pristine."""
    it = iter(trees)
    try:
        acc = next(it)
    except StopIteration:
        raise ValueError("merge_stat_trees() needs at least one tree")
    for t in it:
        acc.merge(t)
    return acc
