"""A copy of ``repro.core.trace`` (pure Python): the port imports nothing
of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

gem5-style DebugFlags + DPRINTF event tracing (paper §2.20).

gem5's first debugging tool is its tracing facility: every model is
sprinkled with ``DPRINTF(Flag, "...", ...)`` statements that compile to
nothing unless the flag is enabled (``--debug-flags=Exec,DRAM``), and
enabled flags stream one formatted line per event — tick, object path,
message — to the trace output.  This module reproduces that for the
desim stack:

* a registry of **hierarchical flags** (``Wire`` enables
  ``Wire.Contention``; ``All`` enables everything),
* :func:`dprintf` — the DPRINTF analogue.  Disabled tracing costs one
  module-attribute read and a branch: the format string is *never*
  rendered and the message never built unless the flag is on.  The
  hottest call sites additionally guard on :data:`_ACTIVE` so a fully
  disabled run does not even pay the call.
* selection via API (:func:`enable` / :func:`disable` /
  :func:`flag_context`), environment (``G5X_DEBUG_FLAGS=Dcn,Exec``,
  ``G5X_DEBUG_FILE=trace.out``), or CLI (e.g. ``examples/quickstart.py
  --debug-flags``).

House rule (test-enforced in ``tests/test_observability.py``): tracing
only *reads* simulation state — a run with every flag enabled is
bit-identical to a silent one.  Output goes to stdout by default (like
gem5's ``simout``), so nothing ever reaches stdout unless a flag was
explicitly enabled.

The flag catalog lives here (not per-module) so ``flags()`` can print
it for CLI help; modules may :func:`register_flag` more.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Set, TextIO, Union

# ---------------------------------------------------------------------------
# flag registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, str] = {}

#: names enabled right now (exact names as passed to ``enable``)
_ENABLED: Set[str] = set()
#: per-flag resolution cache (flag -> effective on/off), cleared on change
_CACHE: Dict[str, bool] = {}

#: fast kill-switch read by every call site: False unless at least one
#: flag is enabled (or counting mode is measuring the disabled path)
_ACTIVE: bool = False

#: counting mode (benchmarks/observability.py): dprintf calls whose flag
#: is disabled increment ``_SUPPRESSED`` instead of vanishing, which is
#: how the <5%-overhead CI assertion knows how many guarded call sites a
#: reference lap actually reaches
_COUNTING: bool = False
_SUPPRESSED: int = 0

_SINK: Optional[TextIO] = None   # None -> sys.stdout at write time


def register_flag(name: str, desc: str = "") -> str:
    """Add a flag to the catalog (idempotent; later desc wins if
    non-empty).  Dotted names are hierarchical: enabling ``Wire`` also
    enables ``Wire.Contention``."""
    if not name or any(not part for part in name.split(".")):
        raise ValueError(f"bad debug flag name {name!r}")
    if desc or name not in _REGISTRY:
        _REGISTRY[name] = desc
    return name


# the standard catalog (gem5: Exec, Cache, DRAM, ...; ours mirrors the
# desim SimObject layers)
register_flag("Exec", "op issue / completion on each pod (executor)")
register_flag("Chip", "compute-resource arbitration (ChipSim.acquire)")
register_flag("Wire", "intra-pod collectives on the ICI torus (WireSim)")
register_flag("Wire.Contention", "only collectives that waited on a "
                                 "contended link")
register_flag("Dcn", "cross-pod rendezvous and fabric transactions "
                     "(DcnSim / AtomicTiming)")
register_flag("Quantum", "dist-gem5 quantum barriers and cross-queue "
                         "deliveries (QuantumSync)")
register_flag("Ckpt", "drain / snapshot / restore lifecycle")
register_flag("Sim", "Simulator exit events and stat dumps")
register_flag("Parallel", "multiprocess engine: worker spawn, barriers, "
                          "collect")


def flags() -> Dict[str, str]:
    """The flag catalog: name -> description."""
    return dict(_REGISTRY)


def enabled_flags() -> List[str]:
    """Exact names currently enabled (sorted; ship to worker procs)."""
    return sorted(_ENABLED)


def _refresh() -> None:
    global _ACTIVE
    _CACHE.clear()
    _ACTIVE = bool(_ENABLED) or _COUNTING


def _parse(spec: Union[str, Iterable[str]]) -> List[str]:
    if isinstance(spec, str):
        return [s.strip() for s in spec.split(",") if s.strip()]
    return [str(s) for s in spec]


def enable(spec: Union[str, Iterable[str]]) -> None:
    """Enable flags: ``enable("Dcn,Exec")`` or ``enable(["Wire"])``.
    ``"All"`` enables everything.  Unknown names raise with the
    catalog (gem5 errors the same way)."""
    for name in _parse(spec):
        if name != "All" and name not in _REGISTRY:
            raise ValueError(
                f"unknown debug flag {name!r}; known flags: "
                f"{', '.join(sorted(_REGISTRY))} (or All)")
        _ENABLED.add(name)
    _refresh()


def disable(spec: Union[None, str, Iterable[str]] = None) -> None:
    """Disable the given flags, or every flag when called bare."""
    if spec is None:
        _ENABLED.clear()
    else:
        for name in _parse(spec):
            _ENABLED.discard(name)
    _refresh()


def enabled(flag: str) -> bool:
    """Effective state of ``flag``: on when the flag itself, any dotted
    prefix of it, or ``All`` is enabled."""
    hit = _CACHE.get(flag)
    if hit is None:
        hit = False
        if _ENABLED:
            if "All" in _ENABLED or flag in _ENABLED:
                hit = True
            else:
                parts = flag.split(".")
                for i in range(1, len(parts)):
                    if ".".join(parts[:i]) in _ENABLED:
                        hit = True
                        break
        _CACHE[flag] = hit
    return hit


@contextmanager
def flag_context(spec: Union[str, Iterable[str]]):
    """Temporarily enable flags (tests / scoped debugging)."""
    before = set(_ENABLED)
    enable(spec)
    try:
        yield
    finally:
        _ENABLED.clear()
        _ENABLED.update(before)
        _refresh()


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

def set_output(dst: Union[None, str, TextIO]) -> None:
    """Route trace lines to a file path or open stream (None -> stdout,
    the gem5 ``simout`` default)."""
    global _SINK
    if isinstance(dst, str):
        _SINK = open(dst, "a")
    else:
        _SINK = dst


def _name_of(obj) -> str:
    if obj is None:
        return "-"
    if isinstance(obj, str):
        return obj
    path = getattr(obj, "path", None)
    if isinstance(path, str):
        return path
    name = getattr(obj, "name", None)
    if isinstance(name, str):
        return name
    return type(obj).__name__


def dprintf(flag: str, obj, fmt: str, *args, tick: Optional[int] = None
            ) -> None:
    """gem5 ``DPRINTF``: when ``flag`` is enabled, write one trace line
    ``<tick>: <obj>: <message>``.  Formatting (``fmt % args``) is
    deferred until after the flag check, so a disabled call never
    renders anything — it must also never *evaluate* anything: pass
    raw values via ``args``, not pre-built f-strings."""
    if not _ACTIVE:
        return
    if not enabled(flag):
        if _COUNTING:
            global _SUPPRESSED
            _SUPPRESSED += 1
        return
    msg = (fmt % args) if args else fmt
    t = "-" if tick is None else str(int(tick))
    sink = _SINK if _SINK is not None else sys.stdout
    sink.write(f"{t:>10}: {_name_of(obj)}: {msg}\n")


# ---------------------------------------------------------------------------
# disabled-path accounting (the ci.sh trace tier's overhead model)
# ---------------------------------------------------------------------------

@contextmanager
def counting():
    """Count suppressed dprintf calls without emitting anything: the
    overhead benchmark multiplies the count by the measured disabled-
    call cost to bound what tracing adds to a flags-off run."""
    global _COUNTING, _SUPPRESSED
    _COUNTING, _SUPPRESSED = True, 0
    _refresh()
    try:
        yield
    finally:
        _COUNTING = False
        _refresh()


def suppressed_calls() -> int:
    return _SUPPRESSED


# ---------------------------------------------------------------------------
# environment selection
# ---------------------------------------------------------------------------

ENV_FLAGS = "G5X_DEBUG_FLAGS"
ENV_FILE = "G5X_DEBUG_FILE"


def init_from_env(environ=None) -> List[str]:
    """Apply ``G5X_DEBUG_FLAGS`` / ``G5X_DEBUG_FILE`` (called once at
    import; call again after mutating os.environ in tests).  Returns
    the flags enabled.  Unknown env flags raise — a typo'd flag that
    silently traces nothing is worse than a crash at startup."""
    env = os.environ if environ is None else environ
    spec = env.get(ENV_FLAGS, "")
    path = env.get(ENV_FILE, "")
    if path:
        set_output(path)
    if spec:
        enable(spec)
    return _parse(spec)


init_from_env()
