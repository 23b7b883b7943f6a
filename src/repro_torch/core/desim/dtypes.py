"""A copy of ``repro.core.desim.dtypes`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

The one HLO dtype-width table (shared by trace.py and hlo_cost.py).

Both HLO parsers — the elastic-trace extractor (``trace.py``) and the
loop-aware cost model (``hlo_cost.py``) — size tensors from the textual
HLO type syntax (``bf16[256,4096]{1,0}``, ``f32[]``, tuples).  They must
agree byte-for-byte or the roofline and the DES would drift apart, so
the dtype table and the shape lexer live here exactly once.

Widths are *bytes per element* and may be fractional: ``s4``/``u4`` are
half a byte (two elements per byte, how XLA packs int4), and zero-width
types (``token``, ``opaque``) carry no payload.  Unknown dtypes are
skipped by the helpers (conservative: contribute 0 bytes) — the same
behaviour both parsers always had.
"""

from __future__ import annotations

import re
from typing import Iterator, Tuple

DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5,
    "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

# one tensor type, e.g. ``bf16[256,4096]{1,0}`` or ``f32[]``; matches
# every element of a tuple type ``(f32[2,3], s4[8])`` one by one
SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def iter_shapes(type_str: str) -> Iterator[Tuple[float, float]]:
    """Yield ``(elements, bytes)`` per tensor in an HLO type string.

    Tensors of unknown dtype are skipped entirely (not yielded), so both
    element and byte totals stay consistent between callers that sum
    elements and callers that sum bytes.
    """
    for m in SHAPE_RE.finditer(type_str):
        dtype, dims = m.groups()
        per = DTYPE_BYTES.get(dtype)
        if per is None:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        yield float(n), n * per


def shape_bytes(type_str: str) -> float:
    """Total bytes over all tensors in an HLO type string."""
    return sum(b for _, b in iter_shapes(type_str))


def shape_elems_bytes(type_str: str) -> Tuple[float, float]:
    """(elements, bytes) totals over all tensors in an HLO type string."""
    elems = 0.0
    nbytes = 0.0
    for e, b in iter_shapes(type_str):
        elems += e
        nbytes += b
    return elems, nbytes
