"""The CUDA WKV6 kernel (``csrc/wkv6.cu``), built at first use by
``repro_torch.kernels.build`` and bound with ctypes."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The bound library, built first if needed (once per process)."""
    lib = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_fwd.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.wkv6_fwd.restype = i32
    return lib
