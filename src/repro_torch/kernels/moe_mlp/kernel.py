"""The CUDA expert-MLP kernel (``csrc/moe_mlp.cu``), built at first use
by ``repro_torch.kernels.build`` and bound with ctypes."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_mlp.cu"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The bound library, built first if needed (once per process)."""
    lib = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_mlp_fwd.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.moe_mlp_fwd.restype = i32
    lib.moe_mlp_smem_bytes.argtypes = [i32] * 3
    lib.moe_mlp_smem_bytes.restype = ctypes.c_longlong
    return lib
