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
    lib.moe_mlp_f32_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.moe_mlp_f32_fwd.restype = i32
    lib.moe_mlp_f32_smem_bytes.argtypes = [i32]
    lib.moe_mlp_f32_smem_bytes.restype = ctypes.c_longlong
    lib.moe_mlp_bf16_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.moe_mlp_bf16_fwd.restype = i32
    return lib
