"""Public wrapper of the int8 block-quantize kernel.

``quantize(x, block=256)`` mirrors ``repro.kernels.quantize.ops.quantize``:
x of any shape is cast to f32, flattened, padded with zeros to a multiple
of ``block`` and quantized row by row, giving ``(q (nb, block) int8,
scales (nb,) f32, pad)``.  ``quantize_blocks`` takes the rows as they
are.  On a CUDA tensor they launch the hand-written kernel
(``csrc/quantize.cu``) or raise; they take the plain version only for
tensors on the CPU.  ``quantize.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import kernel
from repro_torch.kernels.quantize.ref import quantize_plain

BLOCKS = (128, 256)


def quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (nb, block) f32, contiguous -> (q (nb, block) int8, scales
    (nb,) f32)."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"want x (nb, block) with nb >= 1, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"want contiguous float32 rows, got {x.dtype}, "
                        f"contiguous={x.is_contiguous()}")
    if x.device.type == "cpu":
        return quantize_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize for device {x.device}")
    nb, block = x.shape
    if block not in BLOCKS:
        raise ValueError(f"block {block} not built; one of {BLOCKS}")
    if x.data_ptr() % 16:
        raise ValueError("the kernel loads 16-byte vectors: x must start "
                         "on a 16-byte boundary")
    lib = kernel.load()
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    err = lib.quantize_fwd(x.data_ptr(), q.data_ptr(), scales.data_ptr(), nb,
                           block, x.device.index,
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    quantize.launches += 1
    return q, scales


def quantize(x: torch.Tensor, *, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x: any shape -> (q (nb, block) int8, scales (nb,) f32, pad)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    q, scales = quantize_blocks(flat.reshape(-1, block).contiguous())
    return q, scales, pad


quantize.launches = 0
