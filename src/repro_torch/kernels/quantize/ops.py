"""Public wrapper of the int8 block-quantize kernel.

``quantize(x, block=256)`` mirrors ``repro.kernels.quantize.ops.quantize``:
x of any shape is cast to f32, flattened, padded with zeros to a multiple
of ``block`` and quantized row by row, giving ``(q (nb, block) int8,
scales (nb,) f32, pad)``.  ``quantize_blocks`` takes the rows as they
are.  On a CUDA tensor they launch the hand-written kernel
(``csrc/quantize.cu``) or raise; they take the plain version only for
tensors on the CPU.  ``quantize.launches`` counts kernel launches.

The launch is the custom op ``repro_torch::quantize_blocks`` (``OP``):
its CUDA implementation holds the alignment check, the launch and the
count; its fake implementation gives the outputs' shapes, dtypes and
strides, so a dry run on fake tensors sees one op, costed by ``cost``,
and launches nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import register_op
from repro_torch.kernels.quantize import kernel
from repro_torch.kernels.quantize.ref import quantize_plain

BLOCKS = (128, 256)
# operations per value: |x|, max, x / scale, round, and the two sides of
# the clip
OPS_PER_VALUE = 6


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
    if x.shape[1] not in BLOCKS:
        raise ValueError(f"block {x.shape[1]} not built; one of {BLOCKS}")
    return OP(x)


def _quantize_cuda(x):
    """The counted launch on checked CUDA rows."""
    nb, block = x.shape
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


def _quantize_blocks_fake(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty(x.shape[:1]))


def cost(shape, dtype: torch.dtype = torch.float32):
    """(operations, bytes) of one call on rows ``(nb, block)``:
    ``OPS_PER_VALUE`` operations a value; the f32 rows read once, q and
    the f32 scales written once."""
    nb, block = shape
    n = nb * block
    return (float(OPS_PER_VALUE * n),
            float(n * dtype.itemsize + n + nb * torch.float32.itemsize))


OP = register_op("quantize_blocks",
                 "(Tensor x) -> (Tensor, Tensor)",
                 _quantize_cuda, _quantize_blocks_fake,
                 lambda x: cost(x.shape, x.dtype))


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
