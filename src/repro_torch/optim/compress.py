"""Int8 gradient compression with error feedback, as
``repro.optim.compress``.

Gradients are block-quantized to int8 with a per-block f32 scale; the
quantization error is carried in an error buffer and added to the next
step's gradients, so the accumulated update is unbiased.  Each leaf is
quantized on its own, with its own padding, so no block crosses leaves.

``int8_block_quantize`` goes through ``kernels.quantize.ops.quantize``:
on a CUDA tensor it launches the hand-written kernel or raises; only a
CPU tensor takes the plain version.  Dequantization and the new error
are plain elementwise PyTorch (the TPU kernel computes only q and the
scales).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels.quantize.ops import quantize
from repro_torch.models.common import leaves, map_leaves, unflatten


def int8_block_quantize(x: torch.Tensor, block: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape) -> (q int8 (nblocks, block), scales (nblocks,), pad)."""
    return quantize(x, block=block)


def int8_block_dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int,
                          shape, dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def compress_gradients(grads: Any, error: Any, block: int = 256
                       ) -> Tuple[Any, Any]:
    """Quantize (grads + error) leafwise; return (deq grads, new error)."""
    def one(g, e):
        corrected = g.float() + e
        q, s, pad = int8_block_quantize(corrected, block)
        deq = int8_block_dequantize(q, s, pad, g.shape)
        return deq.to(g.dtype), corrected - deq

    pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [d for d, _ in pairs]),
            unflatten(grads, [e for _, e in pairs]))


def init_error_buffer(params: Any) -> Any:
    return map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
