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

On a mesh, a DTensor gradient whose blocks each lie inside one rank's
shard (``blocks_stay_local``) is compressed on the local shards, with no
collective; other DTensor leaves are replicated first, as
``int8_block_quantize`` does for any DTensor.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor

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


def blocks_stay_local(shape, placements, block: int = 256) -> bool:
    """Whether every block of a tensor of global ``shape`` laid out by
    ``placements``, flattened in its global order, lies inside one
    rank's shard as a run of that shard flattened: true when the global
    dims after the innermost split dim k multiply to a multiple of
    ``block`` (a block then never crosses an index of dims 0..k, which
    decide the rank, and the shard's runs of those dims are whole
    blocks, in order), or when no dim is split (the shard is the
    tensor).  The local shard then quantizes to the same blocks, bit for
    bit."""
    if any(p.is_partial() for p in placements):
        return False
    split = [p.dim for p in placements if p.is_shard()]
    return not split or math.prod(shape[max(split) + 1:]) % block == 0


def compress_gradients(grads: Any, error: Any, block: int = 256
                       ) -> Tuple[Any, Any]:
    """Quantize (grads + error) leafwise; return (deq grads, new error).

    A DTensor leaf (with its error buffer in the same placements) for
    which ``blocks_stay_local`` holds is quantized and dequantized on each
    rank's local shards, and both results are returned in its
    placements: nothing is gathered, and the values are those of the
    replicated path bit for bit (the same blocks, the same elementwise
    ops).  Any other DTensor leaf is replicated, as ``quantize`` does."""
    def one(g, e):
        if (isinstance(g, DTensor) and isinstance(e, DTensor)
                and tuple(e.placements) == tuple(g.placements)
                and blocks_stay_local(g.shape, g.placements, block)):
            deq, err = one(g.to_local(), e.to_local())
            return tuple(DTensor.from_local(t, g.device_mesh, g.placements,
                                            run_check=False, shape=g.shape,
                                            stride=g.stride())
                         for t in (deq, err))
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
