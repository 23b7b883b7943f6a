"""Plain PyTorch version of the int8 block-quantize kernel.

Mirrors ``repro.kernels.quantize.ref.quantize_ref`` (the math of
``repro.optim.compress``): per row, ``scale = max(absmax / 127, 1e-12)``
and ``q = clip(round(x / scale), -127, 127)``, rounding half to even.
It is the CPU path of ``ops.quantize`` and the oracle the kernel is held
to, bit for bit, on the card.

Both quotients are tensor-by-tensor divisions, so they are IEEE
quotients on every device: PyTorch divides a CUDA tensor by a Python
number as a product with its reciprocal, which can differ by one ulp.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (nb, block) f32 -> (q int8 (nb, block), scales f32 (nb,))."""
    absmax = x.abs().amax(dim=1)
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale
