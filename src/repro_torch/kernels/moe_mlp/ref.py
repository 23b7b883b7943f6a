"""Plain PyTorch version of the fused expert-MLP kernel.

Mirrors ``repro.kernels.moe_mlp.ref.expert_mlp_ref``: the per-expert
SwiGLU FFN over capacity blocks (the expert compute of
``repro.models.moe``), here in f32 whatever the input dtype, as the TPU
kernel computes it, with the output in x's dtype.  It is the CPU path of
``ops.expert_mlp`` and the oracle the kernel is held to on the card.
"""

from __future__ import annotations

import torch


def expert_mlp_plain(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                     wo: torch.Tensor) -> torch.Tensor:
    """x: (G, E, C, D); wi/wg: (E, D, F); wo: (E, F, D) -> (G, E, C, D)."""
    xf = x.float()
    h = torch.einsum("gecd,edf->gecf", xf, wi.float())
    u = torch.einsum("gecd,edf->gecf", xf, wg.float())
    h = h * torch.sigmoid(h) * u
    return torch.einsum("gecf,efd->gecd", h, wo.float()).to(x.dtype)
