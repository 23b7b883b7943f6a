"""Plain PyTorch oracle for the flash-attention kernel.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: causal
(optionally sliding-window) multi-head attention with an f32 softmax,
masks by index.  ``prefix`` keys are visible to every query row: the
mask of an M-RoPE sequence, whose ``prefix`` vision tokens all sit at
temporal position 0 (``repro_torch.models.transformer.make_positions``).
Query row i is row ``q_offset + i`` of the sequence the keys cover (a
rank's slice of a context-parallel prefill).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e9


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  prefix: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q/k/v: (b, s, h, d) -> (b, s, h, d)."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    if causal:
        qi = q_offset + torch.arange(s, device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = ki <= qi
        if window:
            mask &= ki > qi - window
        if prefix:
            mask |= ki < prefix
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
