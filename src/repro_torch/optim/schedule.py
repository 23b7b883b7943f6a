"""LR schedules of the port, as ``repro.optim.schedule``.  ``wsd_schedule``
is MiniCPM's warmup-stable-decay schedule [arXiv:2404.06395].

Both compute in f32 tensors, as the JAX functions do (Python-float math
in f64 would differ by an ulp), and return a 0-dim f32 tensor on the
device of ``step`` when it is a tensor, else on the CPU.  Every quotient
divides by a tensor: PyTorch divides a CUDA tensor by a Python number as
a product with its reciprocal.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    return a / torch.full_like(a, float(b))


def wsd_schedule(step, peak_lr: float, warmup: int, stable: int,
                 decay: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Warmup (linear) -> Stable (constant) -> Decay (exponential to
    min_ratio * peak over `decay` steps)."""
    s = _f32(step)
    warm = peak_lr * torch.clamp(_div(s, max(warmup, 1)), max=1.0)
    decay_start = warmup + stable
    frac = torch.clamp(_div(s - decay_start, max(decay, 1)), 0.0, 1.0)
    dec = peak_lr * torch.pow(torch.full_like(s, min_ratio), frac)
    return torch.where(s < decay_start, warm, dec)


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = peak_lr * torch.clamp(_div(s, max(warmup, 1)), max=1.0)
    frac = torch.clamp(_div(s - warmup, max(total - warmup, 1)), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(s < warmup, warm, peak_lr * cos)
