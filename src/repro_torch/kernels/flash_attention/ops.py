"""Public wrapper of the flash-attention kernel, in model layout.

``flash_attention(q, k, v)`` takes q ``(b, s, h, d)`` and k/v
``(b, s_kv, kvh, d)`` with ``kvh`` dividing ``h``.  On a CUDA tensor it
launches the hand-written kernel (``csrc/flash_attention.cu``) or
raises; it takes the plain version only for tensors on the CPU.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: kv heads repeated, f32
    arithmetic, output in the input dtype."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                        window=window)
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (b,s,h,d), k/v (b,s,kvh,d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: kv heads must divide {h}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"want float32 or bfloat16 for all of q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention -> (b, s, h, d)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; one of {HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"b * h = {b * h} exceeds the grid ({_MAX_GRID_Y})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    lib = kernel.load()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[q.dtype], b, s, k.shape[1], h, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window), 1.0 / math.sqrt(d), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
