"""Mamba (S6) selective-state-space block of the port [arXiv:2312.00752],
used by the Jamba hybrid architecture [arXiv:2403.19887].

Mirrors ``repro.models.mamba``.  Per channel of d_inner and state index
of d_state the block runs the linear recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t      y_t = h_t . C_t + D x_t

with dt, B and C computed from the input.  Prefill and train run the
chunked scan ``selective_scan_chunked``; decode the one-token step.

The JAX package computes the scan outside any Pallas kernel
(``lax.associative_scan`` inside a ``lax.scan`` over chunks), so the port
computes it in plain PyTorch on every device: within a chunk, a
Hillis-Steele doubling scan (log2(chunk) rounds of elementwise ops)
computes what ``associative_scan`` computes, with its f32 sums in
another order.  The chunks are ``chunk`` tokens with a shorter last one;
JAX takes a single chunk of the whole sequence when ``chunk`` does not
divide it.  Both are the same recurrence; only the order of f32 sums
differs, and the port's (b, chunk, d_inner, d_state) decay and drive
stay at most one full chunk long at any prompt length.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (IDENTITY_SHARDER, Sharder, param,
                                       with_axes)
from repro_torch.models.layers import _silu


def dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba_block(gen: Optional[torch.Generator], cfg) -> Dict:
    """The JAX block's leaves, keys and shapes.  ``A_log`` is the
    deterministic S4D-real init log(1..d_state) on every channel."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
    r = dt_rank(cfg)
    dev = gen.device if gen is not None else torch.device("meta")
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).expand(di, n).clone()
    return {
        "in_proj": param(gen, (d, 2 * di), ("embed", "mlp")),
        "conv_w": param(gen, (cfg.d_conv, di), (None, "mlp"), scale=0.5),
        "conv_b": param(gen, (di,), ("mlp",), init="zeros"),
        "x_proj": param(gen, (di, r + 2 * n), ("mlp", None)),
        "dt_proj": param(gen, (r, di), (None, "mlp"), scale=0.1),
        "dt_bias": param(gen, (di,), ("mlp",), init="zeros"),
        "A_log": with_axes(a_log, ("mlp", None)),
        "D": param(gen, (di,), ("mlp",), init="ones"),
        "out_proj": param(gen, (di, d), ("mlp", "embed")),
    }


def _causal_conv(p: Dict, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv by shifted adds.  x: (b, s, di).

    conv_state: (b, d_conv - 1, di), the trailing inputs of the previous
    segment (zeros at the start).  Returns (y, new_conv_state); both
    promote x and the state as JAX's concatenate does."""
    taps = p["conv_w"].shape[0]
    b, s, di = x.shape
    if conv_state is None:
        conv_state = x.new_zeros((b, taps - 1, di))
    ext = torch.cat([conv_state, x], dim=1)             # (b, s+taps-1, di)
    y = torch.zeros_like(x)
    for i in range(taps):
        y = y + ext[:, i:i + s] * p["conv_w"][i]
    y = y + p["conv_b"]
    new_state = ext[:, -(taps - 1):] if taps > 1 else conv_state
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus as ``jnp.logaddexp(x, 0)`` computes it."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssm_params(p: Dict, xc: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xc: (b, s, di) post-conv.  Returns decay, drive (b, s, di, n) and
    C (b, s, n), all f32: dt = softplus in f32, decay = exp(dt A),
    drive = dt x B."""
    r, n = dt_rank(cfg), cfg.d_state
    proj = torch.einsum("bsd,dk->bsk", xc, p["x_proj"])
    dt_r, B, C = torch.split(proj, [r, n, n], dim=-1)
    dt = torch.einsum("bsr,rd->bsd", dt_r, p["dt_proj"]) + p["dt_bias"]
    dt = _softplus(dt.float())                          # (b, s, di)
    A = -torch.exp(p["A_log"].float())                  # (di, n)
    decay = torch.exp(dt[..., None] * A)                # (b, s, di, n)
    drive = (dt * xc.float())[..., None] * B[:, :, None, :].float()
    return decay, drive, C.float()


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps h -> a_t h + b_t along dim 1
    (Hillis-Steele): after the round of offset k each position holds the
    composition of the last 2k maps up to it.  Returns the cumulative
    (A_t, B_t) with h_t = A_t h_0 + B_t."""
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _scan_chunk(p: Dict, xck: torch.Tensor, h: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: its decay and drive built here (never for the whole
    sequence), scanned from the carried state h (b, di, n).  Returns
    (y (b, L, di) in xck's dtype, as the JAX chunk body emits it, h at
    the chunk's last token)."""
    decay, drive, C = _ssm_params(p, xck, cfg)
    ca, cb = _doubling_scan(decay, drive)
    h_all = ca * h[:, None] + cb
    y = torch.einsum("bsdn,bsn->bsd", h_all, C)
    return y.to(xck.dtype), h_all[:, -1]


def selective_scan_chunked(p: Dict, xc: torch.Tensor, cfg,
                           h0: Optional[torch.Tensor] = None,
                           chunk: int = 256, remat: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective scan.  xc: (b, s, di) post-conv activations.

    Returns (y (b, s, di) f32 = sum_n h C, rounded to xc's dtype per
    chunk as in JAX; h_last (b, di, n) f32).  ``remat`` checkpoints each
    chunk under autograd (``jax.checkpoint(body)``): the backward pass
    rebuilds a chunk's (b, chunk, di, n) tensors instead of keeping them
    for the whole sequence."""
    b, s, di = xc.shape
    h = (torch.zeros((b, di, cfg.d_state), dtype=torch.float32,
                     device=xc.device) if h0 is None else h0.float())
    ys = []
    for c0 in range(0, s, chunk):
        xck = xc[:, c0:c0 + chunk]
        if remat and torch.is_grad_enabled():
            y, h = checkpoint(_scan_chunk, p, xck, h, cfg,
                              use_reentrant=False)
        else:
            y, h = _scan_chunk(p, xck, h, cfg)
        ys.append(y)
    return torch.cat(ys, dim=1).float(), h


def apply_mamba(p: Dict, x: torch.Tensor, cfg,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None, chunk: int = 256,
                remat: bool = True, sharder: Sharder = IDENTITY_SHARDER
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, new_conv_state, new_ssm_state).  A one-token
    input with a carried ssm state takes the single-step recurrence;
    anything else (a one-token prefill too) the chunked scan.  The JAX
    block's constraints: xz by "mlp", and y by "seq" before the output
    projection when there is more than one token."""
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xz = sharder.ac(xz, ("batch", None, "mlp"))
    xin, z = xz.chunk(2, dim=-1)
    xc, new_conv = _causal_conv(p, xin, conv_state)
    xc = _silu(xc)

    if x.shape[1] == 1 and ssm_state is not None:
        decay, drive, C = _ssm_params(p, xc, cfg)
        h = decay[:, 0] * ssm_state + drive[:, 0]       # (b, di, n)
        new_ssm = h
        y = torch.einsum("bdn,bn->bd", h, C[:, 0])[:, None]
    else:
        y, new_ssm = selective_scan_chunked(p, xc, cfg, ssm_state, chunk,
                                            remat=remat)

    y = y + p["D"].float() * xc.float()
    y = y.to(x.dtype) * _silu(z)
    if x.shape[1] > 1:
        y = sharder.ac(y, ("batch", "seq", None))
    out = torch.einsum("bsd,de->bse", y, p["out_proj"])
    return out, new_conv, new_ssm
