"""RWKV-6 (Finch) blocks of the port: attention-free, with data-dependent
decay [arXiv:2404.05892].

Mirrors ``repro.models.rwkv``.  The time mix runs the WKV6 linear
recurrence per head of n channels:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t         (S: (n, n) per head)
    y_t = r_t S_{t-1} + (r_t . u . k_t) v_t      (u: per-head bonus)

``wkv6_chunked`` is the JAX function's chunked scan on the CPU and in
train mode (plain PyTorch under autograd: the kernel is forward-only, in
both packages); outside train mode, on any other device, it launches the
hand-written WKV6 kernel (``kernels/rwkv6_wkv``), which raises for a
device it has no kernel for.  Decode takes the one-token recurrence
``wkv6_step``, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels.rwkv6_wkv.ops import wkv6_state
from repro_torch.models.common import IDENTITY_SHARDER, Sharder, param
from repro_torch.models.layers import _silu

LORA_R = 32       # low-rank size of the data-dependent mix/decay MLPs
MIX_KINDS = 5     # r, k, v, g, w


@register_sharding(torch.ops.aten.flip.default)
def _flip_sharding(x, dims):
    """One mesh dim's layouts of ``flip(x, dims)``, which the backward of
    the chunked scan's ``cumsum`` dispatches (torch 2.11's DTensor has
    none): all replicated, or split along a dim it does not flip (each
    shard flips alone)."""
    flipped = {d % x.ndim for d in dims}
    out = [([Replicate()], [Replicate(), None])]
    for d in range(x.ndim):
        if d not in flipped:
            out.append(([Shard(d)], [Shard(d), None]))
    return out


def init_rwkv_block(gen: Optional[torch.Generator], cfg) -> Dict:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    tm = {
        "mu_x": param(gen, (d,), (None,), init="zeros"),
        "mu": param(gen, (MIX_KINDS, d), (None, None), init="zeros"),
        "lora_a": param(gen, (d, MIX_KINDS, LORA_R), ("embed", None, None),
                        scale=0.02),
        "lora_b": param(gen, (MIX_KINDS, LORA_R, d), (None, None, None),
                        scale=0.02),
        "wr": param(gen, (d, h, hs), ("embed", "heads", None)),
        "wk": param(gen, (d, h, hs), ("embed", "heads", None)),
        "wv": param(gen, (d, h, hs), ("embed", "heads", None)),
        "wg": param(gen, (d, h, hs), ("embed", "heads", None)),
        "wo": param(gen, (h, hs, d), ("heads", None, "embed")),
        "w0": param(gen, (h, hs), ("heads", None), init="zeros"),
        "w_lora_a": param(gen, (d, LORA_R), ("embed", None), scale=0.02),
        "w_lora_b": param(gen, (LORA_R, h, hs), (None, "heads", None),
                          scale=0.02),
        "u": param(gen, (h, hs), ("heads", None), init="zeros"),
        "ln_x_scale": param(gen, (h, hs), ("heads", None), init="ones"),
        "ln_x_bias": param(gen, (h, hs), ("heads", None), init="zeros"),
    }
    cm = {
        "mu_k": param(gen, (d,), (None,), init="zeros"),
        "mu_r": param(gen, (d,), (None,), init="zeros"),
        "wk": param(gen, (d, cfg.d_ff), ("embed", "mlp")),
        "wv": param(gen, (cfg.d_ff, d), ("mlp", "embed")),
        "wr": param(gen, (d, d), ("embed", None)),
    }
    return {"time_mix": tm, "channel_mix": cm}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """xx_t = x_{t-1}; prev: (b, 1, d) carried state (zeros at start), in
    the cache's dtype (promoted to x's, as JAX's concatenate does)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as 1 / (1 + exp(-x)), op by op (see layers._silu)."""
    return 1.0 / (1.0 + torch.exp(-x))


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------

def wkv6_chunked_plain(r, k, v, lw, u, state0, chunk: int):
    """The JAX function's chunked scan: within a chunk, pairwise decays
    are exponentials of cumulative-log-decay differences, all <= 0."""
    b, s, h, n = r.shape
    if s % chunk:
        chunk = s
    nc, L = s // chunk, chunk
    f32 = torch.float32

    def to_chunks(x):
        return x.reshape(b, nc, L, h, n).transpose(0, 1)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    S = (torch.zeros((b, h, n, n), dtype=f32, device=r.device)
         if state0 is None else state0.float())
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    uf = u.float()
    ys = []
    for ci in range(nc):
        rr, kk, vv, ww = (x[ci].float() for x in (rc, kc, vc, lwc))
        cum = torch.cumsum(ww, dim=1)                     # (b,L,h,n), <= 0
        cum_prev = cum - ww                               # cum_{t-1}
        dmat = cum_prev[:, :, None] - cum[:, None]        # (b,L,L,h,n)
        dmat = torch.where(causal[None, :, :, None, None], dmat,
                           float("-inf"))
        scores = torch.einsum("blhn,bmhn,blmhn->bhlm", rr, kk,
                              torch.exp(dmat))
        intra = torch.einsum("bhlm,bmhn->blhn", scores, vv)
        diag = torch.einsum("blhn,hn,blhn->blh", rr, uf, kk)
        intra = intra + diag[..., None] * vv
        # inter-chunk: r_t * a_{t-1} applied to the carried state
        inter = torch.einsum("blhn,bhnm->blhm", rr * torch.exp(cum_prev), S)
        ys.append(inter + intra)
        # S' = diag(a_L) S + sum_m (a_L / a_m) k_m (x) v_m
        a_L = torch.exp(cum[:, -1])                       # (b,h,n)
        k_tail = kk * torch.exp(cum[:, -1:] - cum)
        S = a_L[..., None] * S + torch.einsum("bmhn,bmhv->bhnv", k_tail, vv)
    y = torch.stack(ys, dim=1).reshape(b, s, h, n)
    return y.to(r.dtype), S


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor,
                 state0: Optional[torch.Tensor] = None, chunk: int = 32,
                 mode: str = "prefill"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 scan.  r/k/v/lw: (b, s, h, n) with lw = log(decay)
    <= 0 (f32); u: (h, n).  Returns (y (b, s, h, n), state (b, h, n, n)
    f32).

    ``mode="train"`` and the CPU take the plain scan (chunks of ``chunk``,
    one chunk of length s when ``chunk`` does not divide s, as in JAX);
    otherwise the kernel, ``chunk`` tokens staged at a time."""
    if mode == "train" or r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, lw, u, state0, chunk)
    return wkv6_state(r, k, v, lw, u, state0, chunk=chunk)


def wkv6_step(r, k, v, lw, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  r/k/v/lw: (b, 1, h, n); state (b, h, n, n)."""
    rr, kk, vv, ww = (x[:, 0].float() for x in (r, k, v, lw))
    y = (torch.einsum("bhn,bhnm->bhm", rr, state)
         + torch.einsum("bhn,hn,bhn->bh", rr, u.float(), kk)[..., None] * vv)
    state = torch.exp(ww)[..., None] * state + torch.einsum(
        "bhn,bhv->bhnv", kk, vv)
    return y[:, None].to(r.dtype), state


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _ddlerp(tm: Dict, x: torch.Tensor, xx: torch.Tensor):
    """RWKV6 data-dependent token-shift mixes for r, k, v, g, w."""
    base = x + (xx - x) * tm["mu_x"]
    lo = torch.tanh(torch.einsum("bsd,dkr->bskr", base, tm["lora_a"]))
    delta = torch.einsum("bskr,krd->bskd", lo, tm["lora_b"])
    mixes = tm["mu"][None, None] + delta                   # (b,s,5,d)
    return [x + (xx - x) * mixes[:, :, i] for i in range(MIX_KINDS)]


def _head_groupnorm(tm: Dict, y: torch.Tensor, eps: float = 64e-5
                    ) -> torch.Tensor:
    f = y.float()
    mean = torch.mean(f, dim=-1, keepdim=True)
    var = torch.var(f, dim=-1, keepdim=True, unbiased=False)
    f = (f - mean) * torch.rsqrt(var + eps)
    return (f * tm["ln_x_scale"] + tm["ln_x_bias"]).to(y.dtype)


def apply_time_mix(tm: Dict, x: torch.Tensor, cfg,
                   shift_state: Optional[torch.Tensor] = None,
                   wkv_state: Optional[torch.Tensor] = None,
                   chunk: int = 32, mode: str = "prefill",
                   sharder: Sharder = IDENTITY_SHARDER
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_shift_state, new_wkv_state); r, k and v are
    laid out by heads before the recurrence, as in JAX."""
    xx = _token_shift(x, shift_state)
    xr, xk, xv, xg, xw = _ddlerp(tm, x, xx)
    r = torch.einsum("bsd,dhn->bshn", xr, tm["wr"])
    k = torch.einsum("bsd,dhn->bshn", xk, tm["wk"])
    v = torch.einsum("bsd,dhn->bshn", xv, tm["wv"])
    g = _silu(torch.einsum("bsd,dhn->bshn", xg, tm["wg"]))
    wdel = torch.einsum("bsd,dr->bsr", xw, tm["w_lora_a"])
    wdel = torch.einsum("bsr,rhn->bshn", torch.tanh(wdel), tm["w_lora_b"])
    lw = -torch.exp(tm["w0"][None, None].float() + wdel.float())  # < 0
    r = sharder.ac(r, ("batch", None, "heads", None))
    k = sharder.ac(k, ("batch", None, "heads", None))
    v = sharder.ac(v, ("batch", None, "heads", None))
    if x.shape[1] == 1 and wkv_state is not None:
        y, new_state = wkv6_step(r, k, v, lw, tm["u"], wkv_state)
    else:
        y, new_state = wkv6_chunked(r, k, v, lw, tm["u"], wkv_state,
                                    chunk=chunk, mode=mode)
    y = _head_groupnorm(tm, y) * g
    out = torch.einsum("bshn,hnd->bsd", y, tm["wo"])
    return out, x[:, -1:], new_state


def apply_channel_mix(cm: Dict, x: torch.Tensor, cfg,
                      shift_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    xx = _token_shift(x, shift_state)
    xk = x + (xx - x) * cm["mu_k"]
    xr = x + (xx - x) * cm["mu_r"]
    k = torch.square(F.relu(torch.einsum("bsd,df->bsf", xk, cm["wk"])))
    kv = torch.einsum("bsf,fd->bsd", k, cm["wv"])
    r = _sigmoid(torch.einsum("bsd,de->bse", xr, cm["wr"]))
    return r * kv, x[:, -1:]
