"""Layer library of the port, dense subset: norms, partial RoPE, GQA
attention (train mode in plain PyTorch under autograd, prefill through
the flash kernel on the GPU, KV-cache decode), MLPs, embeddings and the
cross-entropy loss.

Each function mirrors the one of the same name in
``repro.models.layers`` and keeps its layouts: activations
``(b, s, h, hd)``, caches ``(b, kvh, S, hd)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ROADMAP
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import param

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, cfg, d: int) -> Dict:
    p = {"scale": param(gen, (d,), init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = param(gen, (d,), init="zeros")
    return p


def apply_norm(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE, partial RoPE)
# ---------------------------------------------------------------------------

def _rot_dims(cfg) -> int:
    rot = int(cfg.head_dim * cfg.rope_pct)
    return rot - rot % 2


def _inv_freq(rot: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, rot, 2, dtype=torch.float32,
                                   device=device) / rot)


def rope_angles(cfg, positions: torch.Tensor) -> torch.Tensor:
    """positions (b, s) -> angles (b, s, rot//2)."""
    if cfg.pos_scheme == "mrope":
        raise NotImplementedError(f"M-RoPE: {ROADMAP['vlm']}")
    inv = _inv_freq(_rot_dims(cfg), cfg.rope_theta, positions.device)
    return positions.float()[..., None] * inv


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); positions: (b, s).  Rotate-half on the first
    ``_rot_dims`` dims; the rest pass through."""
    if cfg.pos_scheme in ("learned", "none"):
        return x
    rot = _rot_dims(cfg)
    if rot == 0:
        return x
    ang = rope_angles(cfg, positions)                  # (b, s, rot//2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if xp.shape[-1]:
        out = torch.cat([out, xp], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": param(gen, (d, cfg.n_heads, hd)),
        "wk": param(gen, (d, cfg.n_kv_heads, hd)),
        "wv": param(gen, (d, cfg.n_kv_heads, hd)),
        "wo": param(gen, (cfg.n_heads, hd, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = param(gen, (hd,), init="ones")
        p["k_norm"] = param(gen, (hd,), init="ones")
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kvh, hd) -> (b, s, h, hd) by repeating each kv head."""
    kvh = k.shape[2]
    if kvh == n_heads:
        return k
    return k.repeat_interleave(n_heads // kvh, dim=2)


def qkv_project(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Returns q (b,s,h,hd), k/v (b,s,h,hd) (kv repeated), post-RoPE."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    return q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads)


def naive_causal_attention(q, k, v, q_pos, kv_pos, window: int = 0):
    """Reference attention.  q/k/v: (b, s, h, hd); positions (b, s)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float()
    scores = scores / math.sqrt(hd)
    mask = kv_pos[:, None, None, :] <= q_pos[:, None, :, None]
    if window:
        mask &= kv_pos[:, None, None, :] > (q_pos[:, None, :, None] - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs.to(q.dtype), v)


def _chunk_step(acc, m, l, qf, kci, vci, pci, q_pos, window: int):
    """One KV chunk of the online softmax: (acc, m, l) -> updated."""
    s = torch.einsum("bqhk,bshk->bhqs", qf, kci).float()
    mask = pci[:, None, None, :] <= q_pos[:, None, :, None]
    if window:
        mask &= pci[:, None, None, :] > (q_pos[:, None, :, None] - window)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqs,bshk->bhqk", p.to(qf.dtype), vci).float()
    return acc, m_new, l


def blockwise_attention(q, k, v, q_pos, kv_pos, window: int = 0,
                        chunk: int = 1024):
    """Online-softmax attention over KV chunks, in plain PyTorch.
    q: (b, sq, h, hd); k/v: (b, skv, h, hd).

    Each chunk step is checkpointed, as ``jax.checkpoint(body)`` in the
    JAX function: the backward pass recomputes a chunk's f32 scores and
    probabilities instead of keeping them across the whole KV axis."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if skv % chunk:
        chunk = skv
    qf = q * torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        acc, m, l = checkpoint(
            _chunk_step, acc, m, l, qf, k[:, c0:c0 + chunk],
            v[:, c0:c0 + chunk], kv_pos[:, c0:c0 + chunk], q_pos, window,
            use_reentrant=False)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)              # (b, sq, h, hd)


def attention_train(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                    chunk: int = 2048, return_kv: bool = False,
                    mode: str = "prefill"):
    """Training/prefill attention with output projection.

    ``mode="train"`` is the JAX function on every device: the naive
    branch for ``s <= chunk``, the blockwise one above it, in plain
    PyTorch under autograd (the flash kernel is forward-only, in both
    packages).  ``mode="prefill"`` takes those branches on the CPU and
    the flash kernel on any other device (which raises for a device it
    has no kernel for); the kernel takes the unrepeated kv heads and
    masks by index (prefill positions are ``0..s-1``, so index and
    position agree).  ``return_kv`` also returns the pre-repeat
    (b, s, kvh, hd) k and v.
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"attention_train has no mode {mode!r}")
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    if mode == "train" or x.device.type == "cpu":
        kr, vr = _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads)
        if kr.shape[1] > chunk:
            out = blockwise_attention(q, kr, vr, positions, positions,
                                      window=cfg.sliding_window, chunk=chunk)
        else:
            out = naive_causal_attention(q, kr, vr, positions, positions,
                                         window=cfg.sliding_window)
    else:
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if return_kv:
        return y, (k, v)
    return y


def kv_to_cache(k: torch.Tensor, v: torch.Tensor, capacity: int) -> Dict:
    """Prefill KV (b, s, kvh, hd) -> ring-buffer cache (b, kvh, S, hd):
    token t occupies slot t % capacity, as ``attention_decode`` writes."""
    s = k.shape[1]
    if s > capacity:
        k, v = k[:, -capacity:], v[:, -capacity:]
        shift = s % capacity
        if shift:
            k = torch.roll(k, shift, dims=1)
            v = torch.roll(v, shift, dims=1)
    elif s < capacity:
        k = F.pad(k, (0, 0, 0, 0, 0, capacity - s))
        v = F.pad(v, (0, 0, 0, 0, 0, capacity - s))
    return {"k": k.transpose(1, 2).contiguous(),
            "v": v.transpose(1, 2).contiguous()}


def attention_decode(p: Dict, x: torch.Tensor, cfg, cache: Dict,
                     cur_len) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode against a (ring-buffered) KV cache.

    x: (b, 1, d).  cache: {"k": (b, kvh, S, hd), "v": ...}.  cur_len: an
    int (uniform batch) or a (b,) int tensor (per-slot lengths).
    Unlike the JAX function, the new k/v are written into ``cache`` in
    place (at slot ``cur_len % S``) and the same dict is returned.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    S = cache["k"].shape[2]
    cur_len = torch.as_tensor(cur_len, dtype=torch.int64, device=x.device)
    if cur_len.dim() == 0:
        cur_len = cur_len.expand(b)
    pos_now = cur_len[:, None]                          # (b, 1)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k_new = _qk_norm(k_new, p["k_norm"], cfg.norm_eps)
    q = apply_rope(cfg, q, pos_now)
    k_new = apply_rope(cfg, k_new, pos_now)
    knc, vnc = k_new[:, 0], v_new[:, 0]                 # (b, kvh, hd)
    rows = torch.arange(b, device=x.device)
    slot = cur_len % S                                  # ring buffer
    ck, cv = cache["k"], cache["v"]
    ck[rows, :, slot] = knc.to(ck.dtype)
    cv[rows, :, slot] = vnc.to(cv.dtype)
    if ck.dtype != x.dtype:
        # the JAX function attends over the cache promoted to the compute
        # dtype, with this step's k/v not yet rounded to the cache dtype
        ck, cv = ck.to(x.dtype), cv.to(x.dtype)
        ck[rows, :, slot] = knc
        cv[rows, :, slot] = vnc

    kvh = cfg.n_kv_heads
    g = cfg.n_heads // kvh
    qg = q.reshape(b, kvh, g, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, ck).float()
    scores = scores / math.sqrt(hd)
    n_valid = torch.clamp(cur_len + 1, max=S)
    valid = torch.arange(S, device=x.device)[None, :] < n_valid[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", probs.to(x.dtype), cv)
    out = out.reshape(b, 1, cfg.n_heads, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": param(gen, (d, f)), "wo": param(gen, (f, d))}
    if cfg.act == "swiglu":
        p["wg"] = param(gen, (d, f))
    return p


def apply_mlp(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        h = _silu(h) * g
    elif cfg.act == "sq_relu":
        h = torch.square(F.relu(h))
    else:
        h = _gelu_tanh(h)
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# The activations are written op by op as JAX writes them, so that each
# intermediate rounds to bf16 where XLA rounds it (F.silu and F.gelu
# round once, and drift from the JAX package by a bf16 ulp).

def _silu(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * logistic(x), logistic as 1 / (1 + exp(-x))."""
    return h * (1.0 / (1.0 + torch.exp(-h)))


def _gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (approximate=True) tanh form."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=h.dtype)
    return h * (0.5 * (1.0 + torch.tanh(c * (h + 0.044715 * (h * h * h)))))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    return v if v % 128 == 0 else (v // 128 + 1) * 128


def init_embedding(gen: torch.Generator, cfg) -> Dict:
    if cfg.pos_scheme == "learned":
        raise NotImplementedError(f"learned positions: {ROADMAP['audio']}")
    vp = padded_vocab(cfg)
    p = {"table": param(gen, (vp, cfg.d_model), scale=1.0)}
    if not cfg.tie_embeddings:
        p["head"] = param(gen, (cfg.d_model, vp))
    return p


def embed_tokens(p: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = p["table"][tokens]
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)    # minicpm-style embedding scale
    return x


def unembed(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["table"])
    return torch.einsum("bsd,dv->bsv", x, p["head"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, cfg,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32; the padded vocab entries are
    masked out; logits (b, s, Vp)."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp != cfg.vocab_size:
        pad_mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
