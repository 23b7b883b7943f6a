"""Layer library of the port: norms, partial RoPE and M-RoPE, GQA
attention (train mode in plain PyTorch under autograd, prefill through
the flash kernel on the GPU, KV-cache decode), cross attention over
given keys and values, MLPs, embeddings with learned positions and the
cross-entropy loss.

Each function mirrors the one of the same name in
``repro.models.layers`` and keeps its layouts: activations
``(b, s, h, hd)``, caches ``(b, kvh, S, hd)``.  Every parameter carries
the JAX leaf's logical axes, and every ``sharder.ac`` of the JAX function
stands here at the same point with the same names (``sharder`` is the
last argument, the identity by default).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import IDENTITY_SHARDER, Sharder, param

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, cfg, d: int) -> Dict:
    p = {"scale": param(gen, (d,), (None,), init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = param(gen, (d,), (None,), init="zeros")
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
# Rotary embeddings (RoPE, partial RoPE, M-RoPE)
# ---------------------------------------------------------------------------

def _rot_dims(cfg) -> int:
    rot = int(cfg.head_dim * cfg.rope_pct)
    return rot - rot % 2


def _inv_freq(rot: int, theta: float, device=None) -> torch.Tensor:
    """theta^(-i/rot) for even i < rot, computed in f64 and rounded once
    to f32: the correctly rounded values, which JAX's f32 power gives for
    every registry arch, where PyTorch's f32 power is an ulp off on some
    (4 of qwen2-vl-7b's 64)."""
    inv = theta ** (-torch.arange(0, rot, 2, dtype=torch.float64,
                                  device=device) / rot)
    return inv.float()


def rope_angles(cfg, positions: torch.Tensor) -> torch.Tensor:
    """positions (...,) or, for mrope, (..., 3) -> angles (..., rot//2).

    M-RoPE (Qwen2-VL) splits the ``rot//2`` frequencies into t/h/w
    sections of ``(nf//4, (nf - nf//4)//2, rest)`` (16/24/24 at a head
    dim of 128) and turns each section by its own coordinate."""
    inv = _inv_freq(_rot_dims(cfg), cfg.rope_theta, positions.device)
    pos = positions.float()
    if cfg.pos_scheme == "mrope":
        nf = inv.shape[0]
        s1 = nf // 4
        s2 = (nf - s1) // 2
        parts, start = [], 0
        for i, sec in enumerate((s1, s2, nf - s1 - s2)):
            parts.append(pos[..., i:i + 1] * inv[start:start + sec])
            start += sec
        return torch.cat(parts, dim=-1)
    return pos[..., None] * inv


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); positions: (b, s), or (b, s, 3) for mrope.
    Rotate-half on the first ``_rot_dims`` dims; the rest pass through."""
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
        "wq": param(gen, (d, cfg.n_heads, hd), ("embed", "heads", None)),
        "wk": param(gen, (d, cfg.n_kv_heads, hd),
                    ("embed", "kv_heads", None)),
        "wv": param(gen, (d, cfg.n_kv_heads, hd),
                    ("embed", "kv_heads", None)),
        "wo": param(gen, (cfg.n_heads, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = param(gen, (hd,), (None,), init="ones")
        p["k_norm"] = param(gen, (hd,), (None,), init="ones")
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


def qkv_project(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                sharder: Sharder = IDENTITY_SHARDER):
    """Returns q (b,s,h,hd), k/v (b,s,h,hd) (kv repeated), post-RoPE."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    q = sharder.ac(q, ("batch", None, "heads", None))
    k = sharder.ac(k, ("batch", None, "heads", None))
    v = sharder.ac(v, ("batch", None, "heads", None))
    return q, k, v


def per_shard(fn, roles, out_roles, *args):
    """``fn(*args)``, or on a mesh ``fn`` on each rank's shards of them
    (``local_map``): for functions whose rows and heads are independent,
    attention's cores.  ``roles`` names each dim of each argument ("b"
    batch, "s" query rows, "h" heads, None for a dim that must stay
    whole; None for an argument that is no tensor) and ``out_roles`` the
    output's.  The first argument's layout decides: a mesh dim that
    splits its dim of role r splits every argument's dim of role r, and
    leaves whole an argument with no such dim.  DTensor cannot merge two
    dims split over two mesh dims (torch 2.11 refuses the batched
    matmuls' merge of batch and heads), which running on the local
    shards never asks of it."""
    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args)
    mesh = lead.device_mesh
    split = [roles[0][p.dim] if p.is_shard() else None
             for p in lead.placements]

    def layout(r):
        return tuple(Shard(r.index(x)) if x is not None and x in r
                     else Replicate() for x in split)
    reps = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, reps, run_check=False)
            if r is not None and not isinstance(a, DTensor) else a
            for a, r in zip(args, roles)]
    return local_map(fn, out_placements=list(layout(out_roles)),
                     in_placements=tuple(layout(r) if r is not None
                                         else None for r in roles),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


# the roles of attention's arguments for ``per_shard``: q (b, sq, h, hd),
# k and v (b, skv, h, hd) with every key whole, positions (b, sq) and
# (b, skv)
_ATTN_ROLES = (("b", "s", "h", None), ("b", None, "h", None),
               ("b", None, "h", None), ("b", "s"), ("b", None))
_ATTN_OUT = ("b", "s", "h", None)


def _mask(scores, q_pos, kv_pos, window: int):
    """Causal by position (and within ``window``): masked scores."""
    mask = kv_pos[:, None, None, :] <= q_pos[:, None, :, None]
    if window:
        mask &= kv_pos[:, None, None, :] > (q_pos[:, None, :, None] - window)
    return torch.where(mask, scores, NEG_INF)


def naive_causal_attention(q, k, v, q_pos, kv_pos, window: int = 0,
                           cross: bool = False):
    """Reference attention.  q/k/v: (b, s, h, hd); positions (b, s);
    ``cross`` attends every key (no mask)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float()
    scores = scores / math.sqrt(hd)
    if not cross:
        scores = _mask(scores, q_pos, kv_pos, window)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs.to(q.dtype), v)


def _chunk_step(acc, m, l, qf, kci, vci, pci, q_pos, window: int,
                cross: bool):
    """One KV chunk of the online softmax: (acc, m, l) -> updated."""
    s = torch.einsum("bqhk,bshk->bhqs", qf, kci).float()
    if not cross:
        s = _mask(s, q_pos, pci, window)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqs,bshk->bhqk", p.to(qf.dtype), vci).float()
    return acc, m_new, l


def blockwise_attention(q, k, v, q_pos, kv_pos, window: int = 0,
                        chunk: int = 1024, cross: bool = False):
    """Online-softmax attention over KV chunks, in plain PyTorch.
    q: (b, sq, h, hd); k/v: (b, skv, h, hd); ``cross`` as in
    ``naive_causal_attention``.

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
            cross, use_reentrant=False)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)              # (b, sq, h, hd)


def attention_train(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                    chunk: int = 2048, return_kv: bool = False,
                    mode: str = "prefill", n_vis: int = 0,
                    kv: Optional[Tuple] = None,
                    sharder: Sharder = IDENTITY_SHARDER):
    """Training/prefill attention with output projection.

    ``mode="train"`` is the JAX function on every device: the naive
    branch for ``s <= chunk``, the blockwise one above it, in plain
    PyTorch under autograd (the flash kernel is forward-only, in both
    packages).  ``mode="prefill"`` takes those branches on the CPU and
    the flash kernel on any other device (which raises for a device it
    has no kernel for).  Both mask by position, as JAX does: by the
    temporal coordinate of M-RoPE positions (b, s, 3).  The kernel takes
    the unrepeated kv heads (repeated only on a mesh that splits the
    query heads and not the kv heads) and masks by index: prefill
    positions are ``0..s-1``, or for M-RoPE (``make_positions``)
    ``n_vis`` vision tokens at temporal position 0 followed by the text
    at its index, so a key is visible where its index is at most the
    query's or below ``n_vis`` (the kernel's ``prefix``).  On a mesh the
    plain branches run on each rank's shards (``per_shard``).
    ``return_kv`` also returns the pre-repeat (b, s, kvh, hd) k and v.

    ``kv = (k, v, kv_pos)``, keys and values computed elsewhere (the
    encoder's own, or the encoder output's for the decoder's cross
    attention), is attended with no mask (JAX's ``cross``): the kernel
    runs with ``causal=False`` over their ``s_kv`` keys; ``positions``
    then only turn q.  Unlike the JAX function's, these k and v are not
    repeated to the query heads: (b, s_kv, kvh, hd).

    The JAX function's layout constraints stand at the same points: k and
    v by their kv heads before the repeat, q by ("q_seq", "heads"), k and
    v by the query heads after it (on the kernel path, which takes them
    unrepeated, by the query heads as they are), and the attention output
    by "seq" before the output projection.  The returned k and v are the
    ones before any constraint, as JAX's ``kv_raw``.
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"attention_train has no mode {mode!r}")
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
    q = apply_rope(cfg, q, positions)
    q_pos = positions if positions.dim() == 2 else positions[..., 0]
    if kv is None:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        if cfg.qk_norm:
            k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
        k = apply_rope(cfg, k, positions)
        kv_raw = (k, v)
        k = sharder.ac(k, ("batch", None, "kv_heads", None))
        v = sharder.ac(v, ("batch", None, "kv_heads", None))
        kv_pos = q_pos
    else:
        k, v, kv_pos = kv
    cross = kv is not None
    plain = mode == "train" or x.device.type == "cpu"
    if plain or (sharder.axis_size("heads") > 1
                 and sharder.axis_size("kv_heads") == 1):
        # on a mesh that splits the query heads but not the kv heads
        # (GQA), the kernel too takes k and v repeated to the query heads,
        # as JAX does: each rank then holds its heads' k and v, and the
        # local call is MHA with JAX's per-device flops
        k, v = _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads)
    q = sharder.ac(q, ("batch", "q_seq", "heads", None))
    k = sharder.ac(k, ("batch", None, "heads", None))
    v = sharder.ac(v, ("batch", None, "heads", None))
    if not plain:
        out = flash_attention(q, k, v, causal=not cross,
                              window=0 if cross else cfg.sliding_window,
                              prefix=n_vis)
    elif k.shape[1] > chunk:
        out = per_shard(functools.partial(
            blockwise_attention, window=cfg.sliding_window, chunk=chunk,
            cross=cross), _ATTN_ROLES, _ATTN_OUT, q, k, v, q_pos, kv_pos)
    else:
        out = per_shard(functools.partial(
            naive_causal_attention, window=cfg.sliding_window, cross=cross),
            _ATTN_ROLES, _ATTN_OUT, q, k, v, q_pos, kv_pos)
    out = sharder.ac(out, ("batch", "seq", None, None))
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if return_kv:
        return y, kv_raw
    return y


def kv_to_cache(k: torch.Tensor, v: torch.Tensor, capacity: int,
                sharder: Sharder = IDENTITY_SHARDER) -> Dict:
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
        # zeros concatenated, not F.pad: DTensor's constant_pad_nd gives
        # a spec of one placement on a 2-D mesh (torch 2.11)
        zeros = k.new_zeros((k.shape[0], capacity - s) + tuple(k.shape[2:]))
        k = torch.cat([k, zeros], dim=1)
        v = torch.cat([v, zeros], dim=1)
    axes = ("batch", "kv_heads_c", "kv_seq", None)
    return {"k": sharder.ac(k.transpose(1, 2).contiguous(), axes),
            "v": sharder.ac(v.transpose(1, 2).contiguous(), axes)}


def attention_decode(p: Dict, x: torch.Tensor, cfg, cache: Dict,
                     cur_len, sharder: Sharder = IDENTITY_SHARDER
                     ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode against a (ring-buffered) KV cache.

    x: (b, 1, d).  cache: {"k": (b, kvh, S, hd), "v": ...}.  cur_len: an
    int (uniform batch) or a (b,) int tensor (per-slot lengths).
    Unlike the JAX function, the new k/v are written into ``cache`` in
    place (at slot ``cur_len % S``, through ``sharder.write_kv_``, which
    writes a distributed cache's local shards) and the same dict is
    returned.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    S = cache["k"].shape[2]
    cur_len = torch.as_tensor(cur_len, dtype=torch.int64, device=x.device)
    if cur_len.dim() == 0:
        cur_len = cur_len.expand(b)
    pos_now = cur_len[:, None]                          # (b, 1)
    if cfg.pos_scheme == "mrope":
        # a text token's three coordinates are all its index
        pos_now = pos_now[..., None].expand(b, 1, 3)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k_new = _qk_norm(k_new, p["k_norm"], cfg.norm_eps)
    q = apply_rope(cfg, q, pos_now)
    k_new = apply_rope(cfg, k_new, pos_now)
    knc, vnc = k_new[:, 0], v_new[:, 0]                 # (b, kvh, hd)
    slot = cur_len % S                                  # ring buffer
    ck, cv = cache["k"], cache["v"]
    sharder.write_kv_(ck, cv, slot, knc.to(ck.dtype), vnc.to(cv.dtype))
    if ck.dtype != x.dtype:
        # the JAX function attends over the cache promoted to the compute
        # dtype, with this step's k/v not yet rounded to the cache dtype
        ck, cv = ck.to(x.dtype), cv.to(x.dtype)
        sharder.write_kv_(ck, cv, slot, knc, vnc)
    ck = sharder.ac(ck, ("batch", "kv_heads_c", "kv_seq", None))
    cv = sharder.ac(cv, ("batch", "kv_heads_c", "kv_seq", None))

    n_valid = torch.clamp(cur_len + 1, max=S)
    if sharder.axis_size("heads") > 1 and sharder.axis_size("kv_heads") == 1:
        # GQA on a mesh that splits the query heads and not the kv heads:
        # the split heads do not fold into (kvh, g), and each rank attends
        # every head over the slots it holds ("kv_seq") or over all of
        # them, so q is whole there
        q = sharder.ac(q, ("batch", None, None, None))
    if isinstance(ck, DTensor) and any(p.is_shard(2) for p in ck.placements):
        # slots split ("kv_seq"): the max, sums and product over them
        # reduce across ranks, which DTensor does
        out = _decode_attention(ck, cv, q, n_valid)
    else:
        out = per_shard(_decode_attention, _DECODE_ROLES,
                        ("b", None, "h", None), ck, cv, q, n_valid)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


# the roles of ``_decode_attention``'s arguments for ``per_shard``: the
# caches (b, kvh, S, hd) with every slot whole, q (b, 1, h, hd) split
# with the kv heads (a rank's kv heads hold its query heads), the lengths
_DECODE_ROLES = (("b", "h", None, None), ("b", "h", None, None),
                 ("b", None, "h", None), ("b",))


def _decode_attention(ck, cv, q, n_valid):
    """One token's attention over the caches ck, cv (b, kvh, S, hd), its
    q (b, 1, h, hd) grouped by kv head, slots below ``n_valid`` (b,)
    visible -> (b, 1, h, hd)."""
    b, kvh, S, hd = ck.shape
    h = q.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, ck).float()
    scores = scores / math.sqrt(hd)
    valid = torch.arange(S, device=ck.device)[None, :] < n_valid[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", probs.to(q.dtype), cv)
    return out.reshape(b, 1, h, hd)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": param(gen, (d, f), ("embed", "mlp")),
         "wo": param(gen, (f, d), ("mlp", "embed"))}
    if cfg.act == "swiglu":
        p["wg"] = param(gen, (d, f), ("embed", "mlp"))
    return p


def apply_mlp(p: Dict, x: torch.Tensor, cfg,
              sharder: Sharder = IDENTITY_SHARDER) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        h = _silu(h) * g
    elif cfg.act == "sq_relu":
        h = torch.square(F.relu(h))
    else:
        h = _gelu_tanh(h)
    h = sharder.ac(h, ("batch", None, "mlp"))
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# The activations are written op by op as JAX writes them, so that each
# intermediate rounds to bf16 where XLA rounds it (F.silu and F.gelu
# round once, and drift from the JAX package by a bf16 ulp).

def _silu(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * logistic(x), logistic as 1 / (1 + exp(-x))."""
    return h * (1.0 / (1.0 + torch.exp(-h)))


def _gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (approximate=True) tanh form.  Both
    constants are rounded to the dtype first, as JAX's are (a Python
    float times a bf16 tensor multiplies by the unrounded value)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=h.dtype)
    a = torch.tensor(0.044715, dtype=h.dtype)
    return h * (0.5 * (1.0 + torch.tanh(c * (h + a * (h * h * h)))))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    return v if v % 128 == 0 else (v // 128 + 1) * 128


def init_embedding(gen: torch.Generator, cfg) -> Dict:
    """The token table, the head unless tied, and with learned positions
    (whisper's decoder) a ``pos_table`` of 8192 rows, or ``enc_seq`` if
    more, as in JAX."""
    vp = padded_vocab(cfg)
    p = {"table": param(gen, (vp, cfg.d_model), (None, "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        p["head"] = param(gen, (cfg.d_model, vp), ("embed", "vocab"))
    if cfg.pos_scheme == "learned":
        p["pos_table"] = param(gen, (max(8192, cfg.enc_seq), cfg.d_model),
                               (None, "embed"), scale=0.02)
    return p


def embed_tokens(p: Dict, tokens: torch.Tensor, cfg,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, plus ``pos_table[positions]`` (b, s) with learned
    positions.  The rows are gathered by ``F.embedding`` (JAX's
    ``table[tokens]``): its backward, a dense embedding gradient, has a
    DTensor strategy in torch 2.11, where indexing's (an ``index_put``)
    fails on batch-split tokens."""
    x = F.embedding(tokens, p["table"])
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)    # minicpm-style embedding scale
    if cfg.pos_scheme == "learned" and positions is not None:
        x = x + F.embedding(positions, p["pos_table"])
    return x


def unembed(p: Dict, x: torch.Tensor, cfg,
            sharder: Sharder = IDENTITY_SHARDER) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, p["table"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, p["head"])
    return sharder.ac(logits, ("batch", None, "vocab"))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, cfg,
                  mask: Optional[torch.Tensor] = None,
                  sharder: Sharder = IDENTITY_SHARDER) -> torch.Tensor:
    """Mean next-token cross entropy in f32; the padded vocab entries are
    masked out; logits (b, s, Vp).

    On a mesh (DTensor logits) the label's logit is picked by a one-hot
    of the vocab ids laid out like the logits: its backward stays on
    each rank's rows and vocab slice, where ``gather``'s backward builds
    a zero gradient of the global logits' shape on every rank.  A mesh
    that splits the vocab also keeps the log-sum-exp's reductions split:
    spelled out as ``torch.logsumexp`` computes it (max, then the sum of
    exponentials), each rank reduces its slice and DTensor combines the
    partial results.  The values are those of the plain path, bit for
    bit on the CPU (a one-hot pick adds only zeros to the label's
    logit)."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp != cfg.vocab_size:
        pad_mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, NEG_INF)
    labels = labels.long()[..., None]
    if sharder.axis_size("vocab") > 1:
        m = logits.detach().amax(dim=-1, keepdim=True)
        lse = (logits - m).exp().sum(dim=-1, keepdim=True).log() + m
    else:
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    if isinstance(logits, DTensor):
        ids = sharder.ac(torch.arange(vp, device=logits.device), ("vocab",))
        picked = torch.where(ids == labels, logits, 0.0).sum(dim=-1,
                                                             keepdim=True)
    else:
        picked = torch.gather(logits, -1, labels)
    # the difference is taken before the label dim is dropped: on logits
    # split over the vocab, DTensor sums the gathered shards at this shape
    nll = (lse - picked)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
