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
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (IDENTITY_SHARDER, Sharder,
                                       local_shape_and_offset, param)

NEG_INF = -1e9
# devices whose prefill takes the plain attention (the CPU); any other
# takes the flash kernel
PLAIN_DEVICES = ("cpu",)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, cfg, d: int) -> Dict:
    p = {"scale": param(gen, (d,), (None,), init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = param(gen, (d,), (None,), init="zeros")
    return p


def apply_norm(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm or LayerNorm of each row, in f32, cast back to x's dtype.
    Where autograd records nothing (serving), the chain runs in place on
    one f32 copy of x (``_norm_in_place``)."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, *p.values()))):
        return _norm_in_place(p, x, cfg)
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


def _norm_in_place(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """``apply_norm``'s ops in the same order on one f32 copy of x, each
    written into it: the same bits, with one full-size f32 temporary
    alive where the out-of-place chain holds four (x's copy, the
    centred rows, their scaled and shifted results; a 32k-token
    prefill's first norm set its peak)."""
    xf = x.to(torch.float32, copy=True)
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf.mul_(torch.rsqrt(var + cfg.norm_eps)).mul_(p["scale"])
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf.sub_(mean).mul_(torch.rsqrt(var + cfg.norm_eps))
        xf.mul_(p["scale"]).add_(p["bias"])
    return xf.to(x.dtype)


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
    shards never asks of it.

    Under autograd an argument left whole over a mesh dim that splits
    the first argument gets, from each rank, the gradient of that rank's
    share alone: its gradient is a partial sum over that mesh dim
    (``Partial``), as a weight's is where the rows are split, and keys
    and values where the query rows are."""
    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args)
    mesh = lead.device_mesh
    split = [roles[0][p.dim] if p.is_shard() else None
             for p in lead.placements]

    def layout(r, whole=Replicate()):
        return tuple(Shard(r.index(x)) if x is not None and x in r
                     else Replicate() if x is None else whole
                     for x in split)
    reps = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, reps, run_check=False)
            if r is not None and not isinstance(a, DTensor) else a
            for a, r in zip(args, roles)]
    return local_map(fn, out_placements=list(layout(out_roles)),
                     in_placements=tuple(layout(r) if r is not None
                                         else None for r in roles),
                     in_grad_placements=tuple(
                         layout(r, Partial()) if r is not None else None
                         for r in roles),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


# the roles of attention's arguments for ``per_shard``: q (b, sq, h, hd),
# k and v (b, skv, h, hd) with every key whole, positions (b, sq) and
# (b, skv)
_ATTN_ROLES = (("b", "s", "h", None), ("b", None, "h", None),
               ("b", None, "h", None), ("b", "s"), ("b", None))
_ATTN_OUT = ("b", "s", "h", None)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (b, s, d) by w (d, h, hd) -> (b, s, h, hd)."""
    return torch.einsum("bsd,dhk->bshk", x, w)


# the roles of ``_project``'s arguments for ``per_shard``: x by its batch
# and query rows, the weight by its heads
_PROJECT_ROLES = (("b", "s", None), (None, "h", None))


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
    ones laid out by their kv heads (JAX's ``kv_raw`` is taken before
    that constraint; the values are the same).

    On a mesh whose rules split "q_seq" (context parallelism), in
    either mode, x's rows are laid out by it before the projections, so
    that the q, k and v projections, the qk norm and RoPE run on each
    rank's rows (where XLA's propagation of q's layout puts them); k and
    v are then gathered over the rows (every query row sees every key),
    and the kernel, or the plain branch, runs on the rank's query rows
    with every key (``flash_attention_rows``).  The projections run on
    the local shards (``per_shard``): DTensor (torch 2.11) refuses the
    einsum's view that merges the batch and row dims split over two mesh
    dims.  Under autograd their backward runs on the rank's rows too,
    the weights' gradients partial sums over the rows' ranks.  The
    returned k and v are then the gathered ones.
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"attention_train has no mode {mode!r}")
    plain = mode == "train" or x.device.type in PLAIN_DEVICES
    if sharder.axis_size("q_seq") > 1:
        xr = sharder.ac(x, ("batch", "q_seq", None))

        def project(w):
            return per_shard(_project, _PROJECT_ROLES, ("b", "s", "h", None),
                             xr, w)
    else:
        project = functools.partial(_project, x)
    q = project(p["wq"])
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
    q = apply_rope(cfg, q, positions)
    q_pos = positions if positions.dim() == 2 else positions[..., 0]
    if kv is None:
        k = project(p["wk"])
        v = project(p["wv"])
        if cfg.qk_norm:
            k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
        k = apply_rope(cfg, k, positions)
        k = sharder.ac(k, ("batch", None, "kv_heads", None))
        v = sharder.ac(v, ("batch", None, "kv_heads", None))
        kv_raw = (k, v)
        kv_pos = q_pos
    else:
        k, v, kv_pos = kv
    cross = kv is not None
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
        # the gate is projected after the activation's intermediates are
        # freed: one (b, s, d_ff) tensor fewer at the layer's peak
        h = _silu(h)
        h = h * torch.einsum("bsd,df->bsf", x, p["wg"])
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
                 positions: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Token embeddings, plus ``pos_table[positions]`` (b, s) with learned
    positions.  The rows are gathered by ``F.embedding`` (JAX's
    ``table[tokens]``): its backward, a dense embedding gradient, has a
    DTensor strategy in torch 2.11, where indexing's (an ``index_put``)
    fails on batch-split tokens.  ``dtype`` casts the gathered rows
    (the same bits as gathering from the cast table, without a copy of
    the whole table)."""
    x = _rows(p["table"], tokens, dtype)
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)    # minicpm-style embedding scale
    if cfg.pos_scheme == "learned" and positions is not None:
        x = x + _rows(p["pos_table"], positions, dtype)
    return x


def _rows(table: torch.Tensor, ids: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    x = F.embedding(ids, table)
    return x if dtype is None else x.to(dtype)


def unembed(p: Dict, x: torch.Tensor, cfg,
            sharder: Sharder = IDENTITY_SHARDER,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Logits (b, s, Vp), laid out by ("batch", None, "vocab") as in JAX.

    Where the rules split the rows ("q_seq") and not the vocab, the
    logits would be whole on every rank of the rows' mesh dim, and so
    would the loss and its backward: there x and the logits are laid
    out by the rows instead, so that each rank projects, and
    differentiates, its own rows (a train step's; serving's one row
    stays whole), as XLA splits the unembedding's backward over the
    rows in JAX's dry run.  ``dtype`` casts the weight it projects by,
    alone (the table is not cast where the head projects)."""
    rows = ("q_seq" if sharder.axis_size("q_seq") > 1
            and sharder.axis_size("vocab") == 1 else None)
    tied = cfg.tie_embeddings
    w = p["table"] if tied else p["head"]
    if dtype is not None:
        w = w.to(dtype)
    if rows:
        # on the local shards, as ``_project``: DTensor (torch 2.11)
        # refuses the einsum's view merging the split batch and rows
        logits = per_shard(functools.partial(_logits, tied=tied),
                           _LOGITS_ROLES, ("b", "s", None),
                           sharder.ac(x, ("batch", rows, None)), w)
    else:
        logits = _logits(x, w, tied)
    return sharder.ac(logits, ("batch", rows, "vocab"))


def _logits(x: torch.Tensor, w: torch.Tensor, tied: bool) -> torch.Tensor:
    """x (b, s, d) by the table (V, d) when ``tied``, else by the head
    (d, V) -> (b, s, V)."""
    return torch.einsum("bsd,vd->bsv" if tied else "bsd,dv->bsv", x, w)


# the roles of ``_logits``' arguments for ``per_shard``: x by its batch
# and rows, the weight whole
_LOGITS_ROLES = (("b", "s", None), (None, None))


class _TokenNLL(torch.autograd.Function):
    """Each token's negative log-likelihood from one rank's vocab slice of
    the logits: ``logits`` (b, s, v) holds the global vocab ids ``[lo, lo
    + v)``, of which those below ``vocab`` are real and the rest padding;
    ``groups`` are the process groups over which the vocab is split
    (none for whole logits).  Returns (b, s) f32 (f64 for f64 logits).

    Padding is left out of the max and zeroed after the exponential, so
    no masked copy of the logits is made, and the label's logit is
    gathered from the slice that holds it (0 on the other ranks).  The
    ranks then combine the max, the sum of exponentials and the picked
    logit: (b, s, 1) each, in f32 (f64 for f64 logits).  The forward
    holds one f32 tensor of the slice's size, ``logits - max``, at a
    time.  The backward rebuilds
    the softmax from the saved logits and log-sum-exp, one f32 tensor,
    with no collective.  On whole logits every op is one that
    ``torch.logsumexp``, ``gather`` and autograd compute on the f32
    logits with the padding masked to ``NEG_INF``, so the loss and the
    gradient are theirs bit for bit."""

    @staticmethod
    def forward(ctx, logits, labels, vocab: int, lo: int, groups):
        v = logits.shape[-1]
        acc = torch.promote_types(logits.dtype, torch.float32)
        real = min(max(vocab - lo, 0), v)
        idx = labels.long()[..., None] - lo
        mine = (idx >= 0) & (idx < v)
        idx = idx.clamp(0, v - 1)
        if real:
            m = logits[..., :real].amax(dim=-1, keepdim=True).to(acc)
        else:
            m = logits.new_full(idx.shape, NEG_INF, dtype=acc)
        m = _all_reduce(m, "max", groups)
        picked = torch.where(mine, logits.gather(-1, idx).to(acc), 0.0)
        e = torch.sub(logits, m).exp_()
        if real < v:
            e[..., real:] = 0.0
        sums = e.sum(dim=-1, keepdim=True)
        del e
        if groups:
            sums, picked = _all_reduce(torch.cat([sums, picked], -1), "sum",
                                       groups).split(1, dim=-1)
        lse = sums.log_().add_(m)
        ctx.save_for_backward(logits, idx, mine, lse)
        ctx.real = real
        return (lse - picked)[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, idx, mine, lse = ctx.saved_tensors
        g = g[..., None]
        grad = torch.sub(logits, lse).exp_().mul_(g)
        if ctx.real < grad.shape[-1]:
            grad[..., ctx.real:] = 0.0
        grad.scatter_add_(-1, idx, torch.where(mine, -g, 0.0))
        return grad.to(logits.dtype), None, None, None, None


def _all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced by ``op`` over each process group in turn."""
    for group in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, group))
    return t


# the roles of the loss's arguments for ``per_shard``: the logits by
# their rows and vocab, the labels by their rows
_NLL_ROLES = (("b", "s", "v"), ("b", "s"))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, cfg,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32; the padded vocab entries are
    masked out; logits (b, s, Vp).

    On a mesh (DTensor logits) each rank computes its tokens' losses from
    its own shard of the logits (``per_shard``): where the vocab is split
    it holds the slice ``[lo, lo + v)``, and the ranks that split it
    combine three (b, s, 1) partial results (``_TokenNLL``), so no op
    has an operand of the whole vocab.  The values are those of the
    plain path, bit for bit where the vocab is whole."""
    vocab = cfg.vocab_size
    if isinstance(logits, DTensor):
        mesh, placements = logits.device_mesh, tuple(logits.placements)
        _, offset = local_shape_and_offset(tuple(logits.shape), mesh,
                                           placements)
        groups = [mesh.get_group(i) for i, p in enumerate(placements)
                  if p.is_shard(logits.dim() - 1)]
        nll = per_shard(
            lambda x, y: _TokenNLL.apply(x, y, vocab, offset[-1], groups),
            _NLL_ROLES, ("b", "s"), logits, labels)
    else:
        nll = _TokenNLL.apply(logits, labels, vocab, 0, ())
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
