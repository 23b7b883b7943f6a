"""Public wrapper of the flash-attention kernel, in model layout.

``flash_attention(q, k, v)`` takes q ``(b, s, h, d)`` and k/v
``(b, s_kv, kvh, d)`` with ``kvh`` dividing ``h``; causal, it masks by
index, and keys below ``prefix`` are visible to every row (an M-RoPE
sequence's vision tokens, all at temporal position 0, see each other
both ways).  Local query row i is row ``q_offset + i`` of the sequence
the keys cover (0: q holds its first rows; a rank of a context-parallel
prefill holds a slice of the rows).  On a CUDA tensor it
launches the hand-written kernel (``csrc/flash_attention.cu``: bf16 on
the tensor cores, f32 with exact FMAs) or raises; it takes the plain
version only for tensors on the CPU.  ``flash_attention.launches``
counts kernel launches.

The launch is the custom op ``repro_torch::flash_attention`` (``OP``):
its CUDA implementation builds and launches the kernel (alignment checks,
the launch, the count); its fake implementation gives the output's shape,
dtype and strides, so a dry run on fake tensors
(``repro_torch.core.fidelity``) sees one op, costed by ``cost``, and
launches nothing.  On DTensors it runs on each rank's local q, k and v,
split over batch, or over heads where the mesh dims that split them
divide both head counts (``sharding``); q split over its rows (context
parallelism, the "q_seq" rule) takes ``flash_attention_rows``, which
gives each rank's call its rows' offset.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import refuse_autograd, register_op
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          prefix: int = 0, q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: kv heads repeated, f32
    arithmetic, output in the input dtype."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                        window=window, prefix=prefix, q_offset=q_offset)
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int, prefix: int, q_offset: int) -> None:
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
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset}: the global index of the "
                         f"first query row is >= 0")
    # global query row i sees keys (i - window, min(i, s_kv - 1)]; the
    # last row, q_offset + s - 1, sees none once q_offset + s >= s_kv +
    # window, where the plain version averages v over the masked keys and
    # the TPU kernel writes 0
    if causal and window > 0 and q_offset + s >= k.shape[1] + window:
        raise ValueError(f"causal attention with window {window} over "
                         f"s_kv = {k.shape[1]} keys leaves query rows "
                         f"{k.shape[1] + window - 1}.. of rows "
                         f"[{q_offset}, {q_offset + s}) without a visible "
                         f"key")
    if prefix < 0 or (prefix and window > 0):
        raise ValueError(f"prefix {prefix} with window {window}: a prefix "
                         f"is >= 0 and takes no window (no arch has both)")


def check_staging(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The bf16 kernel stages q, k and v in 16-byte copies (8 values):
    raise unless each starts on a 16-byte boundary and its batch, sequence
    and head strides are multiples of 8 values."""
    for name, t in zip("qkv", (q, k, v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the bf16 kernel's 16-byte copies")
        if any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{name}'s strides {tuple(t.stride())} must be "
                             f"multiples of 8 values (16 bytes) in b, s and "
                             f"h for the bf16 kernel's 16-byte copies")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window, or with a bidirectional
    ``prefix``) attention of query rows ``q_offset ..`` -> (b, s, h, d)."""
    _check(q, k, v, causal, window, prefix, q_offset)
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     prefix=prefix, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; one of {HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"b * h = {b * h} exceeds the grid ({_MAX_GRID_Y})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    return run_op(q, k, v, causal=causal, window=window, prefix=prefix,
                  q_offset=q_offset)


def run_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0, prefix: int = 0,
           q_offset: int = 0) -> torch.Tensor:
    """The op on checked inputs, on any device it has an implementation
    for: a DTensor q split over its rows takes ``flash_attention_rows``,
    any other q (a tensor, or a DTensor in a layout of ``sharding``) the
    op itself."""
    if isinstance(q, DTensor) and any(p.is_shard(1) for p in q.placements):
        return flash_attention_rows(q, k, v, causal=causal, window=window,
                                    prefix=prefix, q_offset=q_offset)
    return OP(q, k, v, causal, window, prefix, q_offset)


def flash_attention_rows(q: DTensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         prefix: int = 0, q_offset: int = 0) -> DTensor:
    """Context parallelism: the op on each rank's query rows of a DTensor
    q split over its rows (dim 1), every key whole.

    k and v are laid out as q is, but with dim 1 whole (a rank needs
    every key its rows may see); each rank then calls the op on its
    local q, k and v with ``q_offset`` plus the global index of its
    first row, and the output takes q's placements.  That is right on
    every rank: a query row's output depends only on that row of q, on
    k and v (which the rank holds whole for its batch rows and heads)
    and on the row's global index, which the mask reads; the index is
    the rank's offset (DTensor's split of dim 1, by the mesh dims that
    split it, in mesh order: ``local_shape_and_offset``) plus the local
    row.  A causal split is uneven in work: the rank with the last rows
    sees the most keys.  The kernel raises where it cannot run; nothing
    here gathers q or falls back to the plain version."""
    from repro_torch.dist.sharding import local_shape_and_offset
    from repro_torch.models.common import contiguous_strides
    mesh = q.device_mesh
    qp = tuple(q.placements)
    if any(p.is_partial() for p in qp):
        raise ValueError(f"q's placements {qp}: a partial sum has no rows")
    kvp = tuple(Replicate() if p.is_shard(1) else p for p in qp)
    n_heads = math.prod(mesh.size(i) for i, p in enumerate(qp)
                        if p.is_shard(2))
    if k.shape[2] % n_heads:
        raise ValueError(f"q's heads split {n_heads} ways, which do not "
                         f"divide k's {k.shape[2]} heads: repeat k and v "
                         f"to the query heads first")

    def keys(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, kvp).to_local()
    _, offset = local_shape_and_offset(tuple(q.shape), mesh, qp)
    o = OP(q.to_local(), keys(k), keys(v), causal, window, prefix,
           q_offset + offset[1])
    return DTensor.from_local(o, mesh, qp, run_check=False, shape=q.shape,
                              stride=contiguous_strides(tuple(q.shape)))


def _flash_attention_cuda(q, k, v, causal, window, prefix, q_offset=0):
    """The counted launch on checked CUDA inputs."""
    if q.dtype == torch.bfloat16:
        check_staging(q, k, v)
    o = _launch(q, k, v, causal, window, prefix, q_offset)
    flash_attention.launches += 1
    return o


def _flash_attention_fake(q, k, v, causal, window, prefix, q_offset=0):
    return q.new_empty(q.shape)


def cost(q_shape, kv_shape, dtype: torch.dtype, causal: bool = True,
         window: int = 0, prefix: int = 0, q_offset: int = 0):
    """(flops, bytes) of one call: 4 d flops per (query, key) pair it
    sees.  Causal, query rows ``[q_offset, q_offset + s)`` see
    ``s (q_offset + min(s, s_kv) / 2)`` pairs: the half square of their
    own keys (half of s x s_kv when s_kv <= s) plus the full rectangle
    of the ``q_offset`` keys before them; a window caps it at ``window``
    keys a query; a prefix of p keys adds, for each row below p, the
    keys of the prefix past the row (p^2 / 2 for the rows [0, p): the
    half of the p x p block above the diagonal).  So a diagonal pair
    counts one half, except in rows inside the prefix.  q, k, v and the
    output each moved once."""
    b, s, h, d = q_shape
    s_kv, kvh = kv_shape[1], kv_shape[2]
    pairs = s * (q_offset + min(s, s_kv) / 2) if causal else s * s_kv
    if window > 0:
        pairs = min(pairs, s * window)
    if causal and prefix > 0:
        p = min(prefix, s_kv)
        lo, hi = min(q_offset, p), min(q_offset + s, p)
        pairs += p * (hi - lo) - (hi * hi - lo * lo) / 2
    values = 2 * b * s * h * d + 2 * b * s_kv * kvh * d
    return 4.0 * b * h * d * pairs, float(values * dtype.itemsize)


def sharding(q, k, v, causal, window, prefix, q_offset=0):
    """DTensor layouts of one mesh dim: all replicated; q, k, v and the
    output split over batch (each row's attention is its own); or over
    heads.  The heads split holds per mesh dim: ``register_op`` keeps a
    combination only where the mesh dims that split the heads divide
    both head counts (``kernels._even``), so that every local q head
    keeps its kv head (GQA).  The heads of a (16, 16) mesh's "model" dim
    are split while "data" splits the batch, where a test of the whole
    mesh's 256 would replicate them.  A query split (context
    parallelism, the "q_seq" rule) is no layout of one call: each rank's
    rows need their own ``q_offset``, which one strategy cannot give;
    ``flash_attention`` takes such q to ``flash_attention_rows``."""
    rest = [None] * 4
    return [([Replicate()], [Replicate()] * 3 + rest),
            ([Shard(0)], [Shard(0)] * 3 + rest),
            ([Shard(2)], [Shard(2)] * 3 + rest)]


OP = register_op("flash_attention",
                 "(Tensor q, Tensor k, Tensor v, bool causal, int window, "
                 "int prefix, int q_offset=0) -> Tensor",
                 _flash_attention_cuda, _flash_attention_fake,
                 lambda q, k, v, causal, window, prefix, q_offset=0: cost(
                     q.shape, k.shape, q.dtype, causal, window, prefix,
                     q_offset),
                 sharding)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, prefix: int, q_offset: int = 0) -> torch.Tensor:
    """The kernel on checked CUDA inputs; uncounted."""
    b, s, h, d = q.shape
    lib = kernel.load()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[q.dtype], b, s, k.shape[1], h, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window), int(prefix), int(q_offset),
        1.0 / math.sqrt(d),
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o


flash_attention.launches = 0
