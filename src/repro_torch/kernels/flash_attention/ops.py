"""Public wrapper of the flash-attention kernel, in model layout.

``flash_attention(q, k, v)`` takes q ``(b, s, h, d)`` and k/v
``(b, s_kv, kvh, d)`` with ``kvh`` dividing ``h``; causal, it masks by
index, and keys below ``prefix`` are visible to every row (an M-RoPE
sequence's vision tokens, all at temporal position 0, see each other
both ways).  On a CUDA tensor it
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
divide both head counts (``sharding``).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels import refuse_autograd, register_op
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          prefix: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: kv heads repeated, f32
    arithmetic, output in the input dtype."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                        window=window, prefix=prefix)
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int, prefix: int) -> None:
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
    # query row i sees keys (i - window, min(i, s_kv - 1)]; the last row
    # sees none once s >= s_kv + window, where the plain version averages
    # v over the masked keys and the TPU kernel writes 0
    if causal and window > 0 and s >= k.shape[1] + window:
        raise ValueError(f"causal attention with window {window} over "
                         f"s_kv = {k.shape[1]} keys leaves query rows "
                         f"{k.shape[1] + window - 1}.. of s = {s} without "
                         f"a visible key")
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
                    prefix: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window, or with a bidirectional
    ``prefix``) attention -> (b, s, h, d)."""
    _check(q, k, v, causal, window, prefix)
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     prefix=prefix)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; one of {HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"b * h = {b * h} exceeds the grid ({_MAX_GRID_Y})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    return OP(q, k, v, causal, window, prefix)


def _flash_attention_cuda(q, k, v, causal, window, prefix):
    """The counted launch on checked CUDA inputs."""
    if q.dtype == torch.bfloat16:
        check_staging(q, k, v)
    o = _launch(q, k, v, causal, window, prefix)
    flash_attention.launches += 1
    return o


def _flash_attention_fake(q, k, v, causal, window, prefix):
    return q.new_empty(q.shape)


def cost(q_shape, kv_shape, dtype: torch.dtype, causal: bool = True,
         window: int = 0, prefix: int = 0):
    """(flops, bytes) of one call: 4 d flops per (query, key) pair it
    sees, causal counted as half of s x s_kv, a window as at most
    ``window`` keys a query, a prefix of p keys as p^2 / 2 more pairs
    (the half of the p x p block above the diagonal); q, k, v and the
    output each moved once."""
    b, s, h, d = q_shape
    s_kv, kvh = kv_shape[1], kv_shape[2]
    pairs = s * s_kv / 2 if causal else s * s_kv
    if window > 0:
        pairs = min(pairs, s * window)
    if causal and prefix > 0:
        p = min(prefix, s, s_kv)
        pairs += p * p / 2
    values = 2 * b * s * h * d + 2 * b * s_kv * kvh * d
    return 4.0 * b * h * d * pairs, float(values * dtype.itemsize)


def sharding(q, k, v, causal, window, prefix):
    """DTensor layouts of one mesh dim: all replicated; q, k, v and the
    output split over batch (each row's attention is its own); or over
    heads.  The heads split holds per mesh dim: ``register_op`` keeps a
    combination only where the mesh dims that split the heads divide
    both head counts (``kernels._even``), so that every local q head
    keeps its kv head (GQA).  The heads of a (16, 16) mesh's "model" dim
    are split while "data" splits the batch, where a test of the whole
    mesh's 256 would replicate them.  A query split (context
    parallelism, the "q_seq" rule) is not offered: the kernel masks by
    index, so a shard of query rows would need their offset; such q is
    replicated over the dim that splits it."""
    rest = [None, None, None]
    return [([Replicate()], [Replicate()] * 3 + rest),
            ([Shard(0)], [Shard(0)] * 3 + rest),
            ([Shard(2)], [Shard(2)] * 3 + rest)]


OP = register_op("flash_attention",
                 "(Tensor q, Tensor k, Tensor v, bool causal, int window, "
                 "int prefix) -> Tensor",
                 _flash_attention_cuda, _flash_attention_fake,
                 lambda q, k, v, causal, window, prefix: cost(
                     q.shape, k.shape, q.dtype, causal, window, prefix),
                 sharding)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, prefix: int) -> torch.Tensor:
    """The kernel on checked CUDA inputs; uncounted."""
    b, s, h, d = q.shape
    lib = kernel.load()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[q.dtype], b, s, k.shape[1], h, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window), int(prefix), 1.0 / math.sqrt(d),
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o


flash_attention.launches = 0
