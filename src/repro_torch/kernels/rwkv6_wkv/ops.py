"""Public wrappers of the WKV6 kernel, in model layout.

``wkv6(r, k, v, w, u, chunk=64)`` mirrors ``repro.kernels.rwkv6_wkv.ops.
wkv6``: r/k/v/w ``(b, s, h, n)`` with w the decay in (0, 1), u ``(h, n)``,
and it returns y ``(b, s, h, n)`` in r's dtype from a zero state.
``wkv6_state(r, k, v, lw, u, state0=None, chunk=64)`` is the entry the
model calls: it takes the log decay ``lw`` (f32, <= 0) and an optional
f32 initial state ``(b, h, n, n)``, and returns ``(y, final state)``.

On a CUDA tensor they launch the hand-written kernel (``csrc/wkv6.cu``)
or raise; they take the plain version (``wkv6_ref``, the sequential
recurrence) only for tensors on the CPU.  In f32 the kernel runs that
recurrence in the same order, and ``chunk`` is the number of tokens it
stages at a time: the result does not depend on it.  In bf16 the kernel
runs the chunked form on the tensor cores in chunks of 32 tokens and
ignores ``chunk`` (``ref.wkv6_chunked_factorised`` is that factorisation
in plain PyTorch, for the tests).  ``wkv6.launches`` counts kernel
launches of both.

The launch is the custom op ``repro_torch::wkv6`` (``OP``): its CUDA
implementation holds the copies of unaligned views, the launch and the
count; its fake implementation gives the outputs' shapes, dtypes and
strides, so a dry run on fake tensors sees one op, costed by ``cost``,
and launches nothing.  On DTensors it runs on each rank's local batch
rows or heads (``sharding``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels import refuse_autograd, register_op
from repro_torch.kernels.rwkv6_wkv import kernel
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

HEAD_SIZES = (16, 32, 64)
MAX_CHUNK = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def wkv6_state_plain(r, k, v, lw, u, state0=None):
    """The kernel's function in plain PyTorch: the recurrence on
    w = exp(lw)."""
    return wkv6_ref(r, k, v, torch.exp(lw.float()), u, state0)


def use_kernel(device: torch.device) -> bool:
    """True on a CUDA device (the kernel), False on the CPU (the plain
    version); any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no wkv6 for device {device}")
    return device.type == "cuda"


def _check(r, k, v, lw, u, state0) -> None:
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or lw.shape != r.shape:
        raise ValueError(f"want r/k/v/lw (b,s,h,n) of one shape; got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(lw.shape)}")
    b, s, h, n = r.shape
    if tuple(u.shape) != (h, n):
        raise ValueError(f"u {tuple(u.shape)}, want {(h, n)}")
    if state0 is not None and tuple(state0.shape) != (b, h, n, n):
        raise ValueError(f"state0 {tuple(state0.shape)}, want {(b, h, n, n)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODE:
        raise TypeError(f"want float32 or bfloat16 for all of r/k/v, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if lw.dtype != torch.float32 or not u.is_floating_point() or (
            state0 is not None and state0.dtype != torch.float32):
        raise TypeError(f"want lw and state0 in float32 and u of a float "
                        f"type, got {lw.dtype}, "
                        f"{None if state0 is None else state0.dtype}, "
                        f"{u.dtype}")
    tensors = [r, k, v, lw, u] + ([] if state0 is None else [state0])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("r, k, v, lw, u and state0 must lie on one device")


def wkv6_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor,
               state0: Optional[torch.Tensor] = None, chunk: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 from ``state0`` (zeros if None) -> (y (b, s, h, n) in r's
    dtype, final state (b, h, n, n) f32)."""
    _check(r, k, v, lw, u, state0)
    refuse_autograd("wkv6", r, k, v, lw, u,
                    *([] if state0 is None else [state0]))
    if not use_kernel(r.device):
        return wkv6_state_plain(r, k, v, lw, u, state0)
    b, s, h, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} not built; one of {HEAD_SIZES}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel stages 1 to "
                         f"{MAX_CHUNK} tokens at a time")
    return OP(r, k, v, lw, u, state0, chunk)


def _wkv6_cuda(r, k, v, lw, u, state0, chunk):
    """The counted launch on checked CUDA inputs."""
    b, s, h, n = r.shape
    lib = kernel.load()
    # the kernel's tensor-map copies need 16-byte aligned rows: a view may
    # start anywhere
    r, k, v, lw = (t.contiguous() if t.data_ptr() % 16 == 0 and
                   t.is_contiguous() else t.clone(
                       memory_format=torch.contiguous_format)
                   for t in (r, k, v, lw))
    u = u.float().contiguous()
    if state0 is not None:
        state0 = state0.contiguous()
    y = torch.empty_like(r)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    err = lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        None if state0 is None else state0.data_ptr(), y.data_ptr(),
        state.data_ptr(), _DTYPE_CODE[r.dtype], b, s, h, n, chunk,
        r.device.index, torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, state


def _wkv6_fake(r, k, v, lw, u, state0, chunk):
    b, s, h, n = r.shape
    return r.new_empty(r.shape), r.new_empty((b, h, n, n),
                                             dtype=torch.float32)


def cost(shape, dtype: torch.dtype, with_state: bool = False):
    """(operations, bytes) of one call on r ``(b, s, h, n)``: 4 n^2 f32
    operations per token and head (y: n^2 multiply-adds; the state: n^2
    multiplies and n^2 multiply-adds); r, k, v and y in ``dtype`` and lw
    in f32 moved once, the f32 final state written once and, with
    ``with_state``, the initial one read once (u's h n values are left
    out: under 0.02% at rwkv6-7b's shape)."""
    b, s, h, n = shape
    states = 2 if with_state else 1
    nbytes = (b * s * h * n * (4 * dtype.itemsize + 4)
              + 4 * states * b * h * n * n)
    return float(4 * n * n * b * s * h), float(nbytes)


def sharding(r, k, v, lw, u, state0, chunk):
    """DTensor layouts of one mesh dim: all replicated; split over batch
    (r, k, v, lw, y dim 0 and both states' dim 0, u replicated); or over
    heads (their dim 2, u's dim 0, the states' dim 1).  Each (row, head)
    runs its recurrence alone."""
    def one(seq, u_p, st):
        return ([seq, st], [seq] * 4 + [u_p, st if state0 is not None
                                        else None, None])
    r_, s0 = Replicate(), Shard(0)
    return [one(r_, r_, r_), one(s0, r_, s0), one(Shard(2), s0, Shard(1))]


OP = register_op("wkv6",
                 "(Tensor r, Tensor k, Tensor v, Tensor lw, Tensor u, "
                 "Tensor? state0, int chunk) -> (Tensor, Tensor)",
                 _wkv6_cuda, _wkv6_fake,
                 lambda r, k, v, lw, u, state0, chunk: cost(
                     r.shape, r.dtype, state0 is not None),
                 sharding)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """r/k/v/w: (b, s, h, n) with w = decay in (0, 1); u: (h, n) -> y."""
    lw = torch.log(torch.clamp(w.float(), min=1e-38))
    return wkv6_state(r, k, v, lw, u, chunk=chunk)[0]


wkv6.launches = 0
