"""Public wrapper of the fused expert-MLP kernel, in model layout.

``expert_mlp(x, wi, wg, wo)`` takes the capacity blocks x ``(G, E, C, D)``
and the expert weights wi/wg ``(E, D, F)``, wo ``(E, F, D)``, and returns
``(G, E, C, D)`` in x's dtype.  On a CUDA tensor it launches the
hand-written kernel (``csrc/moe_mlp.cu``) or raises; it takes the plain
version only for tensors on the CPU.  ``expert_mlp.launches`` counts
kernel launches.

The dtype and the shape alone pick the kernel's schedule.  bf16: two
GEMMs per expert on the tensor cores, h carried between them in three
bf16 parts in a workspace (three hold each f32 exactly).  f32: one pass
over d_ff when h for all of it fits a block's shared memory, else d_ff in
tiles of ``split_tile(F)`` columns whose outputs are summed in an f32
workspace.

The launch is the custom op ``repro_torch::expert_mlp`` (``OP``): its
CUDA implementation holds the alignment checks, the workspaces, the
schedule and the count; its fake implementation gives the output's shape,
dtype and strides, so a dry run on fake tensors sees one op, costed by
``cost``, and launches nothing.  On DTensors it runs on each rank's
local capacity blocks, split over groups (the weights replicated) or over
experts (each rank's experts' weights), or on every block with each
rank's slice of d_ff (the weights split along F, JAX's "mlp" layout where
the experts do not divide the mesh dim): SwiGLU is column-wise in F, so
each rank's call is the same kernel on its F columns, and its output is
that rank's share of the down projection's sum, a partial sum that the
model reduces where JAX's layout does.  ``sharding`` lists the layouts.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.kernels import refuse_autograd, register_op
from repro_torch.kernels.moe_mlp import kernel
from repro_torch.kernels.moe_mlp.ref import expert_mlp_plain

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
# shared memory one block may use on Hopper (227 KB), cudaFuncSetAttribute
MAX_SMEM_BYTES = 232448
# the widest d_ff tile of the f32 split schedule
MAX_F_TILE = 1024


def split_tile(f: int) -> int:
    """The d_ff tile of the f32 split schedule: the largest multiple of
    128 that divides ``f`` and is at most ``MAX_F_TILE``."""
    m = f // 128
    return 128 * max(q for q in range(1, MAX_F_TILE // 128 + 1) if m % q == 0)


def _check(x, wi, wg, wo) -> None:
    if x.dim() != 4 or wi.dim() != 3:
        raise ValueError(f"want x (G,E,C,D), wi/wg (E,D,F), wo (E,F,D); got "
                         f"{tuple(x.shape)}, {tuple(wi.shape)}")
    g, e, c, d = x.shape
    f = wi.shape[2]
    if (tuple(wi.shape) != (e, d, f) or tuple(wg.shape) != (e, d, f)
            or tuple(wo.shape) != (e, f, d)):
        raise ValueError(f"weights {tuple(wi.shape)}, {tuple(wg.shape)}, "
                         f"{tuple(wo.shape)} do not fit x {tuple(x.shape)}")
    if (len({t.dtype for t in (x, wi, wg, wo)}) != 1
            or x.dtype not in _DTYPES):
        raise TypeError(f"want float32 or bfloat16 for all of x/wi/wg/wo, "
                        f"got {x.dtype}, {wi.dtype}, {wg.dtype}, {wo.dtype}")
    if len({t.device for t in (x, wi, wg, wo)}) != 1:
        raise ValueError("x and the weights must lie on one device")


def expert_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU FFN over capacity blocks -> (G, E, C, D)."""
    _check(x, wi, wg, wo)
    refuse_autograd("expert_mlp", x, wi, wg, wo)
    if x.device.type == "cpu":
        return expert_mlp_plain(x, wi, wg, wo)
    if x.device.type != "cuda":
        raise ValueError(f"no expert_mlp for device {x.device}")
    _check_launch(x.shape, wi.shape[2])
    return OP(x, wi, wg, wo)


def _check_launch(x_shape, f: int) -> None:
    """The kernel's shape limits, on the shapes it is launched at: the
    wrapper's (global) ones, and each rank's local ones (a rank's slice
    of d_ff), where the op's CUDA implementation is called."""
    g, e, c, d = x_shape
    if d % 32 or f % 128:
        raise ValueError(f"the kernel needs D % 32 == 0 and F % 128 == 0; "
                         f"got D={d}, F={f}")
    if e > _MAX_GRID_Y:
        raise ValueError(f"E = {e} exceeds the grid ({_MAX_GRID_Y})")


def _expert_mlp_cuda(x, wi, wg, wo):
    """The counted launch on checked CUDA inputs."""
    _check_launch(x.shape, wi.shape[2])
    x, wi, wg, wo = (t.contiguous() for t in (x, wi, wg, wo))
    if any(t.data_ptr() % 16 for t in (x, wi, wg, wo)):
        raise ValueError("the kernel loads 16-byte vectors: x and the "
                         "weights must start on a 16-byte boundary")
    if x.dtype == torch.bfloat16:
        out = _launch_bf16(x, wi, wg, wo)
    else:
        out = _launch_f32(x, wi, wg, wo)
    expert_mlp.launches += 1
    return out


def _expert_mlp_fake(x, wi, wg, wo):
    return x.new_empty(x.shape)


def cost(x_shape, w_shape, dtype: torch.dtype):
    """(flops, bytes) of one call on x ``(G, E, C, D)`` and wi ``(E, D,
    F)``: three products of 2 G E C D F flops; the three weights, x and
    the output each moved once."""
    g, e, c, d = x_shape
    f = w_shape[2]
    values = 3 * e * d * f + 2 * g * e * c * d
    return 6.0 * g * e * c * d * f, float(values * dtype.itemsize)


def sharding(x, wi, wg, wo):
    """DTensor layouts of one mesh dim: all replicated; x and the output
    split over groups with the weights replicated; over experts, x's dim
    1 with the weights' dim 0; or over d_ff, x replicated, wi and wg
    split along F (dim 2) and wo along F (dim 1), the output each rank's
    partial sum of the down projection.  The d_ff layout is listed last:
    of layouts that cost DTensor the same redistribution (a local slice
    of a replicated tensor costs none), it takes the first listed, so a
    mesh dim that splits no weight along F makes no partial sum."""
    r, s0, s1, s2 = Replicate(), Shard(0), Shard(1), Shard(2)
    return [([r], [r, r, r, r]), ([s0], [s0, r, r, r]),
            ([s1], [s1, s0, s0, s0]), ([Partial()], [r, s2, s2, s1])]


OP = register_op("expert_mlp",
                 "(Tensor x, Tensor wi, Tensor wg, Tensor wo) -> Tensor",
                 _expert_mlp_cuda, _expert_mlp_fake,
                 lambda x, wi, wg, wo: cost(x.shape, wi.shape, x.dtype),
                 sharding)


def _launch_bf16(x, wi, wg, wo) -> torch.Tensor:
    g, e, c, d = x.shape
    f = wi.shape[2]
    out = torch.empty_like(x)
    # h in three bf16 parts, written by the up GEMM, read by the down GEMM
    h = torch.empty((3, e, g * c, f), dtype=x.dtype, device=x.device)
    err = kernel.load().moe_mlp_bf16_fwd(
        x.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
        out.data_ptr(), h.data_ptr(), g, e, c, d, f, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_mlp kernel launch failed: CUDA error {err}")
    return out


def _launch_f32(x, wi, wg, wo) -> torch.Tensor:
    g, e, c, d = x.shape
    f = wi.shape[2]
    lib = kernel.load()
    # the d_ff columns a block holds as h at a time
    ft = (f if lib.moe_mlp_f32_smem_bytes(f) <= MAX_SMEM_BYTES
          else split_tile(f))
    out = torch.empty_like(x)
    ws = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
          if ft < f else None)
    err = lib.moe_mlp_f32_fwd(
        x.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), g, e, c, d, f,
        ft, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_mlp kernel launch failed: CUDA error {err}")
    return out


expert_mlp.launches = 0
