"""AdamW with decoupled weight decay and global-norm clipping, as
``repro.optim.adamw``.

The optimizer state is a tree congruent with the parameters:
``{"m": tree, "v": tree, "count": 0-dim int32}``.  ``adamw_update``
runs under ``torch.no_grad()`` and, unlike the JAX function, updates the
parameters and moments IN PLACE (it returns the same trees, with a new
``count``): at stablelm-1.6b's size a functional update would hold a
second 20 GB copy of params and moments.  It updates a leaf a few rows
(leading-dim slices: a stacked leaf's layers) at a time, so that its f32
temporaries are of ``UPDATE_CHUNK_BYTES``, not of the leaf, as XLA's
fusion of the update holds none: the update is elementwise, and the
values are those of one pass bit for bit.  A leaf on a device mesh whose
gradient, moments and param share one layout is updated on each rank's
local shards, row by row of the shard.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import leaves, map_leaves

# the f32 bytes of the rows of a leaf that one pass of the update takes:
# mixtral-8x22b's expert leaves, (56, 8, 6144, 1024) on a rank, pass one
# layer (201 MB in f32) at a time
UPDATE_CHUNK_BYTES = 256 << 20


def adamw_init(params: Any, moment_dtype: torch.dtype = torch.float32
               ) -> Dict[str, Any]:
    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    first = next(iter(leaves(params)))
    return {"m": map_leaves(zeros, params), "v": map_leaves(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, leaves in the JAX
    package's order (sorted keys)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(norm.new_tensor(max_norm) / torch.clamp(norm, min=1e-9),
                        max=1.0)
    return map_leaves(lambda x: x * scale.to(x.dtype), tree), norm


@torch.no_grad()
def adamw_update(grads: Any, state: Dict[str, Any], params: Any, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step; params, m and v are updated in place."""
    count = state["count"] + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def upd(g, m, v, p, lr, bc1, bc2):
        g = g.float()
        pf = p.float()
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        mh = m_new / bc1
        vh = v_new / bc2
        step = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
        p.copy_(pf - lr * step)
        m.copy_(m_new)
        v.copy_(v_new)

    def leaf(g, m, v, p):
        scalars = (lr, bc1, bc2)
        if _same_layout(g, m, v, p):
            g, m, v, p = (t.to_local() for t in (g, m, v, p))
            scalars = tuple(t.full_tensor() if isinstance(t, DTensor)
                            else t for t in scalars)
        elif isinstance(p, DTensor):
            return upd(g, m, v, p, *scalars)
        n = _rows_per_pass(p)
        for i in range(0, p.shape[0] if p.dim() else 1, n):
            upd(*(t.narrow(0, i, min(n, t.shape[0] - i)) if t.dim() else t
                  for t in (g, m, v, p)), *scalars)

    map_leaves(leaf, grads, state["m"], state["v"], params)
    return params, {"m": state["m"], "v": state["v"], "count": count}


def _rows_per_pass(p: torch.Tensor) -> int:
    """Rows of ``p`` (slices along its leading dim) whose f32 bytes fit
    ``UPDATE_CHUNK_BYTES``; at least one."""
    if p.dim() == 0 or p.shape[0] == 0:
        return 1
    row = 4 * (p.numel() // p.shape[0])
    return max(1, UPDATE_CHUNK_BYTES // max(row, 1))


def _same_layout(*ts: torch.Tensor) -> bool:
    """Whether every tensor is a DTensor on one mesh with one layout (an
    elementwise op on them is then its local shards' op)."""
    first = ts[0]
    return isinstance(first, DTensor) and all(
        isinstance(t, DTensor) and t.device_mesh == first.device_mesh
        and tuple(t.placements) == tuple(first.placements) for t in ts)
