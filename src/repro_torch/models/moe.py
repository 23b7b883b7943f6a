"""Mixture-of-Experts FFN of the port: top-k routing with sort-based,
group-local dispatch (dropless up to a capacity factor).

Mirrors ``repro.models.moe``: groups are batch rows (subdivided so that
a group never exceeds ``MAX_GROUP_TOKENS``), capacity
``C = min(ceil(top_k T capacity_factor / E), T top_k)`` per group, slots
beyond C drop, and the Switch-style aux loss is returned beside y.  The
JAX package's layout constraints stand at the same points (``sharder``):
the routing metadata by batch alone, the capacity blocks by batch, h by
"mlp" on the einsum path (the kernel never materialises h) and the
expert outputs by "moe_d".

Three orderings follow JAX exactly, or the slot assignment diverges
whenever capacity overflows or router probabilities tie:

* ``jax.lax.top_k`` puts the lower index first among equal values:
  a stable descending sort, first k;
* ``jnp.argsort`` is stable: ``torch.argsort(..., stable=True)``;
* expert segments are found with ``searchsorted`` side left and right.

DTensor has no sharding strategy for ``searchsorted``; this module
registers one (``_searchsorted_sharding``): the sorted rows and the
values split alike over any leading (batch) dim, or both replicated.
The routing metadata is laid out by batch alone, so each group's search
runs where its group lives, as in JAX.

In prefill and decode, with a SwiGLU activation, the expert compute
goes through ``expert_mlp`` on every device: the hand-written kernel on
the card, its plain version on the CPU, both in f32 as the TPU kernel
computes it (the JAX model's einsum path rounds h to the compute dtype).
The train mode, and every other activation, take the einsum path of the
JAX function under autograd (the kernel is forward-only, in both
packages).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels.moe_mlp.ops import expert_mlp
from repro_torch.models.common import IDENTITY_SHARDER, Sharder, param
from repro_torch.models.layers import _gelu_tanh, _silu

MAX_GROUP_TOKENS = 4096


@register_sharding(torch.ops.aten.searchsorted.Tensor)
def _searchsorted_sharding(sorted_sequence, values, **kwargs):
    """One mesh dim's layouts of ``searchsorted(sorted, values)``: all
    replicated, or every operand split on the same leading dim (each row
    is searched alone; the last dim, the one searched, is never split)."""
    out = [([Replicate()], [Replicate(), Replicate()])]
    for d in range(sorted_sequence.ndim - 1):
        out.append(([Shard(d)], [Shard(d), Shard(d)]))
    return out


def init_moe(gen: torch.Generator, cfg) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": param(gen, (d, e), ("embed", None), scale=0.02),
        "wi": param(gen, (e, d, f), ("experts", "embed", "mlp")),
        "wo": param(gen, (e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.act == "swiglu":
        p["wg"] = param(gen, (e, d, f), ("experts", "embed", "mlp"))
    return p


def route_topk(logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., E) -> (gates (..., k) renormalized, idx (..., k))."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e.  The one-hot is a
    comparison with the expert ids, as ``jax.nn.one_hot`` computes it
    (``F.one_hot`` reads the indices' range back on the CPU, which a
    fake tensor cannot give)."""
    experts = torch.arange(n_experts, device=idx.device)
    one_hot = (idx[..., None] == experts).float()          # (..., k, E)
    f = one_hot.sum(dim=-2).mean(dim=tuple(range(one_hot.dim() - 2)))
    f = f / one_hot.shape[-2]
    P = probs.mean(dim=tuple(range(probs.dim() - 1)))
    return n_experts * torch.sum(f * P)


def apply_moe(p: Dict, x: torch.Tensor, cfg, mode: str = "prefill",
              sharder: Sharder = IDENTITY_SHARDER
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss scalar f32).  ``mode`` is
    the model's: "train" takes the einsum expert path."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    sub = max(1, S // MAX_GROUP_TOKENS) if S % MAX_GROUP_TOKENS == 0 else 1
    G, T = B * sub, S // sub
    x = x.reshape(G, T, D)
    TK = T * K
    C = max(1, math.ceil(K * T * cfg.capacity_factor / E))
    C = min(C, TK)
    dev = x.device

    logits = torch.einsum("gtd,de->gte", x, p["router"]).float()
    logits = sharder.ac(logits, ("batch", None, None))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = route_topk(logits, K)                    # (G,T,K)
    aux = load_balance_loss(probs, eidx, E)

    flat_e = sharder.ac(eidx.reshape(G, TK), ("batch", None))
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)  # (G,TK)
    sort_idx = sharder.ac(sort_idx, ("batch", None))
    sorted_e = torch.gather(flat_e, -1, sort_idx)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    # per-group start/end of each expert's segment in sorted order
    starts = torch.searchsorted(sorted_e, experts, side="left")
    ends = torch.searchsorted(sorted_e, experts, side="right")

    # --- dispatch: gather tokens into (G, E, C, D) capacity blocks -----
    pos = starts[:, :, None] + torch.arange(C, device=dev)[None, None, :]
    valid = pos < ends[:, :, None]                         # (G,E,C)
    pos_c = torch.clamp(pos, max=TK - 1).reshape(G, E * C)
    tok_src = torch.gather(sort_idx, -1, pos_c) // K       # (G,EC)
    # token gathers as JAX's take_along_axis (torch.gather), not advanced
    # indexing, which DTensor cannot propagate with group-split indices
    xin = torch.gather(x, 1, tok_src[:, :, None].expand(G, E * C, D))
    xin = xin * valid.reshape(G, E * C, 1).to(x.dtype)
    xin = sharder.ac(xin.reshape(G, E, C, D), ("batch", None, None, None))

    # --- expert compute --------------------------------------------------
    if cfg.act == "swiglu" and mode != "train":
        out = expert_mlp(xin, p["wi"], p["wg"], p["wo"])   # (G,E,C,D)
    else:
        h = torch.einsum("gecd,edf->gecf", xin, p["wi"])
        if cfg.act == "swiglu":
            h = _silu(h) * torch.einsum("gecd,edf->gecf", xin, p["wg"])
        elif cfg.act == "sq_relu":
            h = torch.square(F.relu(h))
        else:
            h = _gelu_tanh(h)
        h = sharder.ac(h, ("batch", None, None, "mlp"))
        out = torch.einsum("gecf,efd->gecd", h, p["wo"])
    out = sharder.ac(out, ("batch", None, None, "moe_d"))

    # --- combine: gather each (token, k) slot's output, weight by gate --
    inv = torch.argsort(sort_idx, dim=-1, stable=True)     # (G,TK)
    c_of = inv - torch.gather(starts, -1, flat_e)          # (G,TK)
    within = (c_of >= 0) & (c_of < C)
    flat_slot = flat_e * C + torch.clamp(c_of, 0, C - 1)   # (G,TK)
    per_k = torch.gather(out.reshape(G, E * C, D), 1,
                         flat_slot[:, :, None].expand(G, TK, D))  # (G,TK,D)
    per_k = per_k * within[:, :, None].to(x.dtype)
    per_k = per_k.reshape(G, T, K, D)
    y = torch.einsum("gtkd,gtk->gtd", per_k, gates.to(x.dtype))
    return y.reshape(B, S, D), aux
