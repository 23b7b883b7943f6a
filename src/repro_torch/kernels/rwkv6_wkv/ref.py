"""Plain PyTorch oracle for the WKV6 kernel: the exact sequential
recurrence.

Mirrors ``repro.kernels.rwkv6_wkv.ref.wkv6_ref``:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t S_{t-1} + (r_t . u . k_t) v_t

r/k/v/w are per-head (b, s, h, n) with w = decay in (0, 1); u (h, n) is
the bonus.  One step per token: slow, and unambiguously right, which is
what an oracle is for.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, s, h, n) in r's dtype, final state (b, h, n, n) f32)."""
    b, s, h, n = r.shape
    rr, kk, vv, ww = (x.float() for x in (r, k, v, w))
    uf = u.float()
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    ys = []
    for t in range(s):
        rt, kt, vt, wt = rr[:, t], kk[:, t], vv[:, t], ww[:, t]  # (b, h, n)
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, S)
                  + torch.einsum("bhn,hn,bhn->bh", rt, uf, kt)[..., None]
                  * vt)
        S = wt[..., None] * S + torch.einsum("bhn,bhm->bhnm", kt, vt)
    return torch.stack(ys, dim=1).to(r.dtype), S
