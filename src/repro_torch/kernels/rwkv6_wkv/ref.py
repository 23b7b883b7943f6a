"""Plain PyTorch oracle for the WKV6 kernel: the exact sequential
recurrence.

Mirrors ``repro.kernels.rwkv6_wkv.ref.wkv6_ref``:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t S_{t-1} + (r_t . u . k_t) v_t

r/k/v/w are per-head (b, s, h, n) with w = decay in (0, 1); u (h, n) is
the bonus.  One step per token: slow, and unambiguously right, which is
what an oracle is for.

``wkv6_chunked_factorised`` is the bf16 kernel's own factorisation of the
same function (chunks, sub-chunks, products of w, bf16 splits), for the
tests that hold its numerics against the recurrence on the CPU.
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


SUB = 16  # tokens per sub-chunk of the chunked form
L = 2 * SUB  # tokens per chunk


def _split(x: torch.Tensor, parts: int) -> list:
    """x (f32) as ``parts`` bf16 values whose sum approaches x: the
    kernel's split_bf16 (each part rounded to nearest)."""
    out = []
    for _ in range(parts):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return out


def _product(a: torch.Tensor, b: torch.Tensor, eq: str, pa: int,
             pb: int) -> torch.Tensor:
    """The kernel's split product on the tensor cores: a in ``pa`` and b
    in ``pb`` bf16 parts, every pair of parts whose orders add to less
    than max(pa, pb) (2 x 2 parts: hi.hi + hi.lo + lo.hi), each exact
    bf16 x bf16 product summed in f32."""
    sa, sb = _split(a, pa), _split(b, pb)
    out = 0.0
    for i, x in enumerate(sa):
        for j, y in enumerate(sb):
            if i + j < max(pa, pb):
                out = out + torch.einsum(eq, x, y)
    return out


def wkv6_chunked_factorised(r: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lw: torch.Tensor,
                            u: torch.Tensor,
                            state0: Optional[torch.Tensor] = None,
                            parts: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's factorisation of WKV6 in plain PyTorch, f32:
    the same chunks of 32 tokens, sub-chunks, reference points and bf16
    splits (``csrc/wkv6.cu``'s head note), so that its numerics can be
    held against the recurrence on the CPU.  Test-only: nothing on the path
    calls it.

    Per channel, w = exp(lw) and every decay is a product of w's (never
    an exponential of a positive number): within a chunk,

      r^[t] = r[t] prod_{tau < t} w     K^[m] = k[m] prod_{tau > m} w
      y = r^ S + A V,   S <- diag(prod w) S + K^T V,

    A the chunk's (L, L) scores.  Pairs inside one 16-token sub-chunk are
    summed channel by channel with the decay carried as a running product
    (A[t, m] = sum_i r[t,i] k[m,i] prod_{m < tau < t} w[tau,i]; A[t, t] is
    the bonus r u k); pairs across sub-chunks (rows in sub-chunk 1,
    columns in sub-chunk 0) are one product of Q^ = r prod w (from the
    start of sub-chunk 1 to t) and K~ = k prod w (from m to the end of
    sub-chunk 0), both <= |r|, |k|.  r, k and v are taken as the bf16
    values the kernel reads (exact in bf16); every other operand of a
    product is split into ``parts[name]`` bf16 parts (default 2 each):
    "r" r^, "k" K^, "s" the state, "q" Q^ and K~, "a" the scores.
    Returns (y (b, s, h, n) f32, final state (b, h, n, n) f32)."""
    p = {"r": 2, "k": 2, "s": 2, "q": 2, "a": 2, **(parts or {})}
    b, s, h, n = r.shape
    pad = -s % L
    rr, kk, vv, ww = (torch.nn.functional.pad(
        x.float(), (0, 0, 0, 0, 0, pad)) for x in
        (r, k, v, torch.exp(lw.float())))
    # padded tokens: r = k = v = 0 and w = 1, which change nothing
    ww[:, s:] = 1.0
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float().clone())
    uf = u.float()
    ys = []
    for c0 in range(0, s + pad, L):
        rc, kc, vc, wc = (x[:, c0:c0 + L] for x in (rr, kk, vv, ww))
        # exclusive prefix / suffix products within each sub-chunk
        pre, suf = torch.ones_like(wc), torch.ones_like(wc)
        for t in range(1, L):
            if t % SUB:
                pre[:, t] = pre[:, t - 1] * wc[:, t - 1]
        for t in range(L - 2, -1, -1):
            if (t + 1) % SUB:
                suf[:, t] = suf[:, t + 1] * wc[:, t + 1]
        # the decay over each sub-chunk; r^ takes sub-chunk 0's in sub-chunk
        # 1, K^ sub-chunk 1's in sub-chunk 0
        tot = [pre[:, SUB * j + SUB - 1] * wc[:, SUB * j + SUB - 1]
               for j in range(2)]
        dr, dk = pre.clone(), suf.clone()
        dr[:, SUB:] *= tot[0][:, None]
        dk[:, :SUB] *= tot[1][:, None]
        rhat, khat = rc * dr, kc * dk
        # scores: the bonus on the diagonal, running products below it
        A = torch.zeros((b, h, L, L), dtype=torch.float32, device=r.device)
        idx = torch.arange(L, device=r.device)
        A[:, :, idx, idx] = torch.einsum("bthn,hn,bthn->bht", rc, uf, kc)
        for j in range(2):
            sl = slice(SUB * j, SUB * j + SUB)
            rs, ks_, ws = rc[:, sl], kc[:, sl], wc[:, sl]
            run = rs.clone()            # d = t - m = 1: r[t], no decay
            for d in range(1, SUB):
                if d > 1:                  # times w[m + 1], m = t - d
                    run[:, d:] = run[:, d:] * ws[:, 1:SUB - d + 1]
                t_idx = torch.arange(d, SUB, device=r.device)
                A[:, :, SUB * j + t_idx, SUB * j + t_idx - d] = torch.einsum(
                    "bthn,bthn->bht", run[:, d:], ks_[:, :SUB - d])
        q = rc[:, SUB:] * pre[:, SUB:]
        kt = kc[:, :SUB] * suf[:, :SUB]
        A[:, :, SUB:, :SUB] = _product(q, kt, "bthn,bmhn->bhtm",
                                       p["q"], p["q"])
        y = _product(rhat, S, "bthn,bhnj->bthj", p["r"], p["s"])
        y = y + _product(A, vc, "bhtm,bmhj->bthj", p["a"], 1)
        a = tot[0] * tot[1]
        S = a[..., None] * S + _product(khat, vc, "bmhn,bmhj->bhnj",
                                        p["k"], 1)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], S
