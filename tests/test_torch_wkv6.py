"""The port's WKV6 wrappers and oracle against the JAX package's.

On the CPU, ``repro_torch.kernels.rwkv6_wkv.ops.wkv6`` takes its plain
version (the sequential recurrence); here it is held against JAX's
Pallas kernel (``interpret=True``) over the sweep of
``tests/test_kernels.py`` at its tolerances: 5e-4, and 1e-3 under strong
decay.  The port's ``wkv6_ref`` is held against JAX's ``wkv6_ref`` with
and without an initial state, y and the final state, at 1e-5: both run
the same recurrence in f32 and differ only in the order of sums inside
each step.  Inputs are made with numpy from a seed and given to both.

The CUDA kernel itself is tested on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.rwkv6_wkv import ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

# (b, s, h, n, chunk): tests/test_kernels.py
SWEEP = [(2, 128, 2, 64, 64), (1, 256, 4, 32, 32), (2, 64, 1, 16, 16),
         (1, 96, 2, 32, 32)]
REF_TOL = 1e-5


def inputs(seed, b, s, h, n, w=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    if w is None:
        w = 1.0 / (1.0 + np.exp(1.0 - rng.standard_normal((b, s, h, n))))
    w = np.broadcast_to(np.float32(w), (b, s, h, n)).astype(np.float32)
    u = (0.5 * rng.standard_normal((h, n))).astype(np.float32)
    return r, k, v, w, u


def as_torch(*arrs):
    return [torch.tensor(np.ascontiguousarray(a)) for a in arrs]


def as_jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("b,s,h,n,chunk", SWEEP)
def test_wkv6_sweep(b, s, h, n, chunk):
    arrs = inputs(21, b, s, h, n)
    want = jax_wkv6(*as_jax(*arrs), chunk=chunk, interpret=True)
    n0 = ops.wkv6.launches
    got = ops.wkv6(*as_torch(*arrs), chunk=chunk)
    assert ops.wkv6.launches == n0               # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (b, s, h, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=5e-4)


def test_wkv6_strong_decay_numerics():
    """w = 1e-3, as tests/test_kernels.py: finite and within 1e-3."""
    arrs = inputs(22, 1, 128, 1, 32, w=1e-3)
    arrs = arrs[:4] + (np.zeros_like(arrs[4]),)
    want = jax_wkv6(*as_jax(*arrs), chunk=64, interpret=True)
    got = ops.wkv6(*as_torch(*arrs), chunk=64)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,n", [(2, 33, 3, 16), (1, 70, 2, 32)])
def test_wkv6_ref_matches_jax(b, s, h, n, with_state):
    r, k, v, w, u = inputs(23, b, s, h, n)
    state0 = (np.random.default_rng(24).standard_normal((b, h, n, n))
              .astype(np.float32) if with_state else None)
    jy, jst = jax_wkv6_ref(*as_jax(r, k, v, w, u),
                           None if state0 is None else jnp.asarray(state0))
    ty, tst = wkv6_ref(*as_torch(r, k, v, w, u),
                       None if state0 is None else torch.tensor(state0))
    assert tst.dtype == torch.float32 and tst.shape == (b, h, n, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=REF_TOL,
                               rtol=REF_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=REF_TOL,
                               rtol=REF_TOL)


def test_wkv6_state_continues_a_sequence():
    """Two calls, the second from the first's final state, give the one
    call over the whole sequence (what prefill-then-decode relies on)."""
    r, k, v, w, u = as_torch(*inputs(25, 2, 40, 2, 16))
    lw = torch.log(w)
    y, st = ops.wkv6_state(r, k, v, lw, u)
    y1, st1 = ops.wkv6_state(r[:, :25], k[:, :25], v[:, :25], lw[:, :25], u)
    y2, st2 = ops.wkv6_state(r[:, 25:], k[:, 25:], v[:, 25:], lw[:, 25:], u,
                             st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=REF_TOL,
                               rtol=REF_TOL)
    torch.testing.assert_close(st2, st, atol=REF_TOL, rtol=REF_TOL)


def test_wkv6_bf16_keeps_the_dtype():
    """bf16 r/k/v and u: f32 arithmetic, y rounded once to bf16.  The
    wrapper's w is exp(log(w)), which may differ from w in the last f32
    bit and so move a rounding by one bf16 ulp (at most 2^-7 relative)."""
    r, k, v, w, u = as_torch(*inputs(26, 1, 20, 2, 16))
    rb, kb, vb = (t.bfloat16() for t in (r, k, v))
    y = ops.wkv6(rb, kb, vb, w, u.bfloat16())
    want, _ = wkv6_ref(rb.float(), kb.float(), vb.float(), w, u.bfloat16())
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want.bfloat16().float(),
                               atol=0, rtol=2 ** -7)


def test_wkv6_refuses_autograd():
    r, k, v, w, u = as_torch(*inputs(27, 1, 8, 1, 16))
    u.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.wkv6(r, k, v, w, u)
    with torch.no_grad():
        ops.wkv6(r, k, v, w, u)


def test_a_cuda_tensor_never_takes_the_plain_path():
    """The wrapper routes by device alone: the kernel on CUDA, the plain
    version on the CPU, and an error anywhere else."""
    assert ops.use_kernel(torch.device("cuda")) is True
    assert ops.use_kernel(torch.device("cuda", 1)) is True
    assert ops.use_kernel(torch.device("cpu")) is False
    with pytest.raises(ValueError, match="no wkv6 for device"):
        ops.use_kernel(torch.device("meta"))
    r = torch.zeros(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="no wkv6 for device"):
        ops.wkv6_state(r, r, r, r, torch.zeros(1, 16, device="meta"))


def test_wkv6_rejects_bad_inputs():
    r = torch.zeros(1, 4, 2, 16)
    u = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="one shape"):
        ops.wkv6_state(r, r, r[:, :3], r, u)
    with pytest.raises(ValueError, match="u "):
        ops.wkv6_state(r, r, r, r, u[:1])
    with pytest.raises(ValueError, match="state0"):
        ops.wkv6_state(r, r, r, r, u, torch.zeros(1, 2, 16, 8))
    with pytest.raises(TypeError):
        ops.wkv6_state(r.half(), r.half(), r.half(), r, u)
    with pytest.raises(TypeError):
        ops.wkv6_state(r, r, r, r.bfloat16(), u)
