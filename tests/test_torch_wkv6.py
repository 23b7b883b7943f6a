"""The port's WKV6 wrappers and oracle against the JAX package's.

On the CPU, ``repro_torch.kernels.rwkv6_wkv.ops.wkv6`` takes its plain
version (the sequential recurrence); here it is held against JAX's
Pallas kernel (``interpret=True``) over the sweep of
``tests/test_kernels.py`` at its tolerances: 5e-4, and 1e-3 under strong
decay.  The port's ``wkv6_ref`` is held against JAX's ``wkv6_ref`` with
and without an initial state, y and the final state, at 1e-5: both run
the same recurrence in f32 and differ only in the order of sums inside
each step.  Inputs are made with numpy from a seed and given to both.

``ref.wkv6_chunked_factorised`` is the bf16 kernel's own factorisation
(chunks of 32 tokens, sub-chunks of 16, decays as products of w,
the cross-sub-chunk reference point, two-part bf16 splits) in plain
PyTorch; it is held here against JAX's ``wkv6_ref`` with r, k and v exact
in bf16 (what the kernel reads): at ``tests/test_kernels.py``'s shapes
and tolerances (5e-4; 1e-3 under strong decay, w = 1e-3), and from a
random state under strong decay, at ragged s and over 2048 slowly
decaying tokens, where y is held as the kernel emits it, rounded to bf16,
at the card's bf16 tolerance (8e-3 of 1 + |y|) and the state at 5e-4.
That settles overflow, underflow and the splits' precision before the
card runs the kernel.

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
from repro_torch.kernels.rwkv6_wkv.ref import (wkv6_chunked_factorised,
                                               wkv6_ref)

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


# --- the bf16 kernel's factorisation against JAX's recurrence ------------

BF16_TOL = 8e-3   # y rounded to bf16, as the kernel emits it
STATE_TOL = 5e-4


def bf16_exact(a):
    """a rounded to bf16 and back: the values a bf16 kernel reads."""
    return torch.tensor(a).bfloat16().float().numpy()


def drawn(seed, b, s, h, n, w0_lo=-6.0, w0_hi=1.0, with_state=True):
    """r, k, v exact in bf16; lw = -exp(w0 + 0.5 N(0, 1)) with w0 per
    channel on [w0_lo, w0_hi], as chip_smoke.py and the model feed it
    (down to ~-7 a token); u; a random state0."""
    rng = np.random.default_rng(seed)
    r, k, v = (bf16_exact(rng.standard_normal((b, s, h, n))
                          .astype(np.float32)) for _ in range(3))
    w0 = rng.uniform(w0_lo, w0_hi, (h, n))
    lw = (-np.exp(w0 + 0.5 * rng.standard_normal((b, s, h, n))))
    u = (0.5 * rng.standard_normal((h, n))).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)).astype(np.float32)
          if with_state else None)
    return r, k, v, lw.astype(np.float32), u, st


def factorised_and_jax(r, k, v, lw, u, st, parts=None):
    ty, tst = wkv6_chunked_factorised(
        *as_torch(r, k, v, lw, u), None if st is None else torch.tensor(st),
        parts=parts)
    jy, jst = jax_wkv6_ref(*as_jax(r, k, v, np.exp(lw), u),
                           None if st is None else jnp.asarray(st))
    return (ty.numpy(), tst.numpy()), (np.asarray(jy), np.asarray(jst))


def assert_bf16_close(got, want):
    """y as the kernel emits it (rounded to bf16) within 8e-3 of 1 + |y|,
    the f32 state within 5e-4 of 1 + |S|."""
    (y, st), (yw, stw) = got, want
    assert np.isfinite(y).all() and np.isfinite(st).all()
    np.testing.assert_allclose(bf16_exact(y), bf16_exact(yw), atol=BF16_TOL,
                               rtol=BF16_TOL)
    np.testing.assert_allclose(st, stw, atol=STATE_TOL, rtol=STATE_TOL)


@pytest.mark.parametrize("b,s,h,n,chunk", SWEEP)
def test_factorisation_sweep(b, s, h, n, chunk):
    """tests/test_kernels.py's shapes and decays (w = sigmoid(N(0, 1) -
    1)) at its tolerance, 5e-4, y and the final state."""
    r, k, v, w, u = inputs(31, b, s, h, n)
    r, k, v = (bf16_exact(x) for x in (r, k, v))
    got, want = factorised_and_jax(r, k, v, np.log(w), u, None)
    for x, xw in zip(got, want):
        np.testing.assert_allclose(x, xw, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("s", [128, 100, 31])
def test_factorisation_strong_decay(s):
    """w = 1e-3 as tests/test_kernels.py, within 1e-3, over whole and
    ragged chunks: products of w underflow within a few tokens, nothing
    overflows."""
    r, k, v, w, u = inputs(32, 1, s, 1, 32, w=1e-3)
    r, k, v = (bf16_exact(x) for x in (r, k, v))
    got, want = factorised_and_jax(r, k, v, np.log(w), np.zeros_like(u),
                                   None)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("s", [200, 47])
def test_factorisation_strong_decay_from_a_state(s):
    """w = 1e-3 over several chunks and sub-chunks from a random state,
    with the bonus term: y within 1e-3, the state within 5e-4."""
    r, k, v, _, u, st = drawn(33, 1, s, 2, 64)
    lw = np.full(r.shape, np.log(1e-3), np.float32)
    got, want = factorised_and_jax(r, k, v, lw, u, st)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=STATE_TOL,
                               rtol=STATE_TOL)


@pytest.mark.parametrize("s", [15, 17, 31, 33, 65, 97])
def test_factorisation_ragged_from_a_state(s):
    """chip_smoke.py's draw of lw at s = L - 1, L + 1 and 2 L + 1 for L =
    16 (a sub-chunk) and 32 (a chunk), and at three chunks and one token,
    from a random state: within 5e-4."""
    got, want = factorised_and_jax(*drawn(34 + s, 1, s, 2, 64))
    for x, xw in zip(got, want):
        np.testing.assert_allclose(x, xw, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("w0", [(-6.0, -6.0), (-6.0, 1.0)])
def test_factorisation_2048_tokens(w0):
    """rwkv6-7b's prefill length at its head size from a random state:
    slow decay (w0 = -6, ~0.9975 a token; the state adds up over all 64
    chunks) and chip_smoke.py's draw.  The two-part splits keep y within
    one bf16 ulp of the recurrence, and y as the kernel emits it within
    bf16's tolerance; the state within 5e-4."""
    got, want = factorised_and_jax(*drawn(35, 1, 2048, 2, 64, *w0))
    assert_bf16_close(got, want)


@pytest.mark.parametrize("operand", ["r", "k", "s", "q", "a"])
def test_every_split_is_needed(operand):
    """One bf16 part instead of two for any one operand of the products
    (r^, K^, the state, Q~ and K~, the scores) takes y outside bf16's
    tolerance; two parts for all stay inside it."""
    args = drawn(36, 1, 200, 2, 64)
    got, want = factorised_and_jax(*args)
    assert_bf16_close(got, want)
    got, want = factorised_and_jax(*args, parts={operand: 1})
    err = np.abs(bf16_exact(got[0]) - bf16_exact(want[0])) / (
        1 + np.abs(bf16_exact(want[0])))
    assert err.max() > BF16_TOL
