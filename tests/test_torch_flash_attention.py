"""The port's flash attention against the JAX package's.

On the CPU, ``repro_torch.kernels.flash_attention.ops.flash_attention``
takes its plain version; here it and the port's ``attention_ref`` are
held against JAX's Pallas kernel (``interpret=True``) and JAX's
``attention_ref`` over the sweep of ``tests/test_kernels.py``, plus
ragged lengths the Pallas kernel cannot take and GQA.  Tolerances are
``test_kernels.py``'s: 2e-5 in f32, 2e-2 in bf16.

The CUDA kernel itself is tested on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

SWEEP = [(2, 256, 4, 64, 0, 128, 128), (1, 512, 2, 128, 0, 128, 128),
         (2, 256, 4, 64, 128, 64, 64), (1, 128, 8, 32, 0, 64, 32),
         (3, 192, 2, 64, 0, 64, 64)]
# (b, s, h, kvh, d, window): ragged s, GQA, d=16, a window not a multiple
# of the tile
EXTRA = [(1, 1, 4, 4, 64, 0), (2, 77, 4, 2, 64, 0), (1, 1000, 2, 2, 32, 0),
         (1, 130, 8, 2, 128, 0), (2, 50, 4, 1, 16, 0), (1, 200, 2, 2, 64, 37)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(seed, b, s, h, kvh, d, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    jx = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    tx = [torch.tensor(a).to(TDT[dtype]) for a in (q, k, v)]
    return jx, tx


def close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,d,win,bq,bk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(b, s, h, d, win, bq, bk, dtype):
    (qj, kj, vj), (qt, kt, vt) = inputs(7, b, s, h, h, d, dtype)
    kernel = jax_flash(qj, kj, vj, causal=True, window=win, block_q=bq,
                       block_k=bk, interpret=True)
    f32 = [a.astype(jnp.float32) for a in (qj, kj, vj)]
    ref = jax_ref(*f32, causal=True, window=win)
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(qt, kt, vt, causal=True, window=win)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, d)
    assert ops.flash_attention.launches == n0     # the CPU runs no kernel
    close(kernel, got, dtype)
    close(ref, got, dtype)
    # the plain oracles agree in the input dtype too
    close(jax_ref(qj, kj, vj, causal=True, window=win),
          attention_ref(qt, kt, vt, causal=True, window=win), dtype)


@pytest.mark.parametrize("b,s,h,kvh,d,win", EXTRA)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_and_gqa(b, s, h, kvh, d, win, dtype):
    (qj, kj, vj), (qt, kt, vt) = inputs(8, b, s, h, kvh, d, dtype)
    rep = h // kvh
    f32 = [jnp.repeat(a.astype(jnp.float32), r, axis=2)
           for a, r in ((qj, 1), (kj, rep), (vj, rep))]
    got = ops.flash_attention(qt, kt, vt, causal=True, window=win)
    close(jax_ref(*f32, causal=True, window=win), got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_not_causal(dtype):
    (qj, kj, vj), (qt, kt, vt) = inputs(9, 2, 128, 2, 2, 32, dtype)
    kernel = jax_flash(qj, kj, vj, causal=False, block_q=64, block_k=64,
                       interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=False)
    close(kernel, got, dtype)


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 16),
                            torch.zeros(1, 8, 3, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("causal,window,s,s_kv,refused", [
    (True, 8, 40, 10, True), (True, 8, 18, 10, True),
    (True, 8, 17, 10, False), (True, 0, 40, 10, False),
    (False, 8, 40, 10, False), (True, 8, 40, 40, False)])
def test_flash_attention_refuses_rows_without_keys(causal, window, s, s_kv,
                                                   refused):
    """Causal with a window, query row i sees keys (i - window, i]: rows
    from s_kv + window - 1 on see none, where the plain version averages
    v over masked keys and the TPU kernel writes 0.  Such inputs are
    refused on every device; all others pass."""
    q = torch.randn(1, s, 2, 16)
    k = v = torch.randn(1, s_kv, 2, 16)
    if refused:
        with pytest.raises(ValueError, match="without a visible key"):
            ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert got.shape == q.shape and bool(torch.isfinite(got).all())


def test_bf16_staging_check():
    """The bf16 kernel copies 16 bytes at a time: q, k and v slices of a
    fused projection pass; a base or a stride off the 8-value grid is
    refused with a ValueError that names it."""
    qkv = torch.zeros(2, 96, 12, 64, dtype=torch.bfloat16)
    ops.check_staging(*qkv.split(4, dim=2))
    odd_base = torch.zeros(2 * 96 * 4 * 64 + 1, dtype=torch.bfloat16)[1:]
    odd_base = odd_base.view(2, 96, 4, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.check_staging(qkv[:, :, :4], odd_base, odd_base)
    padded = torch.zeros(2, 96, 4, 72, dtype=torch.bfloat16)[..., :64]
    ops.check_staging(padded, padded, padded)
    odd_stride = torch.zeros(2, 96, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.check_staging(odd_stride, odd_stride, odd_stride)


# (s, o, n, window, prefix): query rows [o, o + n) of an s-row sequence
# with q_offset = o; causal, windowed (at and past the window's reach),
# with a prefix the rows start inside, end inside and lie past; one row
OFFSET_CASES = [(64, 32, 32, 0, 0), (64, 17, 20, 0, 0), (64, 0, 64, 0, 0),
                (64, 40, 24, 16, 0), (64, 5, 30, 16, 0), (64, 8, 30, 0, 24),
                (64, 16, 8, 0, 24), (64, 48, 16, 0, 24), (64, 63, 1, 0, 0)]


@pytest.mark.parametrize("s,o,n,win,prefix", OFFSET_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_offset_rows_are_those_of_the_whole_sequence(s, o, n, win, prefix,
                                                       dtype):
    """The plain version (and the wrapper on the CPU) on rows [o, o + n)
    with ``q_offset = o`` against those rows of JAX's attention over the
    whole sequence: ``attention_ref``, or with a prefix JAX's
    ``naive_causal_attention`` by M-RoPE temporal positions (the prefix
    at 0, the rest at their index).  1e-6 in f32, the file's tolerance
    in bf16."""
    from repro.models.layers import naive_causal_attention as jax_naive
    (qj, kj, vj), (qt, kt, vt) = inputs(11, 2, s, 4, 2, 16, dtype)
    f32 = [jnp.repeat(a.astype(jnp.float32), r, axis=2)
           for a, r in ((qj, 1), (kj, 2), (vj, 2))]
    if prefix:
        t = jnp.where(jnp.arange(s) < prefix, 0, jnp.arange(s))
        t = jnp.broadcast_to(t, (2, s))
        want = jax_naive(*f32, t, t)
    else:
        want = jax_ref(*f32, causal=True, window=win)
    kw = dict(causal=True, window=win, prefix=prefix, q_offset=o)
    rows = qt[:, o:o + n]
    got = ops.flash_attention_plain(rows, kt, vt, **kw)
    assert got.shape == rows.shape and got.dtype == TDT[dtype]
    tol = 1e-6 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32)[:, o:o + n],
                               atol=tol, rtol=tol)
    assert torch.equal(ops.flash_attention(rows, kt, vt, **kw), got)


@pytest.mark.parametrize("s_kv,o,n,win,prefix", [
    (64, 0, 64, 0, 0), (64, 32, 32, 0, 0), (64, 48, 16, 0, 0),
    (64, 8, 24, 0, 20), (64, 16, 16, 0, 20), (64, 40, 24, 0, 20),
    (64, 0, 20, 0, 20), (64, 32, 16, 8, 0), (64, 48, 16, 16, 0)])
def test_cost_with_offset_is_the_masks_pair_count(s_kv, o, n, win, prefix):
    """``cost`` of rows [o, o + n) counts 4 d flops a (query, key) pair of
    the mask, each diagonal pair of a row at or past the prefix as one
    half (the half-square convention: causal s x s is s^2 / 2); a
    window whose rows all reach back a full window counts every pair
    whole.  The shards of a split sum to the whole."""
    b, h, d = 2, 4, 16
    qi = torch.arange(o, o + n)[:, None]
    ki = torch.arange(s_kv)[None, :]
    mask = ki <= qi
    if win:
        mask &= ki > qi - win
    if prefix:
        mask |= ki < prefix
    pairs = float(mask.sum())
    if not win:
        pairs -= float((torch.arange(o, o + n) >= prefix).sum()) / 2
    flops, nbytes = ops.cost((b, n, h, d), (b, s_kv, h, d), torch.float32,
                             window=win, prefix=prefix, q_offset=o)
    assert flops == 4.0 * b * h * d * pairs
    assert nbytes == 4.0 * (2 * b * n * h * d + 2 * b * s_kv * h * d)
    if not win:
        parts = sum(ops.cost((b, n // 4, h, d), (b, s_kv, h, d),
                             torch.float32, prefix=prefix,
                             q_offset=o + i * n // 4)[0] for i in range(4))
        assert parts == flops


def test_q_offset_refusals():
    """A negative offset is refused, and with a window the rule for rows
    without a visible key reads the global rows: rows [o, o + s) of a
    window over s_kv keys are refused once o + s >= s_kv + window."""
    q = torch.randn(1, 8, 2, 16)
    k = v = torch.randn(1, 16, 2, 16)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="without a visible key"):
        ops.flash_attention(q, k, v, window=4, q_offset=12)
    got = ops.flash_attention(q, k, v, window=4, q_offset=11)
    assert bool(torch.isfinite(got).all())
