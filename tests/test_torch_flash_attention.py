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

