"""The port's fused expert MLP against the JAX package's.

On the CPU, ``repro_torch.kernels.moe_mlp.ops.expert_mlp`` takes its
plain version; here it is held against JAX's Pallas kernel
(``interpret=True``) and JAX's ``expert_mlp_ref`` over the sweep of
``tests/test_kernels.py``, and against ``expert_mlp_ref`` alone at
ragged capacities, which the Pallas kernel rejects (``C % block_c``).
Tolerances are ``test_kernels.py``'s: 1e-4 in f32, 3e-2 in bf16.

The CUDA kernel itself is tested on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_mlp.ops import expert_mlp as jax_expert_mlp
from repro.kernels.moe_mlp.ref import expert_mlp_ref as jax_ref
from repro_torch.kernels.moe_mlp import ops

# (g, e, c, d, f, block_c, block_f): tests/test_kernels.py
SWEEP = [(2, 4, 128, 64, 256, 64, 128), (1, 2, 64, 128, 512, 64, 256),
         (2, 2, 128, 32, 128, 128, 128)]
# (g, e, c, d, f): ragged capacity, as decode (C=1) and short prompts give
RAGGED = [(1, 4, 1, 64, 256), (4, 4, 1, 32, 128), (1, 4, 25, 64, 256),
          (2, 3, 25, 128, 128)]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(seed, g, e, c, d, f, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((g, e, c, d)),
            rng.standard_normal((e, d, f)) / np.sqrt(d),
            rng.standard_normal((e, d, f)) / np.sqrt(d),
            rng.standard_normal((e, f, d)) / np.sqrt(f)]
    arrs = [a.astype(np.float32) for a in arrs]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.tensor(a).to(TDT[dtype]) for a in arrs])


def close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def f32_ref(jx):
    return jax_ref(*(a.astype(jnp.float32) for a in jx))


@pytest.mark.parametrize("g,e,c,d,f,bc,bf", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_mlp_sweep(g, e, c, d, f, bc, bf, dtype):
    jx, tx = inputs(11, g, e, c, d, f, dtype)
    kernel = jax_expert_mlp(*jx, block_c=bc, block_f=bf, interpret=True)
    n0 = ops.expert_mlp.launches
    got = ops.expert_mlp(*tx)
    assert ops.expert_mlp.launches == n0          # the CPU runs no kernel
    assert got.dtype == TDT[dtype] and got.shape == (g, e, c, d)
    close(kernel, got, dtype)
    close(f32_ref(jx), got, dtype)
    close(f32_ref(jx), ops.expert_mlp_plain(*tx), dtype)


@pytest.mark.parametrize("g,e,c,d,f", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_mlp_ragged_capacity(g, e, c, d, f, dtype):
    jx, tx = inputs(12, g, e, c, d, f, dtype)
    close(f32_ref(jx), ops.expert_mlp(*tx), dtype)


def test_expert_mlp_plain_matches_jax_ref():
    """The plain versions agree in f32 (the port's silu is h*sigmoid(h))."""
    jx, tx = inputs(13, 2, 3, 5, 32, 128, "float32")
    np.testing.assert_allclose(ops.expert_mlp_plain(*tx).numpy(),
                               np.asarray(jax_ref(*jx)), atol=1e-6,
                               rtol=1e-6)


def test_expert_mlp_rejects_bad_inputs():
    x = torch.zeros(1, 2, 4, 32)
    wi = torch.zeros(2, 32, 128)
    wo = torch.zeros(2, 128, 32)
    with pytest.raises(ValueError, match="do not fit"):
        ops.expert_mlp(x, wi, wi, wo.transpose(1, 2))
    with pytest.raises(ValueError, match="do not fit"):
        ops.expert_mlp(x, wi[:1], wi[:1], wo[:1])
    with pytest.raises(TypeError):
        ops.expert_mlp(x.half(), wi.half(), wi.half(), wo.half())
    with pytest.raises(TypeError):
        ops.expert_mlp(x, wi.bfloat16(), wi, wo)
    with pytest.raises(ValueError, match="want x"):
        ops.expert_mlp(x[0], wi, wi, wo)


@pytest.mark.parametrize("f,tile", [(14336, 1024), (16384, 1024),
                                    (1152, 384), (3072, 1024), (896, 896),
                                    (128 * 13, 128)])
def test_split_tile_divides_d_ff(f, tile):
    """The split schedule's d_ff tile: the largest multiple of 128 that
    divides d_ff and is at most MAX_F_TILE (jamba-v0.1-52b's 14336 and
    mixtral-8x22b's 16384 walk 14 and 16 tiles of 1024)."""
    got = ops.split_tile(f)
    assert got == tile and f % got == 0 and got % 128 == 0
    assert got <= ops.MAX_F_TILE
