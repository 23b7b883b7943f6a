"""The port's int8 block quantization (``repro_torch.kernels.quantize``,
``repro_torch.optim.compress``) against the JAX package's on the CPU.

Inputs are drawn with numpy from a seed.  On the CPU the wrappers take
the plain version (``quantize_plain``), the oracle the CUDA kernel is
held to bit for bit on the card (``tests/test_torch_gpu.py``).
Tolerances:

* q and the scales are bit-exact against JAX run op by op
  (``jax.disable_jit``), which computes ``absmax / 127`` and
  ``x / scale`` as IEEE quotients, as the port does.
* Against compiled JAX (``jax.jit(int8_block_quantize)``) and the Pallas
  kernel in interpret mode (also jitted), the scales agree within one
  ulp: XLA computes ``absmax / 127.0`` as ``absmax * (1 / 127)``.  q is
  then compared with the plain version applied to JAX's own scales, bit
  for bit.
* ``compress_gradients`` over 5 steps of error feedback: dequantized
  gradients and error buffers bit-exact against ``jax.disable_jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize.ops import quantize as jax_pallas_quantize
from repro.optim.compress import compress_gradients as jax_compress
from repro.optim.compress import init_error_buffer as jax_init_error_buffer
from repro.optim.compress import int8_block_quantize as jax_quantize
from repro_torch.kernels.quantize import ops
from repro_torch.kernels.quantize.ref import quantize_plain
from repro_torch.optim.compress import (compress_gradients, init_error_buffer,
                                        int8_block_dequantize,
                                        int8_block_quantize)

SIZES = [256, 1000, 4096, 65536]          # tests/test_kernels.py:101


def draw(n, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def ulps(a, b):
    """Distance in units in the last place between positive f32 arrays."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_is_bit_exact_against_jax_op_by_op(n, block):
    x = draw(n, seed=n)
    with jax.disable_jit():
        jq, js, jpad = jax_quantize(jnp.asarray(x), block=block)
    for fn in (int8_block_quantize, lambda t, b: ops.quantize(t, block=b)):
        q, s, pad = fn(torch.as_tensor(x), block)
        assert pad == jpad == (-n) % block
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_against_compiled_jax_and_the_pallas_kernel(n, block):
    x = draw(n, seed=n + 1)
    q, s, pad = ops.quantize(torch.as_tensor(x), block=block)
    blocks = np.pad(x, (0, pad)).reshape(-1, block)
    for jq, js, jpad in (
            jax.jit(jax_quantize, static_argnums=1)(jnp.asarray(x), block),
            jax_pallas_quantize(jnp.asarray(x), block=block, interpret=True)):
        assert jpad == pad
        js = np.asarray(js)
        assert ulps(s.numpy(), js).max() <= 1
        # with JAX's scales, the plain version's q is JAX's q
        want_q = np.clip(np.round(blocks / js[:, None]), -127, 127)
        np.testing.assert_array_equal(np.asarray(jq), want_q.astype(np.int8))


def test_quantize_edge_rows():
    """Exact half-quanta (round half to even), an all-zero row, rows of
    absmax 1e-30 and 1e30, and a ragged tail."""
    rows = np.zeros((5, 256), np.float32)
    k = np.arange(-127, 127, dtype=np.float32)
    rows[0, :254] = (k + 0.5) * 0.5            # x / scale = k + 0.5
    rows[0, 254] = 63.5                        # absmax 63.5: scale 0.5
    rows[2] = draw(256, 1) * 1e-30 / 3
    rows[3] = draw(256, 2) * 1e30 / 3
    rows[4] = draw(256, 3)
    x = np.concatenate([rows.reshape(-1), draw(77, 4)])
    with jax.disable_jit():
        jq, js, _ = jax_quantize(jnp.asarray(x))
    q, s, pad = ops.quantize(torch.as_tensor(x))
    assert pad == 256 - 77
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0]) == 0.5
    # x / scale = k + 0.5 exactly: half to even
    np.testing.assert_array_equal(q[0, :254].numpy(), np.round(k + 0.5))
    assert int(q[0, 0]) == -126 and int(q[0, 1]) == -126  # -126.5, -125.5
    assert float(s[1]) == np.float32(1e-12) and not q[1].any()
    assert float(s[2]) == np.float32(1e-12) and not q[2].any()
    assert np.abs(q[3].numpy()).max() == 127


def test_quantize_blocks_checks_its_input():
    with pytest.raises(TypeError, match="float32"):
        ops.quantize_blocks(torch.zeros(2, 256, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="contiguous"):
        ops.quantize_blocks(torch.zeros(256, 2).t())
    with pytest.raises(ValueError, match="nb"):
        ops.quantize_blocks(torch.zeros(0, 256))
    n0 = ops.quantize.launches
    q, s = ops.quantize_blocks(torch.ones(3, 128))
    assert ops.quantize.launches == n0          # the CPU launches nothing
    assert q.shape == (3, 128) and bool((q == 127).all())
    np.testing.assert_array_equal(
        quantize_plain(torch.ones(3, 128))[1].numpy(), s.numpy())


def test_dequantize_roundtrip_error_is_at_most_half_a_quantum():
    x = draw(1000, 9, scale=5.0)
    q, s, pad = int8_block_quantize(torch.as_tensor(x), block=128)
    deq = int8_block_dequantize(q, s, pad, x.shape).numpy()
    scales = np.repeat(s.numpy(), 128)[:1000]
    assert (np.abs(deq - x) <= scales / 2 + 1e-6).all()


def _tree(rng):
    """A parameter-shaped tree whose leaves are not multiples of the
    block, so that each leaf pads on its own."""
    return {"a": {"w": rng.standard_normal((3, 70)).astype(np.float32)},
            "b": rng.standard_normal(300).astype(np.float32) * 1e-3,
            "c": rng.standard_normal((2, 2, 64)).astype(np.float32) * 10}


def test_compress_gradients_five_steps_bit_exact_against_jax():
    rng = np.random.default_rng(0)
    shapes = _tree(rng)
    jerr = jax_init_error_buffer(jax.tree.map(jnp.asarray, shapes))
    terr = init_error_buffer(jax.tree.map(torch.as_tensor, shapes))
    for _ in range(5):
        g = _tree(rng)
        with jax.disable_jit():
            jdeq, jerr = jax_compress(jax.tree.map(jnp.asarray, g), jerr)
        tdeq, terr = compress_gradients(jax.tree.map(torch.as_tensor, g),
                                        terr)
        for want, got in zip(jax.tree.leaves((jdeq, jerr)),
                             jax.tree.leaves((tdeq, terr))):
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_error_feedback_sum_invariant():
    """tests/test_optim.py's invariant: the sum of the compressed
    gradients plus the final error is the sum of the true gradients."""
    rng = np.random.default_rng(0)
    grads_seq = [torch.as_tensor(rng.normal(size=(512,)).astype(np.float32))
                 for _ in range(20)]
    err = init_error_buffer({"w": torch.zeros(512)})
    applied = torch.zeros(512)
    for g in grads_seq:
        deq, err = compress_gradients({"w": g}, err)
        applied = applied + deq["w"]
    true = sum(g.numpy() for g in grads_seq)
    residual = err["w"].numpy()
    np.testing.assert_allclose(applied.numpy() + residual, true, atol=1e-3)
    assert np.linalg.norm(residual) < 0.05 * np.linalg.norm(true) + 1.0
