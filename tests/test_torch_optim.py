"""The port's optimizer and schedules (``repro_torch.optim``) against the
JAX package's (``repro.optim``) on the CPU.

Inputs are drawn with numpy from a seed.  Tolerances: 1e-6 relative
throughout.  The schedules compute in f32 tensors as JAX does; AdamW and
the clip do the same f32 elementwise arithmetic (``pow`` of the bias
corrections and the sums of the global norm may round differently, by
an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import global_norm as jax_global_norm
from repro.optim import wsd_schedule as jax_wsd
from repro_torch.models.common import leaves
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, global_norm, wsd_schedule)

RTOL = 1e-6


@pytest.mark.parametrize("step", [0, 1, 7, 10, 55, 110, 115, 160, 200])
def test_wsd_schedule_matches_jax(step):
    """Steps at 0, 1, in the warmup, at its end, mid-stable, at the start
    of the decay, in it, at its end and past it."""
    kw = dict(peak_lr=1e-3, warmup=10, stable=100, decay=50)
    got = wsd_schedule(step, **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(jax_wsd(step, **kw)),
                               rtol=RTOL)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 99, 100, 130])
def test_cosine_schedule_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_cosine(step, **kw)),
                               rtol=RTOL)


def test_schedule_phases():
    """tests/test_optim.py's phase checks, on the port."""
    peak = 1e-3
    lr = lambda s: float(wsd_schedule(s, peak, 10, 100, 50))  # noqa: E731
    assert lr(0) == 0.0 and lr(5) == pytest.approx(peak / 2)
    assert lr(60) == pytest.approx(peak) and lr(115) < peak
    assert lr(160) == pytest.approx(peak * 0.1, rel=1e-3)
    assert float(cosine_schedule(100, 1.0, 10, 100)) == pytest.approx(0.1)


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((4, 8)) * scale).astype(np.float32),
            "layer": {"b": (rng.standard_normal(8) * scale).astype(np.float32),
                      "a": (rng.standard_normal((2, 3, 5)) * scale
                            ).astype(np.float32)}}


def _close(want_tree, got_tree, rtol=RTOL, atol=0.0):
    for want, got in zip(jax.tree.leaves(want_tree), leaves(got_tree)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments):
    """Four steps from the same params with fresh gradients each step;
    the bias corrections change at every step."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(torch.as_tensor, p0)
    js = jax_adamw_init(jp, jnp.dtype(moments))
    ts = adamw_init(tp, getattr(torch, moments))
    for i in range(4):
        g = _tree(rng, scale=0.1)
        lr = 1e-2 * (i + 1)
        jp, js = jax_adamw_update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        tp2, ts = adamw_update(jax.tree.map(torch.as_tensor, g), ts, tp,
                               torch.tensor(lr, dtype=torch.float32))
        assert tp2 is tp                        # updated in place
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert all(m.dtype == getattr(torch, moments)
                   for m in leaves(ts["m"]))
        # bf16 moments: one rounding of m and v to bf16 per step, the
        # same on both sides, so the same f32 math stays within 1e-6
        _close(jp, tp)
        _close(js["m"], ts["m"])
        _close(js["v"], ts["v"])


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        params, state = adamw_update({"w": 2 * params["w"]}, state, params,
                                     lr=0.1, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1), scale=3.0)
    jc, jn = jax_clip(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = clip_by_global_norm(jax.tree.map(torch.as_tensor, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    np.testing.assert_allclose(float(global_norm(tc)),
                               float(jax_global_norm(jc)), rtol=RTOL)
    _close(jc, tc)
    if max_norm == 1.0:
        assert float(global_norm(tc)) == pytest.approx(1.0, rel=1e-5)


def _stacked(rng, dtype):
    """A stacked leaf (6 layers of (5, 7)), a matrix, a vector and a
    scalar, drawn with numpy and cast to ``dtype``."""
    return {"stack": torch.as_tensor(rng.standard_normal((6, 5, 7)),
                                     dtype=torch.float32).to(dtype),
            "w": torch.as_tensor(rng.standard_normal((3, 4)),
                                 dtype=torch.float32).to(dtype),
            "b": torch.as_tensor(rng.standard_normal(7),
                                 dtype=torch.float32).to(dtype),
            "s": torch.tensor(0.5, dtype=dtype)}


def _three_steps(monkeypatch, chunk_bytes, dtype, moments, mesh=None):
    """Three AdamW steps with ``UPDATE_CHUNK_BYTES`` = ``chunk_bytes``
    from the same seeded params and gradients: the params and moments
    after them, as plain tensors.  On ``mesh`` every leaf is a
    replicated DTensor (the update then runs on the local shards)."""
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "UPDATE_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(3)
    params = _stacked(rng, dtype)
    state = adamw_init(params, moments)
    grads = [_stacked(rng, dtype) for _ in range(3)]
    if mesh is not None:
        from torch.distributed.tensor import Replicate, distribute_tensor

        def put(t):
            return distribute_tensor(t, mesh, [Replicate()] * 2)
        params = {k: put(v) for k, v in params.items()}
        state = {"m": {k: put(v) for k, v in state["m"].items()},
                 "v": {k: put(v) for k, v in state["v"].items()},
                 "count": put(state["count"])}
        grads = [{k: put(v) for k, v in g.items()} for g in grads]
    for i, g in enumerate(grads):
        params, state = adamw_update(g, state, params,
                                     torch.tensor(1e-2 * (i + 1)))
    return [(t.to_local() if hasattr(t, "to_local") else t).clone()
            for t in leaves((params, state["m"], state["v"]))]


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_update_is_the_one_pass_update_bit_for_bit(monkeypatch, dtype,
                                                           moments):
    """``adamw_update`` passes a leaf a few rows at a time
    (``UPDATE_CHUNK_BYTES`` of f32): at 2 rows of the stacked leaf a
    pass (3 passes) and at one row of every leaf a pass (4 bytes), the
    params and moments after three steps equal those of one pass per
    leaf bit for bit, f32 and bf16 params and moments."""
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "UPDATE_CHUNK_BYTES", 2 * 5 * 7 * 4)
    assert adamw._rows_per_pass(torch.empty(6, 5, 7)) == 2
    assert adamw._rows_per_pass(torch.empty(7)) == 70
    one = _three_steps(monkeypatch, 1 << 40, dtype, moments)
    chunked = _three_steps(monkeypatch, 2 * 5 * 7 * 4, dtype, moments)
    bytewise = _three_steps(monkeypatch, 4, dtype, moments)
    for a, b, c in zip(one, chunked, bytewise):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)


def test_chunked_update_on_local_shards_is_the_plain_update(monkeypatch):
    """On the (1, 1) mesh of a world-1 gloo group, every leaf a
    DTensor laid out as its gradient and moments are: the update runs on
    the local shards, chunked, and equals the plain tensors' bit for
    bit (bf16 params, bf16 moments)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    plain = _three_steps(monkeypatch, 2 * 5 * 7 * 4, torch.bfloat16,
                         torch.bfloat16)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        sharded = _three_steps(monkeypatch, 2 * 5 * 7 * 4, torch.bfloat16,
                               torch.bfloat16, mesh)
    finally:
        dist.destroy_process_group()
    for a, b in zip(plain, sharded):
        assert torch.equal(a, b)
