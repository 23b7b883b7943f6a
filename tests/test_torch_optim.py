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
