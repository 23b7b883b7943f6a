"""The port's Mamba block (``repro_torch.models.mamba``) against the JAX
package's (``repro.models.mamba``), at ``smoke(jamba-v0.1-52b)``'s widths
(d_model 64, d_inner 128, d_state 16, d_conv 4), on seeded numpy inputs.

The block comes from JAX's ``init_mamba_block`` and is then perturbed
(``perturb``): the init leaves ``conv_b`` and ``dt_bias`` at zero, ``D``
at one and ``A_log`` at log(1..n) on every channel, which would hide a
port that dropped the conv bias, the dt bias or the skip scale.  The
noise: conv_b 0.1 N(0, 1), dt_bias uniform on [-4, 1] (steps dt from
~0.02 to ~1.3), D 1 + 0.2 N(0, 1), A_log + 0.3 N(0, 1).

Tolerances:

* the causal conv, the SSM parameters and the decode step (f32): 1e-6.
  Both packages run the same f32 arithmetic, op for op.
* the chunked scan (f32): 1e-5 of each tensor's largest magnitude.  The
  port scans a chunk by doubling (Hillis-Steele) where XLA's
  ``associative_scan`` combines in another tree, and the port cuts a
  ragged s into chunks of ``chunk`` tokens plus a shorter last one where
  JAX takes one chunk of s: the same recurrence with its f32 products
  in another order.
* ``apply_mamba`` (f32): 1e-5 against compiled JAX; bf16 against JAX run
  op by op (``jax.disable_jit``): 2e-2, as ``tests/test_torch_model.py``.
* A prefill then one decode step against a prefill one token longer
  (f32, the port alone): 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import mamba as jmm
from repro.models.common import IDENTITY_SHARDER, unzip
from repro_torch.configs import get_config, smoke
from repro_torch.models import mamba as tmm

ARCH = "jamba-v0.1-52b"
EXACT = 1e-6
SCAN_TOL = 1e-5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def perturb(block, seed: int = 0):
    """A copy of the JAX block with its constant-initialised leaves
    replaced by seeded noise (see the module docstring)."""
    rng = np.random.default_rng(seed)
    p = {k: np.array(v, np.float32) for k, v in block.items()}
    p["conv_b"] = 0.1 * rng.standard_normal(p["conv_b"].shape)
    p["dt_bias"] = rng.uniform(-4.0, 1.0, p["dt_bias"].shape)
    p["D"] = 1.0 + 0.2 * rng.standard_normal(p["D"].shape)
    p["A_log"] = p["A_log"] + 0.3 * rng.standard_normal(p["A_log"].shape)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_smoke(jax_get_config(ARCH)), smoke(get_config(ARCH))
    block, _ = unzip(jmm.init_mamba_block(jax.random.PRNGKey(0), jcfg))
    p = perturb(jax.tree.map(np.asarray, block))
    return jcfg, cfg, p


def jparams(p, dtype="float32"):
    return {k: jnp.asarray(v, JDT[dtype]) for k, v in p.items()}


def tparams(p, dtype="float32"):
    return {k: torch.tensor(v).to(TDT[dtype]) for k, v in p.items()}


def close(jax_out, torch_out, tol, rel=False):
    want = np.asarray(jax_out, np.float32)
    got = torch_out.detach().float().numpy()
    if rel:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_init_matches_the_jax_block(setup):
    """The same keys and shapes; A_log the same deterministic S4D-real
    init, log(1..n), to one f32 ulp (XLA's log and PyTorch's round one of
    the 16 values apart)."""
    jcfg, cfg, _ = setup
    block, _ = unzip(jmm.init_mamba_block(jax.random.PRNGKey(0), jcfg))
    mine = tmm.init_mamba_block(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in block.items()}
    np.testing.assert_allclose(mine["A_log"].numpy(),
                               np.asarray(block["A_log"]), rtol=2 ** -23,
                               atol=0)
    assert tmm.dt_rank(cfg) == jmm.dt_rank(jcfg) == 4
    assert not mine["conv_b"].any() and bool((mine["D"] == 1).all())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 9])
def test_causal_conv_matches_jax(setup, s, with_state):
    _, cfg, p = setup
    x = normal(1, 2, s, cfg.d_inner)
    st = normal(2, 2, cfg.d_conv - 1, cfg.d_inner) if with_state else None
    jy, jst = jmm._causal_conv(jparams(p), jnp.asarray(x),
                               None if st is None else jnp.asarray(st))
    ty, tst = tmm._causal_conv(tparams(p), torch.tensor(x),
                               None if st is None else torch.tensor(st))
    assert tuple(tst.shape) == (2, cfg.d_conv - 1, cfg.d_inner)
    close(jy, ty, EXACT)
    close(jst, tst, EXACT)


def test_ssm_params_match_jax(setup):
    jcfg, cfg, p = setup
    xc = normal(3, 2, 11, cfg.d_inner)
    jo = jmm._ssm_params(jparams(p), jnp.asarray(xc), jcfg)
    to = tmm._ssm_params(tparams(p), torch.tensor(xc), cfg)
    for a, b in zip(jo, to):
        assert b.dtype == torch.float32
        close(a, b, EXACT)


def test_softplus_is_jax_softplus():
    """The same formula as ``jax.nn.softplus``, to two f32 ulps (XLA's
    exp and log1p and PyTorch's round apart), from e^-40 to 40."""
    x = np.linspace(-40.0, 40.0, 1001, dtype=np.float32)
    np.testing.assert_allclose(
        tmm._softplus(torch.tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2 ** -22, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (37, 16), (5, 16), (16, 16)])
def test_selective_scan_matches_jax(setup, s, chunk, with_state):
    """Four chunks of 16; a ragged s (one chunk of 37 in JAX, 16 + 16 + 5
    in the port); s under one chunk; exactly one chunk."""
    jcfg, cfg, p = setup
    xc = normal(4, 2, s, cfg.d_inner)
    h0 = (normal(5, 2, cfg.d_inner, cfg.d_state) if with_state else None)
    jy, jh = jmm.selective_scan_chunked(
        jparams(p), jnp.asarray(xc), jcfg,
        None if h0 is None else jnp.asarray(h0), chunk)
    ty, th = tmm.selective_scan_chunked(
        tparams(p), torch.tensor(xc), cfg,
        None if h0 is None else torch.tensor(h0), chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert tuple(th.shape) == (2, cfg.d_inner, cfg.d_state)
    close(jy, ty, SCAN_TOL, rel=True)
    close(jh, th, SCAN_TOL, rel=True)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 13, 64])
def test_doubling_scan_is_the_recurrence(n):
    """The doubling scan's cumulative maps against the recurrence run
    token by token, at lengths on both sides of powers of two."""
    rng = np.random.default_rng(n)
    a = torch.tensor(rng.uniform(0.0, 1.0, (2, n, 3, 4)), dtype=torch.float64)
    b = torch.tensor(rng.standard_normal((2, n, 3, 4)), dtype=torch.float64)
    ca, cb = tmm._doubling_scan(a, b)
    pa, pb = torch.ones_like(a[:, 0]), torch.zeros_like(b[:, 0])
    for t in range(n):
        pa, pb = a[:, t] * pa, a[:, t] * pb + b[:, t]
        torch.testing.assert_close(ca[:, t], pa, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(cb[:, t], pb, rtol=1e-12, atol=1e-12)


def test_decode_step_matches_jax(setup):
    """One token with carried conv and ssm states: the single-step
    recurrence in both packages."""
    jcfg, cfg, p = setup
    x = normal(6, 3, 1, cfg.d_model)
    conv = normal(7, 3, cfg.d_conv - 1, cfg.d_inner)
    ssm = normal(8, 3, cfg.d_inner, cfg.d_state)
    jo = jmm.apply_mamba(jparams(p), jnp.asarray(x), jcfg, IDENTITY_SHARDER,
                         jnp.asarray(conv), jnp.asarray(ssm))
    to = tmm.apply_mamba(tparams(p), torch.tensor(x), cfg,
                         torch.tensor(conv), torch.tensor(ssm))
    for a, b in zip(jo, to):
        close(a, b, EXACT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 40])
def test_apply_mamba_matches_jax(setup, s, dtype):
    """A prefill from zero states (a one-token prefill too: no ssm state,
    so the scan, as in JAX)."""
    jcfg, cfg, p = setup
    x = normal(9, 2, s, cfg.d_model)
    if dtype == "float32":
        jo = jmm.apply_mamba(jparams(p), jnp.asarray(x), jcfg, chunk=16)
    else:
        with jax.disable_jit():
            jo = jmm.apply_mamba(jparams(p, dtype),
                                 jnp.asarray(x, jnp.bfloat16), jcfg,
                                 chunk=16)
    to = tmm.apply_mamba(tparams(p, dtype), torch.tensor(x).to(TDT[dtype]),
                         cfg, chunk=16)
    assert to[0].dtype == TDT[dtype] and to[2].dtype == torch.float32
    for a, b in zip(jo, to):
        close(a, b, TOL[dtype])


def test_prefill_then_step_is_a_longer_prefill(setup):
    """The state handoff: a prefill of s tokens, then one decode step from
    its conv and ssm states, gives the last output of a prefill of s + 1."""
    _, cfg, p = setup
    tp = tparams(p)
    x = torch.tensor(normal(10, 2, 38, cfg.d_model))
    for s in (37, 32):
        _, conv, ssm = tmm.apply_mamba(tp, x[:, :s], cfg, chunk=16)
        step, _, _ = tmm.apply_mamba(tp, x[:, s:s + 1], cfg, conv, ssm)
        longer, _, _ = tmm.apply_mamba(tp, x[:, :s + 1], cfg, chunk=16)
        torch.testing.assert_close(step[:, 0], longer[:, -1], atol=TOL[
            "float32"], rtol=TOL["float32"])


def test_train_mode_gradients_match_jax(setup):
    """f32 gradients of a fixed projection of the block's output, every
    leaf, with each chunk checkpointed (``remat``) in both packages."""
    jcfg, cfg, p = setup
    x = normal(11, 2, 40, cfg.d_model)
    proj = normal(12, 2, 40, cfg.d_model)

    def jloss(jp):
        out, _, _ = jmm.apply_mamba(jp, jnp.asarray(x), jcfg, chunk=16)
        return jnp.sum(out * proj)

    jg = jax.grad(jloss)(jparams(p))
    tp = {k: v.requires_grad_(True) for k, v in tparams(p).items()}
    out, _, _ = tmm.apply_mamba(tp, torch.tensor(x), cfg, chunk=16)
    (out * torch.tensor(proj)).sum().backward()
    for k, t in tp.items():
        want = np.asarray(jg[k])
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max())
                                   + 1e-7, err_msg=k)
        assert bool(t.grad.abs().sum() > 0), k
