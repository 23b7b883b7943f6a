"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU.

Inputs are drawn with numpy from a seed; the expert parameters are those
of ``Model.init`` in JAX (layer 0), carried across by
``params_from_jax``.  Covered: ``route_topk`` on tied router
probabilities (``jax.lax.top_k`` puts the lower index first),
``load_balance_loss``, and ``apply_moe`` on ``smoke(olmoe-1b-7b)`` and
``smoke(mixtral-8x22b)`` at capacity factor 8 (dropless, C clipped to
T*K), 1.0 and 0.5 (tokens dropped), plus a sequence of 8192 tokens that
takes the group subdivision with G > 1.  Tolerances:

* f32: 1e-5 on y, 1e-6 on aux (other summation orders: ~3e-8 seen);
* bf16: 2e-2 on y against JAX run op by op (``jax.disable_jit``), where
  XLA rounds to bf16 at every op boundary as eager PyTorch does.  The
  port's expert FFN (``expert_mlp``) keeps h in f32, as the TPU kernel
  does, where JAX's einsum path rounds it to bf16 (seen: 9.8e-4, one
  bf16 ulp of y).  aux is computed in f32 from the router logits: 1e-6.
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import moe

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "mixtral-8x22b"])
def arch(request):
    """(jax cfg, port cfg, layer-0 expert params as numpy, as torch f32)."""
    name = request.param
    jcfg, cfg = jax_smoke(jax_get_config(name)), smoke(get_config(name))
    jp = jax.tree.map(np.asarray,
                      jax_build_model(jcfg).init(jax.random.PRNGKey(2)))
    tp = params_from_jax(jp, cfg, "cpu")
    ffn = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    return jcfg, cfg, ffn, {k: v[0] for k, v in tp["layers"]["ffn"].items()}


def run_both(jcfg, cfg, ffn, tffn, x, dtype):
    jp = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), ffn)
    jx = jnp.asarray(x, JDT[dtype])
    if dtype == "float32":
        jy, jaux = jmoe.apply_moe(jp, jx, jcfg)
    else:
        with jax.disable_jit():
            jy, jaux = jmoe.apply_moe(jp, jx, jcfg)
    tp = {k: v.to(TDT[dtype]) for k, v in tffn.items()}
    ty, taux = moe.apply_moe(tp, torch.tensor(x).to(TDT[dtype]), cfg)
    assert ty.dtype == TDT[dtype] and ty.shape == x.shape
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), atol=AUX_TOL,
                               rtol=AUX_TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_topk_breaks_ties_toward_lower_index(k):
    logits = np.array([[[1.0, 3.0, 3.0, 0.0, 3.0],
                        [2.0, 2.0, 2.0, 2.0, 2.0],
                        [0.5, -1.0, 0.5, 0.5, -1.0]]], np.float32)
    jg, ji = jmoe.route_topk(jnp.asarray(logits), k)
    tg, ti = moe.route_topk(torch.tensor(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
    assert ti[0, 1].tolist() == list(range(k))


@pytest.mark.parametrize("shape", [(2, 8, 4, 2), (1, 64, 8, 3)])
def test_load_balance_loss_matches_jax(shape):
    *lead, e, k = shape
    rng = np.random.default_rng(sum(shape))
    probs = rng.dirichlet(np.ones(e), size=tuple(lead)).astype(np.float32)
    idx = np.argsort(-probs, axis=-1)[..., :k]
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), e)
    got = moe.load_balance_loss(torch.tensor(probs), torch.tensor(idx), e)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_apply_moe_matches_jax(arch, cf, dtype):
    jcfg, cfg, ffn, tffn = arch
    jcfg, cfg = (replace(c, capacity_factor=cf) for c in (jcfg, cfg))
    b, s = 2, 16
    x = np.random.default_rng(4).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    e, k = cfg.n_experts, cfg.top_k
    cap = min(max(1, math.ceil(k * s * cf / e)), s * k)
    _, idx = moe.route_topk(torch.einsum(
        "bsd,de->bse", torch.tensor(x), tffn["router"]), k)
    load = max(int((idx[i] == j).sum()) for i in range(b) for j in range(e))
    if cf == 8.0:
        assert cap == s * k                  # clipped to T*K, dropless
    else:
        assert load > cap                    # some slots drop
    run_both(jcfg, cfg, ffn, tffn, x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_subdivides_long_groups(arch, dtype):
    """S = 2 * MAX_GROUP_TOKENS: each batch row splits into two groups,
    so G = 4 for B = 2."""
    jcfg, cfg, ffn, tffn = arch
    assert moe.MAX_GROUP_TOKENS == jmoe.MAX_GROUP_TOKENS == 4096
    x = np.random.default_rng(5).standard_normal(
        (2, 2 * moe.MAX_GROUP_TOKENS, cfg.d_model)).astype(np.float32)
    run_both(jcfg, cfg, ffn, tffn, x, dtype)


def test_apply_moe_cpu_takes_no_kernel(arch):
    """On the CPU ``expert_mlp`` takes its plain version: no launch."""
    jcfg, cfg, ffn, tffn = arch
    from repro_torch.kernels.moe_mlp.ops import expert_mlp
    n0 = expert_mlp.launches
    moe.apply_moe(tffn, torch.zeros(1, 4, cfg.d_model), cfg)
    assert expert_mlp.launches == n0
