"""Parity of the port's dense LM (``repro_torch.models``) with
``repro.models.transformer.lm_apply``: prefill logits and caches, then 4
decode steps that continue from the prefill cache, for
``smoke(stablelm-1.6b)`` (LayerNorm, partial RoPE) and
``smoke(deepseek-67b)`` (RMSNorm, GQA with one kv head).

Parameters are initialised once in JAX (``Model.init``) and converted
with ``params_from_jax``.  Tolerances:

* f32: 1e-5, against the JAX function as compiled (``lax.scan``).  The
  two sum in other orders; the observed gap is ~2e-6 on logits of ~3.
* bf16: 2e-2, against the JAX function run op by op
  (``jax.disable_jit``), where XLA rounds to bf16 at every op boundary
  as eager PyTorch does.  Compiled XLA fuses elementwise chains and
  skips roundings, which moves single logits by up to ~0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtf
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ["stablelm-1.6b", "deepseek-67b"]


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    arch = request.param
    jcfg, cfg = jax_smoke(jax_get_config(arch)), smoke(get_config(arch))
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, jax.tree.map(np.asarray, jp)


def close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(arch_params, dtype):
    jcfg, cfg, jp, np_params = arch_params
    tp = params_from_jax(np_params, cfg, "cpu")
    rng = np.random.default_rng(0)
    b, s, cap = 2, 12, 24
    toks = rng.integers(0, cfg.vocab_size, (b, s))

    def jax_apply(*a, **kw):
        if dtype == "float32":
            return jtf.lm_apply(*a, **kw, compute_dtype=jnp.float32)
        with jax.disable_jit():
            return jtf.lm_apply(*a, **kw, compute_dtype=jnp.bfloat16)

    jl, jc, _ = jax_apply(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                          mode="prefill", seq_capacity=cap)
    tl, tc = ttf.lm_apply(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                          mode="prefill", seq_capacity=cap,
                          compute_dtype=TDT[dtype])
    assert tl.shape == (b, 1, 256)
    assert tc["k"].shape == (cfg.n_layers, b, cfg.n_kv_heads, cap,
                             cfg.head_dim)
    close(jl, tl, dtype)
    for n in ("k", "v"):
        close(jc[n], tc[n], dtype)

    cur = s
    tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
    for _ in range(4):
        jl, jc, _ = jax_apply(jp, {"tokens": jnp.asarray(tok, jnp.int32)},
                              jcfg, mode="decode", cache=jc,
                              cur_len=jnp.asarray(cur, jnp.int32))
        tl, tc2 = ttf.lm_apply(tp, {"tokens": torch.as_tensor(tok)}, cfg,
                               mode="decode", cache=tc, cur_len=cur,
                               compute_dtype=TDT[dtype])
        assert tc2 is tc                      # decode writes in place
        close(jl, tl, dtype)
        for n in ("k", "v"):
            close(jc[n], tc[n], dtype)
        tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
        cur += 1


def test_params_from_jax_keeps_key_paths_and_layer_axis(arch_params):
    jcfg, cfg, jp, np_params = arch_params
    tp = params_from_jax(np_params, cfg, "cpu", torch.bfloat16)
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(np_params)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(flat_j) == set(flat_t)
    for k, v in flat_t.items():
        assert v.dtype == torch.bfloat16
        assert tuple(v.shape) == flat_j[k].shape
    assert tp["layers"]["mixer"]["wq"].shape[0] == cfg.n_layers
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(lambda a: a, np_params)
        bad["layers"]["mixer"]["wq"] = bad["layers"]["mixer"]["wq"][:1]
        params_from_jax(bad, cfg, "cpu")


def test_port_init_matches_jax_tree(arch_params):
    """``Model.init`` draws the JAX tree's key paths and shapes, with the
    fan-in scaled normal of ``repro.models.common.param``."""
    jcfg, cfg, jp, np_params = arch_params
    tp = build_model(cfg).init(0, device="cpu")
    flat_j = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(np_params)[0]}
    flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_j == flat_t
    wq = tp["layers"]["mixer"]["wq"]           # (L, d, h, hd): fan-in d*h
    fan_in = cfg.d_model * cfg.n_heads
    assert abs(float(wq.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert torch.equal(tp["layers"]["norm1"]["scale"],
                       torch.ones_like(tp["layers"]["norm1"]["scale"]))
    again = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"]["table"], tp["embed"]["table"])
