"""Parity of the port's dense layer library with ``repro.models.layers``.

The same numpy inputs and the same JAX-initialised parameters go through
both.  Tolerances: f32 at 1e-5 (PyTorch and XLA sum in other orders; the
observed gap is ~1e-6); bf16 at 2e-2 against the JAX function run op by
op (``jax.disable_jit``), where both round to bf16 at every op boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import layers as jl
from repro.models.common import IDENTITY_SHARDER, cast, unzip
from repro_torch.configs import get_config, smoke
from repro_torch.models import layers as tl

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cfgs(arch, **kw):
    from dataclasses import replace
    return (replace(jax_smoke(jax_get_config(arch)), **kw),
            replace(smoke(get_config(arch)), **kw))


def jparams(init_fn, key, cfg, dtype):
    vals, _ = unzip(init_fn(key, cfg))
    return cast(vals, JDT[dtype])


def to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32)).to(TDT[dtype])


def close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-67b"])
def test_norm(arch, dtype):
    jcfg, cfg = cfgs(arch)
    rng = np.random.default_rng(0)
    xj, xt = rand(rng, (2, 5, jcfg.d_model), dtype)
    p = {"scale": rng.standard_normal(jcfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(jcfg.d_model).astype(np.float32)}
    if jcfg.norm == "rmsnorm":
        del p["bias"]
    pj = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), p)
    with jax.disable_jit():
        want = jl.apply_norm(pj, xj, jcfg)
    close(want, tl.apply_norm(to_torch(p, dtype), xt, cfg), dtype)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b",
                                  "mixtral-8x22b", "deepseek-67b",
                                  "minicpm-2b", "nemotron-4-15b",
                                  "jamba-v0.1-52b", "qwen2-vl-7b"])
def test_inv_freq_matches_jax_at_full_width(arch):
    """The inverse frequencies at each arch's full head dim and theta
    equal JAX's bit for bit (an f32 power in PyTorch is an ulp off on
    some of them; the port rounds an f64 power once)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    rot = tl._rot_dims(cfg)
    want = np.asarray(jl._inv_freq(rot, jcfg.rope_theta))
    np.testing.assert_array_equal(
        tl._inv_freq(rot, cfg.rope_theta).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope_pct", [0.25, 1.0])
def test_rope(rope_pct, dtype):
    jcfg, cfg = cfgs("stablelm-1.6b", rope_pct=rope_pct)
    rng = np.random.default_rng(1)
    xj, xt = rand(rng, (2, 9, 4, jcfg.head_dim), dtype)
    pos = rng.integers(0, 500, (2, 9))
    with jax.disable_jit():
        want = jl.apply_rope(jcfg, xj, jnp.asarray(pos))
    got = tl.apply_rope(cfg, xt, torch.as_tensor(pos))
    close(want, got, dtype)
    # stablelm rotates 16 of 64 dims at full width; 4 of 16 at smoke width
    assert tl._rot_dims(cfg) == int(cfg.head_dim * rope_pct)
    assert torch.equal(got[..., tl._rot_dims(cfg):],
                       xt[..., tl._rot_dims(cfg):])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk,window", [(16, 16, 0), (32, 8, 0),
                                            (32, 8, 5), (24, 7, 0)])
def test_naive_and_blockwise_attention(s, chunk, window, dtype):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = [rand(rng, (2, s, 3, 16), dtype)
                                    for _ in range(3)]
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    pj, pt = jnp.asarray(pos), torch.as_tensor(pos)
    with jax.disable_jit():
        naive = jl.naive_causal_attention(qj, kj, vj, pj, pj, window=window)
        block = jl.blockwise_attention(qj, kj, vj, pj, pj, window=window,
                                       chunk=chunk)
    close(naive, tl.naive_causal_attention(qt, kt, vt, pt, pt,
                                           window=window), dtype)
    close(block, tl.blockwise_attention(qt, kt, vt, pt, pt, window=window,
                                        chunk=chunk), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,s,chunk", [("stablelm-1.6b", 12, 2048),
                                          ("deepseek-67b", 12, 2048),
                                          ("stablelm-1.6b", 32, 16)])
def test_attention_train(arch, s, chunk, dtype):
    jcfg, cfg = cfgs(arch)
    p = jparams(jl.init_attention, jax.random.PRNGKey(4), jcfg, dtype)
    rng = np.random.default_rng(3)
    xj, xt = rand(rng, (2, s, jcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    with jax.disable_jit():
        yj, (kj, vj) = jl.attention_train(p, xj, jcfg, jnp.asarray(pos),
                                          IDENTITY_SHARDER, chunk=chunk,
                                          return_kv=True)
    yt, (kt, vt) = tl.attention_train(to_torch(p, dtype), xt, cfg,
                                      torch.as_tensor(pos), chunk=chunk,
                                      return_kv=True)
    assert kt.shape == (2, s, cfg.n_kv_heads, cfg.head_dim)
    for a, b in ((yj, yt), (kj, kt), (vj, vt)):
        close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-67b",
                                  "olmoe-1b-7b"])
def test_qkv_project(arch, dtype):
    """q and the repeated k/v after qk-norm and RoPE (partial RoPE,
    GQA with one kv head, qk-norm)."""
    jcfg, cfg = cfgs(arch)
    p = jparams(jl.init_attention, jax.random.PRNGKey(6), jcfg, dtype)
    rng = np.random.default_rng(6)
    xj, xt = rand(rng, (2, 9, jcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    with jax.disable_jit():
        want = jl.qkv_project(p, xj, jcfg, jnp.asarray(pos), IDENTITY_SHARDER)
    got = tl.qkv_project(to_torch(p, dtype), xt, cfg, torch.as_tensor(pos))
    for a, b in zip(want, got):
        assert b.shape == (2, 9, cfg.n_heads, cfg.head_dim)
        close(a, b, dtype)


@pytest.mark.parametrize("s,capacity", [(5, 8), (8, 8), (11, 8), (16, 8)])
def test_kv_to_cache(s, capacity):
    rng = np.random.default_rng(5)
    (kj, kt), (vj, vt) = [rand(rng, (2, s, 2, 16), "float32")
                          for _ in range(2)]
    want = jl.kv_to_cache(kj, vj, capacity, IDENTITY_SHARDER)
    got = tl.kv_to_cache(kt, vt, capacity)
    for n in ("k", "v"):
        assert got[n].shape == (2, 2, capacity, 16)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-67b"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_decode(arch, per_slot, dtype):
    """Scalar and per-slot ``cur_len``, including a ring-buffer wrap
    (cur_len >= S), with the cache in the compute dtype."""
    jcfg, cfg = cfgs(arch)
    S = 8
    p = jparams(jl.init_attention, jax.random.PRNGKey(6), jcfg, dtype)
    rng = np.random.default_rng(7)
    xj, xt = rand(rng, (3, 1, jcfg.d_model), dtype)
    shp = (3, jcfg.n_kv_heads, S, jcfg.head_dim)
    (kj, kt), (vj, vt) = [rand(rng, shp, dtype) for _ in range(2)]
    cur = np.array([2, 7, 11]) if per_slot else 5
    with jax.disable_jit():
        yj, cj = jl.attention_decode(p, xj, jcfg, {"k": kj, "v": vj},
                                     jnp.asarray(cur, jnp.int32),
                                     IDENTITY_SHARDER)
    cache = {"k": kt.clone(), "v": vt.clone()}
    yt, ct = tl.attention_decode(to_torch(p, dtype), xt, cfg, cache,
                                 torch.as_tensor(cur) if per_slot else cur)
    assert ct is cache                       # written in place
    close(yj, yt, dtype)
    for n in ("k", "v"):
        close(cj[n], ct[n], dtype)


def test_attention_decode_promotes_bf16_cache():
    """f32 compute over a bf16 cache: the JAX function attends over the
    cache promoted to f32 with this step's k/v unrounded, and stores them
    rounded to bf16."""
    jcfg, cfg = cfgs("deepseek-67b")
    p = jparams(jl.init_attention, jax.random.PRNGKey(8), jcfg, "float32")
    rng = np.random.default_rng(9)
    xj, xt = rand(rng, (2, 1, jcfg.d_model), "float32")
    shp = (2, jcfg.n_kv_heads, 6, jcfg.head_dim)
    (kj, kt), (vj, vt) = [rand(rng, shp, "bfloat16") for _ in range(2)]
    cur = np.array([3, 4])
    yj, cj = jl.attention_decode(p, xj, jcfg, {"k": kj, "v": vj},
                                 jnp.asarray(cur, jnp.int32),
                                 IDENTITY_SHARDER)
    cache = {"k": kt.clone(), "v": vt.clone()}
    yt, _ = tl.attention_decode(to_torch(p, "float32"), xt, cfg, cache,
                                torch.as_tensor(cur))
    close(yj, yt, "float32")
    for n in ("k", "v"):
        assert cache[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            cache[n].float().numpy(),
            np.asarray(jnp.asarray(cj[n], jnp.bfloat16), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp(act, dtype):
    jcfg, cfg = cfgs("stablelm-1.6b", act=act)
    p = jparams(jl.init_mlp, jax.random.PRNGKey(10), jcfg, dtype)
    rng = np.random.default_rng(11)
    xj, xt = rand(rng, (2, 6, jcfg.d_model), dtype)
    with jax.disable_jit():
        want = jl.apply_mlp(p, xj, jcfg)
    close(want, tl.apply_mlp(to_torch(p, dtype), xt, cfg), dtype)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_unembed(tie):
    jcfg, cfg = cfgs("stablelm-1.6b", tie_embeddings=tie, vocab_size=300)
    assert tl.padded_vocab(cfg) == jl.padded_vocab(jcfg) == 384
    p = jparams(jl.init_embedding, jax.random.PRNGKey(12), jcfg, "float32")
    pt = to_torch(p, "float32")
    assert set(pt) == ({"table"} if tie else {"table", "head"})
    toks = np.random.default_rng(13).integers(0, 300, (2, 7))
    xj = jl.embed_tokens(p, jnp.asarray(toks), jcfg)
    xt = tl.embed_tokens(pt, torch.as_tensor(toks), cfg)
    close(xj, xt, "float32")
    close(jl.unembed(p, xj, jcfg), tl.unembed(pt, xt, cfg), "float32")
