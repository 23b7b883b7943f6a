"""The port's hybrid family (the ``hybrid`` branches of
``repro_torch.models.transformer``) against the JAX package's, on
``smoke(jamba-v0.1-52b)``: one period of 8 layers, Mamba at positions
0-3 and 5-7, attention at 4, MoE (4 experts, top-2, capacity factor 1.0)
at the odd positions and SwiGLU at the even ones.

Parameters come from ``repro.models.api.Model.init`` through
``params_from_jax``.  The Mamba mixers are perturbed first (``perturb``,
as ``tests/test_torch_mamba.py``): the init leaves ``conv_b`` and
``dt_bias`` at zero and ``D`` at one, which would hide a port that
dropped them.

Tolerances:

* f32 against the JAX function as compiled: logits, caches and the aux
  loss 1e-4.  Both run the same f32 arithmetic in other orders; the
  Mamba scan sums in another tree (``tests/test_torch_mamba.py``).
  Gradients: 1e-4 of each leaf's largest gradient.
* bf16 against JAX run op by op (``jax.disable_jit``): 2e-2, as
  ``tests/test_torch_model.py``.  In prefill and decode the port keeps
  the expert FFN's h in f32 (``expert_mlp``) where JAX's einsum path
  rounds it to bf16, a one-ulp change that 6 later layers and their
  recurrent states carry to 4% of a state's largest value; so the bf16
  prefill and decode run the port with JAX's einsum expert FFN in
  ``expert_mlp``'s place (``jax_style_experts``), and the rest of the
  model then matches op for op (seen: logits equal, states within 2e-7).
  Train logits (both packages take the einsum path): 2e-2 relative plus
  2e-2 of the largest logit, the form of ``tests/test_torch_train.py``'s
  bf16 logits: the port's doubling scan sums the f32 state in another
  order than XLA's ``associative_scan`` from the 16th token of a chunk
  on (the first 16 positions agree bit for bit), which flips bf16
  roundings of the scan's output by one ulp here and there, and 8 layers
  carry the flips (seen: 0.055 on logits of 4.25).
* One train step against ``repro.train.step`` (f32 compute): moments
  within 1e-4 of each leaf's largest (with ``grad_compress``, plus one
  int8 level of the leaf's largest: an element at a rounding boundary of
  its block may land one level apart); params within 1e-6, except where
  the gradient is under 1e-2 of the leaf's largest: AdamW's first step
  moves a param by lr g / |g|, whose size f32 noise (or a flipped int8
  level) decides there, so those stay within 2 lr.
* The prefill-then-decode handoff, the port alone (f32, no capacity
  drops): 1e-5.
* Prefill and decode against the train logits (bf16, the default
  capacity): 0.08 of the largest logit, ``tests/test_models_smoke.py``'s
  bound (capacity drops differ between a prefill and a decode step).
* The server: the same decision log and the same f32 greedy tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import Model as JaxModel
from repro.models import transformer as jtf
from repro.models.common import IDENTITY_SHARDER
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.compress import init_error_buffer as jax_init_error_buffer
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import Request as JaxRequest
from repro.train import step as jax_step
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core.fidelity import (DryRunBackend, StepProgram, TensorSpec,
                                       eval_shape)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_mlp import ops as moe_ops
from repro_torch.models import build_model, layers, moe
from repro_torch.models import transformer as ttf
from repro_torch.models.common import leaves, map_leaves
from repro_torch.serve import BatchServer, Request
from repro_torch.serve.step import build_prefill_step
from repro_torch.train import TrainOptions, batch_to, build_train_step

ARCH = "jamba-v0.1-52b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KINDS = ["mamba"] * 4 + ["attn"] + ["mamba"] * 3


def perturb(np_params, seed: int = 0):
    """A copy of the JAX tree with each Mamba mixer's constant leaves
    replaced by seeded noise: conv_b 0.1 N(0, 1), dt_bias uniform on
    [-4, 1], D 1 + 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.array, np_params)
    for pos in p["layers"]:
        mx = pos["mixer"]
        if "A_log" in mx:
            mx["conv_b"] = 0.1 * rng.standard_normal(mx["conv_b"].shape)
            mx["dt_bias"] = rng.uniform(-4.0, 1.0, mx["dt_bias"].shape)
            mx["D"] = 1.0 + 0.2 * rng.standard_normal(mx["D"].shape)
    return jax.tree.map(lambda a: a.astype(np.float32), p)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_smoke(jax_get_config(ARCH)), smoke(get_config(ARCH))
    fresh = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    np_params = perturb(fresh)
    return jcfg, cfg, np_params, jax.tree.map(jnp.asarray, np_params)


def close(jax_out, torch_out, dtype, scaled=False):
    """Within TOL[dtype]; ``scaled``: atol of TOL[dtype] times the
    largest magnitude of ``jax_out``."""
    want = np.asarray(jax_out, np.float32)
    tol = TOL[dtype]
    scale = float(np.abs(want).max()) if scaled else 1.0
    np.testing.assert_allclose(torch_out.detach().float().numpy(), want,
                               atol=tol * scale, rtol=tol)


def jax_style_experts(x, wi, wg, wo):
    """JAX's einsum expert FFN (h rounded to the compute dtype), in the
    place of ``expert_mlp`` (h in f32)."""
    h = torch.einsum("gecd,edf->gecf", x, wi)
    h = layers._silu(h) * torch.einsum("gecd,edf->gecf", x, wg)
    return torch.einsum("gecf,efd->gecd", h, wo)


def jax_apply(dtype, *a, **kw):
    if dtype == "float32":
        return jtf.lm_apply(*a, **kw, compute_dtype=jnp.float32)
    with jax.disable_jit():
        return jtf.lm_apply(*a, **kw, compute_dtype=jnp.bfloat16)


def dropless(cfg):
    """``cfg`` with a capacity no routing can overflow (C = T)."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def test_the_config_is_one_period_of_jamba(setup):
    jcfg, cfg, _, _ = setup
    assert cfg.family == "hybrid" and cfg.n_layers == cfg.attn_every == 8
    assert [ttf.layer_kind(cfg, i) for i in range(8)] == KINDS
    assert [ttf.layer_kind(cfg, i) for i in range(8)] == \
        [jtf.layer_kind(jcfg, i) for i in range(8)]
    assert [cfg.is_moe_layer(i) for i in range(8)] == [False, True] * 4


def _paths(tree):
    return [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_param_trees_and_leaf_order_match_jax(setup):
    """The port's tree (converted, and its own init) has the JAX tree's
    tuple structure, paths and shapes, and ``leaves`` walks it in
    ``jax.tree.leaves`` order."""
    _, cfg, np_params, _ = setup
    tp = params_from_jax(np_params, cfg, "cpu")
    assert type(tp["layers"]) is tuple and len(tp["layers"]) == 8
    assert _paths(tp) == _paths(np_params)
    assert [id(t) for t in leaves(tp)] == [id(t) for t in
                                            jax.tree.leaves(tp)]
    for got, want in zip(leaves(tp), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(got.numpy(), want)
    own = build_model(cfg).init(0, device="cpu")
    assert _paths(own) == _paths(np_params)
    assert sorted(own["layers"][4]["mixer"]) == ["wk", "wo", "wq", "wv"]
    assert "router" in own["layers"][1]["ffn"]
    assert "router" not in own["layers"][0]["ffn"]


def test_tree_helpers_walk_tuples_in_jax_order(setup):
    _, cfg, np_params, _ = setup
    tp = params_from_jax(np_params, cfg, "cpu")
    doubled = map_leaves(lambda t: 2 * t, tp)
    assert _paths(doubled) == _paths(tp)
    from repro_torch.models.common import unflatten
    back = unflatten(tp, list(leaves(doubled)))
    for a, b in zip(leaves(back), leaves(doubled)):
        assert a is b
    from repro_torch.optim.adamw import global_norm
    want = jnp.sqrt(sum(jnp.sum(jnp.square(x))
                        for x in jax.tree.leaves(np_params)))
    np.testing.assert_allclose(float(global_norm(tp)), float(want),
                               rtol=1e-6)


def test_params_from_jax_names_a_wrong_tuple(setup):
    _, cfg, np_params, _ = setup
    bad = dict(np_params, layers=np_params["layers"][:7])
    with pytest.raises(ValueError, match="/layers: 7 entries"):
        params_from_jax(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, np_params)
    bad["layers"][2]["mixer"]["A_log"] = bad["layers"][2]["mixer"][
        "A_log"][:, :3]
    with pytest.raises(ValueError, match="/layers/2/mixer/A_log: shape"):
        params_from_jax(bad, cfg, "cpu")


# ---------------------------------------------------------------------------
# The LM: train, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_and_aux_match_jax(setup, dtype):
    jcfg, cfg, np_params, jp = setup
    tp = params_from_jax(np_params, cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    jl, _, jaux = jax_apply(dtype, jp, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)},
                            jcfg, mode="train")
    tl, cache, taux = ttf.lm_apply(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                                   mode="train", compute_dtype=TDT[dtype])
    assert cache is None and tl.shape == (2, 32, 256)
    assert float(taux) > 0
    close(jl, tl, dtype, scaled=dtype == "bfloat16")
    close(jaux, taux, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(setup, dtype, monkeypatch):
    """Prefill logits and the tuple cache, then 4 decode steps from a
    cache in the compute dtype with the ssm state in f32 (in bf16 the
    server's cache; JAX's f32 decode cannot write f32 k/v into a bf16
    cache).  bf16 runs JAX's expert FFN (module docstring)."""
    if dtype == "bfloat16":
        monkeypatch.setattr(moe, "expert_mlp", jax_style_experts)
    jcfg, cfg, np_params, jp = setup
    tp = params_from_jax(np_params, cfg, "cpu")
    b, s, cap = 2, 24, 64
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s))
    jl, jc, jaux = jax_apply(dtype, jp, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)},
                             jcfg, mode="prefill", seq_capacity=cap)
    tl, tc, taux = ttf.lm_apply(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                                mode="prefill", seq_capacity=cap,
                                compute_dtype=TDT[dtype])
    assert type(tc) is tuple and len(tc) == 8
    assert [sorted(c) for c in tc] == [
        ["k", "v"] if k == "attn" else ["conv", "ssm"] for k in KINDS]
    assert tc[0]["ssm"].dtype == torch.float32
    assert tc[0]["conv"].dtype == TDT[dtype]
    assert tc[0]["conv"].shape == (1, b, cfg.d_conv - 1, cfg.d_inner)
    assert tc[4]["k"].shape == (1, b, cfg.n_kv_heads, cap, cfg.head_dim)
    close(jl, tl, dtype)
    close(jaux, taux, dtype)
    for want, got in zip(jax.tree.leaves(jc), leaves(tc)):
        close(want, got, dtype)

    jcache = jax.tree.map(lambda a, c: c.astype(a.dtype),
                          JaxModel(jcfg).init_cache(b, cap, JDT[dtype]), jc)
    cache = ttf.init_cache(cfg, b, cap, torch.device("cpu"), TDT[dtype])
    map_leaves(lambda c, n: c.copy_(n), cache, tc)
    assert cache[0]["conv"].dtype == cache[4]["k"].dtype == TDT[dtype]
    assert cache[0]["ssm"].dtype == torch.float32
    tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
    for i in range(4):
        jl, jcache, jaux = jax_apply(
            dtype, jp, {"tokens": jnp.asarray(tok, jnp.int32)}, jcfg,
            mode="decode", cache=jcache,
            cur_len=jnp.asarray(s + i, jnp.int32))
        tl, tc2, taux = ttf.lm_apply(tp, {"tokens": torch.as_tensor(tok)},
                                     cfg, mode="decode", cache=cache,
                                     cur_len=s + i, compute_dtype=TDT[dtype])
        assert tc2 is cache                   # decode writes in place
        assert cache[0]["ssm"].dtype == torch.float32
        close(jl, tl, dtype)
        close(jaux, taux, dtype)
        for want, got in zip(jax.tree.leaves(jcache), leaves(cache)):
            close(want, got, dtype)
        tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]


def test_train_gradients_match_jax(setup):
    """f32 gradients of a fixed projection of the train logits, every
    leaf of every position, each one reached."""
    jcfg, cfg, np_params, jp = setup
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    proj = np.random.default_rng(4).standard_normal(
        (2, 32, 256)).astype(np.float32)

    def jloss(p):
        logits, _, aux = jtf.lm_apply(
            p, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg, mode="train",
            compute_dtype=jnp.float32)
        return jnp.sum(logits * proj) + aux

    jg = jax.grad(jloss)(jp)
    tp = params_from_jax(np_params, cfg, "cpu")
    for leaf in leaves(tp):
        leaf.requires_grad_(True)
    logits, _, aux = ttf.lm_apply(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                                  mode="train", compute_dtype=torch.float32)
    ((logits * torch.tensor(proj)).sum() + aux).backward()
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat_j) == len(list(leaves(tp)))
    for (key, want), got in zip(flat_j, leaves(tp)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0 and bool(got.grad.abs().sum() > 0), \
            jax.tree_util.keystr(key)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-7,
                                   err_msg=jax.tree_util.keystr(key))


class JaxModelF32(JaxModel):
    """The JAX model with f32 compute throughout (its ``Model`` trains in
    bf16), so that the step and the server are held to f32 tolerances."""

    def train_logits(self, params, batch, sharder=IDENTITY_SHARDER,
                     chunk=2048):
        logits, _, aux = jtf.lm_apply(params, batch, self.cfg, sharder,
                                      mode="train", chunk=chunk,
                                      compute_dtype=jnp.float32)
        return logits, aux

    def prefill(self, params, batch, sharder=IDENTITY_SHARDER, chunk=2048,
                seq_capacity=0):
        logits, cache, _ = jtf.lm_apply(
            params, batch, self.cfg, sharder, mode="prefill", chunk=chunk,
            seq_capacity=seq_capacity, compute_dtype=jnp.float32)
        return logits, cache

    def decode(self, params, batch, cache, cur_len, sharder=IDENTITY_SHARDER):
        logits, cache, _ = jtf.lm_apply(
            params, batch, self.cfg, sharder, mode="decode", cache=cache,
            cur_len=cur_len, compute_dtype=jnp.float32)
        return logits, cache


@pytest.mark.parametrize("grad_compress", [False, True],
                         ids=["plain", "grad_compress"])
def test_train_step_matches_jax(setup, grad_compress):
    """One ``build_train_step`` step from a JAX train state against
    ``repro.train.step``'s: metrics, then params, moments and the error
    buffer leaf by leaf (tolerances in the module docstring)."""
    jcfg, cfg, np_params, jp = setup
    opts = TrainOptions(peak_lr=1e-3, warmup=0, total_steps=10,
                        grad_compress=grad_compress)
    jopts = jax_step.TrainOptions(**dataclasses.asdict(opts))
    jstate = {"params": jp, "opt": jax_adamw_init(jp, jnp.float32),
              "step": jnp.zeros((), jnp.int32)}
    if grad_compress:
        jstate["err"] = jax_init_error_buffer(jp)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                  opts, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "mask": np.ones((2, 32), np.float32)}
    jfn = jax.jit(jax_step.build_train_step(JaxModelF32(jcfg), jopts))
    jnew, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = build_train_step(build_model(cfg, torch.float32), opts)(
        tstate, batch_to(batch, "cpu"))
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    assert float(tm["lr"]) == pytest.approx(1e-3)
    level = 1.0 / 127 if grad_compress else 0.0
    for name in ("m", "v"):
        for want, got in zip(jax.tree.leaves(jnew["opt"][name]),
                             leaves(tnew["opt"][name])):
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            lim = (1e-4 + (2 * level if name == "v" else level)) * scale
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=lim + 1e-12)
    if grad_compress:
        for want, got in zip(jax.tree.leaves(jnew["err"]),
                             leaves(tnew["err"])):
            want = np.asarray(want)
            g = float(np.abs(want).max())
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2 * level * 127 * g + 1e-7)
    for wp, wm, got in zip(jax.tree.leaves(jnew["params"]),
                           jax.tree.leaves(jnew["opt"]["m"]),
                           leaves(tnew["params"])):
        wp, wm = np.asarray(wp), np.abs(np.asarray(wm))
        err = np.abs(got.detach().numpy() - wp)
        small = wm <= 1e-2 * wm.max()
        assert err[~small].max(initial=0.0) <= 1e-6, err[~small].max()
        assert err.max() <= 2 * 1e-3 * (1 + 1e-6)
    assert int(tnew["step"]) == 1 and int(tnew["opt"]["count"]) == 1


# ---------------------------------------------------------------------------
# The handoff and the prefill/decode consistency
# ---------------------------------------------------------------------------

def test_prefill_then_decode_is_a_longer_prefill(setup):
    """The state handoff: a prefill of s tokens and one decode step give
    the last logits of a prefill of s + 1 tokens.  Capacity drops would
    differ between the two (a decode step drops nothing), so the MoE
    layers run dropless here."""
    _, cfg, np_params, _ = setup
    model = build_model(dropless(cfg), torch.float32)
    p = model.load(params_from_jax(np_params, cfg, "cpu"), "cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 41)))
    for s in (40, 17):
        _, cache = model.prefill(p, {"tokens": toks[:, :s]}, seq_capacity=64)
        step, _ = model.decode(p, {"tokens": toks[:, s:s + 1]}, cache, s)
        longer, _ = model.prefill(p, {"tokens": toks[:, :s + 1]})
        torch.testing.assert_close(step, longer, atol=1e-5, rtol=1e-5)


def test_prefill_decode_consistency(setup):
    """``tests/test_models_smoke.py``'s check on the port (bf16, default
    capacity): prefill of s - 1 tokens and one decode step against the
    teacher-forced train logits, within 0.08 of the largest logit."""
    _, cfg, np_params, _ = setup
    model = build_model(cfg)
    p = params_from_jax(np_params, cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 32)))
    full, _ = model.train_logits(p, {"tokens": toks})
    pl, cache = model.prefill(model.load(p, "cpu"), {"tokens": toks[:, :-1]},
                              seq_capacity=32)
    dl, _ = model.decode(model.load(p, "cpu"), {"tokens": toks[:, -1:]},
                         cache, 31)
    f = full.float()
    scale = float(f[:, -2:].abs().max()) + 1e-9
    assert float((pl[:, 0].float() - f[:, -2]).abs().max()) / scale < 0.08
    assert float((dl[:, 0].float() - f[:, -1]).abs().max()) / scale < 0.08


def test_train_mode_reaches_no_kernel_wrapper(setup, monkeypatch):
    """Train mode takes the plain attention and expert paths; with both
    wrappers made to raise, every leaf still gets a gradient."""
    def refuse(*a, **kw):
        raise AssertionError("a forward-only kernel wrapper was called")
    monkeypatch.setattr(layers, "flash_attention", refuse)
    monkeypatch.setattr(moe, "expert_mlp", refuse)
    _, cfg, np_params, _ = setup
    tp = params_from_jax(np_params, cfg, "cpu")
    for t in leaves(tp):
        t.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 16)))
    logits, aux = build_model(cfg).train_logits(tp, {"tokens": toks})
    grads = torch.autograd.grad(logits.float().sum() + aux,
                                list(leaves(tp)))
    assert all(bool(g.abs().sum() > 0) for g in grads)


# ---------------------------------------------------------------------------
# The server and the dry run
# ---------------------------------------------------------------------------

PROMPT_LENS = [4, 3, 2, 10, 3]
MAX_NEW = [5, 3, 6, 10, 2]        # request 3 stops at capacity (16 - 1)
SLOTS, CAP = 2, 16


def test_server_matches_jax_server_f32(setup):
    jcfg, cfg, np_params, jp = setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    jsrv = JaxBatchServer(model=JaxModelF32(jcfg), params=jp, slots=SLOTS,
                          seq_capacity=CAP)
    jsrv.instantiate()
    jdone = jsrv.serve([JaxRequest(rid=i, prompt=p, max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    srv = BatchServer(build_model(cfg, torch.float32),
                      params_from_jax(np_params, cfg, "cpu"), slots=SLOTS,
                      seq_capacity=CAP, device="cpu")
    done = srv.serve([Request(rid=i, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    assert ([dataclasses.astuple(d) for d in srv.scheduler.decisions]
            == [dataclasses.astuple(d) for d in jsrv.scheduler.decisions])
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.output == jr.output, r.rid
    assert srv.decode_steps == jsrv.stats.flat()["server.decode_steps"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_server_insert_keeps_the_ssm_state_in_f32(setup, dtype):
    """A prefill's cache reaches the server's slot leaf by leaf, through
    the tuple: the ssm state in f32 bit for bit, conv and k/v in the
    cache's bf16; the free slot stays zero."""
    _, cfg, np_params, _ = setup
    model = build_model(cfg, dtype)
    srv = BatchServer(model, params_from_jax(np_params, cfg, "cpu"),
                      slots=2, seq_capacity=CAP, device="cpu")
    prompt = np.random.default_rng(10).integers(0, cfg.vocab_size, 9)
    seen = []
    decode = srv._decode

    def spy(params, batch):
        seen.append(map_leaves(torch.clone, batch["cache"]))
        return decode(params, batch)
    srv._decode = spy
    srv.serve([Request(rid=0, prompt=prompt, max_new_tokens=2)])
    _, want = model.prefill(srv.params, {"tokens": torch.as_tensor(
        prompt)[None]}, seq_capacity=CAP)
    first = seen[0]
    for pos, kind in enumerate(KINDS):
        got, ref = first[pos], want[pos]
        if kind == "mamba":
            assert got["ssm"].dtype == torch.float32
            assert got["conv"].dtype == torch.bfloat16
            assert torch.equal(got["ssm"][:, 0], ref["ssm"][:, 0])
            assert torch.equal(got["conv"][:, 0],
                               ref["conv"][:, 0].to(torch.bfloat16))
        else:
            assert got["k"].dtype == torch.bfloat16
            assert torch.equal(got["k"][:, 0], ref["k"][:, 0].to(
                torch.bfloat16))
        assert not any(t[:, 1].any() for t in got.values())


def test_dry_run_costs_the_mamba_ops():
    """A smoke jamba prefill on fake CUDA tensors: one flash op (the
    attention position) and four ``moe_mlp`` ops (the odd positions); the
    Mamba layers' ops (conv, softplus, the doubling scan) and the MoE
    dispatch's (``searchsorted``, ``floor_divide``) all have a cost
    rule."""
    model = build_model(smoke(get_config(ARCH)))
    specs = eval_shape(lambda: model.load(model.init(0, "cpu"), "cpu"))
    prog = StepProgram("jamba prefill", build_prefill_step(model),
                       (specs, {"tokens": TensorSpec((2, 64), torch.int64)}),
                       device="cuda")
    n0 = (flash_ops.flash_attention.launches, moe_ops.expert_mlp.launches)
    rep = DryRunBackend().run(prog)
    assert rep.detail["kernels"] == {"flash_attention": 1, "expert_mlp": 4}
    assert (flash_ops.flash_attention.launches,
            moe_ops.expert_mlp.launches) == n0
    assert rep.detail["unknown_ops"] == {}
    names = {n for n, _, _ in rep.detail["ops"]}
    assert {"aten.exp.default", "aten.log1p.default", "aten.bmm.default",
            "aten.searchsorted.Tensor", "aten.floor_divide.default"} <= names
    assert rep.flops > 0 and rep.bytes_accessed > 0


def test_entry_points_take_the_card_for_jamba():
    """With no device, ``Model.init``, ``init_cache`` and ``BatchServer``
    take ``cuda``, which raises here; with ``device="cpu"`` they run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    model = build_model(smoke(get_config(ARCH)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(model, params, slots=1, seq_capacity=8)
    cache = model.init_cache(2, 8, "cpu")
    assert type(cache) is tuple and len(cache) == 8
    assert cache[1]["ssm"].dtype == torch.float32
    assert cache[1]["conv"].dtype == cache[4]["v"].dtype == torch.bfloat16


def test_launcher_trains_jamba_on_cpu(capsys):
    from repro_torch.launch import train as launch_train
    res = launch_train.main(["--arch", ARCH, "--steps", "3", "--batch", "2",
                             "--seq", "16", "--device", "cpu"])
    assert res["steps"] == 3 and np.isfinite(res["last_loss"])
    assert "step 2:" in capsys.readouterr().out
