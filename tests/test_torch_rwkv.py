"""The port's RWKV-6 family (``repro_torch.models.rwkv`` and the ``ssm``
branches of the LM) against the JAX package's.

Every test starts from one parameter tree, initialised in JAX and then
perturbed with seeded numpy noise (``perturb``) before both packages get
it.  JAX's ``init_rwkv_block`` leaves ``u``, ``w0``, ``mu``, ``mu_x``,
``mu_k``, ``mu_r`` and ``ln_x_bias`` at zero and ``ln_x_scale`` at one:
with u = 0 the bonus term never runs, with mu = 0 the token-shift mixes
never run, and with w0 = 0 every decay is ~e^-1 a step, so the state
forgets within a few tokens.  A port that ignored any of those, or
carried the state wrongly, would pass on fresh parameters.  The noise:
u ~ 0.5 N(0, 1), w0 uniform on [-6, 1] (decays from ~0.9975 to ~0.07 a
step), the mixes uniform on [0, 1], the group-norm scale 1 + 0.2 N(0, 1)
and bias 0.2 N(0, 1).

Tolerances:

* the WKV6 step, the time mix and the channel mix (f32): 1e-5.  Both
  packages run the same f32 arithmetic and differ only in the order of
  sums.
* the chunked WKV6 scan (f32): 1e-4.  Its scan inputs are harsher than
  the model's (log decays down to -e a step, sums of |y| up to ~43), and
  XLA takes the cumulative sums of the log decay in another order than
  ``torch.cumsum`` (they differ by ~1.5e-5 on sums of ~100), which moves
  every exp(cum) factor by that much relative: observed 5.7e-5.
* smoke(rwkv6-7b) in f32 against the JAX function as compiled: 1e-5,
  the tolerance of ``tests/test_torch_model.py``.  Gradients: 1e-4
  relative to each leaf's largest gradient.
* bf16 against JAX run op by op (``jax.disable_jit``), where XLA rounds
  at every op boundary as eager PyTorch does: 2e-2, as
  ``tests/test_torch_model.py``.
* The prefill-then-decode handoff (f32, the port alone): 1e-5.  The
  decode step runs the one-token recurrence where the longer prefill
  runs the chunked scan: the same function in another order.
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
from repro.models import rwkv as jrw
from repro.models import transformer as jtf
from repro.models.common import IDENTITY_SHARDER
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rwkv6_wkv.ops import wkv6
from repro_torch.models import build_model
from repro_torch.models import rwkv as trw
from repro_torch.models import transformer as ttf
from repro_torch.serve import BatchServer, Request

ARCH = "rwkv6-7b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SCAN_TOL = 1e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def perturb(np_params, seed: int = 0):
    """A copy of the JAX tree with its zero- and one-initialised RWKV
    leaves replaced by seeded noise (see the module docstring)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.array, np_params)
    tm, cm = p["layers"]["mixer"], p["layers"]["ffn"]

    def noise(shape, kind):
        if kind == "mix":
            return rng.uniform(0.0, 1.0, shape)
        if kind == "w0":
            return rng.uniform(-6.0, 1.0, shape)
        return {"u": 0.5, "scale": 0.2, "bias": 0.2}[kind] * \
            rng.standard_normal(shape)

    tm["u"] = noise(tm["u"].shape, "u")
    tm["w0"] = noise(tm["w0"].shape, "w0")
    tm["mu"] = noise(tm["mu"].shape, "mix")
    tm["mu_x"] = noise(tm["mu_x"].shape, "mix")
    tm["ln_x_scale"] = 1.0 + noise(tm["ln_x_scale"].shape, "scale")
    tm["ln_x_bias"] = noise(tm["ln_x_bias"].shape, "bias")
    cm["mu_k"] = noise(cm["mu_k"].shape, "mix")
    cm["mu_r"] = noise(cm["mu_r"].shape, "mix")
    return jax.tree.map(lambda a: a.astype(np.float32), p)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_smoke(jax_get_config(ARCH)), smoke(get_config(ARCH))
    fresh = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    np_params = perturb(fresh)
    jp = jax.tree.map(jnp.asarray, np_params)
    return jcfg, cfg, np_params, jp


def close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


def layer0(np_params, part):
    return {k: v[0] for k, v in np_params["layers"][part].items()}


# ---------------------------------------------------------------------------
# WKV6 scans
# ---------------------------------------------------------------------------

def scan_inputs(seed, b, s, h, n, with_state):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.uniform(-6.0, 1.0, (b, s, h, n))).astype(np.float32)
    u = (0.5 * rng.standard_normal((h, n))).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)).astype(np.float32)
          if with_state else None)
    return r, k, v, lw, u, st


def both(arrs):
    j = [None if a is None else jnp.asarray(a) for a in arrs]
    t = [None if a is None else torch.tensor(a) for a in arrs]
    return j, t


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,n,chunk", [(2, 64, 2, 16, 32),
                                           (1, 96, 3, 16, 32),
                                           (2, 45, 2, 16, 32),
                                           (1, 7, 2, 32, 32)])
def test_wkv6_chunked_matches_jax(b, s, h, n, chunk, with_state):
    """Chunks of 32, and the ragged s that falls back to one chunk of
    length s (45, 7), from zeros and from a nonzero state."""
    j, t = both(scan_inputs(31, b, s, h, n, with_state))
    jy, jst = jrw.wkv6_chunked(*j, chunk=chunk)
    n0 = wkv6.launches
    ty, tst = trw.wkv6_chunked(*t, chunk=chunk)
    assert wkv6.launches == n0                   # the CPU runs no kernel
    close(jy, ty, SCAN_TOL)
    close(jst, tst, SCAN_TOL)


@pytest.mark.parametrize("b,h,n", [(2, 2, 16), (3, 4, 32)])
def test_wkv6_step_matches_jax(b, h, n):
    j, t = both(scan_inputs(32, b, 1, h, n, True))
    jy, jst = jrw.wkv6_step(*j)
    ty, tst = trw.wkv6_step(*t)
    close(jy, ty, TOL["float32"])
    close(jst, tst, TOL["float32"])


def test_wkv6_chunked_train_mode_records_gradients():
    """Train mode is the plain scan under autograd on every device."""
    _, t = both(scan_inputs(33, 1, 64, 2, 16, True))
    u = t[4].requires_grad_(True)
    y, st = trw.wkv6_chunked(*t, chunk=32, mode="train")
    (y.sum() + st.sum()).backward()
    assert u.grad is not None and bool(u.grad.abs().sum() > 0)


# ---------------------------------------------------------------------------
# Time mix and channel mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(setup, with_state):
    jcfg, cfg, np_params, _ = setup
    tm = layer0(np_params, "mixer")
    jtm = {k: jnp.asarray(v) for k, v in tm.items()}
    ttm = {k: torch.tensor(v) for k, v in tm.items()}
    rng = np.random.default_rng(34)
    b, s, d = 2, 40, cfg.d_model
    h, n = cfg.n_rwkv_heads, cfg.rwkv_head_size
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    shift = rng.standard_normal((b, 1, d)).astype(np.float32)
    wkv = rng.standard_normal((b, h, n, n)).astype(np.float32)
    st = (shift, wkv) if with_state else (None, None)
    jo = jrw.apply_time_mix(jtm, jnp.asarray(x), jcfg, IDENTITY_SHARDER,
                            *(None if a is None else jnp.asarray(a)
                              for a in st))
    to = trw.apply_time_mix(ttm, torch.tensor(x), cfg,
                            *(None if a is None else torch.tensor(a)
                              for a in st))
    for a, c in zip(jo, to):
        close(a, c, TOL["float32"])


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(setup, with_state):
    jcfg, cfg, np_params, _ = setup
    cm = layer0(np_params, "ffn")
    rng = np.random.default_rng(35)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    shift = (rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
             if with_state else None)
    jo = jrw.apply_channel_mix({k: jnp.asarray(v) for k, v in cm.items()},
                               jnp.asarray(x), jcfg,
                               None if shift is None else jnp.asarray(shift))
    to = trw.apply_channel_mix({k: torch.tensor(v) for k, v in cm.items()},
                               torch.tensor(x), cfg,
                               None if shift is None else torch.tensor(shift))
    for a, c in zip(jo, to):
        close(a, c, TOL["float32"])


# ---------------------------------------------------------------------------
# The LM: train, prefill, decode
# ---------------------------------------------------------------------------

def jax_apply(dtype, *a, **kw):
    if dtype == "float32":
        return jtf.lm_apply(*a, **kw, compute_dtype=jnp.float32)
    with jax.disable_jit():
        return jtf.lm_apply(*a, **kw, compute_dtype=jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(setup, dtype):
    jcfg, cfg, np_params, jp = setup
    tp = params_from_jax(np_params, cfg, "cpu")
    rng = np.random.default_rng(36)
    b, s = 2, 40
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jl, jc, _ = jax_apply(dtype, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          jcfg, mode="prefill")
    tl, tc, taux = ttf.lm_apply(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                                mode="prefill", compute_dtype=TDT[dtype])
    assert float(taux) == 0.0
    assert set(tc) == {"shift_tm", "shift_cm", "wkv"}
    assert tc["wkv"].dtype == torch.float32
    assert tc["wkv"].shape == (cfg.n_layers, b, cfg.n_rwkv_heads,
                               cfg.rwkv_head_size, cfg.rwkv_head_size)
    assert tc["shift_tm"].dtype == TDT[dtype]
    close(jl, tl, TOL[dtype])
    for n in tc:
        close(jc[n], tc[n], TOL[dtype])

    # decode from a zero cache of the server's dtypes, as JAX does
    jcache = jax.tree.map(lambda a, c: c.astype(a.dtype),
                          JaxModel(jcfg).init_cache(b, 64), jc)
    cache = ttf.init_cache(cfg, b, 64, torch.device("cpu"))
    for n, c in cache.items():
        c.copy_(tc[n])
    tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
    for i in range(4):
        jl, jcache, _ = jax_apply(
            dtype, jp, {"tokens": jnp.asarray(tok, jnp.int32)}, jcfg,
            mode="decode", cache=jcache,
            cur_len=jnp.asarray(s + i, jnp.int32))
        tl, tc2, _ = ttf.lm_apply(tp, {"tokens": torch.as_tensor(tok)}, cfg,
                                  mode="decode", cache=cache, cur_len=s + i,
                                  compute_dtype=TDT[dtype])
        assert tc2 is cache                   # decode writes in place
        assert cache["wkv"].dtype == torch.float32
        close(jl, tl, TOL[dtype])
        for n in cache:
            close(jcache[n], cache[n], TOL[dtype])
        tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_match_jax(setup, dtype):
    jcfg, cfg, np_params, jp = setup
    tp = params_from_jax(np_params, cfg, "cpu")
    toks = np.random.default_rng(37).integers(0, cfg.vocab_size, (2, 64))
    jl, _, _ = jax_apply(dtype, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jcfg, mode="train")
    tl, cache, _ = ttf.lm_apply(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                                mode="train", compute_dtype=TDT[dtype])
    assert cache is None and tl.shape == (2, 64, 256)
    close(jl, tl, TOL[dtype])


def test_train_gradients_match_jax(setup):
    """f32 gradients of a fixed projection of the train logits, leaf by
    leaf, with every time-mix leaf (u and w0 included) reached."""
    jcfg, cfg, np_params, jp = setup
    toks = np.random.default_rng(38).integers(0, cfg.vocab_size, (2, 32))
    proj = np.random.default_rng(39).standard_normal(
        (2, 32, 256)).astype(np.float32)

    def jloss(p):
        logits, _, _ = jtf.lm_apply(
            p, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg, mode="train",
            compute_dtype=jnp.float32)
        return jnp.sum(logits * proj)

    jg = jax.grad(jloss)(jp)
    tp = params_from_jax(np_params, cfg, "cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    logits, _, _ = ttf.lm_apply(tp, {"tokens": torch.as_tensor(toks)}, cfg,
                                mode="train", compute_dtype=torch.float32)
    (logits * torch.tensor(proj)).sum().backward()
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert set(flat_j) == set(flat_t)
    for key, t in flat_t.items():
        want = np.asarray(flat_j[key])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-7,
                                   err_msg=jax.tree_util.keystr(key))
    for name, g in tp["layers"]["mixer"].items():
        assert bool(g.grad.abs().sum() > 0), name


def test_prefill_then_decode_is_a_longer_prefill(setup):
    """The decode state handoff: a prefill of s tokens and one decode step
    give the last logits of a prefill of s + 1 tokens."""
    _, cfg, np_params, _ = setup
    model = build_model(cfg, torch.float32)
    p = model.load(params_from_jax(np_params, cfg, "cpu"), "cpu")
    toks = torch.as_tensor(np.random.default_rng(40).integers(
        0, cfg.vocab_size, (1, 65)))
    for s in (64, 40):
        _, cache = model.prefill(p, {"tokens": toks[:, :s]})
        step, _ = model.decode(p, {"tokens": toks[:, s:s + 1]}, cache, s)
        longer, _ = model.prefill(p, {"tokens": toks[:, :s + 1]})
        torch.testing.assert_close(step, longer, atol=TOL["float32"],
                                   rtol=TOL["float32"])


def test_params_from_jax_covers_the_rwkv_tree(setup):
    jcfg, cfg, np_params, _ = setup
    tp = params_from_jax(np_params, cfg, "cpu", torch.bfloat16)
    flat_j = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(np_params)[0]}
    flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_j == flat_t
    L, d = cfg.n_layers, cfg.d_model
    h, n = cfg.n_rwkv_heads, cfg.rwkv_head_size
    tm = tp["layers"]["mixer"]
    assert tm["lora_a"].shape == (L, d, trw.MIX_KINDS, trw.LORA_R)
    assert tm["w_lora_b"].shape == (L, trw.LORA_R, h, n)
    assert tp["layers"]["ffn"]["wk"].shape == (L, d, cfg.d_ff)
    np.testing.assert_array_equal(
        tm["w0"].float().numpy(),
        np_params["layers"]["mixer"]["w0"].astype(jnp.bfloat16)
        .astype(np.float32))
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(lambda a: a, np_params)
        bad["layers"]["mixer"]["w_lora_b"] = \
            bad["layers"]["mixer"]["w_lora_b"][:, :, :1]
        params_from_jax(bad, cfg, "cpu")


def test_port_init_matches_jax_tree(setup):
    _, cfg, np_params, _ = setup
    tp = build_model(cfg).init(0, device="cpu")
    flat_j = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(np_params)[0]}
    flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_j == flat_t
    tm = tp["layers"]["mixer"]
    assert not tm["u"].any() and not tm["w0"].any()
    assert torch.equal(tm["ln_x_scale"], torch.ones_like(tm["ln_x_scale"]))


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

PROMPT_LENS = [4, 3, 2, 10, 3]
MAX_NEW = [5, 3, 6, 10, 2]        # request 3 stops at capacity (16 - 1)
SLOTS, CAP = 2, 16


class JaxF32Model(JaxModel):
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


def test_server_matches_jax_server_f32(setup):
    jcfg, cfg, np_params, jp = setup
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    jsrv = JaxBatchServer(model=JaxF32Model(jcfg), params=jp, slots=SLOTS,
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
def test_server_insert_keeps_the_state_in_f32(setup, dtype):
    """A prefill's WKV state reaches the server's cache in f32, bit for
    bit, and its token-shift states in the cache's bf16."""
    _, cfg, np_params, _ = setup
    model = build_model(cfg, dtype)
    srv = BatchServer(model, params_from_jax(np_params, cfg, "cpu"),
                      slots=2, seq_capacity=CAP, device="cpu")
    prompt = np.random.default_rng(42).integers(0, cfg.vocab_size, 9)
    seen = []
    decode = srv._decode

    def spy(params, batch):
        seen.append({n: c.clone() for n, c in batch["cache"].items()})
        return decode(params, batch)
    srv._decode = spy
    srv.serve([Request(rid=0, prompt=prompt, max_new_tokens=2)])
    _, want = model.prefill(srv.params, {"tokens": torch.as_tensor(
        prompt)[None]})
    first = seen[0]
    assert first["wkv"].dtype == torch.float32
    assert first["shift_tm"].dtype == torch.bfloat16
    assert torch.equal(first["wkv"][:, 0], want["wkv"][:, 0])
    assert torch.equal(first["shift_cm"][:, 0],
                       want["shift_cm"][:, 0].to(torch.bfloat16))
    assert not first["wkv"][:, 1].any()          # the free slot is untouched
