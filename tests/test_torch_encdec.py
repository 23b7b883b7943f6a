"""The port's encoder-decoder slice (whisper-small: learned positions,
cross attention, ``models/encdec.py``) against the JAX package, on
``smoke(whisper-small)``: 2 encoder layers over 16 frames, 4 decoder
layers, d_model 64, 4 heads of 16.

Parameters are initialised once in JAX and converted with
``params_from_jax``; every other input is drawn from a numpy seed.
Tolerances:

* f32, every module and ``encdec_apply`` in train, prefill and decode:
  1e-5, against the JAX functions as compiled (the two sum in other
  orders), as ``tests/test_torch_model.py``.
* bf16 prefill and decode: 2e-2, against JAX run op by op
  (``jax.disable_jit``), as ``tests/test_torch_model.py``.
* ``_decode_cross`` in bf16 at a head dim of 24 (the divide by sqrt(24)
  rounds; by sqrt(16) or sqrt(64) it is exact in bf16): equal to JAX's
  op by op, which divides the bf16 scores in f32.
* The server and the train step, computing in f32: the same decision
  log and tokens as ``repro.serve.BatchServer``; the train step's loss
  within 1e-5 and its gradient norm within 1e-4, as
  ``tests/test_torch_train.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import SyntheticPipeline as JaxPipeline
from repro.models import Model as JaxModel
from repro.models import build_model as jax_build_model
from repro.models import encdec as jed
from repro.models import layers as jll
from repro.models.common import IDENTITY_SHARDER
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import Request as JaxRequest
from repro.train import TrainOptions as JaxTrainOptions
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_train_state as jax_init_train_state
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model
from repro_torch.models import encdec as ed
from repro_torch.models import layers as ll
from repro_torch.models.common import cast
from repro_torch.serve import BatchServer, Request
from repro_torch.train import TrainOptions, batch_to, build_train_step

ARCH = "whisper-small"
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_smoke(jax_get_config(ARCH)), smoke(get_config(ARCH))
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jp, np_params, params_from_jax(np_params, cfg, "cpu")


def _inputs(cfg, b: int, s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    enc = (rng.standard_normal((b, cfg.enc_seq, cfg.d_model)) * 0.1
           ).astype(np.float32)
    return toks, enc


def _jbatch(toks, enc):
    return {"tokens": jnp.asarray(toks, jnp.int32),
            "enc_embeds": jnp.asarray(enc)}


def _tbatch(toks, enc):
    return {"tokens": torch.as_tensor(toks),
            "enc_embeds": torch.as_tensor(enc)}


def close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


def _dec0(jp, tp):
    """Decoder layer 0's params in both packages."""
    return (jax.tree.map(lambda x: x[0], jp["dec_layers"]),
            {k: {n: t[0] for n, t in v.items()}
             for k, v in tp["dec_layers"].items()})


# --- config and params ------------------------------------------------------

def test_config_is_the_published_whisper_small():
    """Widths of ``src/repro/configs/whisper_small.py``.  The tree holds
    285.54 M params: ``param_counts`` (249.53 M) leaves out the decoder's
    cross attention (12 x 4 d^2), the learned positions (8192 decoder
    rows, 1500 encoder frames), the norms and the vocab padding."""
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.pos_scheme, cfg.act, cfg.norm) == (
        "audio", "learned", "gelu", "layernorm")
    assert (cfg.enc_layers, cfg.enc_seq, cfg.n_layers, cfg.d_model,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size) == (12, 1500, 12, 768, 12, 12, 64, 3072, 51865)
    assert ll.padded_vocab(cfg) == 51968
    shapes = ed.init_encdec(None, cfg)          # meta tensors: no memory
    assert tuple(shapes["embed"]["pos_table"].shape) == (8192, 768)
    assert tuple(shapes["enc_pos"].shape) == (1500, 768)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(shapes))
    d, f, vp = 768, 3072, 51968
    attn, mlp, norm = 4 * d * d, 2 * d * f, 2 * d
    assert n == (2 * vp * d + (8192 + 1500) * d
                 + 12 * (2 * norm + attn + mlp)          # encoder layers
                 + 12 * (3 * norm + 2 * attn + mlp)      # decoder layers
                 + 2 * norm) == 285_542_400
    assert cfg.param_counts()["total"] == n - (
        12 * attn + (8192 + 1500) * d + 12 * 5 * norm + 2 * norm
        + 2 * (vp - cfg.vocab_size) * d)


def test_params_from_jax_covers_the_encdec_tree(setup):
    """``enc_pos``, ``enc_layers``, ``enc_norm``, ``dec_layers`` and
    ``embed/pos_table`` carry across leaf for leaf, and the port's own
    init draws the same tree."""
    jcfg, cfg, jp, np_params, tp = setup
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(np_params)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(flat_j) == set(flat_t)
    for k, v in flat_t.items():
        np.testing.assert_array_equal(v.numpy(), flat_j[k])
    assert tp["enc_layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert tp["dec_layers"]["cross_attn"]["wk"].shape == (4, 64, 4, 16)
    assert tp["embed"]["pos_table"].shape == (8192, 64)
    own = build_model(cfg).init(0, "cpu")
    assert {k: tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(own)[0]} == \
        {k: tuple(v.shape) for k, v in
         jax.tree_util.tree_flatten_with_path(tp)[0]}


# --- layers ------------------------------------------------------------------

def test_learned_positions_are_added_as_in_jax(setup):
    jcfg, cfg, jp, _, tp = setup
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 5))
    pos = rng.integers(0, 8192, (2, 5))
    want = jll.embed_tokens(jp["embed"], jnp.asarray(toks, jnp.int32), jcfg,
                            positions=jnp.asarray(pos, jnp.int32))
    got = ll.embed_tokens(tp["embed"], torch.as_tensor(toks), cfg,
                          positions=torch.as_tensor(pos))
    close(want, got, 0.0)
    bare = ll.embed_tokens(tp["embed"], torch.as_tensor(toks), cfg)
    assert float((got - bare).abs().max()) > 1e-3


@pytest.mark.parametrize("chunk", [64, 8], ids=["naive", "blockwise"])
def test_cross_attention_matches_jax(chunk):
    """``cross=True`` drops the mask in the naive and the blockwise
    branch (s_kv = 24 over chunks of 8), as JAX's; the flash kernel's
    function with ``causal=False`` is the same."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
            for _ in range(2))
    qp = np.tile(np.arange(5), (2, 1))
    kp = np.tile(np.arange(24), (2, 1))
    if chunk < 24:
        want = jll.blockwise_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                       chunk=chunk, cross=True)
        got = ll.blockwise_attention(*map(torch.as_tensor, (q, k, v, qp, kp)),
                                     chunk=chunk, cross=True)
    else:
        want = jll.naive_causal_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                          cross=True)
        got = ll.naive_causal_attention(
            *map(torch.as_tensor, (q, k, v, qp, kp)), cross=True)
    close(want, got, 1e-5)
    flash = flash_ops.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                      causal=False)
    torch.testing.assert_close(flash, got, atol=1e-5, rtol=1e-5)
    causal = ll.naive_causal_attention(
        *map(torch.as_tensor, (q, k, v, qp, kp)))
    assert float((causal - got).abs().max()) > 1e-3


def test_encode_matches_jax(setup):
    """The encoder's frames attend each other both ways (``kv``)."""
    jcfg, cfg, jp, _, tp = setup
    _, enc = _inputs(cfg, 2, 3, seed=3)
    jpf = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    want = jed.encode(jpf, jnp.asarray(enc), jcfg, IDENTITY_SHARDER)
    got = ed.encode(tp, torch.as_tensor(enc), cfg)
    assert got.shape == (2, cfg.enc_seq, cfg.d_model)
    close(want, got, TOL["float32"])


def test_cross_kv_and_decode_cross_match_jax(setup):
    jcfg, cfg, jp, _, tp = setup
    jl0, tl0 = _dec0(jp, tp)
    rng = np.random.default_rng(4)
    enc_out = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    h = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jk, jv = jed._cross_kv(jl0, jnp.asarray(enc_out), jcfg)
    tk, tv = ed._cross_kv(tl0, torch.as_tensor(enc_out), cfg)
    close(jk, tk, TOL["float32"])
    close(jv, tv, TOL["float32"])
    jc = {"k": jk.transpose(0, 2, 1, 3), "v": jv.transpose(0, 2, 1, 3)}
    tc = {"k": tk.transpose(1, 2), "v": tv.transpose(1, 2)}
    want = jed._decode_cross(jl0, jnp.asarray(h), jcfg, jc, IDENTITY_SHARDER)
    got = ed._decode_cross(tl0, torch.as_tensor(h), cfg, tc)
    assert got.shape == (2, 1, cfg.d_model)
    close(want, got, TOL["float32"])


def test_decode_cross_divides_the_bf16_scores_in_f32():
    """JAX divides the bf16 scores by an f32 array, which promotes them
    to f32 first; the port casts before the divide.  At a head dim of 24
    the divide by sqrt(24) rounds, so a bf16 divide would give other
    probabilities: the port equals JAX run op by op."""
    jcfg = dataclasses.replace(jax_smoke(jax_get_config(ARCH)), d_head=24)
    cfg = dataclasses.replace(smoke(get_config(ARCH)), d_head=24)
    rng = np.random.default_rng(5)
    d, h, hd, s = cfg.d_model, cfg.n_heads, 24, cfg.enc_seq
    lp = {"cross_attn": {
        "wq": rng.standard_normal((d, h, hd)) / math.sqrt(d),
        "wo": rng.standard_normal((h, hd, d)) / math.sqrt(h * hd)}}
    x = rng.standard_normal((3, 1, d))
    cache = {n: rng.standard_normal((3, h, s, hd)) * 3 for n in ("k", "v")}

    def bf16(tree, mod):
        return jax.tree.map(lambda a: mod(np.asarray(a, np.float32)), tree)
    with jax.disable_jit():
        want = jed._decode_cross(
            bf16(lp, lambda a: jnp.asarray(a, jnp.bfloat16)),
            jnp.asarray(x, jnp.bfloat16), jcfg,
            bf16(cache, lambda a: jnp.asarray(a, jnp.bfloat16)),
            IDENTITY_SHARDER)
    got = ed._decode_cross(
        bf16(lp, lambda a: torch.as_tensor(a).bfloat16()),
        torch.as_tensor(x).bfloat16(), cfg,
        bf16(cache, lambda a: torch.as_tensor(a).bfloat16()))
    assert got.dtype == torch.bfloat16
    close(want, got, 0.0)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_dec_forward_matches_jax(setup, mode):
    """The decoder stack in each mode, from the same encoder output (f32):
    decode continues a prefill of 6 tokens at ``cur_len`` 6 and 4."""
    jcfg, cfg, jp, _, tp = setup
    jpf = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    rng = np.random.default_rng(6)
    enc_out = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(6), (2, 1))
    kw = dict(seq_capacity=12)
    jx, jc = jed.dec_forward(jpf, jnp.asarray(x), jnp.asarray(enc_out), jcfg,
                             IDENTITY_SHARDER, jnp.asarray(pos),
                             "train" if mode == "train" else "prefill", **kw)
    tx, tc = ed.dec_forward(tp, torch.as_tensor(x), torch.as_tensor(enc_out),
                            cfg, torch.as_tensor(pos),
                            "train" if mode == "train" else "prefill", **kw)
    close(jx, tx, TOL["float32"])
    if mode == "train":
        assert tc is None
        return
    for part in ("self", "cross"):
        for n in ("k", "v"):
            close(jc[part][n], tc[part][n], TOL["float32"])
    if mode == "prefill":
        return
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    cur = np.array([6, 4])
    jx, jc = jed.dec_forward(jpf, jnp.asarray(x1), None, jcfg,
                             IDENTITY_SHARDER, None, "decode", cache=jc,
                             cur_len=jnp.asarray(cur, jnp.int32))
    tx, tc2 = ed.dec_forward(tp, torch.as_tensor(x1), None, cfg, None,
                             "decode", cache=tc, cur_len=torch.as_tensor(cur))
    assert tc2 is tc
    close(jx, tx, TOL["float32"])
    for part in ("self", "cross"):
        for n in ("k", "v"):
            close(jc[part][n], tc[part][n], TOL["float32"])


# --- the model ---------------------------------------------------------------

def test_train_logits_and_loss_match_jax_f32(setup):
    jcfg, cfg, jp, _, tp = setup
    toks, enc = _inputs(cfg, 2, 10)
    labels = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 10))
    jl, _, _ = jed.encdec_apply(jp, _jbatch(toks, enc), jcfg, mode="train",
                                compute_dtype=jnp.float32)
    tl, _, aux = ed.encdec_apply(tp, _tbatch(toks, enc), cfg, mode="train",
                                 compute_dtype=torch.float32)
    assert tl.shape == (2, 10, 256) and float(aux) == 0.0
    close(jl, tl, TOL["float32"])
    jloss = jll.cross_entropy(jl, jnp.asarray(labels, jnp.int32), jcfg)
    tloss = ll.cross_entropy(tl, torch.as_tensor(labels), cfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def _slot_caches(apply, params, cfg, toks, enc, cap, mod):
    """Prefill each row on its own (lengths L and L - 2) and join the
    caches along the batch axis: slots at different positions."""
    outs = [apply(params, {"tokens": toks[i:i + 1, :toks.shape[1] - 2 * i],
                           "enc_embeds": enc[i:i + 1]}, cfg,
                  mode="prefill", seq_capacity=cap) for i in range(2)]
    logits = mod.concatenate([o[0] for o in outs], 0)
    cache = {part: {n: mod.concatenate([o[1][part][n] for o in outs], 1)
                    for n in ("k", "v")} for part in ("self", "cross")}
    return logits, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(setup, dtype):
    """A prefill of L = 9 and 7 tokens (one slot each), then 3 decode
    steps at the per-slot ``cur_len``, each at its learned position."""
    jcfg, cfg, jp, _, tp = setup
    L, cap = 9, 16
    toks, enc = _inputs(cfg, 2, L, seed=8)

    def jax_apply(*a, **kw):
        if dtype == "float32":
            return jed.encdec_apply(*a, **kw, compute_dtype=jnp.float32)
        with jax.disable_jit():
            return jed.encdec_apply(*a, **kw, compute_dtype=jnp.bfloat16)

    def torch_apply(*a, **kw):
        return ed.encdec_apply(*a, **kw, compute_dtype=TDT[dtype])

    jl, jc = _slot_caches(jax_apply, jp, jcfg, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(enc), cap, jnp)
    tl, tc = _slot_caches(torch_apply, tp, cfg, torch.as_tensor(toks),
                          torch.as_tensor(enc), cap, torch)
    assert tc["self"]["k"].shape == (cfg.n_layers, 2, 4, cap, 16)
    assert tc["cross"]["k"].shape == (cfg.n_layers, 2, 4, cfg.enc_seq, 16)
    close(jl, tl, TOL[dtype])
    cur = np.array([L, L - 2])
    tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
    for _ in range(3):
        jl, jc, _ = jax_apply(jp, {"tokens": jnp.asarray(tok, jnp.int32)},
                              jcfg, mode="decode", cache=jc,
                              cur_len=jnp.asarray(cur, jnp.int32))
        tl, tc2, _ = torch_apply(tp, {"tokens": torch.as_tensor(tok)}, cfg,
                                 mode="decode", cache=tc,
                                 cur_len=torch.as_tensor(cur))
        assert tc2 is tc
        close(jl, tl, TOL[dtype])
        for part in ("self", "cross"):
            for n in ("k", "v"):
                close(jc[part][n], tc[part][n], TOL[dtype])
        tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
        cur = cur + 1


def test_cache_spec_and_init_cache_match_jax():
    jcfg, cfg = jax_smoke(jax_get_config(ARCH)), smoke(get_config(ARCH))
    want = jed.encdec_cache_spec(jcfg, 3, 20)
    got = ed.encdec_cache_spec(cfg, 3, 20)
    for part in ("self", "cross"):
        for n in ("k", "v"):
            assert got[part][n].shape == want[part][n].shape
            assert got[part][n].dtype == torch.bfloat16
    cache = build_model(cfg).init_cache(3, 20, "cpu")
    assert cache["cross"]["v"].shape == (4, 3, 4, 16, 16)
    assert not any(bool(cache[p][n].any()) for p in cache for n in ("k", "v"))


# --- serving and training ----------------------------------------------------

class JaxF32Model(JaxModel):
    def prefill(self, params, batch, sharder=IDENTITY_SHARDER, chunk=2048,
                seq_capacity=0):
        logits, cache, _ = jed.encdec_apply(
            params, batch, self.cfg, sharder, mode="prefill", chunk=chunk,
            seq_capacity=seq_capacity, compute_dtype=jnp.float32)
        return logits, cache

    def decode(self, params, batch, cache, cur_len, sharder=IDENTITY_SHARDER):
        logits, cache, _ = jed.encdec_apply(
            params, batch, self.cfg, sharder, mode="decode", cache=cache,
            cur_len=cur_len, compute_dtype=jnp.float32)
        return logits, cache

    def train_logits(self, params, batch, sharder=IDENTITY_SHARDER,
                     chunk=2048):
        logits, _, aux = jed.encdec_apply(params, batch, self.cfg, sharder,
                                          mode="train", chunk=chunk,
                                          compute_dtype=jnp.float32)
        return logits, aux


def test_server_with_frames_matches_jax_server_f32(setup):
    """Requests with ``extras["enc_embeds"]``: the same decisions and
    greedy tokens as ``repro.serve.BatchServer``.  The frames never enter
    the decoder's sequence, so ``cur_len = len(prompt)`` after a prefill
    is each slot's own position; an empty slot's cross cache is zeros."""
    jcfg, cfg, jp, _, tp = setup
    rng = np.random.default_rng(9)
    lens, new = [4, 3, 2, 10, 3], [5, 3, 6, 10, 2]
    reqs = [(rng.integers(0, cfg.vocab_size, n),
             (rng.standard_normal((cfg.enc_seq, cfg.d_model)) * 0.1
              ).astype(np.float32)) for n in lens]
    jsrv = JaxBatchServer(model=JaxF32Model(jcfg), params=jp, slots=2,
                          seq_capacity=16)
    jsrv.instantiate()
    jdone = jsrv.serve([JaxRequest(rid=i, prompt=p, max_new_tokens=m,
                                   extras={"enc_embeds": e})
                        for i, ((p, e), m) in enumerate(zip(reqs, new))])
    srv = BatchServer(build_model(cfg, torch.float32), tp, slots=2,
                      seq_capacity=16, device="cpu")
    done = srv.serve([Request(rid=i, prompt=p, max_new_tokens=m,
                              extras={"enc_embeds": e})
                      for i, ((p, e), m) in enumerate(zip(reqs, new))])
    assert ([dataclasses.astuple(d) for d in srv.scheduler.decisions]
            == [dataclasses.astuple(d) for d in jsrv.scheduler.decisions])
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.output == jr.output, r.rid
    assert srv.tokens_out == jsrv.stats.flat()["server.tokens_out"]


def test_train_steps_carry_the_frames_and_match_jax():
    """The port's pipeline gives the JAX pipeline's batches, frames
    included, and two train steps (f32 compute) give JAX's loss and
    gradient norm: the frames reach the loss through the encoder."""
    jcfg, cfg = jax_smoke(jax_get_config(ARCH)), smoke(get_config(ARCH))
    shape = dict(name="t", seq_len=12, global_batch=2, kind="train")
    jpipe = JaxPipeline(jcfg, JaxShapeConfig(**shape), seed=3)
    pipe = SyntheticPipeline(cfg, ShapeConfig(**shape), seed=3)
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=10, chunk=16)
    jstate = jax_init_train_state(JaxF32Model(jcfg), jax.random.PRNGKey(0),
                                  JaxTrainOptions(**kw))
    jfn = jax.jit(jax_build_train_step(JaxF32Model(jcfg),
                                       JaxTrainOptions(**kw)))
    opts = TrainOptions(**kw)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                  opts, "cpu")
    tfn = build_train_step(build_model(cfg, torch.float32), opts)
    for i in range(2):
        jb, b = jpipe.batch(i), pipe.batch(i)
        assert set(b) == set(jb) == {"tokens", "labels", "mask",
                                     "enc_embeds"}
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k])
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        tstate, tm = tfn(tstate, batch_to(b, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    grads = tstate["params"]["enc_layers"]["attn"]["wq"]
    assert bool(torch.isfinite(grads).all())


def test_params_cast_once_serve(setup):
    """``Model.load`` casts the converted tree once; the bf16 prefill
    through it equals ``encdec_apply`` on the f32 tree (cast per call)."""
    _, cfg, _, _, tp = setup
    model = build_model(cfg)
    toks, enc = _inputs(cfg, 1, 5, seed=10)
    got, _ = model.prefill(model.load(tp, "cpu"), _tbatch(toks, enc))
    want, _, _ = ed.encdec_apply(cast(tp, torch.bfloat16), _tbatch(toks, enc),
                                 cfg, mode="prefill")
    assert torch.equal(got, want)


# --- launchers -------------------------------------------------------------

class _Recorder:
    """Stands in for a launcher's server: records the requests."""
    seen = []
    tokens_out = requests = decode_steps = tokens_per_decode_step = 0
    latency = [0.0]

    def __init__(self, *a, **kw):
        pass

    def instantiate(self):
        pass

    def serve(self, reqs):
        _Recorder.seen = reqs
        return []

    class stats:
        @staticmethod
        def dump_text():
            return ""


def test_launchers_draw_the_same_requests(monkeypatch):
    """The same seed gives the same prompts and frame embeddings in
    ``repro.launch.serve`` and ``repro_torch.launch.serve``."""
    import sys

    from repro.launch import serve as jax_launch
    from repro_torch.launch import serve as torch_launch
    monkeypatch.setattr(jax_launch, "BatchServer", _Recorder)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH,
                                      "--requests", "3", "--seed", "7"])
    jax_launch.main()
    want = _Recorder.seen
    monkeypatch.setattr(torch_launch, "BatchServer", _Recorder)
    torch_launch.main(["--arch", ARCH, "--requests", "3", "--seed", "7",
                       "--device", "cpu"])
    got = _Recorder.seen
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert set(g.extras) == set(w.extras) == {"enc_embeds"}
        np.testing.assert_array_equal(g.extras["enc_embeds"],
                                      w.extras["enc_embeds"])


def test_launcher_serves_whisper_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--requests", "3", "--max-new", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "req 2:" in out and "server.requests 3" in out
