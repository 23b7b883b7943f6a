"""The port's VLM slice (qwen2-vl-7b: M-RoPE, a vision prefix) against
the JAX package, on ``smoke(qwen2-vl-7b)``: 4 layers, d_model 64, d_head
16, heads 4 over 1 kv head, n_vis 4.

Parameters are initialised once in JAX and converted with
``params_from_jax``; every other input is drawn from a numpy seed.
Tolerances:

* ``rope_angles`` in f32: equal (the same correctly rounded inverse
  frequencies and f32 products); ``apply_rope``: 1e-6 (cos and sin of
  the same angles, up to each library's last bit), also at d_head 128
  (sections 16/24/24).
* ``make_positions``: equal integers.
* ``lm_apply`` in f32 (train, prefill, decode): 1e-5, as
  ``tests/test_torch_model.py``.  Decode runs at the model's own
  position ``cur_len = n_vis + L``, a per-slot vector.
* bf16 prefill and decode: 2e-2 against JAX run op by op
  (``jax.disable_jit``), as ``tests/test_torch_model.py``.
* The server, computing in f32: the same decision log and tokens as
  ``repro.serve.BatchServer``.  Both servers set ``cur_len =
  len(prompt)`` after a prefill that holds ``n_vis + len(prompt)``
  tokens, as the JAX server does (``src/repro/serve/server.py``).
* The kernel's mask: ``flash_attention``'s plain version with ``prefix
  = n_vis`` equals the model's plain attention masked by the temporal
  M-RoPE coordinate, within 1e-6.
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
from repro.models import build_model as jax_build_model
from repro.models import layers as jll
from repro.models import transformer as jtf
from repro.models.common import IDENTITY_SHARDER
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model
from repro_torch.models import layers as ll
from repro_torch.models import transformer as ttf
from repro_torch.serve import BatchServer, Request

ARCH = "qwen2-vl-7b"
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_smoke(jax_get_config(ARCH)), smoke(get_config(ARCH))
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jp, np_params, params_from_jax(np_params, cfg, "cpu")


def _inputs(cfg, b: int, s_text: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s_text))
    vis = (rng.standard_normal((b, cfg.n_vis, cfg.d_model)) * 0.1
           ).astype(np.float32)
    return toks, vis


def _jbatch(toks, vis):
    return {"tokens": jnp.asarray(toks, jnp.int32),
            "vision_embeds": jnp.asarray(vis)}


def _tbatch(toks, vis):
    return {"tokens": torch.as_tensor(toks),
            "vision_embeds": torch.as_tensor(vis)}


def close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


def test_config_is_the_published_backbone():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.pos_scheme, cfg.n_vis) == ("vlm", "mrope", 256)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        28, 3584, 28, 4, 128, 18944, 152064)
    assert cfg.rope_theta == 1e6
    assert abs(cfg.param_counts()["total"] / 1e9 - 7.615) < 0.01


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_rope_angles_and_apply_rope_match_jax(width):
    """(b, s, 3) positions with distinct t/h/w; at full width the
    sections are 16/24/24 of the 64 frequencies."""
    cfg = get_config(ARCH) if width == "full" else smoke(get_config(ARCH))
    jcfg = (jax_get_config(ARCH) if width == "full"
            else jax_smoke(jax_get_config(ARCH)))
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 3000, (2, 9, 3))
    x = rng.standard_normal((2, 9, 3, cfg.head_dim)).astype(np.float32)
    ja = jll.rope_angles(jcfg, jnp.asarray(pos, jnp.int32))
    ta = ll.rope_angles(cfg, torch.as_tensor(pos))
    assert ta.shape == (2, 9, cfg.head_dim // 2)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if width == "full":
        nf = cfg.head_dim // 2
        inv = ll._inv_freq(cfg.head_dim, cfg.rope_theta)
        for c, (lo, hi) in enumerate(((0, 16), (16, 40), (40, nf))):
            want = torch.as_tensor(pos[..., c:c + 1]).float() * inv[lo:hi]
            assert torch.equal(ta[..., lo:hi], want)
    close(jll.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos, jnp.int32)),
          ll.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(pos)), 1e-6)


@pytest.mark.parametrize("n_vis,s,offset", [(0, 6, 0), (4, 9, 0), (5, 9, 0),
                                            (4, 9, 3)])
def test_make_positions_matches_jax(setup, n_vis, s, offset):
    """n_vis 5 is not square: a grid of 2."""
    jcfg, cfg = setup[:2]
    want = np.asarray(jtf.make_positions(jcfg, 2, s, n_vis=n_vis,
                                         offset=offset))
    got = ttf.make_positions(cfg, 2, s, torch.device("cpu"), n_vis=n_vis,
                             offset=offset)
    assert got.shape == (2, s, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_prefix_is_the_mrope_mask(setup):
    """The CUDA path's attention (the kernel's function: index mask,
    ``prefix = n_vis``) is the plain path's (JAX's: the temporal M-RoPE
    coordinate), for a square and a non-square vision prefix."""
    cfg = setup[1]
    gen = torch.Generator().manual_seed(2)
    for n_vis in (4, 5):
        s = n_vis + 7
        q = torch.randn(2, s, cfg.n_heads, cfg.head_dim, generator=gen)
        k, v = (torch.randn(2, s, cfg.n_kv_heads, cfg.head_dim,
                            generator=gen) for _ in range(2))
        t = ttf.make_positions(cfg, 2, s, torch.device("cpu"),
                               n_vis=n_vis)[..., 0]
        want = ll.naive_causal_attention(q, ll._repeat_kv(k, cfg.n_heads),
                                         ll._repeat_kv(v, cfg.n_heads), t, t)
        got = flash_ops.flash_attention(q, k, v, prefix=n_vis)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        plain = flash_ops.flash_attention(q, k, v)
        assert float((plain[:, :n_vis] - want[:, :n_vis]).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="prefix"):
        flash_ops.flash_attention(q, k, v, window=4, prefix=2)


def test_params_from_jax_covers_the_vlm_tree(setup):
    """qwen2-vl's tree is the dense tree: the same key paths, shapes and
    stacked layer axis, leaf for leaf, and the port's own init draws the
    same tree."""
    jcfg, cfg, jp, np_params, tp = setup
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(np_params)[0]}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(flat_j) == set(flat_t)
    for k, v in flat_t.items():
        np.testing.assert_array_equal(v.numpy(), flat_j[k])
    assert tp["layers"]["mixer"]["wq"].shape == (4, 64, 4, 16)
    own = build_model(cfg).init(0, "cpu")
    assert {k: tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(own)[0]} == \
        {k: tuple(v.shape) for k, v in
         jax.tree_util.tree_flatten_with_path(tp)[0]}


def test_train_logits_and_loss_match_jax_f32(setup):
    """Train mode over the merged sequence; labels and mask of length
    n_vis + s_text (the vision part masked), as JAX's input specs."""
    jcfg, cfg, jp, _, tp = setup
    toks, vis = _inputs(cfg, 2, 10)
    s = cfg.n_vis + 10
    rng = np.random.default_rng(5)
    labels = rng.integers(0, cfg.vocab_size, (2, s))
    mask = np.zeros((2, s), np.float32)
    mask[:, cfg.n_vis:] = 1.0
    jl, _, _ = jtf.lm_apply(jp, _jbatch(toks, vis), jcfg, mode="train",
                            compute_dtype=jnp.float32)
    tl, _, _ = ttf.lm_apply(tp, _tbatch(toks, vis), cfg, mode="train",
                            compute_dtype=torch.float32)
    assert tl.shape == (2, s, 256)
    close(jl, tl, TOL["float32"])
    jloss = jll.cross_entropy(jl, jnp.asarray(labels, jnp.int32), jcfg,
                              jnp.asarray(mask))
    tloss = ll.cross_entropy(tl, torch.as_tensor(labels), cfg,
                             torch.as_tensor(mask))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def _slot_caches(apply, params, cfg, toks, vis, cap, mod):
    """Prefill each row on its own (text lengths L and L - 2) and join the
    caches along the batch axis: slots at different positions."""
    outs = [apply(params, {"tokens": toks[i:i + 1, :toks.shape[1] - 2 * i],
                           "vision_embeds": vis[i:i + 1]}, cfg,
                  mode="prefill", seq_capacity=cap) for i in range(2)]
    logits = mod.concatenate([o[0] for o in outs], 0)
    cache = {n: mod.concatenate([o[1][n] for o in outs], 1)
             for n in ("k", "v")}
    return logits, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(setup, dtype):
    """A prefill of n_vis + L tokens, then 3 decode steps at the model's
    own positions ``cur_len = n_vis + L`` per slot (L = 9 and 7)."""
    jcfg, cfg, jp, _, tp = setup
    L, cap = 9, 24
    toks, vis = _inputs(cfg, 2, L, seed=3)

    def jax_apply(*a, **kw):
        if dtype == "float32":
            return jtf.lm_apply(*a, **kw, compute_dtype=jnp.float32)
        with jax.disable_jit():
            return jtf.lm_apply(*a, **kw, compute_dtype=jnp.bfloat16)

    def torch_apply(*a, **kw):
        return ttf.lm_apply(*a, **kw, compute_dtype=TDT[dtype])

    jl, jc = _slot_caches(jax_apply, jp, jcfg, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(vis), cap, jnp)
    tl, tc = _slot_caches(torch_apply, tp, cfg, torch.as_tensor(toks),
                          torch.as_tensor(vis), cap, torch)
    assert tc["k"].shape == (cfg.n_layers, 2, 1, cap, cfg.head_dim)
    close(jl, tl, TOL[dtype])
    for n in ("k", "v"):
        close(jc[n], tc[n], TOL[dtype])
    cur = np.array([cfg.n_vis + L, cfg.n_vis + L - 2])
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
        for n in ("k", "v"):
            close(jc[n], tc[n], TOL[dtype])
        tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
        cur = cur + 1


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


PROMPT_LENS = [4, 3, 2, 10, 3]
MAX_NEW = [5, 3, 6, 10, 2]
SLOTS, CAP = 2, 16


def test_server_with_vision_extras_matches_jax_server_f32(setup):
    """Requests with ``extras["vision_embeds"]``: the same decisions and
    greedy tokens as ``repro.serve.BatchServer``, computing in f32."""
    jcfg, cfg, jp, _, tp = setup
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, n),
             (rng.standard_normal((cfg.n_vis, cfg.d_model)) * 0.1
              ).astype(np.float32)) for n in PROMPT_LENS]
    jsrv = JaxBatchServer(model=JaxF32Model(jcfg), params=jp, slots=SLOTS,
                          seq_capacity=CAP)
    jsrv.instantiate()
    jdone = jsrv.serve([JaxRequest(rid=i, prompt=p, max_new_tokens=m,
                                   extras={"vision_embeds": v})
                        for i, ((p, v), m) in enumerate(zip(reqs, MAX_NEW))])
    srv = BatchServer(build_model(cfg, torch.float32), tp, slots=SLOTS,
                      seq_capacity=CAP, device="cpu")
    done = srv.serve([Request(rid=i, prompt=p, max_new_tokens=m,
                              extras={"vision_embeds": v})
                      for i, ((p, v), m) in enumerate(zip(reqs, MAX_NEW))])
    assert ([dataclasses.astuple(d) for d in srv.scheduler.decisions]
            == [dataclasses.astuple(d) for d in jsrv.scheduler.decisions])
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.output == jr.output, r.rid
    assert srv.tokens_out == jsrv.stats.flat()["server.tokens_out"]
    # the vision prefix reaches the tokens: without it they change
    bare = BatchServer(build_model(cfg, torch.float32), tp, slots=SLOTS,
                       seq_capacity=CAP, device="cpu").serve(
        [Request(rid=i, prompt=p, max_new_tokens=m)
         for i, ((p, _), m) in enumerate(zip(reqs, MAX_NEW))])
    assert [r.output for r in bare] != [r.output for r in done]


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
    """The same seed gives the same prompts and vision embeddings in
    ``repro.launch.serve`` and ``repro_torch.launch.serve``: both draw the
    length, the embeddings, then the prompt."""
    import sys

    from repro.launch import serve as jax_launch
    from repro_torch.launch import serve as torch_launch
    monkeypatch.setattr(jax_launch, "BatchServer", _Recorder)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH,
                                      "--requests", "4", "--seed", "7"])
    jax_launch.main()
    want = _Recorder.seen
    monkeypatch.setattr(torch_launch, "BatchServer", _Recorder)
    torch_launch.main(["--arch", ARCH, "--requests", "4", "--seed", "7",
                       "--device", "cpu"])
    got = _Recorder.seen
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert set(g.extras) == set(w.extras) == {"vision_embeds"}
        np.testing.assert_array_equal(g.extras["vision_embeds"],
                                      w.extras["vision_embeds"])
