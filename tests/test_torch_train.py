"""The port's training path (``repro_torch.train``, ``Model.train_logits``,
``cross_entropy``) against the JAX package's on the CPU.

Parameters and train states are initialised in JAX and carried across
(``params_from_jax``, ``train_state_from_jax``); batches come from the
synthetic pipeline (numpy, one seed).  Covered: ``cross_entropy`` with a
padded vocab and a mask; ``train_logits``, the aux loss and the gradient
of every leaf against ``jax.value_and_grad`` for the smoke configs of
stablelm-1.6b, minicpm-2b (tied embeddings, residual scale),
nemotron-4-15b (squared ReLU, GQA) and olmoe-1b-7b (MoE, aux loss in the
loss), each with the naive (s <= chunk) and the checkpointed blockwise
(s > chunk) attention; 10 steps of ``build_train_step`` step by step;
one step resumed from a JAX state after 3 JAX steps; the pipeline copy;
the config copies; the launcher; and the forward-only kernel wrappers,
which training must not reach.  Tolerances:

* f32 compute, against JAX compiled: logits and loss 1e-5 (other
  summation orders; seen 2.4e-6 on logits, 1.5e-5 on minicpm's logits
  of ~80, hence rtol); the gradient of each leaf within 1e-5 of that
  leaf's largest gradient (seen 1.3e-6).
* bf16 compute, against JAX run op by op (``jax.disable_jit``): logits
  within 2e-2 relative plus 2e-2 of the largest logit (bf16 roundings in
  other places, a few bf16 ulps: seen 0.03 on logits of 4.5, 0.5 on
  minicpm's 80); each leaf's gradient within 3e-2
  of its largest gradient (seen 1.7e-2: bf16 products of the backward
  pass, rounded where the two frameworks round).
* 10 train steps, f32 compute: loss 1e-5 and grad_norm 1e-4 relative,
  lr 1e-6 relative.  The two trajectories start from the same state and
  drift only by the ulps of each step's gradients (seen 2e-6 on loss).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import SyntheticPipeline as JaxPipeline
from repro.models import api as jax_api
from repro.models import transformer as jtf
from repro.models.common import IDENTITY_SHARDER
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.compress import init_error_buffer as jax_init_error_buffer
from repro.train import step as jax_step
from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_mlp import ops as moe_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, layers, moe
from repro_torch.models.common import leaves
from repro_torch.models.layers import cross_entropy
from repro_torch.train import (TrainOptions, batch_to, build_train_step,
                               default_options_for, init_train_state)

ARCHS = ["stablelm-1.6b", "minicpm-2b", "nemotron-4-15b", "olmoe-1b-7b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SEQ, BATCH = 32, 4


class JaxModelF32(jax_api.Model):
    """The JAX model with f32 compute in ``train_logits`` (the JAX
    ``Model`` always trains in bf16), so that the step-by-step test holds
    the two packages to f32 tolerances."""

    def train_logits(self, params, batch, sharder=IDENTITY_SHARDER,
                     chunk=2048):
        logits, _, aux = jtf.lm_apply(params, batch, self.cfg, sharder,
                                      mode="train", chunk=chunk,
                                      compute_dtype=jnp.float32)
        return logits, aux


def configs(arch):
    return jax_smoke(jax_get_config(arch)), smoke(get_config(arch))


def jax_batch(jcfg, step=0, seed=0, batch=BATCH):
    return JaxPipeline(jcfg, JaxShapeConfig("t", SEQ, batch, "train"),
                       seed=seed).batch(step)


@functools.lru_cache(maxsize=None)
def jax_params(arch, seed=0):
    """JAX-initialised params of the smoke config (drawing them op by op
    takes seconds, so once per arch and seed)."""
    return jax_api.Model(configs(arch)[0]).init(jax.random.PRNGKey(seed))


def jax_train_state(arch, jopts, seed=1):
    """``repro.train.step.init_train_state`` from the cached params."""
    params = jax_params(arch, seed)
    state = {"params": params,
             "opt": jax_adamw_init(params, jnp.dtype(jopts.moment_dtype)),
             "step": jnp.zeros((), jnp.int32)}
    if jopts.grad_compress:
        state["err"] = jax_init_error_buffer(params)
    return state


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    jcfg, cfg = configs(request.param)
    jp = jax_params(request.param)
    return jcfg, cfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_with_padded_vocab(masked):
    jcfg, cfg = configs("stablelm-1.6b")
    jcfg = dataclasses.replace(jcfg, vocab_size=250)
    cfg = dataclasses.replace(cfg, vocab_size=250)
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 256)).astype(np.float32) * 3
    logits[..., 250:] = 50.0            # the padding must not count
    labels = rng.integers(0, 250, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jcfg,
                             mask=None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels), cfg,
                        mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("chunk", [64, 16], ids=["naive", "blockwise"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_and_grads_match_jax(arch_params, dtype, chunk):
    jcfg, cfg, jp, np_params = arch_params
    b = jax_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jax_loss(params):
        lg, _, aux = jtf.lm_apply(params, jb, jcfg, mode="train", chunk=chunk,
                                  compute_dtype=JDT[dtype])
        loss = jax_cross_entropy(lg, jb["labels"], jcfg, mask=jb["mask"])
        return loss + 0.01 * aux, (lg, aux)

    grad_fn = jax.value_and_grad(jax_loss, has_aux=True)
    if dtype == "bfloat16":
        with jax.disable_jit():
            (jl, (jlg, jaux)), jg = grad_fn(jp)
    else:
        (jl, (jlg, jaux)), jg = grad_fn(jp)

    tp = params_from_jax(np_params, cfg, "cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    tb = batch_to(b, "cpu")
    lg, aux = build_model(cfg, TDT[dtype]).train_logits(tp, tb, chunk=chunk)
    loss = cross_entropy(lg, tb["labels"], cfg, mask=tb["mask"]) + 0.01 * aux
    grads = torch.autograd.grad(loss, list(leaves(tp)))

    assert lg.shape == (BATCH, SEQ, 256) and lg.dtype == TDT[dtype]
    tol = LOGIT_TOL[dtype]
    want = np.asarray(jlg, np.float32)
    # bf16: a rounding flipped early moves a logit by ulps of the largest
    # logits (0.5 at minicpm's ~80), so the bound scales with them
    scale = np.abs(want).max() if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(lg.detach().float().numpy(), want,
                               atol=tol * scale, rtol=tol)
    loss, aux = float(loss.detach()), float(aux.detach())
    np.testing.assert_allclose(loss, float(jl), atol=tol, rtol=tol)
    np.testing.assert_allclose(aux, float(jaux), atol=tol, rtol=tol)
    assert (aux > 0) == (cfg.family == "moe")
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for want, got in zip(jleaves, grads):
        want = np.asarray(want, np.float32)
        assert np.abs(want).max() > 0
        err = np.abs(got.numpy() - want).max()
        assert err <= GRAD_TOL[dtype] * np.abs(want).max(), err


def _run_steps(arch, opts, n_steps, batch=BATCH, resume_after=0):
    """(JAX metrics, port metrics) per step: both start from one
    JAX-initialised state; a resumed port starts after ``resume_after``
    JAX steps, from the JAX state."""
    jcfg, cfg = configs(arch)
    jopts = jax_step.TrainOptions(**dataclasses.asdict(opts))
    jmodel = JaxModelF32(jcfg)
    jstate = jax_train_state(arch, jopts)
    jfn = jax.jit(jax_step.build_train_step(jmodel, jopts))
    pipe = JaxPipeline(jcfg, JaxShapeConfig("t", SEQ, batch, "train"), seed=3)
    tfn = build_train_step(build_model(cfg, torch.float32), opts)
    tstate, jm, tm = None, [], []
    for i in range(n_steps):
        if i == resume_after:
            tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                          cfg, opts, "cpu")
        b = pipe.batch(i)
        jstate, m = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
        if tstate is not None:
            tstate, m = tfn(tstate, batch_to(b, "cpu"))
            tm.append({k: float(v) for k, v in m.items()})
    return jm[resume_after:], tm, tstate, cfg


def _close_steps(jm, tm):
    assert len(jm) == len(tm)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["aux_loss"], j["aux_loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)


@pytest.mark.parametrize("variant", ["plain", "grad_compress", "accum2"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b"])
def test_ten_train_steps_match_jax(arch, variant):
    opts = TrainOptions(peak_lr=3e-3, warmup=3, total_steps=10,
                        grad_compress=variant == "grad_compress",
                        accum_steps=2 if variant == "accum2" else 1)
    jm, tm, state, cfg = _run_steps(arch, opts, 10)
    _close_steps(jm, tm)
    assert tm[-1]["loss"] < tm[0]["loss"]          # the stream is learnable
    assert (tm[0]["aux_loss"] > 0) == (cfg.family == "moe")
    assert int(state["step"]) == 10 and int(state["opt"]["count"]) == 10
    assert ("err" in state) == opts.grad_compress


def test_wsd_schedule_steps_match_jax():
    """minicpm's default options take the WSD schedule."""
    jcfg, cfg = configs("minicpm-2b")
    assert default_options_for(cfg).schedule == "wsd"
    assert jax_step.default_options_for(jcfg).schedule == "wsd"
    opts = dataclasses.replace(default_options_for(cfg), warmup=2,
                               wsd_stable=2, wsd_decay=3, peak_lr=1e-3)
    jm, tm, _, _ = _run_steps("minicpm-2b", opts, 8)
    _close_steps(jm, tm)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_resumed_step_from_a_jax_state_matches_jax(moments):
    """After 3 JAX steps the bias corrections are not trivial; the port
    takes the JAX state (params, moments, count, step, error buffer) and
    goes on in step."""
    opts = TrainOptions(peak_lr=3e-3, warmup=2, total_steps=10,
                        grad_compress=True, moment_dtype=moments)
    jm, tm, state, _ = _run_steps("stablelm-1.6b", opts, 5, resume_after=3)
    _close_steps(jm, tm)
    assert int(state["step"]) == 5
    assert all(m.dtype == TDT[moments] for m in leaves(state["opt"]["m"]))


def test_pipeline_copy_gives_the_jax_batches():
    for arch in ("stablelm-1.6b", "olmoe-1b-7b"):
        jcfg, cfg = configs(arch)
        for seed in (0, 5):
            jp = JaxPipeline(jcfg, JaxShapeConfig("t", SEQ, 3, "train"), seed)
            tp = SyntheticPipeline(cfg, ShapeConfig("t", SEQ, 3, "train"), seed)
            for step in (0, 1, 17):
                for kind in ("train", "prefill", "decode"):
                    want, got = jp.batch(step, kind), tp.batch(step, kind)
                    assert sorted(want) == sorted(got)
                    for k in want:
                        assert got[k].dtype == want[k].dtype
                        np.testing.assert_array_equal(got[k], want[k])


def test_new_config_copies_match_the_jax_package():
    for name in ("minicpm-2b", "nemotron-4-15b"):
        cfg, want = REGISTRY[name], jax_get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert cfg.source == want.source
    assert get_config("minicpm-2b").tie_embeddings
    assert get_config("nemotron-4-15b").act == "sq_relu"


@pytest.mark.parametrize("wrapper", ["flash_attention", "expert_mlp"])
def test_forward_only_kernels_refuse_autograd(wrapper):
    gen = torch.Generator().manual_seed(0)
    if wrapper == "flash_attention":
        args = [torch.randn(1, 8, 2, 16, generator=gen) for _ in range(3)]
        fn = flash_ops.flash_attention
    else:
        args = [torch.randn(1, 2, 4, 32, generator=gen),
                torch.randn(2, 32, 128, generator=gen),
                torch.randn(2, 32, 128, generator=gen),
                torch.randn(2, 128, 32, generator=gen)]
        fn = moe_ops.expert_mlp
    fn(*args)                                       # no grad: runs
    args[-1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*args)
    with torch.no_grad():
        fn(*args)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b"])
def test_train_mode_reaches_no_kernel_wrapper(arch, monkeypatch):
    """The train mode takes the plain attention and expert paths: with
    both wrappers made to raise, a train step still runs, and every leaf
    gets a gradient."""
    def refuse(*a, **kw):
        raise AssertionError("a forward-only kernel wrapper was called")
    monkeypatch.setattr(layers, "flash_attention", refuse)
    monkeypatch.setattr(moe, "expert_mlp", refuse)
    jcfg, cfg = configs(arch)
    tp = build_model(cfg).init(0, "cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    tb = batch_to(jax_batch(jcfg), "cpu")
    for chunk in (64, 16):
        lg, aux = build_model(cfg).train_logits(tp, tb, chunk=chunk)
        loss = cross_entropy(lg, tb["labels"], cfg) + 0.01 * aux
        grads = torch.autograd.grad(loss, list(leaves(tp)))
        assert all(bool(g.abs().sum() > 0) for g in grads)


def test_trained_params_serve(monkeypatch):
    """The quickstart's flow: train, then serve the master params (which
    require grad) through BatchServer; olmoe's expert FFN goes through the
    forward-only expert_mlp wrapper, which would refuse a tracked input."""
    from repro_torch.serve import BatchServer, Request
    jcfg, cfg = configs("olmoe-1b-7b")
    model = build_model(cfg)
    opts = TrainOptions(warmup=1, total_steps=2)
    state = init_train_state(model, 0, opts, "cpu")
    state, _ = build_train_step(model, opts)(state,
                                             batch_to(jax_batch(jcfg), "cpu"))
    assert all(p.requires_grad for p in leaves(state["params"]))
    n0 = moe_ops.expert_mlp.launches
    calls = []
    monkeypatch.setattr(moe, "expert_mlp",
                        lambda *a: calls.append(1) or moe_ops.expert_mlp(*a))
    srv = BatchServer(model, state["params"], slots=2, seq_capacity=16,
                      device="cpu")
    done = srv.serve([Request(i, np.arange(3 + i), max_new_tokens=3)
                      for i in range(3)])
    assert all(len(r.output) == 3 for r in done) and calls
    assert moe_ops.expert_mlp.launches == n0        # the CPU launches nothing


def test_launcher_trains_on_cpu(capsys):
    res = launch_train.main(["--steps", "4", "--batch", "2", "--seq", "16",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    final = json.loads(out[out.index("{"):])
    assert final == res
    assert set(final) == {"first_loss", "last_loss", "steps",
                          "median_step_s"}
    assert final["steps"] == 4 and np.isfinite(final["last_loss"])
    assert "step 3:" in out


def test_launcher_raises_without_a_card_and_for_a_checkpoint_dir(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(build_model(configs("stablelm-1.6b")[1]), 0)


def test_launcher_checkpoints_on_cpu(tmp_path, capsys):
    """``--ckpt-dir`` runs the Trainer with checkpoints: the final state
    is on disk and restores into the port's train state."""
    from repro_torch.checkpoint import CheckpointManager
    res = launch_train.main(["--steps", "4", "--batch", "2", "--seq", "16",
                             "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr()
    assert json.loads(out.out[out.out.index("{"):]) == res
    assert res["steps"] == 4 and "step 3:" in out.out
    assert "trainer.steps" in out.err            # the stats dump
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.available_steps() == [4]
    model = build_model(configs("stablelm-1.6b")[1])
    state = mgr.restore(init_train_state(model, 0, default_options_for(
        model.cfg), "cpu"))
    assert int(state["step"]) == 4 and int(state["opt"]["count"]) == 4
