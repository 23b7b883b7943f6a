"""The port's fidelity layer (``repro_torch.core.fidelity``) against the
JAX package's (``repro.core.fidelity``), on the CPU.

Tolerances, each measured here:

* The toy of ``benchmarks/fidelity_spectrum.py`` (4 x tanh(x @ w), D=256):
  the dry run's flops equal JAX's within 1e-6 (its dots, tanh and sum
  count the same; the HLO holds 16 more flops of scalar bookkeeping).
* The quickstart's smoke olmoe-1b-7b train step: within 2% (measured
  0.98946 with a rule for every op it dispatches: the dots agree within
  0.04%; XLA's autodiff spells some pointwise work with other ops than
  PyTorch's).  Bytes are reported,
  not gated: eager PyTorch fuses nothing (1.5x JAX's, measured).
* ``DesimBackend``: on the same flops and bytes as JAX's dry run, the
  predicted step on ``v5e_pod()`` equals JAX's to the simulator's 1 ns
  tick; on its own counts it differs from JAX's by the bytes ratio alone
  (both steps are bytes-bound on v5e), to the tick.
* A prefill on fake CUDA tensors (the kernel path) against the same
  prefill on fake CPU tensors (the plain path): the flops differ by
  exactly the kernels' ``cost`` less the flops of the plain code the CPU
  path runs in their place (1e-9 relative: float sums).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.core import fidelity as jf
from repro.data import SyntheticPipeline as JaxPipeline
from repro.models import build_model as jax_build_model
from repro.sim import v5e_pod as jax_v5e_pod
from repro.train import TrainOptions as JaxTrainOptions
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_train_state as jax_init_train_state
from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import fidelity as tf
from repro_torch import kernels
from repro_torch.core.fidelity import TensorSpec, specs_of
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_mlp import ops as moe_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import build_model
from repro_torch.models import layers, rwkv
from repro_torch.serve.step import build_prefill_step
from repro_torch.sim import v5e_pod
from repro_torch.train import (TrainOptions, batch_to, build_train_step,
                               init_train_state)

ROOT = Path(__file__).resolve().parents[1]
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"
TOY_TOL = 1e-6
TRAIN_FLOPS_TOL = 0.02
# v5e's ridge point (ChipModel: 197e12 * 0.85 flop/s over 819e9 * 0.8 B/s):
# a step with fewer flops per byte is bytes-bound
V5E_RIDGE = 197e12 * 0.85 / (819e9 * 0.8)
WRAPPERS = (flash_ops.flash_attention, moe_ops.expert_mlp, q_ops.quantize,
            wkv_ops.wkv6)


# --- the interface ---------------------------------------------------------

def test_report_fields_and_backends_match_jax():
    names = [f.name for f in dataclasses.fields(tf.StepReport)]
    assert names == [f.name for f in dataclasses.fields(jf.StepReport)]
    assert list(tf.BACKENDS) == list(jf.BACKENDS)
    for kind in ("native", "dryrun"):
        assert tf.get_backend(kind).kind == kind
    with pytest.raises(ValueError, match="unknown backend"):
        tf.get_backend("kvm")


def test_specs_and_eval_shape():
    """``specs_of`` keeps shape, dtype and requires_grad; ``eval_shape``
    gives the specs of a model's params without allocating them."""
    cfg = smoke(get_config("stablelm-1.6b"))
    model = build_model(cfg)
    state = init_train_state(model, 0, TrainOptions(), "cpu")
    specs = specs_of(state)
    assert specs["params"]["embed"]["table"] == TensorSpec(
        tuple(state["params"]["embed"]["table"].shape), torch.float32, True)
    assert specs["opt"]["count"].requires_grad is False
    want = specs_of(model.load(model.init(0, "cpu"), "cpu"))
    assert tf.eval_shape(lambda: model.load(model.init(0, "cpu"),
                                            "cpu")) == want


# --- dry run against JAX ---------------------------------------------------

D = 256


def _toy_torch(w, x):
    for _ in range(4):
        x = torch.tanh(x @ w)
    return x.sum()


def _toy_jax(w, x):
    for _ in range(4):
        x = jnp.tanh(x @ w)
    return x.sum()


@pytest.fixture(scope="module")
def jax_toy():
    specs = (jax.ShapeDtypeStruct((D, D), jnp.float32),
             jax.ShapeDtypeStruct((64, D), jnp.float32))
    prog = jf.StepProgram("fidelity_toy", _toy_jax, specs)
    return prog, jf.DryRunBackend().run(prog)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_toy_dry_run_matches_jax(jax_toy, device):
    """On fake CPU and fake CUDA tensors alike (no card needed: nothing
    runs)."""
    _, want = jax_toy
    prog = tf.StepProgram("fidelity_toy", _toy_torch,
                          (TensorSpec((D, D), torch.float32),
                           TensorSpec((64, D), torch.float32)), device=device)
    rep = tf.DryRunBackend().run(prog)
    assert rep.flops == pytest.approx(want.flops, rel=TOY_TOL)
    assert rep.flops == 4 * (2 * 64 * D * D + 64 * D) + 64 * D
    assert rep.collective_bytes == 0.0
    assert rep.memory["argument_bytes"] == want.memory["argument_bytes"]
    assert rep.memory["output_bytes"] == want.memory["output_bytes"]
    assert [n for n, _, _ in rep.detail["ops"]].count("aten.mm.default") == 4
    print(f"toy bytes: torch {rep.bytes_accessed:.0f}, JAX "
          f"{want.bytes_accessed:.0f}, ratio "
          f"{rep.bytes_accessed / want.bytes_accessed:.4f}")


QUICK_SHAPE = dict(seq_len=32, global_batch=4)
QUICK_OPTS = dict(peak_lr=5e-3, warmup=5, total_steps=30, chunk=16)


@pytest.fixture(scope="module")
def quick_train():
    """The quickstart's train step of smoke(olmoe-1b-7b), dry-run by both
    packages: (torch program, torch report, JAX program, JAX report)."""
    jcfg = jax_smoke(jax_get_config("olmoe-1b-7b"))
    jmodel = jax_build_model(jcfg)
    jopts = JaxTrainOptions(**QUICK_OPTS)
    jstate = jax_init_train_state(jmodel, jax.random.PRNGKey(0), jopts)
    jpipe = JaxPipeline(jcfg, JaxShapeConfig("quick", kind="train",
                                             **QUICK_SHAPE))
    jprog = jf.StepProgram(
        "quick_train", jax_build_train_step(jmodel, jopts),
        (jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                      jstate),
         {k: jax.ShapeDtypeStruct(v.shape, jnp.asarray(v).dtype)
          for k, v in jpipe.batch(0).items()}))
    jrep = jf.DryRunBackend().run(jprog)

    cfg = smoke(get_config("olmoe-1b-7b"))
    model = build_model(cfg)
    opts = TrainOptions(**QUICK_OPTS)
    state = init_train_state(model, 0, opts, "cpu")
    pipe = SyntheticPipeline(cfg, ShapeConfig("quick", kind="train",
                                              **QUICK_SHAPE))
    prog = tf.StepProgram("quick_train", build_train_step(model, opts),
                          (specs_of(state),
                           specs_of(batch_to(pipe.batch(0), "cpu"))),
                          device="cpu")
    return prog, tf.DryRunBackend().run(prog), jprog, jrep


def test_quickstart_train_step_flops_match_jax(quick_train):
    _, rep, _, want = quick_train
    assert rep.detail["unknown_ops"] == {}
    ratio = rep.flops / want.flops
    print(f"quickstart train step: flops torch {rep.flops:.0f} JAX "
          f"{want.flops:.0f} ratio {ratio:.4f}; bytes torch "
          f"{rep.bytes_accessed:.0f} JAX {want.bytes_accessed:.0f} ratio "
          f"{rep.bytes_accessed / want.bytes_accessed:.4f}")
    assert abs(ratio - 1) <= TRAIN_FLOPS_TOL
    assert rep.memory["argument_bytes"] == want.memory["argument_bytes"]
    assert rep.detail["kernels"] == {}         # the CPU path: no kernel op


def test_desim_matches_jax_on_v5e(quick_train):
    prog, rep, jprog, jrep = quick_train
    want = jf.DesimBackend(board=jax_v5e_pod()).run(jprog,
                                                    dryrun_report=jrep)
    # the same counts: the same prediction, to the simulator's 1 ns tick
    same = tf.StepReport("dryrun", prog.name, flops=jrep.flops,
                         bytes_accessed=jrep.bytes_accessed)
    got = tf.DesimBackend(board=v5e_pod()).run(prog, dryrun_report=same)
    assert got.predicted_step_s == pytest.approx(want.predicted_step_s,
                                                 abs=1e-9)
    # its own counts: both bytes-bound, so the bytes ratio alone
    assert jrep.flops / jrep.bytes_accessed < V5E_RIDGE
    assert rep.flops / rep.bytes_accessed < V5E_RIDGE
    own = tf.DesimBackend(board=v5e_pod()).run(prog, dryrun_report=rep)
    assert own.predicted_step_s == pytest.approx(
        want.predicted_step_s * rep.bytes_accessed / jrep.bytes_accessed,
        abs=2e-9)
    assert own.detail["trace"]["ops"][0]["flops"] == rep.flops
    assert own.flops == rep.flops and own.memory == rep.memory


def test_desim_runs_the_dry_run_itself_and_needs_a_replay():
    """The backend makes the dry run itself; it needs no replay from the
    caller (it did until the port had its own simulator): with no
    arguments it runs on the card's default board, one H100 SXM5, where
    the toy's one region takes its roofline time to the tick."""
    prog = tf.StepProgram("fidelity_toy", _toy_torch,
                          (TensorSpec((D, D), torch.float32),
                           TensorSpec((64, D), torch.float32)), device="cpu")
    rep = tf.DesimBackend(board=v5e_pod(), record_stats=True).run(prog)
    dry = tf.DryRunBackend().run(prog)
    assert rep.flops == dry.flops
    assert rep.predicted_step_s > 0 and rep.detail["stats"]
    card = tf.get_backend("desim").run(prog)
    assert card.predicted_step_s == pytest.approx(max(
        dry.flops / (989e12 * 0.85), dry.bytes_accessed / (3.35e12 * 0.8)),
        abs=1e-9)


# --- the kernel path on fake CUDA tensors ----------------------------------

def _attention_plain(q, k, v, q_pos, kv_pos, window, cross):
    """What the CPU path of ``layers.attention_train`` runs where the CUDA
    path calls the flash kernel (s within one chunk); ``cross`` where it
    calls it not causal."""
    h = q.shape[2]
    return layers.naive_causal_attention(
        q, layers._repeat_kv(k, h), layers._repeat_kv(v, h), q_pos, kv_pos,
        window=window, cross=cross)


def _plain_flops(name, args):
    """Flops of the plain code the CPU model path runs in place of one
    kernel call with ``args``."""
    def dry(fn, *specs):
        return tf.DryRunBackend().run(
            tf.StepProgram(name, fn, specs, device="cpu")).flops
    if name == "flash_attention":
        q, k, v, causal, window, prefix = args
        q_pos, kv_pos = (TensorSpec(t.shape[:2], torch.int64) for t in (q, k))
        return dry(lambda *a: _attention_plain(*a, window, not causal),
                   q, k, v, q_pos, kv_pos)
    if name == "expert_mlp":
        return dry(moe_ops.expert_mlp_plain, *args)
    if name == "wkv6":
        r, k, v, lw, u, state0, chunk = args
        return dry(lambda *a: rwkv.wkv6_chunked_plain(*a, None, chunk),
                   r, k, v, lw, u)
    raise KeyError(name)


def _prefill_batch(cfg, b: int, s: int):
    """The specs of a prefill batch of ``s`` positions, as JAX's
    ``Model.input_specs`` gives them: a VLM's tokens are ``s - n_vis``
    and its ``vision_embeds`` (b, n_vis, d_model) bf16; an
    encoder-decoder's ``enc_embeds`` (b, enc_seq, d_model) bf16 go
    beside its ``s`` tokens."""
    if cfg.family == "audio":
        return {"tokens": TensorSpec((b, s), torch.int64),
                "enc_embeds": TensorSpec((b, cfg.enc_seq, cfg.d_model),
                                         torch.bfloat16)}
    if cfg.family != "vlm":
        return {"tokens": TensorSpec((b, s), torch.int64)}
    return {"tokens": TensorSpec((b, s - cfg.n_vis), torch.int64),
            "vision_embeds": TensorSpec((b, cfg.n_vis, cfg.d_model),
                                        torch.bfloat16)}


@pytest.mark.parametrize("arch,want", [
    ("stablelm-1.6b", {"flash_attention": 4}),
    ("olmoe-1b-7b", {"flash_attention": 4, "expert_mlp": 4}),
    ("rwkv6-7b", {"wkv6": 4}),
    ("qwen2-vl-7b", {"flash_attention": 4}),
    ("whisper-small", {"flash_attention": 2 + 2 * 4})])
def test_prefill_on_fake_cuda_counts_the_kernel_ops(arch, want, monkeypatch):
    """A smoke prefill on fake CUDA tensors, on this host with no card:
    each kernel is one custom op, once per layer, at its ``cost``; no
    kernel is built, no data pointer read and no launch counted.  Its
    flops are the plain path's (fake CPU tensors) with the plain code
    swapped for the kernels."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg)
    params = specs_of(model.load(model.init(0, "cpu"), "cpu"))
    batch = _prefill_batch(cfg, 2, 64)
    calls = []
    for name, fn in list(kernels.COSTS.items()):
        monkeypatch.setitem(kernels.COSTS, name,
                            lambda *a, _n=name, _f=fn: calls.append(
                                (_n, specs_of(a), _f(*a))) or _f(*a))
    for mod in (flash_ops, moe_ops, q_ops, wkv_ops):
        monkeypatch.setattr(mod.kernel, "load", _refuse)
    monkeypatch.setattr(torch.Tensor, "data_ptr", _refuse)
    before = [w.launches for w in WRAPPERS]
    reps = {dev: tf.DryRunBackend().run(tf.StepProgram(
        f"{arch} prefill", build_prefill_step(model), (params, batch),
        device=dev)) for dev in ("cuda", "cpu")}
    assert [w.launches for w in WRAPPERS] == before
    assert reps["cuda"].detail["kernels"] == want
    assert reps["cpu"].detail["kernels"] == {}
    assert len(calls) == sum(want.values())
    monkeypatch.undo()
    kernel_flops = sum(f for _, _, (f, _) in calls)
    plain = sum(_plain_flops(n, a) for n, a, _ in calls)
    assert reps["cpu"].flops == pytest.approx(
        reps["cuda"].flops - kernel_flops + plain, rel=1e-9)
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert reps["cuda"].memory[key] == reps["cpu"].memory[key], key
    # the peak: the plain path holds what the kernels keep on chip (the
    # attention scores, the expert FFN's hidden layer, the scan's chunks)
    assert 0 < reps["cuda"].memory["temp_bytes"] \
        < reps["cpu"].memory["temp_bytes"]


def _refuse(*a, **kw):
    raise AssertionError("a dry run reached the real kernel path")


def test_moe_dispatch_ops_have_cost_rules():
    """``floor_divide`` is a divide and a floor, 2 flops an element;
    ``searchsorted`` ceil(log2 n) compares a query over n sorted values;
    both are ``known``, so a smoke olmoe prefill, whose dispatch runs
    them, reports no op without a rule, on either path."""
    from repro_torch.core import op_cost
    aten = torch.ops.aten
    assert op_cost.known(aten.floor_divide.default)
    assert op_cost.known(aten.searchsorted.Tensor)
    with op_cost.CostMode() as mode:
        torch.searchsorted(torch.arange(100.0), torch.arange(8.0))
        torch.arange(10) // 3
    assert [(n, f) for n, f, _ in mode.ops if "arange" not in n] == [
        ("aten.searchsorted.Tensor", 7.0 * 8), ("aten.floor_divide.default",
                                                2.0 * 10)]
    assert not mode.unknown
    cfg = smoke(get_config("olmoe-1b-7b"))
    model = build_model(cfg)
    params = specs_of(model.load(model.init(0, "cpu"), "cpu"))
    for dev in ("cuda", "cpu"):
        rep = tf.DryRunBackend().run(tf.StepProgram(
            "olmoe prefill", build_prefill_step(model),
            (params, _prefill_batch(cfg, 2, 64)), device=dev))
        assert rep.detail["unknown_ops"] == {}, dev
        names = {n for n, _, _ in rep.detail["ops"]}
        assert {"aten.searchsorted.Tensor",
                "aten.floor_divide.default"} <= names


def test_train_step_ops_have_cost_rules():
    """The ops a train step's backward and the RWKV plain scan dispatch,
    each at ``hlo_cost``'s count: ``scatter`` and ``scatter_add`` 1 flop
    an operand element, ``masked_fill_`` 1 an output element (a select),
    ``cumsum`` 1 an input element (a reduce-window), ``tril`` the compare
    of its (n, m) matrix and a select an element; ``select_backward``,
    ``slice_backward`` and ``flip`` move data only."""
    from repro_torch.core import op_cost
    x = torch.randn(6, 5)
    idx = torch.randint(0, 6, (3, 5))
    with op_cost.CostMode() as mode:
        torch.zeros(6, 5).scatter_add(0, idx, torch.ones(3, 5))
        torch.zeros(6, 5).scatter(0, idx, torch.ones(3, 5))
        x.clone().masked_fill_(x > 0, 0.0)
        torch.cumsum(x, dim=0)
        torch.tril(torch.ones(4, 4, dtype=torch.bool), -1)
        torch.flip(x, (0,))
        torch.ops.aten.select_backward(torch.ones(5), (6, 5), 0, 2)
        torch.ops.aten.slice_backward(torch.ones(2, 5), (6, 5), 0, 1, 3, 1)
    flops = {n: f for n, f, _ in mode.ops}
    assert not mode.unknown
    assert flops["aten.scatter_add.default"] == 30
    assert flops["aten.scatter.src"] == 30
    assert flops["aten.masked_fill_.Scalar"] == 30
    assert flops["aten.cumsum.default"] == 30
    assert flops["aten.tril.default"] == 16 + 16
    for n in ("aten.flip.default", "aten.select_backward.default",
              "aten.slice_backward.default"):
        assert flops[n] == 0


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_every_arch_train_step_dry_run_has_a_cost_rule_for_every_op(arch):
    """The smoke train step of every arch (the CPU path: autograd on fake
    CUDA tensors needs a card), AdamW and its backward included."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg)
    opts = TrainOptions(**QUICK_OPTS)
    state = init_train_state(model, 0, opts, "cpu")
    pipe = SyntheticPipeline(cfg, ShapeConfig("quick", kind="train",
                                              **QUICK_SHAPE))
    rep = tf.DryRunBackend().run(tf.StepProgram(
        f"{arch} train", build_train_step(model, opts),
        (specs_of(state), specs_of(batch_to(pipe.batch(0), "cpu"))),
        device="cpu"))
    assert rep.detail["unknown_ops"] == {}
    assert rep.flops > 0


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_every_arch_dry_run_has_a_cost_rule_for_every_op(arch):
    """The smoke prefill of every arch the port runs, on fake CUDA
    tensors (the kernel path): no op is costed without a rule."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg)
    params = specs_of(model.load(model.init(0, "cpu"), "cpu"))
    rep = tf.DryRunBackend().run(tf.StepProgram(
        f"{arch} prefill", build_prefill_step(model),
        (params, _prefill_batch(cfg, 2, 64)), device="cuda"))
    assert rep.detail["unknown_ops"] == {}
    assert rep.flops > 0


@pytest.mark.parametrize("index", [
    lambda t, i: t[:, -1:], lambda t, i: t[0], lambda t, i: t[None, 1],
    lambda t, i: t[..., :2], lambda t, i: t[1:, ..., None],
    lambda t, i: t[i], lambda t, i: t[:, i], lambda t, i: t[i, :, i],
    lambda t, i: t[i[:, None], i], lambda t, i: t[-1, ::2].contiguous(),
    lambda t, i: t.transpose(0, 2).contiguous()],
    ids=["slice", "int", "none-int", "ellipsis", "slice-ellipsis-none",
         "tensor", "slice-tensor", "tensor-slice-tensor", "broadcast",
         "step-contiguous", "transpose-contiguous"])
def test_indexing_fake_cuda_tensors_without_a_card(index):
    """Indexing and ``contiguous`` of fake CUDA tensors in a dry run give
    the shapes and strides the CPU gives, with or without a card."""
    x, ix = torch.zeros(4, 5, 6), torch.tensor([0, 3, 1])
    want = index(x, ix)
    with FakeTensorMode(), tf._device_guard_free("cuda"):
        got = index(torch.empty(4, 5, 6, device="cuda"),
                    torch.zeros(3, dtype=torch.int64, device="cuda"))
    assert got.shape == want.shape and got.stride() == want.stride()
    assert got.device.type == "cuda"


@pytest.mark.parametrize("index", [
    lambda t: t[torch.zeros(4, dtype=torch.bool, device="cuda")],
    lambda t: t[np.int64(1)], lambda t: t[[0, 1]], lambda t: t[True]],
    ids=["bool-mask", "numpy-int", "list", "bool"])
def test_indexing_fake_cuda_refuses_forms_it_does_not_spell(index):
    """Without a card, an index form that ``_basic_index`` does not
    spell raises rather than being costed as other ops."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bindings index")
    with FakeTensorMode(), tf._device_guard_free("cuda"):
        t = torch.empty(4, 5, 6, device="cuda")
        with pytest.raises(TypeError, match="not supported"):
            index(t)


def test_dry_run_with_autograd_on_fake_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prog = tf.StepProgram("grad", lambda w: (w * w).sum(),
                          (TensorSpec((4,), torch.float32, True),),
                          device="cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tf.DryRunBackend().run(prog)


# the custom op of each kernel on fake CUDA inputs, and its plain version on
# CPU tensors of the same shapes
def _flash_case():
    q = torch.randn(2, 40, 4, 16)
    kv = torch.randn(2, 40, 2, 16)
    return (flash_ops.OP, (q, kv, kv, True, 0, 0),
            lambda: flash_ops.flash_attention_plain(q, kv, kv))


def _moe_case():
    x = torch.randn(2, 4, 5, 32).bfloat16()
    wi, wo = torch.randn(4, 32, 128).bfloat16(), torch.randn(4, 128, 32)
    return (moe_ops.OP, (x, wi, wi, wo.bfloat16()),
            lambda: moe_ops.expert_mlp_plain(x, wi, wi, wo.bfloat16()))


def _quantize_case():
    x = torch.randn(3, 256)
    return q_ops.OP, (x,), lambda: q_ops.quantize_blocks(x)


def _wkv_case():
    r = torch.randn(1, 33, 2, 16).bfloat16()
    lw = -torch.rand(1, 33, 2, 16)
    u, st = torch.randn(2, 16), torch.randn(1, 2, 16, 16)
    return (wkv_ops.OP, (r, r, r, lw, u, st, 32),
            lambda: wkv_ops.wkv6_state_plain(r, r, r, lw, u, st))


@pytest.mark.parametrize("case", [_flash_case, _moe_case, _quantize_case,
                                  _wkv_case],
                         ids=["flash_attention", "expert_mlp", "quantize",
                              "wkv6"])
def test_fake_outputs_are_the_plain_versions(case):
    op, args, plain = case()
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    with FakeTensorMode():
        fake = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                if isinstance(a, torch.Tensor) else a for a in args]
        got = op(*fake)
    got = got if isinstance(got, tuple) else (got,)
    assert [(g.shape, g.dtype, g.device.type) for g in got] == \
        [(w.shape, w.dtype, "cuda") for w in want]
    assert all(g.is_contiguous() for g in got)


@pytest.mark.parametrize("name,args,flops,nbytes", [
    # PERF.md section 6's counts at the main paths' shapes: (value in the
    # unit, as PERF.md writes it)
    ("flash_attention", ((1, 2048, 32, 64), (1, 2048, 32, 64),
                         torch.bfloat16), "17.18 G", "33.55 M"),
    ("flash_attention", ((1, 2048, 28, 128), (1, 2048, 4, 128),
                         torch.bfloat16), "30.06 G", "33.55 M"),
    ("flash_attention", ((1, 2048, 28, 128), (1, 2048, 4, 128),
                         torch.bfloat16, True, 0, 256), "30.53 G", "33.55 M"),
    ("moe_mlp", ((1, 64, 320, 2048), (64, 2048, 1024), torch.bfloat16),
     "257.70 G", "973.08 M"),
    ("moe_mlp", ((4, 64, 1, 2048), (64, 2048, 1024), torch.bfloat16),
     "3.22 G", "807.40 M"),
    ("moe_mlp", ((1, 16, 256, 4096), (16, 4096, 14336), torch.bfloat16),
     "1443 G", "5704 M"),
    ("moe_mlp", ((1, 8, 640, 6144), (8, 6144, 16384), torch.bfloat16),
     "3092 G", "4958 M"),
    ("quantize", ((1081344, 256),), "1.66 G", "1.388 G"),
    ("wkv6", ((1, 2048, 64, 64), torch.bfloat16), "2.147 G", "101.71 M")])
def test_kernel_costs_reproduce_the_recorded_counts(name, args, flops,
                                                    nbytes):
    """Each kernel's ``cost`` is the one definition of its work: the
    bounds of ``chip_smoke.py`` and the dry run's kernel ops read it."""
    mod = {"flash_attention": flash_ops, "moe_mlp": moe_ops,
           "quantize": q_ops, "wkv6": wkv_ops}[name]
    got = mod.cost(*args)
    for value, want in zip(got, (flops, nbytes)):
        text, unit = want.split()
        digits = len(text.split(".")[1]) if "." in text else 0
        scale = {"M": 1e6, "G": 1e9}[unit]
        assert f"{value / scale:.{digits}f}" == text, (name, value, want)


# --- native ----------------------------------------------------------------

def test_native_backend_on_the_cpu_returns_a_direct_calls_outputs():
    rng = np.random.default_rng(0)
    w = torch.as_tensor(0.01 * rng.standard_normal((D, D)),
                        dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal((64, D)), dtype=torch.float32)
    prog = tf.StepProgram("fidelity_toy", _toy_torch,
                          specs_of((w, x)), device="cpu")
    rep = tf.NativeBackend().run(prog, w, x, iters=3)
    assert rep.backend == "native" and rep.wall_s > 0
    assert torch.equal(rep.outputs, _toy_torch(w, x))
    # device None: taken from the args
    prog.device = None
    assert torch.equal(tf.NativeBackend().run(prog, w, x).outputs,
                       _toy_torch(w, x))


def test_native_backend_raises_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prog = tf.StepProgram("toy", _toy_torch, (), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.NativeBackend().run(prog)


# --- the quickstart twin ---------------------------------------------------

NO_JAX = r"""
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def test_quickstart_twin_runs_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", NO_JAX, str(QUICKSTART), "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "quickstart OK", out.stdout
    assert any(ln.startswith("dryrun: flops/step=") for ln in lines)
    assert any(ln.startswith("desim: predicted") for ln in lines)
    assert sum("exit event" in ln for ln in lines) == 3
