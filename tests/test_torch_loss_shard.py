"""The port's train loss (``repro_torch.models.layers.cross_entropy``) on
the CPU: on a mesh each rank computes from its own share of the logits,
and no more than one f32 tensor of the logits' size lives at a time.

* Against the JAX package's ``cross_entropy`` on smoke stablelm's config
  with a padded (250, padded to 256) and an unpadded (256) vocab, masked
  and not: the loss and its gradient in f32.
* Against the formula it replaces (``torch.logsumexp`` and ``gather`` on
  the f32 logits with the padding masked to -1e9), bit for bit: the loss
  and the gradient, f32 and bf16 logits, padded and not.
* On the (1, 1) mesh of a world-1 gloo group: the loss on DTensor logits,
  replicated or split over "model" (one rank: its collectives run on a
  group of one), and smoke stablelm's and minicpm's ``loss_and_grads``,
  bit for bit against plain tensors.
* Memory, on fake tensors (``core.fidelity.DryRunBackend``): the loss's
  forward and backward at a rank's train_4k logits of stablelm-1.6b
  (vocab split over 16) and minicpm-2b (whole) hold at most one f32 and
  two bf16 tensors of the logits' size at once, where the replaced
  formula held five.
* ``op_cost``'s rule for the in-place scatter-add of the backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import fidelity as tf
from repro_torch.core import op_cost
from repro_torch.dist.sharding import MeshSharder, make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.common import TensorSpec, leaves, map_leaves
from repro_torch.models.layers import NEG_INF, cross_entropy, padded_vocab
from repro_torch.train import TrainOptions, init_train_state
from repro_torch.train.step import loss_and_grads

B, S = 3, 7
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(vocab):
    return (dataclasses.replace(jax_smoke(jax_get_config("stablelm-1.6b")),
                                vocab_size=vocab),
            dataclasses.replace(smoke(get_config("stablelm-1.6b")),
                                vocab_size=vocab))


def draw(vocab, masked, seed=0, b=B, s=S):
    """f32 logits (b, s, padded vocab) with large padded entries (they
    must not count), labels and an optional mask, from ``seed``."""
    rng = np.random.default_rng(seed)
    vp = padded_vocab(configs(vocab)[1])
    logits = rng.standard_normal((b, s, vp)).astype(np.float32) * 3
    logits[..., vocab:] = 50.0
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.6).astype(np.float32) if masked else None
    return logits, labels, mask


def replaced_formula(logits, labels, cfg, mask=None):
    """The loss as the port computed it before: the f32 logits, a copy
    with the padding masked to ``NEG_INF``, ``torch.logsumexp`` and a
    ``gather`` of the labels' logits."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp != cfg.vocab_size:
        pad = torch.arange(vp) < cfg.vocab_size
        logits = torch.where(pad, logits, NEG_INF)
    labels = labels.long()[..., None]
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    nll = (lse - torch.gather(logits, -1, labels))[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_and_grad(fn, logits, labels, cfg, mask):
    x = logits.clone().requires_grad_()
    loss = fn(x, labels, cfg, mask)
    loss.backward()
    return loss.detach(), x.grad


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("vocab", [250, 256], ids=["padded", "unpadded"])
def test_cross_entropy_matches_jax(vocab, masked):
    """The loss within 1e-6 relative and its gradient within 1e-5 of the
    largest gradient of JAX's (f32; the padded entries get none)."""
    jcfg, cfg = configs(vocab)
    logits, labels, mask = draw(vocab, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda l: jax_cross_entropy(l, jnp.asarray(labels), jcfg,
                                    mask=jmask))(jnp.asarray(logits))
    got, got_g = loss_and_grad(
        cross_entropy, torch.as_tensor(logits), torch.as_tensor(labels), cfg,
        None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want_g = np.asarray(want_g)
    assert np.abs(got_g.numpy() - want_g).max() <= 1e-5 * np.abs(
        want_g).max()
    assert not got_g[..., vocab:].any()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("vocab", [250, 256], ids=["padded", "unpadded"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_entropy_is_the_replaced_formula_bit_for_bit(dtype, vocab,
                                                           masked):
    """The same f32 ops on the same values: the max, ``logits - max``,
    its exponential and their sum, the log plus the max; in the backward
    ``exp(logits - lse)`` times the gradient, the label's entry less
    it, cast to the logits' dtype.  Larger shapes than the JAX case, so
    that the reductions run vectorised over many rows."""
    _, cfg = configs(vocab)
    logits, labels, mask = draw(vocab, masked, seed=1, b=4, s=64)
    x = torch.as_tensor(logits).to(DTYPES[dtype])
    y = torch.as_tensor(labels)
    m = None if mask is None else torch.as_tensor(mask)
    got, got_g = loss_and_grad(cross_entropy, x, y, cfg, m)
    want, want_g = loss_and_grad(replaced_formula, x, y, cfg, m)
    assert torch.equal(got, want)
    assert got_g.dtype == x.dtype and torch.equal(got_g, want_g)


# ---------------------------------------------------------------------------
# The (1, 1) mesh
# ---------------------------------------------------------------------------

def on_mesh(t, mesh, placements):
    """``t`` as a DTensor on the (1, 1) ``mesh``, its one shard ``t``
    itself (``from_local``: no collective), a leaf that requires grad
    where ``t`` does."""
    d = DTensor.from_local(t.detach(), mesh, placements, run_check=False)
    return d.requires_grad_(t.requires_grad)


@pytest.fixture(scope="module")
def mesh11():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _one_by_one(mesh, dtype, layout, make):
    """The masked loss and the logits' gradient on the (1, 1) ``mesh``,
    the DTensors built by ``make(t, mesh, placements)``, against plain
    tensors'."""
    vocab = 250
    _, cfg = configs(vocab)
    logits, labels, mask = draw(vocab, True, seed=2, b=4, s=64)
    x = torch.as_tensor(logits).to(DTYPES[dtype])
    y, m = torch.as_tensor(labels), torch.as_tensor(mask)
    want, want_g = loss_and_grad(cross_entropy, x, y, cfg, m)
    place = [Replicate(), Shard(2) if layout == "vocab_split"
             else Replicate()]
    dx = make(x, mesh, place).requires_grad_()
    dy, dm = (make(t, mesh, [Shard(0), Replicate()]) for t in (y, m))
    got = cross_entropy(dx, dy, cfg, dm)
    got.backward()
    assert dx.grad.placements == dx.placements
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(dx.grad.full_tensor(), want_g)


@pytest.mark.parametrize("layout", ["replicated", "vocab_split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_one_by_one_mesh_loss_is_bit_for_bit(mesh11, dtype, layout):
    """DTensor logits on the (1, 1) mesh, whole or split over "model"
    (a split of one: the vocab-split path with its all-reduces), with the
    labels and the mask split over "data": the loss and the logits'
    gradient equal the plain tensors' bit for bit."""
    _one_by_one(mesh11, dtype, layout, on_mesh)


@pytest.mark.parametrize("layout", ["replicated", "vocab_split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_one_by_one_mesh_loss_from_distribute_tensor(mesh11, dtype, layout):
    """The same, the DTensors built by ``distribute_tensor`` as
    ``chip_smoke.py``'s phase 22 builds them (a broadcast over "data"
    and a scatter over "model", each into a new buffer): bit for bit."""
    _one_by_one(mesh11, dtype, layout,
                lambda t, mesh, p: distribute_tensor(t, mesh, p))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "minicpm-2b"])
def test_one_by_one_mesh_loss_and_grads_are_bit_for_bit(mesh11, arch):
    """A smoke model's loss and every gradient leaf on DTensor params and
    batch on the (1, 1) mesh equal the plain tensors' bit for bit (the
    CPU's twin of the card's (1, 1)-mesh train steps)."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    opts = TrainOptions(warmup=0, total_steps=10)
    sh = MeshSharder(mesh11, make_rules(cfg, ShapeConfig("t", 16, 4,
                                                         "train"), mesh11))
    params = init_train_state(model, 0, opts, "cpu")["params"]
    dparams = map_leaves(lambda t, sp: on_mesh(t, mesh11, sp.placements),
                         params, sh.param_shardings(model.param_specs()[1]))
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=g),
             "mask": (torch.rand(4, 16, generator=g) > 0.25).float()}
    dbatch = map_leaves(lambda t, sp: on_mesh(t, mesh11, sp.placements),
                        batch, sh.batch_shardings(batch))
    grads, loss, aux = loss_and_grads(model, opts, params, batch)
    with sh.scope():
        dgrads, dloss, daux = loss_and_grads(model, opts, dparams, dbatch,
                                             sh)
    assert torch.equal(dloss.full_tensor(), loss)
    for dg, gr in zip(leaves(dgrads), leaves(grads)):
        assert torch.equal(dg.full_tensor(), gr)


# ---------------------------------------------------------------------------
# Memory and cost
# ---------------------------------------------------------------------------

def _peak(fn, shape, vocab):
    """Peak bytes the loss's forward and backward create at once on fake
    bf16 logits of ``shape`` (``DryRunBackend``, CPU tensors)."""
    cfg = dataclasses.replace(smoke(get_config("stablelm-1.6b")),
                              vocab_size=vocab)

    def step(logits, labels):
        loss = fn(logits, labels, cfg)
        return torch.autograd.grad(loss, logits)[0]
    rep = tf.DryRunBackend().run(tf.StepProgram(
        "loss", step, (TensorSpec(shape, torch.bfloat16, True),
                       TensorSpec(shape[:2], torch.int64)), device="cpu"))
    return rep.memory["temp_bytes"] + rep.memory["output_bytes"]


# a rank's logits in the train_4k cells on the (16, 16) mesh: 16 rows of
# 4096 tokens; stablelm-1.6b's vocab split over the 16 ranks of "model",
# minicpm-2b's whole (122753 does not divide 16), padded to 122880
RANK_LOGITS = {"stablelm-1.6b": ((16, 4096, 100352 // 16), 100352),
               "minicpm-2b": ((16, 4096, 122880), 122753)}


@pytest.mark.parametrize("arch", sorted(RANK_LOGITS))
def test_loss_holds_one_f32_copy_of_the_logits(arch):
    """At most one f32 tensor of the logits' size and two bf16 ones (the
    gradient in f32, then cast) live at once, plus (b, s) vectors; the
    replaced formula's peak is over twice that."""
    shape, vocab = RANK_LOGITS[arch]
    n = shape[0] * shape[1] * shape[2]
    got = _peak(cross_entropy, shape, vocab)
    old = _peak(replaced_formula, shape, vocab)
    rows = shape[0] * shape[1] * 64
    print(f"{arch} {shape}: peak {got / 1e9:.3f} GB, replaced formula "
          f"{old / 1e9:.3f} GB")
    assert got <= (4 + 2) * n + rows
    assert old >= 2 * got


def test_in_place_scatter_add_costs_its_slice():
    """The backward's label update, ``scatter_add_`` in place: one flop
    per element of the tensor it writes into (``hlo_cost``'s scatter
    rule, as the out-of-place ``scatter_add``) and twice the values'
    bytes (an in-place index write)."""
    t, idx, src = (torch.zeros(6, 5), torch.zeros(6, 1, dtype=torch.long),
                   torch.ones(6, 1))
    with op_cost.CostMode() as mode:
        t.scatter_add_(1, idx, src)
    assert not mode.unknown
    assert [(n, f, b) for n, f, b in mode.ops] == [
        ("aten.scatter_add_.default", 30.0, 2.0 * 6 * 4)]
