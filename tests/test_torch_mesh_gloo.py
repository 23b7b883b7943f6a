"""Sharded runs of the port on a real device mesh: 4 gloo ranks of the CPU
on a (2, 2) ("data", "model") mesh, one ``torch.multiprocessing`` spawn
for the whole file (a ``FileStore`` under ``tmp_path``, so xdist workers
never share a rendezvous).  f32 compute at smoke size.

* Every registry arch, its params distributed by its rules
  (``MeshSharder.param_shardings(param_specs()[1])``): a prefill and one
  decode step with the sharder; the ``full_tensor()`` logits match the
  unsharded port within 1e-5 of the largest logit (f32: DTensor sums
  partial products in other orders; seen ~1e-6).
* smoke mixtral-8x22b with its experts whole, so that "model" splits the
  expert weights' d_ff: a prefill and one decode step within 1e-5 of the
  unsharded port; the expert-MLP op's d_ff layout (a partial sum over
  "model") on the op's own, within 1e-5 of the plain version.
* smoke deepseek-67b and qwen2-vl-7b (1 kv head) under the decode rules:
  the cache split along its slots, a prefill and 8 decode steps within
  1e-5 of the unsharded port.
* smoke stablelm, olmoe, rwkv6-7b and whisper-small under the decode
  rules, the cache laid out as the dry run's decode batch (its layers
  split over "data"): 3 decode steps within 1e-5 of the unsharded port,
  each returning its cache argument, the cache after them equal to the
  plain one's within 1e-5; stablelm once more at a batch that does not
  divide "data".
* Context-parallel prefills (query rows over "model", the rules
  overridden) of smoke stablelm, qwen2-vl (a vision prefix) and whisper
  (encoder and cross attention not causal), on the plain path and on the
  kernel path with the op given its plain version for the test, within
  1e-5 of the unsharded port on every rank, each rank's op calls on its
  rows with their offset.
* stablelm and olmoe: one train step with ``grad_compress`` on DTensor
  state against the plain step (see ``test_train_step_matches`` for the
  bounds); before it, every stacked leaf's gradient leaves autograd in
  its param's placements, and the compress of the gradients laid out
  like the params is bit-equal to the replicated path and issues no
  collective for the leaves whose blocks stay local.
* The loss (``cross_entropy``) on logits laid out as the train rules
  lay them out, for a vocab that "model" splits (with and without
  padding) and one it does not: the loss and the logits' gradient within
  1e-5 of the unsharded port, each rank holding its share of the vocab.
  Every arch's ``loss_and_grads`` on DTensor params and batch: the loss
  and the unembedding leaf's gradient within 1e-5 of the unsharded
  port's, the gradients within 1e-5 of the largest gradient (rwkv6's
  2e-5: ``GRAD_TOL``), and rwkv6's gap shrinking 10 times or more in
  f64, so rounding.
* smoke stablelm's sharded prefill against the JAX package's
  ``lm_apply`` on the same params, directly.
* A distributed save whose write fails on rank 0 raises on every rank,
  async and sync, and publishes nothing.
* Resharding restores: a checkpoint written by the JAX package, and one
  saved from the (2, 2) mesh (byte-equal to an unsharded save of the same
  state), restored onto (4, 1) and (1, 4): full tensors equal bit for bit,
  and each rank's local shard is its slice.

Each case runs on every rank inside one process group; a case that
raises records its traceback, and its test fails with it.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _mesh_gloo_worker as gw

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtf
from repro.train import step as jax_step
from repro_torch.configs import get_config, smoke
from repro_torch.models import build_model
from repro_torch.models.common import map_leaves

WORLD = gw.WORLD
B, S = gw.B, gw.S
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write the JAX inputs, spawn the 4 ranks once, return rank 0's
    results and the output directory."""
    out = tmp_path_factory.mktemp("gloo")
    # stablelm params for the ranks, and the same values as JAX arrays
    jcfg = jax_smoke(jax_get_config("stablelm-1.6b"))
    cfg = smoke(get_config("stablelm-1.6b"))
    params = build_model(cfg, torch.float32).init(0, "cpu")
    torch.save(params, out / "stablelm_params.pt")
    jp = map_leaves(lambda t: jnp.asarray(t.numpy()), params)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    torch.save(torch.as_tensor(tokens), out / "stablelm_tokens.pt")
    # a JAX train state (numpy leaves, bf16 moments) saved by JAX
    opts = jax_step.TrainOptions(grad_compress=True,
                                 moment_dtype="bfloat16")
    shapes = jax.eval_shape(lambda: jax_step.init_train_state(
        jax_build_model(jcfg), jax.random.PRNGKey(0), opts))
    rng = np.random.default_rng(7)
    state = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape, np.float32).astype(s.dtype)
                   if jnp.issubdtype(s.dtype, jnp.floating)
                   else rng.integers(1, 100, s.shape).astype(s.dtype)),
        shapes)
    jm = JaxCheckpointManager(str(out / "ckpt_jax"), async_save=False)
    jm.save(state, 1)
    ctx = mp.start_processes(gw._worker, args=(str(out / "store"), str(out)),
                             nprocs=WORLD, start_method="spawn", join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(out / "results.pt"), out, (jcfg, jp)


def _ok(res, name):
    r = res[name]
    assert "error" not in r, f"{name}:\n{r['error']}"
    return r


@pytest.mark.parametrize("arch", gw.ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(run, arch):
    r = _ok(run[0], f"serve/{arch}")
    assert r["dtensor"] == "DTensor"
    assert r["prefill"] <= gw.LOGIT_TOL, r
    assert r["decode"] <= gw.LOGIT_TOL, r


def test_d_ff_split_experts_match_unsharded(run):
    """smoke mixtral with its experts whole (``gw.D_FF_RULES``): "model"
    splits the stacked expert weights along d_ff, ``wi`` (L, E, D, F) on
    dim 3 and ``wo`` (L, E, F, D) on dim 2, and the prefill and a decode
    step are within 1e-5 of the largest logit of the unsharded port.  On
    the CPU the expert FFN is the plain version on DTensors (DTensor's
    own einsum layouts: a partial sum reduced at the model's "moe_d"
    constraint); the op's d_ff layout is ``test_moe_d_ff_layout_sums_
    each_ranks_slice``'s."""
    r = _ok(run[0], f"serve_d_ff/{gw.D_FF_ARCH}")
    assert r["experts"] == {"wi": [None, 3], "wo": [None, 2]}, r
    assert r["prefill"] <= gw.LOGIT_TOL, r
    assert r["decode"] <= gw.LOGIT_TOL, r


def test_moe_d_ff_layout_sums_each_ranks_slice(run):
    """The expert-MLP op on x split over groups ("data") and the weights
    split along d_ff over "model": the op runs on each rank's blocks and
    its half of d_ff, and its output is a partial sum over "model"; the
    sum equals the plain version on the whole tensors within 1e-5 of the
    largest value (two f32 halves of the down projection's sum, added in
    another order)."""
    r = _ok(run[0], "ops")["moe d_ff"]
    assert r["placements"] == [True] and r["local_shapes"], r
    assert r["sharded"], r
    assert r["rel"][0] <= 1e-5, r


@pytest.mark.parametrize("arch", gw.Q_SEQ_ARCHS)
def test_context_parallel_prefill_matches_unsharded(run, arch):
    """Under rules that split the query rows over "model" (2) and no
    heads, every rank's full logits are within 1e-5 of the largest logit
    of the unsharded port, on the plain path and on the kernel path.  On
    the kernel path each op call ran on the rank's batch rows (over
    "data") and query rows (over "model") with every key, with the
    offset of the rank's rows: S / 2 times its "model" coordinate."""
    r = _ok(run[0], f"q_seq/{arch}")
    assert len(r["ranks"]) == WORLD
    for rank in r["ranks"]:
        assert rank["plain"] <= gw.LOGIT_TOL, rank
        assert rank["kernel"] <= gw.LOGIT_TOL, rank
        calls = rank["calls"]
        assert calls, rank
        for q_shape, k_shape, causal, q_offset in calls:
            assert q_shape[0] == B // 2 and k_shape[0] == B // 2
            assert q_shape[1] * 2 == k_shape[1] or not causal
            if causal:
                assert q_offset == rank["coordinate"][1] * q_shape[1], rank
        # the causal calls: every attention layer of the decoder
        assert any(c[2] for c in calls)
        if r["family"] == "audio":
            assert any(not c[2] for c in calls)


@pytest.mark.parametrize("arch", gw.TRAIN_ARCHS)
def test_stacked_gradients_keep_the_params_placements(run, arch):
    """Every stacked layer leaf's gradient leaves autograd in its param's
    placements (a partial sum where the param is replicated), none laid
    out whole: the backward of the layer split stacks each rank's
    shards."""
    r = _ok(run[0], f"train/{arch}")["grads"]
    assert r["stacked_placements"], r
    assert all(r["stacked_placements"].values()), r["stacked_placements"]


@pytest.mark.parametrize("arch", gw.TRAIN_ARCHS)
def test_compress_on_local_shards_is_bit_equal(run, arch):
    """``compress_gradients`` on the gradients laid out like the params:
    the dequantized gradients and the new error buffer equal the
    replicated path's bit for bit; the leaves whose blocks stay local
    keep the gradients' placements and issue no collective."""
    r = _ok(run[0], f"train/{arch}")["grads"]
    assert r["bit_equal"] and r["local_bit_equal"], r
    assert r["placements_kept"], r
    assert r["n_local"] > 0 and r["local_comms"] == 0, r


@pytest.mark.parametrize("arch", gw.KV_SEQ_ARCHS)
def test_decode_rules_split_the_cache_along_its_slots(run, arch):
    """Under the decode rules of a cache whose kv heads (1) do not divide
    "model" (2), the cache is split along its slots ("kv_seq"): each
    rank writes the slots it holds, and the decode attention's max, sum
    and product over the slots reduce across the ranks.  The prefill
    and 8 decode steps (past the ring buffer's wrap) within 1e-5 of the
    largest logit of the unsharded port; the cache equal to the plain
    one's within 1e-5."""
    r = _ok(run[0], f"kv_seq/{arch}")
    assert r["rules_kv_seq"] == ("model",), r
    # the stacked cache (L, b, kvh, S, hd): batch over "data", slots over
    # "model"
    assert r["cache_split_dims"] == [1, 3], r
    assert len(r["errs"]) == 1 + gw.KV_SEQ_STEPS
    assert max(r["errs"]) <= gw.LOGIT_TOL, r
    assert r["cache_err"] <= 1e-5, r


@pytest.mark.parametrize("case", [f"layer_split/{a}"
                                  for a in gw.LAYER_SPLIT_ARCHS]
                         + ["layer_split_whole/stablelm-1.6b"])
def test_layer_split_decode_moves_one_layer_and_returns_its_cache(run, case):
    """A cache laid out as the dry run's decode batch, its layers split
    over "data" (``batch_shardings``): each decode step moves one layer's
    slice at a time to the batch split (``MeshSharder.decode_layer``),
    or whole to every rank where the batch (3) does not divide "data",
    and writes back into the argument what it wrote (the new KV rows,
    RWKV's new states; whisper's cross cache is read only).  Each of
    LAYER_SPLIT_STEPS steps within 1e-5 of the largest logit of the
    unsharded port, each returning its cache argument itself, and the
    cache after them within 1e-5 of the plain one's."""
    r = _ok(run[0], case)
    assert r["placements"] == ["(Shard(dim=0), Replicate())"], r
    assert len(r["errs"]) == gw.LAYER_SPLIT_STEPS
    assert max(r["errs"]) <= gw.LOGIT_TOL, r
    assert all(r["returned"]), r
    assert r["cache_err"] <= 1e-5, r


@pytest.mark.parametrize("vocab", gw.XENT_VOCABS)
def test_loss_on_vocab_split_logits_matches_unsharded(run, vocab):
    """A vocab that "model" (2) divides is split over it, each rank
    holding half the padded vocab; one it does not divide is whole on
    every rank.  The loss and the logits' gradient are within 1e-5 of
    the plain tensors' (relative to the loss and the largest gradient)."""
    r = _ok(run[0], f"xent/{vocab}")
    assert r["vocab_split"] == (2 if vocab % 2 == 0 else 1), r
    assert r["local_vocab"] * r["vocab_split"] == r["padded_vocab"], r
    assert r["loss"] <= 1e-5 and r["grad"] <= 1e-5, r


# the gradients' bound, of the largest gradient: 1e-5, as the logits'.
# rwkv6's recurrence runs its backward through products of decays over
# the sequence, and its sums in another order on the mesh differ by
# 1.12e-5 of the largest gradient (``layers/mixer/lora_b`` 1.93e-5 of
# its own; every other arch 3.2e-6 or less), as they did (1.17e-5) when
# the loss's pick ran on the whole vocab: its loss and its head's
# gradient agree to 0 and 8.5e-7.  That the gap is rounding and no
# sharding fault, ``test_rwkv6_loss_gradient_gap_is_rounding`` shows
GRAD_TOL = {"rwkv6-7b": 2e-5}


@pytest.mark.parametrize("arch", gw.ARCHS)
def test_sharded_loss_and_gradients_match_unsharded(run, arch):
    """Every arch's loss and gradients on the (2, 2) mesh, the vocab
    split over "model", against the unsharded port's: the loss within
    1e-5 of itself, the gradients within ``GRAD_TOL`` of the largest
    gradient (as the logits' check), and the unembedding leaf, where the
    loss's gradient enters the model, within 1e-5 of its own largest
    value."""
    r = _ok(run[0], f"loss/{arch}")
    assert r["vocab_split"] == 2, r
    assert r["loss"] <= 1e-5 and r["unembed"] <= 1e-5, r
    assert r["grad"] <= GRAD_TOL.get(arch, 1e-5), r


def test_rwkv6_loss_gradient_gap_is_rounding(run):
    """rwkv6's case in f64 (the model computes in f64 around its f32
    recurrence and norms; the master gradients are f32): the sharded
    gradients' gap to the unsharded falls to 3.3e-7 of the largest
    gradient, 34 times below f32's, and the loss to 1.5e-16.  Rounding
    shrinks with the precision; a wrong term on the mesh (a missing sum
    over a shard, a wrong offset) would keep its size."""
    r32, r64 = _ok(run[0], "loss/rwkv6-7b"), _ok(run[0], "loss64/rwkv6-7b")
    assert r64["loss"] <= 1e-12, r64
    assert r64["grad"] <= 1e-6 and 10 * r64["grad"] <= r32["grad"], (r32,
                                                                     r64)


@pytest.mark.parametrize("arch", gw.TRAIN_ARCHS)
def test_train_step_matches(run, arch):
    """The loss within 1e-5 relative.  The compressed gradients round to
    int8, so a sum order that moves a value across a rounding boundary
    flips one step of its block: the error buffer then moves by at most
    one int8 step (bounded by twice the largest error, as every error is
    within half a step) and AdamW's first update of that value by at
    most 2 lr.  Such flips stay rare: under 0.5% of the values move by
    more than 1e-5."""
    r = _ok(run[0], f"train/{arch}")
    assert r["param_types"] == ["DTensor"]
    assert abs(r["loss_sharded"] - r["loss"]) <= 1e-5 * abs(r["loss"]), r
    p_max, p_frac = r["params"]
    e_max, e_frac = r["err"]
    assert p_max <= 2 * r["lr0"] + 1e-6 and p_frac < 5e-3, r
    assert e_max <= r["err_step"] + 1e-6 and e_frac < 5e-3, r


OP_CASES = ["flash batch", "flash heads", "flash batch+heads", "flash q_seq",
            "moe groups", "moe experts", "quantize rows", "wkv6 batch",
            "wkv6 heads"]


@pytest.mark.parametrize("case", OP_CASES)
def test_kernel_op_strategy_runs_on_local_shards(run, case):
    """Each op's strategy on the (2, 2) mesh, the ops given a CPU
    implementation for the test (their plain versions): the op ran once
    on each rank's shards, kept the layout, and its full result equals
    the plain version's on the whole tensors (the local computations are
    independent: the same values, bit for bit)."""
    r = _ok(run[0], "ops")[case]
    r = {k: v for k, v in r.items() if k != "rel"}
    assert r == {"placements": [True] * len(r["placements"]),
                 "local_shapes": True, "sharded": True,
                 "equal": [True] * len(r["equal"])}, r


def test_sharded_prefill_matches_jax(run):
    """f32 against the JAX function as compiled: 1e-5, as
    ``tests/test_torch_model.py``."""
    _ok(run[0], "jax_logits")
    res, out, (jcfg, jp) = run
    tokens = torch.load(out / "stablelm_tokens.pt").numpy()
    want, _, _ = jax.jit(lambda p, t: jtf.lm_apply(
        p, {"tokens": t}, jcfg, mode="prefill",
        compute_dtype=jnp.float32))(jp, jnp.asarray(tokens, jnp.int32))
    got = torch.load(out / "stablelm_logits.pt")
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-5, rtol=1e-5)


def test_mesh_checkpoint_is_byte_equal_to_an_unsharded_save(run):
    _ok(run[0], "train/stablelm-1.6b")
    out = run[1]
    mesh_dir, plain_dir = (out / d / "step_00000001"
                           for d in ("ckpt_mesh", "ckpt_plain"))
    names = sorted(os.listdir(plain_dir))
    assert sorted(os.listdir(mesh_dir)) == names and len(names) > 10
    for n in names:
        assert (mesh_dir / n).read_bytes() == (plain_dir / n).read_bytes(), n


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_a_failed_mesh_save_raises_on_every_rank(run, mode):
    r = _ok(run[0], "save_fails")[mode]
    outcomes = r["outcomes"]
    assert all(o is not None for o in outcomes), outcomes
    assert outcomes[0].startswith("NotADirectoryError"), outcomes
    for o in outcomes[1:]:
        assert o.startswith("RuntimeError: rank 0 failed to write the "
                            "checkpoint: NotADirectoryError"), outcomes
    assert r["published"] == []


@pytest.mark.parametrize("dest", gw.RESTORE_MESHES, ids=str)
@pytest.mark.parametrize("source", ["mesh", "jax"])
def test_resharding_restore_is_bit_for_bit(run, source, dest):
    r = _ok(run[0], f"restore_{source}/{dest}")
    assert r["bad"] == [], r
    assert r["leaves"] > 10
    if dest == (1, 4):
        assert r["sharded_leaves"] > 0, r       # heads / mlp split 4 ways
