"""Sharded runs of the port on a real device mesh: 4 gloo ranks of the CPU
on a (2, 2) ("data", "model") mesh, one ``torch.multiprocessing`` spawn
for the whole file (a ``FileStore`` under ``tmp_path``, so xdist workers
never share a rendezvous).  f32 compute at smoke size.

* Every registry arch, its params distributed by its rules
  (``MeshSharder.param_shardings(param_specs()[1])``): a prefill and one
  decode step with the sharder; the ``full_tensor()`` logits match the
  unsharded port within 1e-5 of the largest logit (f32: DTensor sums
  partial products in other orders; seen ~1e-6).
* smoke deepseek-67b and qwen2-vl-7b (1 kv head) under the decode rules:
  the cache split along its slots, a prefill and 8 decode steps within
  1e-5 of the unsharded port.
* stablelm and olmoe: one train step with ``grad_compress`` on DTensor
  state against the plain step (see ``test_train_step_matches`` for the
  bounds).
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


OP_CASES = ["flash batch", "flash heads", "flash batch+heads", "moe groups",
            "moe experts", "quantize rows", "wkv6 batch", "wkv6 heads"]


@pytest.mark.parametrize("case", OP_CASES)
def test_kernel_op_strategy_runs_on_local_shards(run, case):
    """Each op's strategy on the (2, 2) mesh, the ops given a CPU
    implementation for the test (their plain versions): the op ran once
    on each rank's shards, kept the layout, and its full result equals
    the plain version's on the whole tensors (the local computations are
    independent: the same values, bit for bit)."""
    r = _ok(run[0], "ops")[case]
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
