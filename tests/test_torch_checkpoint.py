"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``) against the
JAX package's on the CPU.

The first half is the twin of the manager tests in
``tests/test_checkpoint_ft.py``: round trip, async saves and the latest
step, ``keep_n``, the ``.tmp`` directory never visible, a failed async
save surfacing on ``wait()`` and on the next ``save()``, a corrupt newest
step skipped, a truncated leaf raising, and the cast into a bf16 target.
The second half crosses packages: each restores the other's checkpoint
of a smoke train state of stablelm-1.6b, olmoe-1b-7b and jamba-v0.1-52b
(whose layers are a tuple of per-position trees), with equal keys,
manifests and leaves; JAX's bf16 moments read bit for bit, and the port's
bf16 ``.npy`` payload equal to JAX's byte for byte; a save followed at
once by a train step (which updates in place) still restores the
pre-step values; a restored state trains.  Every comparison is exact:
a checkpoint moves bits, it computes nothing.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro_torch.checkpoint.manager as mgr_mod
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import api as jax_api
from repro.train import step as jax_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.models import build_model
from repro_torch.models.common import (TensorSpec, leaves, leaves_with_path,
                                       map_leaves)
from repro_torch.train import (TrainOptions, batch_to, build_train_step,
                               init_train_state)

CROSS_ARCHS = ["stablelm-1.6b", "olmoe-1b-7b", "jamba-v0.1-52b"]


def state_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.zeros(4)},
            "opt": {"m": torch.ones(8, 4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def assert_trees_equal(a, b):
    ka = [k for k, _ in leaves_with_path(a)]
    assert ka == [k for k, _ in leaves_with_path(b)]
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.detach(), y.detach())


# ---------------------------------------------------------------------------
# the manager alone (twin of tests/test_checkpoint_ft.py:29-164)
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st_ = state_tree()
    mgr.save(st_, 7)
    restored = mgr.restore(st_)
    assert_trees_equal(st_, restored)
    assert all(r is not s for r, s in zip(leaves(restored), leaves(st_)))


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state_tree(0), 5)
    mgr.save(state_tree(1), 10)          # waits for the first internally
    mgr.wait()
    assert mgr.latest_step() == 10
    assert mgr.saves == 2 and mgr.save_seconds > 0


def test_keep_n_pruning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(state_tree(s), s)
    assert mgr.available_steps() == [3, 4]


def test_atomicity_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state_tree(), 3)
    # a stale .tmp dir (simulated crash) is not a valid checkpoint
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert mgr.latest_step() == 3


def test_async_save_exception_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state_tree(0), 1)
    mgr.wait()
    real_save = mgr_mod.np.save
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        raise OSError("disk full")

    monkeypatch.setattr(mgr_mod.np, "save", boom)
    mgr.save(state_tree(1), 2)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    monkeypatch.setattr(mgr_mod.np, "save", real_save)
    assert calls["n"] == 1
    # the failed save never published; the manager still works
    assert mgr.latest_step() == 1
    mgr.save(state_tree(2), 3)
    mgr.wait()
    assert mgr.latest_step() == 3


def test_async_save_exception_also_surfaces_on_next_save(tmp_path,
                                                         monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(mgr_mod.np, "save",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            OSError("enospc")))
    mgr.save(state_tree(0), 1)
    with pytest.raises(OSError, match="enospc"):
        mgr.save(state_tree(1), 2)      # save() waits for the previous


def test_keep_n_pruning_under_back_to_back_async_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=True)
    for s in range(1, 7):
        mgr.save(state_tree(s), s)
    mgr.wait()
    assert mgr.available_steps() == [5, 6]
    assert_trees_equal(state_tree(6), mgr.restore(state_tree(6)))


def test_restore_skips_corrupt_newest_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st1 = state_tree(1)
    mgr.save(st1, 1)
    mgr.save(state_tree(2), 2)
    os.remove(os.path.join(str(tmp_path), "step_00000002",
                           "manifest.json"))
    assert mgr.latest_step() == 1
    assert_trees_equal(st1, mgr.restore(st1))   # step 1, not the husk


def test_restore_of_partially_corrupt_newest_raises_cleanly(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st_ = state_tree()
    mgr.save(st_, 1)
    mgr.save(st_, 2)
    victim = os.path.join(str(tmp_path), "step_00000002", "params__w.npy")
    with open(victim, "wb") as f:
        f.write(b"\x93NUMPY garbage")
    with pytest.raises(ValueError):
        mgr.restore(st_, step=2)
    assert_trees_equal(st_, mgr.restore(st_, step=1))


def test_restore_with_dtype_cast_rounds_as_jax(tmp_path):
    """An f32 checkpoint restored into bf16 specs: ``Tensor.to`` rounds to
    nearest even, the bits of the JAX manager's ``astype``."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st_ = state_tree()
    st_["params"]["w"] = st_["params"]["w"] * (1 + 2.0 ** -9)  # ties nearby
    mgr.save(st_, 1)
    target = map_leaves(lambda x: TensorSpec(
        tuple(x.shape), torch.bfloat16 if x.is_floating_point() else x.dtype),
        st_)
    restored = mgr.restore(target, device="cpu")
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert restored["step"].dtype == torch.int32
    jtarget = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(tuple(x.shape), jnp.bfloat16
                                       if x.is_floating_point() else jnp.int32),
        st_)
    want = JaxCheckpointManager(str(tmp_path), async_save=False).restore(
        jtarget)
    for key, got in leaves_with_path(restored):
        w = np.asarray(_jax_leaf(want, key))
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), w)


def test_restore_into_specs_places_and_marks_grad(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st_ = state_tree()
    mgr.save(st_, 7)
    target = map_leaves(lambda x: TensorSpec(tuple(x.shape), x.dtype,
                                             x.is_floating_point()), st_)
    restored = mgr.restore(target, device="cpu")
    assert_trees_equal(st_, restored)
    assert restored["params"]["w"].requires_grad
    assert not restored["step"].requires_grad


def test_restore_with_shardings_names_the_roadmap_item(tmp_path):
    """``restore(shardings=...)`` places leaves on a mesh (ROADMAP Queue 1
    item 9a): a tree of tensors in place of ``NamedSharding``s is
    refused by name; on a one-rank gloo mesh each leaf comes back a
    DTensor equal to the plain restore bit for bit (the multi-rank
    reshardings are in ``tests/test_torch_mesh_gloo.py``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.sharding import NamedSharding
    from repro_torch.launch.mesh import make_mesh
    from torch.distributed.tensor import Replicate
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st_ = state_tree()
    mgr.save(st_, 1)
    with pytest.raises(TypeError, match="NamedSharding"):
        mgr.restore(st_, shardings=st_)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        shard = NamedSharding(mesh, (Replicate(), Replicate()))
        got = mgr.restore(st_, shardings=map_leaves(lambda _: shard, st_))
        for a, b in zip(leaves(got), leaves(st_)):
            assert isinstance(a, DTensor)
            assert torch.equal(a.full_tensor(), b)
    finally:
        dist.destroy_process_group()


def test_restore_refuses_a_wrong_shape(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state_tree(), 1)
    target = state_tree()
    target["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(target)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _jax_leaf(tree, key):
    for part in key.split("/"):
        tree = tree[int(part) if isinstance(tree, (tuple, list)) else part]
    return tree


def jax_state(arch, moments="float32", seed=0):
    """A JAX train state of the smoke config (``grad_compress``: with the
    error buffer): the tree of ``repro.train.step.init_train_state``
    (its structure by ``jax.eval_shape``), every leaf drawn with numpy
    from ``seed``, nonzero, so that no leaf looks like a fresh state's.
    Leaves are numpy arrays (bf16 as ml_dtypes), as the manager's
    ``jax.device_get`` gives them."""
    cfg = jax_smoke(jax_get_config(arch))
    opts = jax_step.TrainOptions(grad_compress=True, moment_dtype=moments)
    shapes = jax.eval_shape(lambda: jax_step.init_train_state(
        jax_api.Model(cfg), jax.random.PRNGKey(0), opts))
    rng = np.random.default_rng(seed)

    def draw(s):
        if jnp.issubdtype(s.dtype, jnp.floating):
            return rng.standard_normal(s.shape, np.float32).astype(s.dtype)
        return rng.integers(1, 100, s.shape).astype(s.dtype)
    return jax.tree.map(draw, shapes)


def port_state(arch, moments="float32", seed=5):
    cfg = smoke(get_config(arch))
    opts = TrainOptions(grad_compress=True, moment_dtype=moments)
    return init_train_state(build_model(cfg, torch.float32), seed, opts,
                            "cpu")


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _bits(x):
    """A leaf's bits as an integer numpy array (bf16 through int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_each_package_restores_the_others_checkpoint(arch, tmp_path):
    jstate = jax_state(arch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxCheckpointManager(jdir, async_save=False).save(jstate, 3)

    # torch restores JAX's: every key of the port's state, every leaf
    target = port_state(arch)
    restored = CheckpointManager(jdir).restore(target)
    keys = [k for k, _ in leaves_with_path(restored)]
    jkeys = list(_manifest(jdir, 3)["leaves"])
    assert sorted(keys) == sorted(jkeys)
    for key, got in leaves_with_path(restored):
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_jax_leaf(jstate, key)))
    assert all(p.requires_grad for p in leaves(restored["params"]))

    # the port writes it back; JAX restores the port's, and the two
    # manifests are equal, structure string included
    CheckpointManager(tdir, async_save=False).save(restored, 3)
    assert _manifest(tdir, 3) == _manifest(jdir, 3)
    back = JaxCheckpointManager(tdir).restore(jax_state(arch, seed=9))
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jamba_keys_are_jax_keys():
    """Each leaf of a jamba train state has the key JAX's
    ``tree_flatten_with_path`` gives it: tuple entries by index."""
    from repro.checkpoint.manager import _flatten
    want = list(_flatten(jax_state("jamba-v0.1-52b")))
    got = [k for k, _ in leaves_with_path(port_state("jamba-v0.1-52b"))]
    assert got == want
    params = [k for k in got if k.startswith("params/")]
    assert params[0] == "params/embed/head" and len(params) == 114
    assert "params/layers/0/ffn/wg" in params


def test_jax_bf16_moments_read_bit_for_bit(tmp_path):
    """The JAX manager writes bf16 leaves as 2-byte void arrays; the port
    reads them without ml_dtypes, bit for bit, and writes the same bytes
    for the same values."""
    jstate = jax_state("stablelm-1.6b", moments="bfloat16")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxCheckpointManager(jdir, async_save=False).save(jstate, 2)
    assert _manifest(jdir, 2)["leaves"]["opt/m/embed/head"]["dtype"] == \
        "bfloat16"
    restored = CheckpointManager(jdir).restore(
        port_state("stablelm-1.6b", moments="bfloat16"))
    m = restored["opt"]["m"]["embed"]["head"]
    assert m.dtype == torch.bfloat16
    for key, got in leaves_with_path(restored):
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_jax_leaf(jstate, key)))
    CheckpointManager(tdir, async_save=False).save(restored, 2)
    assert _manifest(tdir, 2) == _manifest(jdir, 2)
    for key, info in _manifest(jdir, 2)["leaves"].items():
        if info["dtype"] != "bfloat16":
            continue
        a = open(os.path.join(jdir, "step_00000002", info["file"]),
                 "rb").read()
        b = open(os.path.join(tdir, "step_00000002", info["file"]),
                 "rb").read()
        n = int(np.prod(info["shape"])) * 2
        assert len(a) == len(b) and a[-n:] == b[-n:], key


def test_async_save_then_a_step_restores_the_pre_step_values(tmp_path,
                                                             monkeypatch):
    """``save`` snapshots before it returns: the train step that follows
    at once updates params and moments in place, and the background
    write (held back until the step is done) still writes the values
    of the save."""
    cfg = smoke(get_config("stablelm-1.6b"))
    model = build_model(cfg, torch.float32)
    opts = TrainOptions(warmup=1, total_steps=4, grad_compress=True)
    step = build_train_step(model, opts)
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", 16, 2, "train"), seed=0)
    state = init_train_state(model, 0, opts, "cpu")
    state, _ = step(state, batch_to(pipe.batch(0), "cpu"))  # lr > 0 next
    before = map_leaves(lambda x: x.detach().clone(), state)
    stepped = threading.Event()
    real_save = np.save

    def held_save(*a, **kw):
        assert stepped.wait(timeout=60)
        return real_save(*a, **kw)

    monkeypatch.setattr(mgr_mod.np, "save", held_save)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state, 1)
    state, _ = step(state, batch_to(pipe.batch(1), "cpu"))
    stepped.set()
    mgr.wait()
    monkeypatch.setattr(mgr_mod.np, "save", real_save)
    changed = [k for (k, a), b in zip(leaves_with_path(state), leaves(before))
               if not torch.equal(a.detach(), b)]
    for key in ("params/embed/table", "opt/m/embed/table",
                "opt/v/embed/table", "err/embed/table", "step"):
        assert key in changed, key
    assert_trees_equal(before, mgr.restore(state, step=1))


def test_a_restored_state_trains(tmp_path):
    cfg = smoke(get_config("olmoe-1b-7b"))
    model = build_model(cfg, torch.float32)
    opts = TrainOptions(warmup=1, total_steps=4, grad_compress=True)
    state = init_train_state(model, 0, opts, "cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state, 0)
    restored = mgr.restore(state)
    assert all(p.requires_grad for p in leaves(restored["params"]))
    assert not any(m.requires_grad for m in leaves(restored["opt"]))
    batch = batch_to(SyntheticPipeline(cfg, ShapeConfig("t", 16, 2, "train"),
                                       seed=0).batch(0), "cpu")
    step = build_train_step(model, opts)
    new, m = step(restored, batch)
    _, m0 = step(state, batch)
    assert int(new["step"]) == 1 and np.isfinite(float(m["loss"]))
    assert float(m["loss"]) == float(m0["loss"])
