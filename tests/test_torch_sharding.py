"""Parity of the port's logical-axis sharding (``repro_torch.dist.sharding``,
``repro_torch.launch.mesh``, the models' axes and specs) with the JAX
package's, on the CPU with mock meshes: no device, no process group.

* ``make_rules``: the mapping, ``describe()`` and ``size()`` equal JAX's
  for every registry arch x ``SHAPES`` x the single- and multi-pod mock
  meshes of ``tests/test_sharding_rules.py``.
* ``Model.param_specs()``: the axes tree equals JAX's
  ``param_specs()[1]`` key path by key path at full width (JAX by
  ``eval_shape``, the port on the meta device), the shapes too, and
  ``Rules.spec`` of every leaf's axes equals JAX's, as tuples.
* ``train_state_specs``, ``input_specs`` and ``cache_spec`` equal JAX's.
* ``_spec_for_shape`` on uneven dims, ``Rules.placements``, and the
  production meshes under PyTorch's fake process group (a subprocess).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.dist.sharding import MeshSharder as JMeshSharder
from repro.dist.sharding import make_rules as jax_make_rules
from repro.models import build_model as jax_build_model
from repro.train.step import TrainOptions as JTrainOptions
from repro.train.step import train_state_specs as jax_train_state_specs
from repro_torch.configs import SHAPES, get_config
from repro_torch.dist.sharding import (MeshSharder, PartitionSpec, Rules,
                                       make_rules)
from repro_torch.models import build_model
from repro_torch.models.common import Axes, leaves_with_path
from repro_torch.train import TrainOptions, train_state_specs
from torch.distributed.tensor import Replicate, Shard

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(JREGISTRY)
LOGICAL = ("batch", "seq", "embed", "mlp", "heads", "kv_heads",
           "kv_heads_c", "vocab", "q_seq", "kv_seq", "experts", "moe_d")
JDTYPE = {jnp.int32: torch.int32, jnp.float32: torch.float32,
          jnp.bfloat16: torch.bfloat16}


class FakeMesh:
    """A mesh as the JAX package's rule tests mock it."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


SINGLE = FakeMesh((16, 16), ("data", "model"))
MULTI = FakeMesh((2, 16, 16), ("pod", "data", "model"))


def jax_path(path) -> str:
    """A JAX key path joined as the port's ``leaves_with_path`` keys."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def jax_axes_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            e is None or isinstance(e, str) for e in x))
    return {jax_path(p): tuple(a) for p, a in flat}


def jax_spec_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax_path(p): (tuple(s.shape), JDTYPE[s.dtype.type])
            for p, s in flat}


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_matches_jax(arch, shape):
    for mesh in (SINGLE, MULTI):
        j = jax_make_rules(jax_get_config(arch), JSHAPES[shape], mesh)
        t = make_rules(get_config(arch), SHAPES[shape], mesh)
        assert t.mapping == j.mapping
        assert t.describe() == j.describe()
        assert t.axis_sizes == j.axis_sizes
        for name in LOGICAL:
            assert t.size(name) == j.size(name), name


@pytest.fixture(scope="module", params=ARCHS)
def specs(request):
    """(arch, JAX (shapes, axes), port (specs, axes)) at full width."""
    arch = request.param
    jshapes, jaxes = jax_build_model(jax_get_config(arch)).param_specs()
    return arch, (jshapes, jaxes), build_model(get_config(arch)).param_specs()


def test_param_specs_match_jax(specs):
    arch, (jshapes, jaxes), (tspecs, taxes) = specs
    want_axes = jax_axes_leaves(jaxes)
    got_axes = dict(leaves_with_path(taxes))
    assert list(got_axes) == list(want_axes)         # key paths, in order
    for key, axes in got_axes.items():
        assert isinstance(axes, Axes)
        assert axes == want_axes[key], key
    want_shapes = jax_spec_leaves(jshapes)
    got_shapes = {k: (s.shape, s.dtype)
                  for k, s in leaves_with_path(tspecs)}
    assert got_shapes == want_shapes


def test_rules_spec_matches_jax_on_every_param(specs):
    arch, (_, jaxes), (_, taxes) = specs
    for mesh in (SINGLE, MULTI):
        for shape in JSHAPES:
            j = jax_make_rules(jax_get_config(arch), JSHAPES[shape], mesh)
            t = make_rules(get_config(arch), SHAPES[shape], mesh)
            for key, axes in leaves_with_path(taxes):
                got = t.spec(axes)
                assert isinstance(got, PartitionSpec)
                assert tuple(got) == tuple(j.spec(tuple(axes))), key


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "jamba-v0.1-52b"])
def test_train_state_specs_match_jax(arch, compress):
    jspecs, jaxes = jax_train_state_specs(
        jax_build_model(jax_get_config(arch)),
        JTrainOptions(grad_compress=compress, moment_dtype="bfloat16"))
    tspecs, taxes = train_state_specs(
        build_model(get_config(arch)),
        TrainOptions(grad_compress=compress, moment_dtype="bfloat16"))
    assert dict(leaves_with_path(taxes)) == jax_axes_leaves(jaxes)
    got = {k: (s.shape, s.dtype) for k, s in leaves_with_path(tspecs)}
    assert got == jax_spec_leaves(jspecs)
    assert ("err" in tspecs) == compress
    assert all(s.requires_grad for _, s in leaves_with_path(tspecs["params"]))


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_jax(arch, shape):
    jm = jax_build_model(jax_get_config(arch))
    tm = build_model(get_config(arch))
    jin = jm.input_specs(JSHAPES[shape])
    tin = tm.input_specs(SHAPES[shape])
    assert sorted(tin) == sorted(jin)
    got = {k: (s.shape, s.dtype) for k, s in leaves_with_path(tin)}
    assert got == jax_spec_leaves(jin)
    for kind in ("train", "prefill"):
        got = {k: (s.shape, s.dtype) for k, s in
               leaves_with_path(tm.input_specs(SHAPES[shape], kind))}
        assert got == jax_spec_leaves(jm.input_specs(JSHAPES[shape], kind))
    b, s = JSHAPES[shape].global_batch, 1024
    got = {k: (t.shape, t.dtype)
           for k, t in leaves_with_path(tm.cache_spec(b, s))}
    assert got == jax_spec_leaves(jm.cache_spec(b, s))


@pytest.mark.parametrize("shape,axes", [
    ((256, 4096, 2048), ("batch", "seq", None)),      # even
    ((2, 7, 24), ("batch", None, "mlp")),             # mlp 24 % 16 != 0
    ((32, 100, 12, 64), ("batch", "q_seq", "heads", None)),
    ((3, 8, 4096), ("batch", None, "vocab")),          # batch 3 uneven
    ((128, 8, 4096, 128), ("batch", "kv_heads_c", "kv_seq", None)),
    ((5,), ("mlp",)),
])
def test_spec_for_shape_matches_jax_on_uneven_dims(shape, axes):
    for arch in ("stablelm-1.6b", "minicpm-2b", "deepseek-67b"):
        for mesh in (SINGLE, MULTI):
            for sname in JSHAPES:
                j = jax_make_rules(jax_get_config(arch), JSHAPES[sname], mesh)
                t = make_rules(get_config(arch), SHAPES[sname], mesh)
                want = JMeshSharder(None, j)._spec_for_shape(shape, axes)
                got = MeshSharder(None, t)._spec_for_shape(shape, axes)
                assert tuple(got) == tuple(want), (arch, sname, shape)


def test_placements_follow_mesh_order():
    r = Rules({"a": ("model",), "b": ("pod", "data")},
              {"pod": 2, "data": 16, "model": 16})
    spec = r.spec(("b", None, "a"))
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert r.placements(spec, MULTI) == (Shard(0), Shard(0), Shard(2))
    assert r.placements(PartitionSpec(), MULTI) == (Replicate(),) * 3
    assert r.placements(PartitionSpec(None, "data"), SINGLE) == (
        Shard(1), Replicate())
    one = FakeMesh((1, 16), ("data", "model"))     # a size-1 axis splits
    assert r.placements(PartitionSpec("data", "model"), one) == (
        Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        r.placements(PartitionSpec(("data", "pod")), MULTI)
    with pytest.raises(ValueError, match="not in the mesh"):
        r.placements(PartitionSpec("pod"), SINGLE)


def test_production_mesh_raises_without_a_process_group():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


FAKE_PG = r"""
import sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import describe, make_production_mesh
multi = sys.argv[1] == "multi"
dist.init_process_group("fake", store=FakeStore(), rank=3,
                        world_size=512 if multi else 256)
mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
print("DESCRIBE", describe(mesh))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("kind,want", [
    ("single", {"axes": {"data": 16, "model": 16}, "devices": 256}),
    ("multi", {"axes": {"pod": 2, "data": 16, "model": 16},
               "devices": 512}),
])
def test_production_mesh_under_the_fake_process_group(kind, want):
    """JAX's ``describe`` gives ``{"axes": {name: size}, "devices": n}``
    for these meshes; the port's is the same dict."""
    out = subprocess.run(
        [sys.executable, "-c", FAKE_PG, kind], capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert f"DESCRIBE {want}" in out.stdout, out.stdout


def test_nested_scopes_keep_implicit_replication_to_the_outermost():
    """A train step's scope holds a model call's scope: leaving the inner
    one must not end implicit replication for the rest of the step (a
    plain tensor meeting a DTensor), and leaving the outer one ends it."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        sh = MeshSharder(mesh, Rules({}, {"data": 1, "model": 1}))
        x = distribute_tensor(torch.ones(2, 2), mesh,
                              [Replicate(), Replicate()])
        with sh.scope():
            with sh.scope():
                (x * torch.ones(2, 2)).full_tensor()
            assert torch.equal((x * torch.ones(2, 2)).full_tensor(),
                               torch.ones(2, 2))
        with pytest.raises(RuntimeError, match="mixed torch.Tensor"):
            x * torch.ones(2, 2)
    finally:
        dist.destroy_process_group()
