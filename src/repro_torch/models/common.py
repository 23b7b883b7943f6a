"""Parameter-tree helpers of the port.

Parameters are nested dicts of tensors with the JAX package's key paths
(``embed/table``, ``layers/mixer/wq``, ...); a hybrid arch's ``layers``
is a tuple of per-position trees, as in JAX.  Each leaf is drawn through
``param`` from an explicit ``torch.Generator``.  Every ``param`` call
names the logical axes of the JAX package's leaf ("embed", "mlp",
"heads", ...); on the meta device (no generator: ``Model.param_specs``)
the leaf carries them as its ``logical_axes`` attribute, and
``stack_inits`` prepends ``None`` (the layer axis is never sharded).
``param_axes`` reads them into a tree of ``Axes``, the tree
``repro_torch.dist.sharding`` maps onto a device mesh.  Drawn tensors
carry nothing: ``Model.init`` returns plain tensors, as before.

``Sharder`` is the hook the model code calls at each of the JAX package's
``sharder.ac`` sites; ``IDENTITY_SHARDER`` leaves every tensor as it is
and ``repro_torch.dist.sharding.MeshSharder`` lays it out on a mesh.

The tree walks below treat dicts and plain tuples as nodes and anything
else (a tensor, a ``TensorSpec``) as a leaf.  They visit tuples in index
order and dicts in sorted-key order, which is ``jax.tree.leaves`` order:
sums over leaves (``global_norm``, the gradient list of a train step)
then run in the JAX package's order.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

Tree = Any                  # nested dicts and tuples of tensors


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, as ``jax.ShapeDtypeStruct``, and
    whether it requires grad (the master params of a train state do)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    requires_grad: bool = False


class Axes(tuple):
    """A leaf's logical axes, one name (or ``None``) per dim: a tuple,
    equal to the JAX package's, that the tree walks below take for a
    leaf (only a plain tuple is a node)."""


def with_axes(t: torch.Tensor, axes: Tuple[Optional[str], ...]
              ) -> torch.Tensor:
    """``t``; on the meta device, carrying ``axes`` as its
    ``logical_axes``."""
    if len(axes) != t.dim():
        raise ValueError(f"axes {axes} for a tensor of shape "
                         f"{tuple(t.shape)}")
    if t.is_meta:
        t.logical_axes = Axes(axes)
    return t


def param(gen: Optional[torch.Generator], shape: Tuple[int, ...],
          axes: Tuple[Optional[str], ...], scale: Optional[float] = None,
          init: str = "normal") -> torch.Tensor:
    """One f32 parameter on ``gen``'s device with its logical ``axes``.
    Fan-in scaled normal by default, as ``repro.models.common.param``.
    With no generator, an empty tensor on the ``meta`` device (shapes and
    axes only)."""
    if gen is None:
        v = torch.empty(shape, dtype=torch.float32, device="meta")
    elif init == "zeros":
        v = torch.zeros(shape, dtype=torch.float32, device=gen.device)
    elif init == "ones":
        v = torch.ones(shape, dtype=torch.float32, device=gen.device)
    else:
        if scale is None:
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        v = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device).mul_(scale)
    return with_axes(v, axes)


def param_axes(params: Tree) -> Tree:
    """The ``Axes`` tree of a tree built by ``param`` (and
    ``stack_inits``) on the meta device."""
    return map_leaves(lambda t: t.logical_axes, params)


def stack_inits(init_fn: Callable[[torch.Generator], Tree],
                gen: torch.Generator, n: int) -> Tree:
    """Stack ``n`` independent inits of one layer along a leading axis,
    as ``repro.models.common.stack_inits`` (the layer axis the decoder
    loop indexes).

    The layers are drawn one after another from ``gen`` and written into
    a stacked tree allocated up front, so the peak is the stack plus one
    layer (olmoe-1b-7b's f32 experts are 25.8 GB stacked; holding every
    layer before stacking would double that).  A stack of one (a hybrid
    arch cut to one period) is a view of the one layer: no copy.  Each
    stacked leaf's axes are its layer's with ``None`` in front, as in
    JAX."""
    first = init_fn(gen)

    def stacked(x, out):
        return with_axes(out, (None,) + tuple(x.logical_axes)) \
            if x.is_meta else out

    if n == 1:
        return map_leaves(lambda x: stacked(x, x.unsqueeze(0)), first)
    out = map_leaves(lambda x: stacked(x, x.new_empty((n,) + tuple(x.shape))),
                     first)
    map_leaves(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, n):
        map_leaves(lambda o, x: o[i].copy_(x), out, init_fn(gen))
    return out


def _is_tuple(tree: Any) -> bool:
    """A plain tuple is a node; a named tuple (``TensorSpec``) a leaf."""
    return type(tree) is tuple


def map_leaves(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf by leaf over trees of the same structure, in
    ``leaves`` order."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_tuple(tree):
        return tuple(map_leaves(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree: Tree) -> Iterator[torch.Tensor]:
    """The leaves of ``tree`` in the JAX package's order (``jax.tree.leaves``
    sorts dict keys), which fixes the order of sums over leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif _is_tuple(tree):
        for t in tree:
            yield from leaves(t)
    else:
        yield tree


def leaves_with_path(tree: Tree, path: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` in ``leaves`` order.  The key joins the path with
    ``/``: a dict entry adds its key, a tuple entry its index, as the JAX
    package's checkpoint keys (``jax.tree_util.tree_flatten_with_path``),
    e.g. ``params/layers/0/ffn/wg`` for a hybrid arch."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (str(k),))
    elif _is_tuple(tree):
        for i, t in enumerate(tree):
            yield from leaves_with_path(t, path + (str(i),))
    else:
        yield "/".join(path), tree


def unflatten(tree: Tree, values) -> Tree:
    """A tree shaped like ``tree`` holding ``values`` in ``leaves`` order."""
    it = iter(values)
    return map_leaves(lambda _: next(it), tree)


def zeros(specs: Tree, device: torch.device) -> Tree:
    """A tree of zero tensors on ``device`` shaped like a tree of
    ``TensorSpec`` (a zero cache from its spec)."""
    return map_leaves(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                            device=device), specs)


def contiguous_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return tuple(reversed(strides))


def local_shape_and_offset(shape: Tuple[int, ...], mesh: Any,
                           placements: Tuple[Any, ...]
                           ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of ``shape`` laid out by
    ``placements`` on ``mesh``: its shape and its offset in the global
    tensor.  Each ``Shard(d)`` splits the part of dim d left by the mesh
    dims before it as DTensor does (``torch.chunk``: pieces of ceil(size
    / n)).  Plain integers, so that it also runs inside a
    ``FakeTensorMode`` (torch 2.13's ``compute_local_shape_and_global_
    offset`` computes with tensors there)."""
    coord = mesh.get_coordinate()
    size, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d, n = p.dim, mesh.size(i)
            piece = -(-size[d] // n)
            start = min(coord[i] * piece, size[d])
            offset[d] += start
            size[d] = min(start + piece, size[d]) - start
    return tuple(size), tuple(offset)


def cast(tree: Tree, dtype: torch.dtype,
         device: Optional[torch.device] = None) -> Tree:
    """Cast float leaves to ``dtype`` (and move them to ``device``).
    Leaves already in that dtype and on that device are returned as they
    are, so casting cast parameters costs nothing."""
    def _c(x: torch.Tensor) -> torch.Tensor:
        if x.is_floating_point():
            return x.to(device=device, dtype=dtype)
        return x.to(device=device)
    return map_leaves(_c, tree)


class Sharder:
    """Activation-layout hook threaded through the model code, as
    ``repro.models.common.Sharder``.

    ``ac(x, logical_axes)`` lays ``x`` out by its logical axes when a
    mesh is active; this default instance is the identity, so the model
    code runs on plain tensors without a mesh.  ``scope()`` is the
    context a step runs the model in (nothing here; on a mesh it lets
    the tensors the model makes itself meet the distributed ones)."""

    def ac(self, x: torch.Tensor, axes: Tuple[Optional[str], ...]
           ) -> torch.Tensor:
        return x

    def axis_size(self, logical: str) -> int:
        """The number of shards of a logical axis (1: unsharded)."""
        return 1

    def scope(self) -> contextlib.AbstractContextManager:
        return contextlib.nullcontext()

    def decode_layer(self, cache: Tree, i: int) -> Tree:
        """Layer ``i``'s tree of a stacked cache (leaves (layers, batch,
        ...)) for a decode step to read and write in place: here each
        leaf's view ``x[i]`` (on a mesh, a leaf whose layer dim is split
        over ranks gives the layer's slice moved to its batch split, and
        the step's writes into it reach the leaf too)."""
        return map_leaves(lambda x: x.select(0, i), cache)

    def write_state_(self, state: torch.Tensor, new: torch.Tensor
                     ) -> None:
        """A decode step's write of a recurrent layer's new state into
        its view of the stacked cache, in place (cast to its dtype)."""
        state.copy_(new)

    def write_kv_(self, ck: torch.Tensor, cv: torch.Tensor,
                  slot: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> None:
        """A decode step's write into the caches ``ck`` and ``cv`` (b,
        kvh, S, hd), in place: row r takes ``k[r]`` and ``v[r]`` (kvh, hd)
        at slot ``slot[r]`` (on a mesh, each rank writes its local
        shards)."""
        rows = torch.arange(ck.shape[0], device=ck.device)
        ck[rows, :, slot] = k
        cv[rows, :, slot] = v


IDENTITY_SHARDER = Sharder()
