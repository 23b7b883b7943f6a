"""Parameter-tree helpers of the port.

Parameters are nested dicts of tensors with the JAX package's key paths
(``embed/table``, ``layers/mixer/wq``, ...); a hybrid arch's ``layers``
is a tuple of per-position trees, as in JAX.  Each leaf is drawn through
``param`` from an explicit ``torch.Generator``; the logical sharding axes
of the JAX tree are not kept (sharding is a later slice).

The tree walks below treat dicts and plain tuples as nodes and anything
else (a tensor, a ``TensorSpec``) as a leaf.  They visit tuples in index
order and dicts in sorted-key order, which is ``jax.tree.leaves`` order:
sums over leaves (``global_norm``, the gradient list of a train step)
then run in the JAX package's order.
"""

from __future__ import annotations

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


def param(gen: Optional[torch.Generator], shape: Tuple[int, ...],
          scale: Optional[float] = None, init: str = "normal") -> torch.Tensor:
    """One f32 parameter on ``gen``'s device.  Fan-in scaled normal by
    default, as ``repro.models.common.param``.  With no generator, an
    empty tensor on the ``meta`` device (shapes only)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    device = gen.device
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if scale is None:
        fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    v = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return v.mul_(scale)


def stack_inits(init_fn: Callable[[torch.Generator], Tree],
                gen: torch.Generator, n: int) -> Tree:
    """Stack ``n`` independent inits of one layer along a leading axis,
    as ``repro.models.common.stack_inits`` (the layer axis the decoder
    loop indexes).

    The layers are drawn one after another from ``gen`` and written into
    a stacked tree allocated up front, so the peak is the stack plus one
    layer (olmoe-1b-7b's f32 experts are 25.8 GB stacked; holding every
    layer before stacking would double that).  A stack of one (a hybrid
    arch cut to one period) is a view of the one layer: no copy."""
    first = init_fn(gen)
    if n == 1:
        return map_leaves(lambda x: x.unsqueeze(0), first)
    out = map_leaves(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
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


def unflatten(tree: Tree, values) -> Tree:
    """A tree shaped like ``tree`` holding ``values`` in ``leaves`` order."""
    it = iter(values)
    return map_leaves(lambda _: next(it), tree)


def zeros(specs: Tree, device: torch.device) -> Tree:
    """A tree of zero tensors on ``device`` shaped like a tree of
    ``TensorSpec`` (a zero cache from its spec)."""
    return map_leaves(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                            device=device), specs)


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
