"""Parameter-tree helpers of the port.

Parameters are nested dicts of tensors with the JAX package's key paths
(``embed/table``, ``layers/mixer/wq``, ...).  Each leaf is drawn through
``param`` from an explicit ``torch.Generator``; the logical sharding axes
of the JAX tree are not kept (sharding is a later slice).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

Tree = Dict[str, Any]


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
    layer before stacking would double that)."""
    first = init_fn(gen)
    out = map_leaves(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    map_leaves(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, n):
        map_leaves(lambda o, x: o[i].copy_(x), out, init_fn(gen))
    return out


def map_leaves(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf by leaf over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def leaves(tree: Tree) -> Iterator[torch.Tensor]:
    """The leaves of ``tree`` in the JAX package's order (``jax.tree.leaves``
    sorts dict keys), which fixes the order of sums over leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def unflatten(tree: Tree, values) -> Tree:
    """A tree shaped like ``tree`` holding ``values`` in ``leaves`` order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


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
