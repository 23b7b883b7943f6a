"""Flops and bytes of a PyTorch step, op by op, as it dispatches.

The port's analogue of ``repro.core.desim.hlo_cost``.  A step run under
``CostMode`` (on fake tensors: ``core.fidelity.DryRunBackend``) is seen
as the stream of aten ops it dispatches, after autograd, each costed on
its shapes alone, with ``hlo_cost``'s conventions:

  * a dot (``mm``, ``bmm``, ``addmm``, ...) is 2 M N K flops, and the
    add of ``addmm`` one more per output element;
  * a pointwise op is 1 flop per output element, transcendentals too;
    ops that ``hlo_cost`` would see as several HLO ops (softmax, the
    sigmoid and tanh backward) count as those;
  * a reduction is 1 flop per input element (a mean adds its divide);
  * ``floor_divide`` is 2 flops per output element: XLA lowers an
    integer or float floor division to a ``divide`` and a ``floor`` (or
    the sign fix-up of a truncating divide), and ``hlo_cost`` counts
    each as one elementwise flop;
  * ``searchsorted`` is ceil(log2 n) flops per query over a sorted axis
    of length n: one ``compare`` per step of a binary search.  JAX's
    default ``method="scan"`` is such a search (ceil(log2(n + 1)) steps,
    one more only when n is a power of two); the index arithmetic and
    selects of its loop are not counted;
  * each of the port's kernels (the ``repro_torch::*`` custom ops) is
    one op, costed by the ``cost`` it was registered with
    (``repro_torch.kernels.COSTS``).

Eager PyTorch fuses nothing, so its bytes exceed what ``hlo_cost``
counts for XLA's fusions of the same step: every pointwise op reads and
writes memory.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels

aten = torch.ops.aten

# flops per output element of ops that hlo_cost sees as several HLO ops:
# softmax is max, subtract, exp, sum and divide; its backward multiply,
# sum, multiply and subtract; log-softmax's backward exp, sum, multiply,
# subtract; the sigmoid and tanh backward 1 - y, times y (or y again),
# times the gradient
_PER_ELEMENT = {
    aten._softmax: 5, aten._log_softmax: 5, aten._softmax_backward_data: 4,
    aten._log_softmax_backward_data: 4, aten.sigmoid_backward: 3,
    aten.tanh_backward: 3,
    # the one-HLO-op rules of the module docstring: a scatter's output is
    # its operand's shape, and a cumsum's its input's
    aten.scatter: 1, aten.scatter_add: 1, aten.masked_fill: 1,
    aten.masked_fill_: 1, aten.cumsum: 1,
}
# ops that move data or allocate and compute nothing
_NO_FLOPS = {
    aten._to_copy, aten.copy_, aten.clone, aten.fill_, aten.zero_,
    aten.zeros, aten.ones, aten.full, aten.zeros_like, aten.ones_like,
    aten.new_zeros, aten.new_ones, aten.new_full,
    aten.full_like, aten.scalar_tensor, aten.arange, aten.cat, aten.stack,
    aten.index, aten.index_select, aten.gather, aten.embedding,
    aten.index_put, aten.index_put_, aten._index_put_impl_,
    aten.constant_pad_nd, aten.repeat, aten.repeat_interleave, aten.sort,
    aten.topk, aten.argsort, aten.lift_fresh_copy, aten.select_backward,
    aten.slice_backward, aten.flip,
}
# ops that allocate without writing, or only alias
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh}
# gathers and index writes: twice the slice they touch
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
_INDEX_WRITES = {aten.index_put, aten.index_put_, aten._index_put_impl_}


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _dot_flops(packet, args, out: torch.Tensor) -> float:
    """2 M N K for every output element's K-long sum; the add of
    ``addmm``/``baddbmm`` one more per output element."""
    if packet in (aten.addmm, aten.baddbmm, aten.addmv):
        k = args[1].shape[-1]
        return (2.0 * k + 1.0) * out.numel()
    return 2.0 * args[0].shape[-1] * out.numel()


def _search_flops(args, out_elems: float) -> float:
    """ceil(log2 n) compares per query of ``searchsorted`` over a sorted
    axis of length n (the last axis of its first argument)."""
    n = args[0].shape[-1]
    return math.ceil(math.log2(n)) * out_elems if n > 1 else out_elems


_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.mv, aten.addmv,
         aten.dot}


# ops with a rule of their own (see the module docstring)
_DIVIDES = {aten.floor_divide}
_SEARCHES = {aten.searchsorted}
_TRIL = {aten.tril}


def known(func) -> bool:
    """Whether ``op_cost`` has a rule for ``func``'s flops: a kernel, a
    dot, a listed op, a reduction or a pointwise op.  Any other op that
    writes an output is costed at 0 flops and its bytes, and counted in
    ``CostMode.unknown``: reported, not guessed."""
    packet = func.overloadpacket
    return (func.namespace == "repro_torch" or func.is_view
            or packet in _DOTS or packet in _PER_ELEMENT
            or packet in _NO_FLOPS or packet in _FREE
            or packet in _DIVIDES or packet in _SEARCHES or packet in _TRIL
            or torch.Tag.reduction in func.tags
            or torch.Tag.pointwise in func.tags)


def op_cost(func, args, kwargs, out) -> Tuple[float, float]:
    """(flops, bytes) of one dispatched op."""
    packet = func.overloadpacket
    if func.namespace == "repro_torch":
        return kernels.COSTS[packet.__name__](*args, **kwargs)
    outs = _tensors(out)
    if not outs or func.is_view or packet in _FREE:
        return 0.0, 0.0
    ins = _tensors((args, kwargs))
    out_bytes = sum(_nbytes(t) for t in outs)
    if packet in _GATHERS:
        nbytes = 2.0 * out_bytes
    elif packet in _INDEX_WRITES:
        nbytes = 2.0 * _nbytes(args[2])
    else:
        nbytes = sum(_nbytes(t) for t in ins) + out_bytes
    out_elems = float(sum(t.numel() for t in outs))
    if packet in _DOTS:
        flops = _dot_flops(packet, args, outs[0])
    elif packet in _PER_ELEMENT:
        flops = _PER_ELEMENT[packet] * out_elems
    elif packet in _NO_FLOPS:
        flops = 0.0
    elif packet in _DIVIDES:
        flops = 2.0 * out_elems
    elif packet in _SEARCHES:
        flops = float(_search_flops(args, out_elems))
    elif packet in _TRIL:
        flops = float(math.prod(outs[0].shape[-2:])) + out_elems
    elif torch.Tag.reduction in func.tags:
        flops = float(args[0].numel())
        if packet is aten.mean:
            flops += out_elems
    elif torch.Tag.pointwise in func.tags:
        flops = out_elems
    else:
        flops = 0.0
    return flops, nbytes


class CostMode(TorchDispatchMode):
    """Costs every op dispatched inside it.  ``ops`` holds ``(name,
    flops, bytes)`` of each op that computes or moves something, in
    order; ``kernels`` counts the calls of each of the port's kernels;
    ``unknown`` the calls of ops with an output that ``op_cost`` has no
    flops rule for (``known``)."""

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, float, float]] = []
        self.kernels: Counter = Counter()
        self.unknown: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, nbytes = op_cost(func, args, kwargs, out)
        if func.namespace == "repro_torch":
            self.kernels[func.overloadpacket.__name__] += 1
        elif _tensors(out) and not known(func):
            self.unknown[str(func)] += 1
        if flops or nbytes:
            self.ops.append((str(func), flops, nbytes))
        return out

    @property
    def flops(self) -> float:
        return math.fsum(f for _, f, _ in self.ops)

    @property
    def bytes(self) -> float:
        return math.fsum(b for _, _, b in self.ops)
