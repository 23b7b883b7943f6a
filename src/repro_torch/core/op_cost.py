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

On a device mesh (DTensor arguments) the costs are per device, as
``hlo_cost``'s of the post-SPMD module: ``CostMode`` hands every op on
DTensors to DTensor, and costs the ops DTensor dispatches on each rank's
local shards, at their local shapes, and the functional collectives its
redistributions emit (``_c10d_functional.*``), each by kind with its
operand bytes per device and its group's size (``hlo_cost``'s
``collectives``; the ``wait_tensor`` after each is free).  DTensor's own
shape propagation (its op run once at global shapes on fresh tensors)
is not the step's work and is not costed.

``CostMode.replicated`` lists each kernel call on DTensors that ran with
an operand gathered over a mesh dim that split it: where the kernel's
strategy has no layout for the split it is given, DTensor gathers the
operand there and every rank of that dim runs the same call.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from collections import Counter
from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._dtensor_spec import DTensorSpec
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
    # its operand's shape (in place too), and a cumsum's its input's
    aten.scatter: 1, aten.scatter_add: 1, aten.scatter_add_: 1,
    aten.masked_fill: 1,
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
    aten.slice_backward, aten.flip, aten.scatter_,
    aten.embedding_dense_backward,
}
# ops that allocate without writing, or only alias
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh}
# gathers and index writes: twice the slice they touch (an index write's
# values are its argument at the index given here; an in-place scatter
# writes the slice, as a KV-cache write by indexing does, and an in-place
# scatter-add adds into it, as an accumulating ``index_put_`` does)
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
_INDEX_WRITES = {aten.index_put: 2, aten.index_put_: 2,
                 aten._index_put_impl_: 2, aten.scatter_: 3,
                 aten.scatter_add_: 3}


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
# ops whose bytes are pure copies (``hlo_cost``'s ``copy_bytes``)
_COPIES = {aten.copy_, aten._to_copy, aten.clone, aten.cat}
# functional collectives by name prefix -> ``hlo_cost``'s kind (DTensor's
# own ``_dtensor::shard_dim_alltoall`` moves a split from one dim to
# another on a CUDA mesh: an all-to-all)
COLLECTIVE_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                    "reduce_scatter": "reduce-scatter",
                    "all_to_all": "all-to-all",
                    "shard_dim_alltoall": "all-to-all"}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")


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
    return (func.namespace == "repro_torch"
            or func.namespace in COLLECTIVE_NAMESPACES or func.is_view
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
    if func.namespace in COLLECTIVE_NAMESPACES:
        if collective_kind(func) is None:               # wait_tensor
            return 0.0, 0.0
        return 0.0, sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
    outs = _tensors(out)
    if not outs or func.is_view or packet in _FREE:
        return 0.0, 0.0
    ins = _tensors((args, kwargs))
    out_bytes = sum(_nbytes(t) for t in outs)
    if packet in _GATHERS:
        nbytes = 2.0 * out_bytes
    elif packet is aten.embedding_dense_backward:
        # the zero gradient of the table written, then the rows' gradient
        # added into it: an indexing's backward (zeros and an index_put)
        nbytes = out_bytes + 2.0 * _nbytes(args[0])
    elif packet in _INDEX_WRITES:
        values = args[_INDEX_WRITES[packet]]
        nbytes = 2.0 * _nbytes(values if isinstance(values, torch.Tensor)
                               else args[2])
    elif packet is aten.copy_:
        # reads its source and writes its destination, whose old values
        # are not read: a prefill's write of a layer's entry into the
        # stacked cache moves what hlo_cost counts for a scan's
        # dynamic-update-slice, twice the entry
        nbytes = _nbytes(args[1]) + out_bytes
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


def collective_kind(func) -> "str | None":
    """``hlo_cost``'s kind of a functional collective (None for the
    ``wait_tensor`` that follows one)."""
    name = func.overloadpacket.__name__
    return next((k for p, k in COLLECTIVE_KINDS.items()
                 if name.startswith(p)), None)


def group_size(func, args, kwargs) -> int:
    """The size of a functional collective's group: its ``group_size``
    argument, or that of the group its ``group_name`` names."""
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    if "group_size" in bound:
        return int(bound["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return int(_resolve_process_group(bound["group_name"]).size())


class CostMode(TorchDispatchMode):
    """Costs every op dispatched inside it.  ``ops`` holds ``(name,
    flops, bytes)`` of each op that computes or moves something, in
    order; ``kernels`` counts the calls of each of the port's kernels;
    ``unknown`` the calls of ops with an output that ``op_cost`` has no
    flops rule for (``known``).

    Ops on DTensors are left to DTensor (``NotImplemented``), which then
    dispatches its local ops, costed here at the local shapes.
    ``collectives`` sums the functional collectives by kind (``count``,
    ``bytes``: operand bytes per device, ``group_sizes``), and
    ``largest_collectives`` by kind the one with the largest operand
    (its ``shape``, ``dtype`` and ``bytes`` a device);
    ``copy_bytes`` the bytes of the copy ops (``copy_``, ``_to_copy``,
    ``clone``, ``cat``); ``top_dots`` and ``top_bytes`` are the largest
    dots by flops and ops by bytes, ``(value, "op [local shapes]")``;
    ``moves`` lists each collective and ``cat`` as ``(op, shapes)``, the
    shapes of its tensor operands and outputs (what a check for a
    tensor moved or rebuilt whole reads).  ``stream_collectives`` places
    each collective in the stream, ``(at, kind, bytes, group size)``:
    ``ops[:at]`` are the ops dispatched up to it, its own entry the last
    of them, and ``bytes`` its operand bytes per device, what
    ``collectives[kind]["bytes"]`` sums (``core.fidelity.step_trace``
    cuts the stream there).  ``replicated`` maps a kernel's
    name to ``{"calls": n, "gathered": {argument: [mesh dims]}}`` for its
    calls on DTensors that gathered some argument over a mesh dim (of
    more than one rank) that split it (``_observe_redistribution``).

    ``peak_bytes`` is the peak of the storage the step's ops created and
    that was alive at once (each storage once, its views and in-place
    writes free, a collective's ``wait_tensor`` its argument, as the
    real op returns it; weak references see it freed), the storage of
    the ``arguments`` given to ``track_arguments`` not counted."""

    TOP_DOTS, TOP_BYTES = 5, 8

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, float, float]] = []
        self.kernels: Counter = Counter()
        self.unknown: Counter = Counter()
        self.collectives: Dict[str, Dict] = {}
        self.largest_collectives: Dict[str, Dict] = {}
        self.copy_bytes = 0.0
        self.top_dots: List[Tuple[float, str]] = []
        self.top_bytes: List[Tuple[float, str]] = []
        self.moves: List[Tuple[str, List[Tuple[int, ...]]]] = []
        self.stream_collectives: List[Tuple[int, str, float, int]] = []
        self.replicated: Dict[str, Dict] = {}
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self.created: Dict[int, float] = {}      # id(storage) -> bytes
        self.argument_storages: Dict[int, float] = {}
        self._propagating = 0
        self._patched: List = []

    # -- arguments and storage -------------------------------------------
    def track_arguments(self, tree) -> None:
        """The step's arguments: their storage (a DTensor's local shard's)
        is not the step's to create.  Reading a DTensor's local shard
        dispatches a view, which is not the step's either."""
        self._propagating += 1
        try:
            for t in _tensors(tree):
                st = _local(t).untyped_storage()
                self.argument_storages[id(st)] = float(st.nbytes())
        finally:
            self._propagating -= 1

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self.created or key in self.argument_storages:
                continue
            n = float(st.nbytes())
            self.created[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.created.pop(key, 0.0)

    def storage_bytes(self, tree) -> Tuple[float, float]:
        """(bytes created by the step, bytes of the arguments) of the
        distinct storages of ``tree`` (a step's outputs)."""
        seen = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            seen[id(st)] = st
        created = sum(self.created.get(k, 0.0) for k in seen)
        args = sum(self.argument_storages.get(k, 0.0) for k in seen)
        return float(created), float(args)

    # -- DTensor's own bookkeeping ---------------------------------------
    def __enter__(self):
        """Marks DTensor's bookkeeping so that it is not costed: its
        sharding propagation (the op run at global shapes on fresh
        tensors, the layouts' search) and its shard offsets.  torch 2.13
        computes offsets with small tensors (a split of a split dim, an
        argmax over a split dim, a strided shard's indices), so these run
        outside the step's ``FakeTensorMode``: a fake tensor has no value
        to read."""
        import torch.distributed.tensor._dispatch as dt_dispatch
        import torch.distributed.tensor._sharding_prop as dt_prop
        import torch.distributed.tensor._utils as dt_utils
        import torch.distributed.tensor.placement_types as dt_placements
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        prop = DTensor._op_dispatcher.sharding_propagator
        self._patched = []
        # DTensor takes an active FakeTensorMode for tracing and then
        # skips its propagation cache: the step's shapes are static, so
        # the cache holds
        for mod in (dt_dispatch, dt_prop):
            if hasattr(mod, "_are_we_tracing"):
                self._patched.append((mod, "_are_we_tracing",
                                      mod._are_we_tracing))
                mod._are_we_tracing = _not_tracing
        for owner, name, unfake in (
                (prop, "propagate_op_sharding", True),
                (prop, "propagate_op_sharding_non_cached", True),
                (prop, "_propagate_tensor_meta_non_cached", False),
                (dt_utils, "_compute_local_shape_and_global_offset", True),
                (getattr(dt_placements, "_StridedShard", None),
                 "local_shard_size_and_offset", True)):
            run = getattr(owner, name, None)
            if run is None:
                continue

            def bookkeeping(*args, _run=run, _unfake=unfake, **kwargs):
                self._propagating += 1
                try:
                    with (unset_fake_temporarily() if _unfake
                          else contextlib.nullcontext()):
                        return _run(*args, **kwargs)
                finally:
                    self._propagating -= 1
            setattr(owner, name, bookkeeping)
            self._patched.append((owner, name, run))
        # DTensor redistributes an op's arguments to the layout its
        # strategy picked here (a static method; taken from the class's
        # dict to be put back as one)
        dispatcher = type(DTensor._op_dispatcher)
        redistribute = dispatcher.__dict__["redistribute_local_args"]

        def observed(op_info, schema, *args, **kwargs):
            self._observe_redistribution(op_info, schema)
            return redistribute.__func__(op_info, schema, *args, **kwargs)
        dispatcher.redistribute_local_args = staticmethod(observed)
        self._patched.append((dispatcher, "redistribute_local_args",
                              redistribute))
        return super().__enter__()

    def __exit__(self, *exc):
        for owner, name, run in reversed(self._patched):
            if name.endswith("_non_cached"):
                delattr(owner, name)           # the class's method again
            else:
                setattr(owner, name, run)
        self._patched = []
        return super().__exit__(*exc)

    def _observe_redistribution(self, op_info, schema) -> None:
        """Record a kernel call whose arguments DTensor redistributes
        from ``op_info``'s layouts to ``schema``'s: each argument split
        over a mesh dim of more than one rank that the call takes
        replicated there."""
        op = schema.op
        if op.namespace != "repro_torch":
            return
        want = (tree_leaves(schema.args_schema)
                if op_info.args_tree_spec is not None
                else schema.args_schema)
        names = [a.name for a in op._schema.arguments]
        gathered: Dict[str, List[str]] = {}
        for i, (have, to) in enumerate(zip(op_info.flat_args_schema, want)):
            if not isinstance(have, DTensorSpec):
                continue
            mesh = have.mesh
            for dim, (p, q) in enumerate(zip(have.placements,
                                             to.placements)):
                if p.is_shard() and q.is_replicate() and mesh.size(dim) > 1:
                    gathered.setdefault(names[i], []).append(
                        mesh.mesh_dim_names[dim] if mesh.mesh_dim_names
                        else str(dim))
        if gathered:
            entry = self.replicated.setdefault(
                op.overloadpacket.__name__, {"calls": 0, "gathered": {}})
            entry["calls"] += 1
            for arg, dims in gathered.items():
                have = entry["gathered"].setdefault(arg, [])
                have.extend(d for d in dims if d not in have)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._propagating or any(
                t.device.type == "meta" for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__ == "wait_tensor" \
                and func.namespace in COLLECTIVE_NAMESPACES:
            # a collective's result is its wait's: the real op returns its
            # argument, a fake one a new tensor, whose storage would count
            # the result twice at the peak
            return args[0]
        self._track(out)
        flops, nbytes = op_cost(func, args, kwargs, out)
        collective = None
        if func.namespace == "repro_torch":
            self.kernels[func.overloadpacket.__name__] += 1
        elif func.namespace in COLLECTIVE_NAMESPACES:
            kind = collective_kind(func)
            if kind is not None:
                c = self.collectives.setdefault(
                    kind, {"count": 0, "bytes": 0.0, "group_sizes": []})
                first = _tensors(args[:1])
                operand = sum(_nbytes(t) for t in first)
                n = group_size(func, args, kwargs)
                big = self.largest_collectives.get(kind)
                if first and (big is None or operand > big["bytes"]):
                    self.largest_collectives[kind] = {
                        "shape": list(first[0].shape),
                        "dtype": str(first[0].dtype).replace("torch.", ""),
                        "bytes": operand}
                c["count"] += 1
                c["bytes"] += operand
                if n not in c["group_sizes"]:
                    c["group_sizes"] = sorted(c["group_sizes"] + [n])
                self._move(func, args, out)
                collective = (kind, operand, n)
        elif _tensors(out) and not known(func):
            self.unknown[str(func)] += 1
        if func.overloadpacket in _COPIES:
            self.copy_bytes += nbytes
        if func.overloadpacket is aten.cat:
            self._move(func, args, out)
        if flops or nbytes:
            self.ops.append((str(func), flops, nbytes))
            if func.overloadpacket in _DOTS:
                _keep_top(self.top_dots, flops, func, args, self.TOP_DOTS)
            _keep_top(self.top_bytes, nbytes, func, args, self.TOP_BYTES)
        if collective is not None:
            self.stream_collectives.append((len(self.ops),) + collective)
        return out

    def _move(self, func, args, out) -> None:
        self.moves.append((str(func), [tuple(t.shape) for t in
                                       _tensors((args, out))]))

    @property
    def flops(self) -> float:
        return math.fsum(f for _, f, _ in self.ops)

    @property
    def bytes(self) -> float:
        return math.fsum(b for _, _, b in self.ops)

    @property
    def collective_bytes(self) -> float:
        return math.fsum(c["bytes"] for c in self.collectives.values())


def _not_tracing() -> bool:
    return False


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _keep_top(top: List, value: float, func, args, k: int) -> None:
    """Insert ``(value, label)`` into the descending list ``top`` of at
    most ``k`` entries."""
    if len(top) >= k and value <= top[-1][0]:
        return
    shapes = [tuple(t.shape) for t in _tensors(args)]
    top.append((value, f"{func} {shapes}"))
    top.sort(key=lambda e: -e[0])
    del top[k:]
