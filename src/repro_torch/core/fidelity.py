"""Fidelity spectrum of the port: interchangeable execution backends.

The port's twin of ``repro.core.fidelity``.  gem5's CPU models span a
fidelity/performance spectrum (KVM, atomic, detailed) over one system
description; so do these backends over one ``StepProgram`` (a step
function and the specs of its inputs):

* ``NativeBackend``  -- really run it (gem5's KVM mode): on the card,
                        timed with CUDA events.
* ``DryRunBackend``  -- run it once on fake tensors (gem5's atomic mode):
                        nothing is allocated or launched; every op it
                        dispatches is costed (``core.op_cost``), the
                        port's kernels as one op each at their ``cost``.
* ``DesimBackend``   -- replay the dry run's cost, as an elastic trace,
                        on the port's own simulator (``core.desim``,
                        ``sim``), the card's machine by default (gem5's
                        detailed mode).

All three return a ``StepReport`` with the JAX package's fields.  A
program on a device mesh (``StepProgram.mesh`` and ``in_shardings``) is
dry-run as one rank of it: each input a fake local shard wrapped as a
DTensor, every cost per device (``launch/dryrun.py`` runs the production
meshes under PyTorch's fake process group).  The
port imports nothing of ``repro``: the simulator it replays on is its own
copy of the reference's, pure Python.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode

from torch.distributed.tensor import DTensor

from repro_torch.core.op_cost import CostMode
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import local_shape_and_offset
from repro_torch.models.common import (TensorSpec, contiguous_strides,
                                       map_leaves)


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples; a
    ``TensorSpec`` is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any):
    """The leaves of a tree, as ``_tree_map`` sees them."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def specs_of(tree: Any) -> Any:
    """The ``TensorSpec`` of every tensor in ``tree`` (shape, dtype,
    requires_grad); other leaves as they are."""
    return _tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype,
                                          t.requires_grad)
                     if isinstance(t, torch.Tensor) else t, tree)


def eval_shape(fn: Callable) -> Any:
    """The specs of ``fn()``'s outputs, from one run on fake tensors (the
    port's ``jax.eval_shape``): nothing is allocated.  A model too large
    for the card is costed from the specs of its params taken this way:
    ``eval_shape(lambda: model.load(model.init(0, "cpu"), "cpu"))``."""
    with FakeTensorMode():
        return specs_of(fn())


@dataclass
class StepProgram:
    """The system under test, in gem5 terms: the workload and its inputs.

    ``input_specs`` is a tuple of positional args, each a tree (dicts,
    lists, tuples) of ``TensorSpec`` and plain values; ``device`` is
    where the step runs (``cuda`` unless the caller names the CPU).
    ``mesh`` is the ``DeviceMesh`` the step runs on, and
    ``in_shardings`` a tree beside ``input_specs`` with the
    ``dist.sharding.NamedSharding`` of each spec (the JAX program's
    ``in_shardings``); without a mesh the inputs are plain tensors.
    JAX's ``out_shardings`` has no twin: DTensor gives each output the
    layout its last op leaves."""

    name: str
    fn: Callable
    input_specs: Any
    device: DeviceLike = None
    mesh: Any = None
    in_shardings: Any = None


@dataclass
class StepReport:
    backend: str
    name: str
    wall_s: float = 0.0                       # host wall time of the call
    predicted_step_s: Optional[float] = None  # desim/roofline prediction
    outputs: Any = None
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    collective_bytes: Optional[float] = None
    memory: Optional[Dict[str, float]] = None
    detail: Dict[str, Any] = field(default_factory=dict)


class Backend:
    kind = "abstract"

    def run(self, prog: StepProgram, *args, **kw) -> StepReport:
        raise NotImplementedError


class NativeBackend(Backend):
    """Execute for real (gem5 KVM mode): one warm-up call, then ``iters``
    timed calls.  On the card the calls are timed with CUDA events on
    the current stream (``wall_s`` is their mean); only a program on the
    CPU is timed with ``perf_counter``.  A CUDA program with no card
    raises.

    Unlike JAX's pure step, the port's train step updates params and
    moments in place: every call, the warm-up too, advances the
    optimizer."""

    kind = "native"

    def run(self, prog: StepProgram, *args, iters: int = 1) -> StepReport:
        dev = resolve_device(prog.device or _device_of(args))
        out = prog.fn(*args)
        iters = max(iters, 1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(iters):
                out = prog.fn(*args)
            end.record(stream)
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = prog.fn(*args)
            dt = (time.perf_counter() - t0) / iters
        return StepReport(self.kind, prog.name, wall_s=dt, outputs=out)


class DryRunBackend(Backend):
    """Run the step once on fake tensors and cost what it dispatches
    (gem5 atomic mode; JAX lowers and compiles instead).

    The inputs, params included, are made fake tensors on
    ``prog.device`` from their specs, so no device memory is allocated
    and no kernel is launched: each of the port's kernels is one custom
    op whose fake implementation gives its outputs' shapes.  On a mesh
    each input is its shard on this process's rank of the mesh (rank 0
    under the fake process group), a fake local tensor wrapped by
    ``DTensor.from_local`` at the spec's global shape, and every number
    below is per device.  ``flops`` and ``bytes_accessed`` sum
    ``core.op_cost`` over the ops; ``collective_bytes`` the collectives'
    operand bytes (0 without a mesh).  ``memory`` holds the exact
    ``argument_bytes`` and ``output_bytes``; ``alias_bytes``, the
    outputs' bytes that are arguments' storage (a cache or a state
    updated in place, JAX's donated buffers); and ``temp_bytes``, the
    peak of the storage the step created and held at once, less the
    outputs it created, so that ``argument_bytes + output_bytes +
    temp_bytes - alias_bytes`` is the step's peak on the device;
    ``code_bytes`` stays 0.0.  ``detail["ops"]`` is the op stream
    ``(name, flops, bytes)``, the analogue of ``detail["hlo"]``;
    ``detail["kernels"]`` counts each kernel's calls;
    ``detail["unknown_ops"]`` the calls of ops that ``op_cost`` has no
    flops rule for (costed at 0 flops and their bytes);
    ``detail["collectives"]``, ``["copy_bytes"]``, ``["moves"]``,
    ``["top_dots"]``, ``["top_bytes"]`` and ``["stream_collectives"]``
    are ``CostMode``'s, and ``["replicated_kernels"]`` its
    ``replicated``.

    The step may not read a value back to the host (``.item()``,
    ``int(tensor)``): a fake tensor has none.  The train and prefill
    steps do not; the server's sampling loop does.  A step on fake CUDA
    tensors runs on a host with no card as long as autograd records
    nothing: PyTorch's autograd engine needs the CUDA runtime for a CUDA
    leaf that requires grad, so such a program raises there."""

    kind = "dryrun"

    def run(self, prog: StepProgram) -> StepReport:
        dev = torch.device(prog.device or "cuda")
        if dev.type == "cuda" and not torch.cuda.is_available() and any(
                isinstance(s, TensorSpec) and s.requires_grad
                for s in _leaves(prog.input_specs)):
            raise RuntimeError(
                f"{prog.name}: a dry run that records autograd on fake "
                f"CUDA tensors needs a CUDA device; run it on the card, or "
                f"with device='cpu'")
        t0 = time.perf_counter()
        with FakeTensorMode(), _device_guard_free(dev):
            args = (_fake(prog.input_specs, dev) if prog.mesh is None else
                    _fake_shards(prog.input_specs, prog.in_shardings, dev))
            with CostMode() as cost:
                cost.track_arguments(args)
                out = prog.fn(*args)
            arg_bytes, out_bytes = _bytes_of(args), _bytes_of(out)
            created, alias = cost.storage_bytes(out)
            temp = max(0.0, cost.peak_bytes - created)
            del out, args
        rep = StepReport(self.kind, prog.name,
                         wall_s=time.perf_counter() - t0, flops=cost.flops,
                         bytes_accessed=cost.bytes,
                         collective_bytes=cost.collective_bytes)
        rep.memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                      "temp_bytes": temp, "alias_bytes": alias,
                      "code_bytes": 0.0}
        rep.detail["ops"] = cost.ops
        rep.detail["kernels"] = dict(cost.kernels)
        rep.detail["unknown_ops"] = dict(cost.unknown)
        rep.detail["collectives"] = cost.collectives
        rep.detail["copy_bytes"] = cost.copy_bytes
        rep.detail["top_dots"] = cost.top_dots
        rep.detail["top_bytes"] = cost.top_bytes
        rep.detail["moves"] = cost.moves
        rep.detail["stream_collectives"] = cost.stream_collectives
        rep.detail["replicated_kernels"] = cost.replicated
        return rep


def step_trace(name: str, report: StepReport) -> Dict[str, Any]:
    """The elastic trace of a step as plain data, in
    ``core.desim.trace.TraceOp``'s field names, as the reference's
    ``HloTrace.from_hlo_text`` builds its trace: the op stream cut at each
    collective (``detail["stream_collectives"]``) into compute regions
    (``region0``, ``region1``, ...), each collective an op between them
    with its kind, ``coll_bytes`` (its operand bytes per device, as JAX
    passes an instruction's operand bytes) and ``participants`` (its
    group's size, as JAX passes ``replica_groups``), every op after the
    first depending on the one before.  ``overlap`` is False and
    ``scope`` "ici", as JAX's trace of a module compiled for host
    devices sets them (no ``-start`` collective there).

    A region's flops and bytes are the exact sums of its ops' (a
    collective's own bytes, its read and write of memory, in the region
    it ends), where JAX apportions the module's totals to its regions
    by their output bytes: XLA's cost analysis has no count per region.
    A step with no collective (one device) is one region holding the
    report's flops and bytes."""
    cuts = report.detail.get("stream_collectives") or []
    if not cuts:
        return {"name": name, "ops": [{
            "kind": "compute", "flops": report.flops or 0.0,
            "bytes": report.bytes_accessed or 0.0, "name": "region0"}]}
    stream = report.detail["ops"]
    ops: list = []
    start = 0
    for r, (at, kind, nbytes, n) in enumerate(cuts + [(len(stream),) + (
            None,) * 3]):
        region = {"kind": "compute",
                  "flops": math.fsum(f for _, f, _ in stream[start:at]),
                  "bytes": math.fsum(b for _, _, b in stream[start:at]),
                  "name": f"region{r}"}
        if ops:
            region["deps"] = (len(ops) - 1,)
        ops.append(region)
        if kind is not None:
            ops.append({"kind": kind, "coll_bytes": nbytes,
                        "participants": n, "deps": (len(ops) - 1,),
                        "overlap": False, "scope": "ici",
                        "name": f"{kind}.{r}"})
        start = at
    return {"name": name, "ops": ops}


class DesimBackend(Backend):
    """Discrete-event timing replay of the step's cost (gem5 detailed
    mode), as JAX's ``DesimBackend`` replays its compiled step.

    The dry run's report (made first if none is given) becomes
    ``step_trace``'s elastic trace, an ``HloTrace`` of ``TraceOp``s
    (``core.desim.trace``), which runs to completion through the port's
    ``sim.Simulator`` front end on ``board``, else on a board of
    ``machine``, else of ``core.desim.machine.default_cluster(prog.mesh)``:
    the card's machine for the program's mesh, one NVIDIA H100 SXM5
    without one.  A board this backend builds times collectives with the
    ring algorithm, the card's (the simulator has no NVSwitch topology).
    ``detail["trace"]`` keeps ``step_trace``'s dict and
    ``detail["desim"]`` the ``ExecResult``.

    ``record_stats=True`` also dumps the run's gem5-style statistics tree
    into ``detail["stats"]`` (flat dict) and ``detail["stats_text"]``
    (stats.txt-style dump).  ``workers=N`` (N>1) shards the machine's
    pods across N worker processes (``core.desim.parallel``): the same
    numbers, less wall clock on multipod boards."""

    kind = "desim"

    def __init__(self, machine=None, record_stats: bool = False,
                 board=None, workers: int = 1):
        self.machine = machine
        self.board = board
        self.record_stats = record_stats
        self.workers = int(workers or 1)

    def run(self, prog: StepProgram,
            dryrun_report: Optional[StepReport] = None) -> StepReport:
        from repro_torch.core.desim.machine import default_cluster
        from repro_torch.core.desim.trace import HloTrace, TraceOp
        from repro_torch.sim import Board, Simulator

        if dryrun_report is None:
            dryrun_report = DryRunBackend().run(prog)
        board = self.board or Board(
            self.machine or default_cluster(prog.mesh), algorithm="ring")
        t0 = time.perf_counter()
        trace = step_trace(prog.name, dryrun_report)
        sim = Simulator(board, HloTrace(
            name=prog.name, ops=[TraceOp(**op) for op in trace["ops"]],
            meta={"total_flops": dryrun_report.flops or 0.0,
                  "total_bytes": dryrun_report.bytes_accessed or 0.0}),
            record_stats=self.record_stats, workers=self.workers)
        result = sim.run_to_completion()
        rep = StepReport(self.kind, prog.name,
                         wall_s=time.perf_counter() - t0,
                         predicted_step_s=result.makespan_s,
                         flops=dryrun_report.flops,
                         bytes_accessed=dryrun_report.bytes_accessed,
                         collective_bytes=dryrun_report.collective_bytes,
                         memory=dryrun_report.memory)
        rep.detail["desim"] = result
        rep.detail["trace"] = trace
        rep.detail["ops"] = dryrun_report.detail.get("ops")
        if self.record_stats and sim.sim_root is not None:
            rep.detail["stats"] = result.stats
            rep.detail["stats_text"] = sim.sim_root.stats.dump_text()
        return rep


BACKENDS = {
    "native": NativeBackend,
    "dryrun": DryRunBackend,
    "desim": DesimBackend,
}


def get_backend(kind: str, **kw) -> Backend:
    try:
        return BACKENDS[kind](**kw)
    except KeyError:
        raise ValueError(f"unknown backend {kind!r}; one of {list(BACKENDS)}")


# ---------------------------------------------------------------------------
# Fake inputs
# ---------------------------------------------------------------------------

def _fake(specs: Any, device: torch.device) -> Any:
    """``specs`` with every ``TensorSpec`` made a tensor on ``device``:
    a fake one, inside a ``FakeTensorMode``."""
    return _tree_map(lambda s: torch.empty(
        s.shape, dtype=s.dtype, device=device).requires_grad_(
            s.requires_grad) if isinstance(s, TensorSpec) else s, specs)


def _fake_shards(specs: Any, shardings: Any, device: torch.device) -> Any:
    """``specs`` with every ``TensorSpec`` made a DTensor: this rank's
    local shard (a fake tensor on ``device``, inside a
    ``FakeTensorMode``) by its ``NamedSharding`` in ``shardings``, at the
    spec's global shape and contiguous strides.  A spec that requires
    grad gives a leaf DTensor that requires grad, as
    ``distribute_tensor`` does."""
    def one(s, sh):
        if not isinstance(s, TensorSpec):
            return s
        local, _ = local_shape_and_offset(tuple(s.shape), sh.mesh,
                                          sh.placements)
        t = DTensor.from_local(
            torch.empty(tuple(local), dtype=s.dtype, device=device),
            sh.mesh, sh.placements, run_check=False, shape=s.shape,
            stride=contiguous_strides(tuple(s.shape)))
        return t.requires_grad_(s.requires_grad)
    return map_leaves(one, specs, shardings)


def _device_of(args: Any) -> torch.device:
    """``cuda`` if any tensor in ``args`` lies there, else the CPU."""
    return torch.device("cuda" if any(
        isinstance(t, torch.Tensor) and t.device.type == "cuda"
        for t in _leaves(args)) else "cpu")


def _bytes_of(tree: Any) -> float:
    """Bytes of the distinct tensors in ``tree``; a DTensor's are its
    local shard's."""
    seen = {id(t): t.to_local() if isinstance(t, DTensor) else t
            for t in _leaves(tree) if isinstance(t, torch.Tensor)}
    return float(sum(t.numel() * t.element_size() for t in seen.values()))


def _device_guard_free(device: DeviceLike):
    """A context in which fake CUDA tensors can be indexed on a host with
    no card: PyTorch's Python bindings of indexing (``t[...]``),
    ``contiguous`` and ``copy_`` take a device guard, which needs the CUDA
    runtime.
    There they are spelled with the aten ops they dispatch to, so the
    ops, and their costs, are the same: indexing by a torch function mode
    over the step's own code, ``contiguous`` and ``copy_`` also as
    methods of ``torch.Tensor`` while the context lasts, since DTensor
    calls them on its local shards with torch functions disabled.
    Elsewhere it does nothing."""
    if torch.device(device).type != "cuda" or torch.cuda.is_available():
        return contextlib.nullcontext()
    return _guard_free()


@contextlib.contextmanager
def _guard_free():
    torch.Tensor.contiguous = _contiguous
    torch.Tensor.copy_ = _copy_
    try:
        with _GuardFreeIndexing():
            yield
    finally:
        del torch.Tensor.contiguous, torch.Tensor.copy_


def _contiguous(t, memory_format=torch.contiguous_format):
    return t if t.is_contiguous(memory_format=memory_format) else t.clone(
        memory_format=memory_format)


def _copy_(t, src, non_blocking=False):
    return torch.ops.aten.copy_.default(t, src, non_blocking)


class _GuardFreeIndexing(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            view, adv = _basic_index(*args)
            if not adv:
                return view
            index = [None] * view.dim()
            for d, ix in adv:
                index[d] = ix
            return torch.ops.aten.index(view, index)
        return func(*args, **kwargs)


def _basic_index(t: torch.Tensor, idx):
    """The view that the basic indices of ``idx`` (Python ints, slices,
    None, Ellipsis) select, and the advanced indices (integer tensors) as
    (dim, index) pairs on that view.

    It covers the index forms the port's steps use, not all of Python
    indexing: any other index (a bool or a bool mask, a numpy scalar or
    array, a list) raises TypeError rather than being costed as ops the
    real binding would not dispatch."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(i is Ellipsis for i in idx):
        k = idx.index(Ellipsis)
        used = sum(1 for i in idx if i is not None and i is not Ellipsis)
        idx = idx[:k] + (slice(None),) * (t.dim() - used) + idx[k + 1:]
    view, dim, adv = t, 0, []
    for i in idx:
        if i is None:
            view = view.unsqueeze(dim)
            dim += 1
        elif type(i) is int:
            view = view.select(dim, i)
        elif isinstance(i, slice):
            view = torch.ops.aten.slice(view, dim, i.start, i.stop,
                                        i.step or 1)
            dim += 1
        elif isinstance(i, torch.Tensor) and not (
                i.dtype.is_floating_point or i.dtype.is_complex
                or i.dtype in (torch.bool, torch.uint8)):
            adv.append((dim, i))
            dim += 1
        else:
            raise TypeError(f"index {type(i).__name__} "
                            f"{getattr(i, 'dtype', '')} is not supported "
                            f"on fake CUDA tensors without a card")
    return view, adv
