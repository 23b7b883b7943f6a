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
* ``DesimBackend``   -- hand the dry run's cost, as an elastic trace, to
                        a replay that times it on a machine model (gem5's
                        detailed mode).

All three return a ``StepReport`` with the JAX package's fields.  The
port imports nothing of ``repro``, so the replay is the caller's: a
callable that takes the trace as plain data (``TraceOp``'s field names)
and returns the makespan, such as one built on the JAX-free
``repro.sim`` (``examples/quickstart_torch.py``).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode

from repro_torch.core.op_cost import CostMode
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import TensorSpec


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
    where the step runs (``cuda`` unless the caller names the CPU).  The
    JAX program's ``in_shardings``, ``out_shardings`` and ``mesh`` wait
    for the port's sharding (ROADMAP.md Queue 1 item 9)."""

    name: str
    fn: Callable
    input_specs: Any
    device: DeviceLike = None


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
    op whose fake implementation gives its outputs' shapes.  ``flops``
    and ``bytes_accessed`` sum ``core.op_cost`` over the ops;
    ``collective_bytes`` is 0 (one device).  ``memory`` holds the exact
    ``argument_bytes`` and ``output_bytes``; ``temp_bytes``,
    ``alias_bytes`` and ``code_bytes`` stay 0.0 (eager PyTorch has no
    compiled module to read them from).  ``detail["ops"]`` is the op
    stream ``(name, flops, bytes)``, the analogue of ``detail["hlo"]``;
    ``detail["kernels"]`` counts each kernel's calls.

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
            args = _fake(prog.input_specs, dev)
            with CostMode() as cost:
                out = prog.fn(*args)
            arg_bytes, out_bytes = _bytes_of(args), _bytes_of(out)
        rep = StepReport(self.kind, prog.name,
                         wall_s=time.perf_counter() - t0, flops=cost.flops,
                         bytes_accessed=cost.bytes, collective_bytes=0.0)
        rep.memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                      "temp_bytes": 0.0, "alias_bytes": 0.0,
                      "code_bytes": 0.0}
        rep.detail["ops"] = cost.ops
        rep.detail["kernels"] = dict(cost.kernels)
        return rep


def step_trace(name: str, report: StepReport) -> Dict[str, Any]:
    """The elastic trace of a one-device step as plain data, in
    ``repro.core.desim.trace.TraceOp``'s field names: one compute region
    holding the step's flops and bytes, as ``HloTrace.from_hlo_text``
    makes of a module with no collective."""
    return {"name": name, "ops": [{
        "kind": "compute", "flops": report.flops or 0.0,
        "bytes": report.bytes_accessed or 0.0, "name": "region0"}]}


class DesimBackend(Backend):
    """Discrete-event timing replay of the step's cost (gem5 detailed
    mode).

    ``replay(trace)`` takes ``step_trace``'s dict and returns the
    makespan in seconds, or a result with ``makespan_s`` (kept in
    ``detail["desim"]``).  With ``record_stats=True`` it is called as
    ``replay(trace, record_stats=True)`` and the result's ``stats`` go
    into ``detail["stats"]``.  Without a ``dryrun_report`` the dry run is
    made first."""

    kind = "desim"

    def __init__(self, replay: Optional[Callable] = None,
                 record_stats: bool = False):
        self.replay = replay
        self.record_stats = record_stats

    def run(self, prog: StepProgram,
            dryrun_report: Optional[StepReport] = None) -> StepReport:
        if self.replay is None:
            raise ValueError(
                "DesimBackend needs replay=: a callable that takes the "
                "trace dict {'name', 'ops': [{'kind', 'flops', 'bytes', "
                "'name'}]} and returns the makespan in seconds, e.g. one "
                "that builds repro.core.desim.trace.HloTrace from "
                "TraceOp(**op) and runs repro.sim.Simulator on a board "
                "(examples/quickstart_torch.py, sim_replay)")
        if dryrun_report is None:
            dryrun_report = DryRunBackend().run(prog)
        trace = step_trace(prog.name, dryrun_report)
        t0 = time.perf_counter()
        result = (self.replay(trace, record_stats=True) if self.record_stats
                  else self.replay(trace))
        rep = StepReport(self.kind, prog.name,
                         wall_s=time.perf_counter() - t0,
                         predicted_step_s=float(getattr(result, "makespan_s",
                                                        result)),
                         flops=dryrun_report.flops,
                         bytes_accessed=dryrun_report.bytes_accessed,
                         collective_bytes=dryrun_report.collective_bytes,
                         memory=dryrun_report.memory)
        rep.detail["desim"] = result
        rep.detail["trace"] = trace
        rep.detail["ops"] = dryrun_report.detail.get("ops")
        if self.record_stats:
            rep.detail["stats"] = getattr(result, "stats", None)
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


def _device_of(args: Any) -> torch.device:
    """``cuda`` if any tensor in ``args`` lies there, else the CPU."""
    return torch.device("cuda" if any(
        isinstance(t, torch.Tensor) and t.device.type == "cuda"
        for t in _leaves(args)) else "cpu")


def _bytes_of(tree: Any) -> float:
    """Bytes of the distinct tensors in ``tree``."""
    seen = {id(t): t for t in _leaves(tree) if isinstance(t, torch.Tensor)}
    return float(sum(t.numel() * t.element_size() for t in seen.values()))


def _device_guard_free(device: DeviceLike):
    """A context in which fake CUDA tensors can be indexed on a host with
    no card: PyTorch's Python bindings of indexing (``t[...]``) and
    ``contiguous`` take a device guard, which needs the CUDA runtime.
    There they are spelled with the aten ops they dispatch to, so the
    ops, and their costs, are the same.  Elsewhere it does nothing."""
    if torch.device(device).type != "cuda" or torch.cuda.is_available():
        return contextlib.nullcontext()
    return _GuardFreeIndexing()


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
        if func is torch.Tensor.contiguous:
            t = args[0]
            fmt = kwargs.get("memory_format", torch.contiguous_format)
            return t if t.is_contiguous(memory_format=fmt) else t.clone(
                memory_format=fmt)
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
