"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel package is ``<name>/{csrc/, kernel.py, ops.py, ref.py}``:
  csrc/     -- CUDA C++ source for sm_90a with a plain C interface
  kernel.py -- its library, built with nvcc at first use (``build``) and
               bound with ctypes
  ops.py    -- public wrapper in model layout, with its launch counter,
               the kernel's custom op and its ``cost`` (flops, bytes)
  ref.py    -- plain PyTorch version (the CPU path and the on-card oracle)

The kernels are forward-only, as the TPU kernels are: a wrapper refuses,
on every device, inputs that require grad while grad mode is on, since
its result would carry no ``grad_fn`` and drop their gradients.

Each wrapper launches its kernel through a custom op
``repro_torch::<name>`` (``register_op``), so that a dispatch mode sees
the kernel as one op: a dry run on fake tensors
(``repro_torch.core.fidelity``) costs it by ``COSTS[<name>]`` and
launches nothing.  Each op also has a DTensor sharding strategy
(``torch.distributed.tensor.experimental.register_sharding``): on
DTensors the op launches the same kernel on each rank's local shards,
laid out as the strategy allows, or on replicated inputs for any other
layout; it never drops to the plain version.  A layout survives only
where it splits every argument evenly (``_even``).
"""

import math
from typing import Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import register_sharding

# each kernel's custom op, by name, to its (flops, bytes) on the op's own
# arguments; filled by ``register_op``
COSTS: Dict[str, Callable[..., Tuple[float, float]]] = {}


def register_op(name: str, schema: str, cuda_impl, fake_impl, cost,
                sharding):
    """Define the custom op ``repro_torch::<name>`` with ``schema``: its
    CUDA implementation (the kernel's checks that need real memory, the
    launch and the count), its fake implementation (the outputs' shapes,
    dtypes and strides, nothing else), ``cost``, its (flops, bytes) on
    the op's arguments, kept in ``COSTS``, and ``sharding``, its DTensor
    strategy: called with the op's arguments (a tensor's as its DTensor
    spec), it lists the layouts of one mesh dim the kernel computes
    locally, each ``([output placements], [input placements])`` with
    ``None`` for an argument that is no tensor.  Returns the op.

    ``register_sharding`` expands the one-dim layouts to every
    combination over the mesh's dims, blind to each dim's size; the
    expansion is then registered again through the propagator's
    ``register_op_strategy`` with the combinations that split some
    argument unevenly taken out (``_even``), so that a layout holds only
    where the mesh dims that take it divide the dim they split (flash's
    heads over "model" but not over the whole mesh).

    ``torch.library.define`` and ``impl``, not ``custom_op``: the latter
    runs a Python autograd layer and an aliasing check on every call,
    host time that every decode step would pay."""
    qualname = f"repro_torch::{name}"
    torch.library.define(qualname, schema)
    torch.library.impl(qualname, "cuda", cuda_impl)
    torch.library.register_fake(qualname, fake_impl)
    COSTS[name] = cost
    op = getattr(torch.ops.repro_torch, name).default
    register_sharding(op)(sharding)
    prop = DTensor._op_dispatcher.sharding_propagator
    expand = prop.op_strategy_funcs[op]

    def even_strategy(op_schema):
        strategy = expand(op_schema)
        strategy.strategies = [s for s in strategy.strategies if _even(s)]
        return strategy

    prop.register_op_strategy(op, even_strategy,
                              prop.op_to_schema_info.get(op))
    return op


def _even(op_spec) -> bool:
    """Whether every tensor argument of one expanded layout splits each
    of its dims into equal shards: the product of the sizes of the mesh
    dims that shard a dim divides that dim."""
    for spec in op_spec.input_specs:
        if spec is None or spec.tensor_meta is None:
            continue
        for dim, size in enumerate(spec.tensor_meta.shape):
            n = math.prod(spec.mesh.size(i)
                          for i, p in enumerate(spec.placements)
                          if p.is_shard(dim))
            if size % n:
                return False
    return True


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a call of the forward-only kernel
    ``name`` on ``tensors``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (no backward kernel): its result would "
            f"drop the gradients of its inputs.  Call it under "
            f"torch.no_grad(); training takes the model's train mode, which "
            f"does not call it")
