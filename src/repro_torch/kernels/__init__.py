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
launches nothing.
"""

from typing import Callable, Dict, Tuple

import torch

# each kernel's custom op, by name, to its (flops, bytes) on the op's own
# arguments; filled by ``register_op``
COSTS: Dict[str, Callable[..., Tuple[float, float]]] = {}


def register_op(name: str, schema: str, cuda_impl, fake_impl, cost):
    """Define the custom op ``repro_torch::<name>`` with ``schema``: its
    CUDA implementation (the kernel's checks that need real memory, the
    launch and the count), its fake implementation (the outputs' shapes,
    dtypes and strides, nothing else) and ``cost``, its (flops, bytes)
    on the op's arguments, kept in ``COSTS``.  Returns the op.

    ``torch.library.define`` and ``impl``, not ``custom_op``: the latter
    runs a Python autograd layer and an aliasing check on every call,
    host time that every decode step would pay."""
    qualname = f"repro_torch::{name}"
    torch.library.define(qualname, schema)
    torch.library.impl(qualname, "cuda", cuda_impl)
    torch.library.register_fake(qualname, fake_impl)
    COSTS[name] = cost
    return getattr(torch.ops.repro_torch, name).default


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a call of the forward-only kernel
    ``name`` on ``tensors``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (no backward kernel): its result would "
            f"drop the gradients of its inputs.  Call it under "
            f"torch.no_grad(); training takes the model's train mode, which "
            f"does not call it")
