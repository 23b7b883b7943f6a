"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel package is ``<name>/{csrc/, kernel.py, ops.py, ref.py}``:
  csrc/     -- CUDA C++ source for sm_90a with a plain C interface
  kernel.py -- its library, built with nvcc at first use (``build``) and
               bound with ctypes
  ops.py    -- public wrapper in model layout, with its launch counter
  ref.py    -- plain PyTorch version (the CPU path and the on-card oracle)

The kernels are forward-only, as the TPU kernels are: a wrapper refuses,
on every device, inputs that require grad while grad mode is on, since
its result would carry no ``grad_fn`` and drop their gradients.
"""

import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a call of the forward-only kernel
    ``name`` on ``tensors``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (no backward kernel): its result would "
            f"drop the gradients of its inputs.  Call it under "
            f"torch.no_grad(); training takes the model's train mode, which "
            f"does not call it")
