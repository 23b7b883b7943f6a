"""Device meshes of the port, the twin of ``repro.launch.mesh``.

Every function here builds a mesh when called; importing the module
touches no process group and no device (tests import it in a process
with none).  A mesh spans the ranks of the default process group, which
the caller initialises (``torch.distributed.init_process_group``: the
address, world size and rank are the caller's to give).

Production layouts, as in the JAX package:
  single pod : (16, 16)      axes ("data", "model")          = 256 ranks
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")   = 512 ranks

"model" carries tensor and sequence parallelism, "data" the FSDP
all-gathers and gradient reduce-scatters, "pod" the all-reduce across
pods.  ``describe`` gives the JAX package's dict.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group
    (whose world size must be the product of ``shape``).  DTensor's
    sharding-propagation cache is emptied first (``forget_layouts``)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    forget_layouts()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def forget_layouts() -> None:
    """Empty DTensor's sharding-propagation cache.  Its keys compare
    meshes by shape, names, ranks and device type, not by process group:
    after a process group is destroyed and another made, the cache hands
    an op's output a mesh of the dead group, whose collectives then name
    groups that no longer resolve (or resolve to others).  A new mesh
    starts from an empty cache: the Python one and, where PyTorch has
    one (2.13), the C++ dispatch's."""
    prop = DTensor._op_dispatcher.sharding_propagator
    for clear in (getattr(prop.propagate_op_sharding, "cache_clear", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None)):
        if clear is not None:
            clear()


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A 1-device mesh with the production axis names (smoke runs)."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the single-pod or multi-pod mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) single-pod or (2, 16, 16) multi-pod mesh; raises
    unless the default process group has 256 or 512 ranks."""
    shape, axes = production_shape(multi_pod)
    n = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {shape} needs a process group of {n} ranks; "
            + (f"the default group has {world}" if world
               else "no process group is initialised"))
    return make_mesh(shape, axes, device_type)


def describe(mesh: DeviceMesh) -> dict:
    return {"axes": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
            "devices": int(mesh.size())}
