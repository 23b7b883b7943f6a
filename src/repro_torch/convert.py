"""Parameters of the JAX package -> parameters of the port.

``params_from_jax(tree, cfg, device, dtype)`` takes the pytree that
``repro.models.api.Model.init`` returns, with its leaves turned into
numpy arrays (``jax.tree.map(np.asarray, params)``), and returns the
port's parameter tree: the same key paths and the same stacked layer
axis, leaf for leaf.  It imports no JAX: the caller does the numpy
conversion.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf


def _convert(tree: Any, want: Any, path: str, device, dtype) -> Any:
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or '/'}: keys {got}, want "
                             f"{sorted(want)}")
        return {k: _convert(tree[k], want[k], f"{path}/{k}", device, dtype)
                for k in want}
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {arr.shape}, want "
                         f"{tuple(want.shape)}")
    # via f32: numpy has no bfloat16, and the JAX master params are f32
    return torch.tensor(arr.astype(np.float32, copy=False), device=device,
                        dtype=dtype)


def params_from_jax(tree: Dict, cfg, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """Convert a JAX parameter tree (numpy leaves) for ``cfg``."""
    want = tf.init_lm(None, cfg)          # shapes only, on the meta device
    return _convert(tree, want, "", resolve_device(device), dtype)
