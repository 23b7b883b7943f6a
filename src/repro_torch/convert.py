"""Parameters and train states of the JAX package -> those of the port.

``params_from_jax(tree, cfg, device, dtype)`` takes the pytree that
``repro.models.api.Model.init`` returns, with its leaves turned into
numpy arrays (``jax.tree.map(np.asarray, params)``), and returns the
port's parameter tree: the same key paths and the same stacked layer
axis (a hybrid arch's ``layers``: a tuple of per-position trees), leaf
for leaf.  ``train_state_from_jax(state, cfg, opts, device)``
does the same for a train state of ``repro.train.step``.  Neither
imports JAX: the caller does the numpy conversion.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import leaves
from repro_torch.train.step import default_options_for, moment_dtype


def _convert(tree: Any, want: Any, path: str, device, dtype) -> Any:
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or '/'}: keys {got}, want "
                             f"{sorted(want)}")
        return {k: _convert(tree[k], want[k], f"{path}/{k}", device, dtype)
                for k in want}
    if type(want) is tuple:            # a hybrid arch's per-position layers
        if not isinstance(tree, (tuple, list)) or len(tree) != len(want):
            got = (len(tree) if isinstance(tree, (tuple, list))
                   else type(tree))
            raise ValueError(f"{path or '/'}: {got} entries, want a tuple "
                             f"of {len(want)}")
        return tuple(_convert(t, w, f"{path}/{i}", device, dtype)
                     for i, (t, w) in enumerate(zip(tree, want)))
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


def _scalar(x, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)


def train_state_from_jax(state: Dict, cfg, opts=None,
                         device: DeviceLike = None) -> Dict:
    """Convert a JAX train state (numpy leaves: ``params``, ``opt`` with
    ``m``, ``v`` and ``count``, ``step`` and, with ``grad_compress``,
    ``err``) into the port's, ready for ``build_train_step``: params f32
    with ``requires_grad``, moments in ``opts.moment_dtype``."""
    opts = opts or default_options_for(cfg)
    dev = resolve_device(device)
    mdt = moment_dtype(opts)
    params = params_from_jax(state["params"], cfg, dev)
    for p in leaves(params):
        p.requires_grad_(True)
    out = {"params": params,
           "opt": {"m": params_from_jax(state["opt"]["m"], cfg, dev, mdt),
                   "v": params_from_jax(state["opt"]["v"], cfg, dev, mdt),
                   "count": _scalar(state["opt"]["count"], dev)},
           "step": _scalar(state["step"], dev)}
    if opts.grad_compress:
        out["err"] = params_from_jax(state["err"], cfg, dev)
    elif "err" in state:
        raise ValueError("the state carries an error buffer but "
                         "opts.grad_compress is off")
    return out
