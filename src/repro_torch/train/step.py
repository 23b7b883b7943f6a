"""Train step of the port, as ``repro.train.step``: loss and gradients by
autograd, optional int8 gradient compression with error feedback,
global-norm clipping and AdamW.

``build_train_step(model, opts)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The state is the JAX package's tree: ``params``
(f32 master, ``requires_grad``), ``opt`` (``m``, ``v``, ``count``),
``step`` and, with ``grad_compress``, ``err``.  Unlike the JAX function
the step updates params and moments in place (see ``optim.adamw``) and
returns a new state dict holding them.  A batch is a dict of tensors on
the params' device (``batch_to``).  With ``accum_steps > 1`` the batch is
split along its first axis into microbatches whose gradients are summed
and scaled by ``1 / accum_steps``, as the JAX ``lax.scan`` does.

On a device mesh (``repro_torch.dist.sharding``) the state's leaves are
DTensors laid out by ``train_state_specs``' axes, and the step runs the
model with the mesh's ``sharder``; given ``param_axes``, the gradients
are laid out like the params the moment they are produced
(``shard_like_params``, the JAX step's constraint), before compression,
clipping and AdamW, which update the distributed state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import Model
from repro_torch.models.common import (IDENTITY_SHARDER, Axes, Sharder,
                                       TensorSpec, leaves, map_leaves,
                                       unflatten)
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_gradients, cosine_schedule,
                               wsd_schedule)
from repro_torch.optim.compress import init_error_buffer


@dataclass(frozen=True)
class TrainOptions:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | wsd
    wsd_stable: int = 8000
    wsd_decay: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    aux_weight: float = 0.01          # MoE load-balance loss weight
    accum_steps: int = 1
    grad_compress: bool = False       # int8 + error feedback
    chunk: int = 2048                 # attention kv-chunk
    moment_dtype: str = "float32"     # adam m/v dtype (bf16 at 141B scale)


def lr_at(opts: TrainOptions, step) -> torch.Tensor:
    if opts.schedule == "wsd":
        return wsd_schedule(step, opts.peak_lr, opts.warmup,
                            opts.wsd_stable, opts.wsd_decay)
    return cosine_schedule(step, opts.peak_lr, opts.warmup, opts.total_steps)


def default_options_for(cfg: ArchConfig) -> TrainOptions:
    # minicpm trains with the WSD schedule (its paper-specific feature)
    if cfg.name == "minicpm-2b":
        return TrainOptions(schedule="wsd")
    return TrainOptions()


def moment_dtype(opts: TrainOptions) -> torch.dtype:
    return getattr(torch, opts.moment_dtype)


def init_train_state(model: Model, key=0, opts: Optional[TrainOptions] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Fresh state on ``device`` (``cuda`` unless the caller passes
    ``cpu``); ``key`` is a seed or a generator, as ``Model.init``."""
    opts = opts or default_options_for(model.cfg)
    dev = resolve_device(device)
    params = map_leaves(lambda p: p.requires_grad_(True),
                        model.init(key, dev))
    state = {"params": params, "opt": adamw_init(params, moment_dtype(opts)),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if opts.grad_compress:
        state["err"] = init_error_buffer(params)
    return state


def train_state_specs(model: Model, opts: Optional[TrainOptions] = None
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(``TensorSpec`` tree, logical-axes tree) of the train state, as
    the JAX ``train_state_specs``: params and moments share the params'
    axes; ``count`` and ``step`` are scalars; with ``grad_compress`` the
    f32 error buffer takes the params' axes too."""
    opts = opts or default_options_for(model.cfg)
    p_specs, p_axes = model.param_specs()
    mdt = moment_dtype(opts)
    i32 = TensorSpec((), torch.int32)
    master = map_leaves(lambda s: s._replace(requires_grad=True), p_specs)
    moments = map_leaves(lambda s: s._replace(dtype=mdt), p_specs)
    specs = {"params": master, "opt": {"m": moments, "v": moments,
                                       "count": i32},
             "step": i32}
    axes = {"params": p_axes, "opt": {"m": p_axes, "v": p_axes,
                                      "count": Axes(())},
            "step": Axes(())}
    if opts.grad_compress:
        specs["err"] = map_leaves(lambda s: s._replace(dtype=torch.float32),
                                  p_specs)
        axes["err"] = p_axes
    return specs, axes


def batch_to(batch: Dict[str, np.ndarray], device: DeviceLike = None
             ) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}


def loss_and_grads(model: Model, opts: TrainOptions, params: Dict,
                   batch: Dict[str, torch.Tensor],
                   sharder: Sharder = IDENTITY_SHARDER
                   ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """(gradient tree of ``loss + aux_weight * aux``, loss, aux) of one
    (micro)batch; the loss is the masked mean next-token cross entropy."""
    with record_function("forward"):
        logits, aux = model.train_logits(params, batch, chunk=opts.chunk,
                                         sharder=sharder)
        loss = cross_entropy(logits, batch["labels"], model.cfg,
                             mask=batch.get("mask"), sharder=sharder)
        total = loss + opts.aux_weight * aux
    grads = torch.autograd.grad(total, list(leaves(params)),
                                allow_unused=True, materialize_grads=True)
    return unflatten(params, grads), loss.detach(), aux.detach()


def build_train_step(model: Model, opts: Optional[TrainOptions] = None,
                     sharder: Sharder = IDENTITY_SHARDER,
                     param_axes: Any = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` are 0-dim tensors.
    Its phases are marked for ``torch.profiler`` (``record_function``:
    ``forward``, ``compress``, ``optimizer``; the backward pass runs on
    autograd's own thread, outside any of them).

    ``sharder`` runs the model on a mesh; ``param_axes``, the params'
    logical-axes tree, lays each gradient out like its param as soon as
    it is produced (``shard_like_params``), as the JAX step does."""
    opts = opts or default_options_for(model.cfg)

    def shard_like_params(grads):
        if param_axes is None:
            return grads
        return map_leaves(sharder.ac, grads, param_axes)

    def microbatches(batch):
        # microbatch i is rows [i m, (i + 1) m), as the JAX step's reshape
        # to (a, m, ...) gives; a slice, which DTensor takes on a batch
        # split over the data-parallel ranks (a reshape of that split dim
        # into a < ranks pieces it refuses)
        a = opts.accum_steps
        for i in range(a):
            yield {k: (v.narrow(0, i * (v.shape[0] // a), v.shape[0] // a)
                       if v.dim() else v) for k, v in batch.items()}

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        with sharder.scope():
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        if opts.accum_steps > 1:
            grads, loss, aux = None, 0.0, 0.0
            for mb in microbatches(batch):
                g, l, a = loss_and_grads(model, opts, params, mb, sharder)
                g = shard_like_params(g)
                grads = g if grads is None else map_leaves(torch.add, grads, g)
                loss, aux = loss + l, aux + a
            inv = 1.0 / opts.accum_steps
            grads = map_leaves(lambda g: g * inv, grads)
            loss, aux = loss * inv, aux * inv
        else:
            grads, loss, aux = loss_and_grads(model, opts, params, batch,
                                              sharder)
            grads = shard_like_params(grads)

        new_state = dict(state)
        if opts.grad_compress:
            with torch.no_grad(), record_function("compress"):
                grads, err = compress_gradients(grads, state["err"])
                # the state keeps its layout: the dequantized gradients
                # and the new error buffer laid out like the params
                grads = shard_like_params(grads)
                new_state["err"] = shard_like_params(err)
        with torch.no_grad(), record_function("optimizer"):
            grads, gnorm = clip_by_global_norm(grads, opts.clip_norm)
            lr = lr_at(opts, state["step"])
            new_state["params"], new_state["opt"] = adamw_update(
                grads, state["opt"], params, lr,
                weight_decay=opts.weight_decay)
            new_state["step"] = state["step"] + 1
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                   "lr": lr}
        return new_state, metrics

    return train_step
