"""Model API of the port, as ``repro.models.api``:

    init(seed | generator, device)            -> params (f32 master)
    param_specs()                             -> (TensorSpec tree, Axes tree)
    load(params, device)                      -> params cast once to compute_dtype
    train_logits(params, batch, chunk)        -> (logits (b, s, Vp), aux_loss)
    prefill(params, batch, ...)               -> (last_logits, cache)
    decode(params, batch, cache, cur_len)     -> (logits, cache), in place
    init_cache(batch, seq_len, device)        -> zero stacked cache: bf16 KV,
                                                 or RWKV states (WKV in f32);
                                                 a hybrid arch's is a tuple of
                                                 per-position dicts: KV, or
                                                 Mamba conv (bf16) and ssm
                                                 (f32) states; an encoder-
                                                 decoder's self and cross KV
    cache_spec(batch, seq_len, dtype)         -> that cache's TensorSpec tree
    input_specs(shape, kind)                  -> a batch's TensorSpec dict

Each method dispatches on the family, as the JAX ``Model`` does: the
audio family (whisper) to ``models/encdec.py``, every other to the
decoder LM of ``models/transformer.py``.

Every method that creates tensors runs on ``cuda`` unless the caller
passes ``device="cpu"``.  ``train_logits`` takes the f32 master
params (not ``load``'s bf16 copy) and casts them on every call, so that
gradients reach them.

``train_logits``, ``prefill`` and ``decode`` take a ``sharder``
(``repro_torch.dist.sharding.MeshSharder`` for params distributed on a
device mesh; the identity by default) and run the model inside its
``scope()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.common import (IDENTITY_SHARDER, Sharder, TensorSpec,
                                       cast, map_leaves, param_axes)


def init_fn(cfg: ArchConfig) -> Callable:
    """The parameter init of ``cfg``'s family: ``(generator, cfg) ->
    params``; with no generator, the shapes on the meta device."""
    return ed.init_encdec if cfg.family == "audio" else tf.init_lm


@dataclass
class Model:
    cfg: ArchConfig
    compute_dtype: torch.dtype = torch.bfloat16

    def init(self, key: Union[int, torch.Generator] = 0,
             device: DeviceLike = None) -> Dict:
        """f32 parameters drawn from ``key``: a seed, or a generator on
        the target device."""
        dev = resolve_device(device)
        if isinstance(key, torch.Generator):
            if key.device.type != dev.type:
                raise ValueError(f"generator on {key.device}, params on {dev}")
            gen = key
        else:
            gen = torch.Generator(device=dev).manual_seed(int(key))
        return init_fn(self.cfg)(gen, self.cfg)

    def param_specs(self) -> Tuple[Any, Any]:
        """(``TensorSpec`` tree, logical-axes tree) of the params, as the
        JAX ``param_specs``: the init run on the meta device, where
        nothing is drawn."""
        meta = init_fn(self.cfg)(None, self.cfg)
        specs = map_leaves(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                           meta)
        return specs, param_axes(meta)

    def load(self, params: Dict, device: DeviceLike = None) -> Dict:
        """``params`` on ``device`` in the compute dtype, cast once, for
        serving: detached from autograd, so that trained master params
        (``requires_grad``) serve through the forward-only kernels."""
        return map_leaves(torch.Tensor.detach, cast(
            params, self.compute_dtype, resolve_device(device)))

    @property
    def _audio(self) -> bool:
        return self.cfg.family == "audio"

    def _apply(self, params: Dict, batch: Dict, sharder: Sharder, **kw):
        apply = ed.encdec_apply if self._audio else tf.lm_apply
        with sharder.scope():
            return apply(params, batch, self.cfg,
                         compute_dtype=self.compute_dtype, sharder=sharder,
                         **kw)

    def train_logits(self, params: Dict, batch: Dict, chunk: int = 2048,
                     sharder: Sharder = IDENTITY_SHARDER
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _, aux = self._apply(params, batch, sharder, mode="train",
                                     chunk=chunk)
        return logits, aux

    def prefill(self, params: Dict, batch: Dict, chunk: int = 2048,
                seq_capacity: int = 0, sharder: Sharder = IDENTITY_SHARDER):
        logits, cache, _ = self._apply(params, batch, sharder,
                                       mode="prefill", chunk=chunk,
                                       seq_capacity=seq_capacity)
        return logits, cache

    def decode(self, params: Dict, batch: Dict, cache: Dict, cur_len,
               sharder: Sharder = IDENTITY_SHARDER):
        logits, cache, _ = self._apply(params, batch, sharder, mode="decode",
                                       cache=cache, cur_len=cur_len)
        return logits, cache

    def cache_spec(self, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16):
        """The decode cache's ``TensorSpec`` tree, as ``init_cache``
        makes it."""
        if self._audio:
            return ed.encdec_cache_spec(self.cfg, batch, seq_len, dtype)
        return tf.cache_spec(self.cfg, batch, seq_len, dtype)

    def init_cache(self, batch: int, seq_len: int, device: DeviceLike = None,
                   dtype: torch.dtype = torch.bfloat16):
        init = ed.init_cache if self._audio else tf.init_cache
        return init(self.cfg, batch, seq_len, resolve_device(device), dtype)

    def input_specs(self, shape: ShapeConfig, kind: Optional[str] = None
                    ) -> Dict[str, Any]:
        """A batch's ``TensorSpec``s for one (arch x shape) cell, with
        the JAX ``input_specs``' keys, shapes and dtypes (int32 tokens
        and labels, an f32 mask, bf16 stub-frontend embeddings).  ``kind``
        defaults to ``shape.kind``; a decode batch holds the cache's
        specs at ``shape.seq_len`` and a scalar ``cur_len``."""
        cfg = self.cfg
        kind = kind or shape.kind
        B, S = shape.global_batch, shape.seq_len
        i32, bf16 = torch.int32, torch.bfloat16
        extras: Dict[str, Any] = {}
        if cfg.family == "vlm" and kind != "decode":
            extras["vision_embeds"] = TensorSpec((B, cfg.n_vis, cfg.d_model),
                                                 bf16)
        if cfg.family == "audio" and kind != "decode":
            extras["enc_embeds"] = TensorSpec((B, cfg.enc_seq, cfg.d_model),
                                              bf16)
        s_text = S - (cfg.n_vis if cfg.family == "vlm" else 0)
        if kind == "train":
            return {"tokens": TensorSpec((B, s_text), i32),
                    "labels": TensorSpec((B, S), i32),
                    "mask": TensorSpec((B, S), torch.float32), **extras}
        if kind == "prefill":
            return {"tokens": TensorSpec((B, s_text), i32), **extras}
        return {"tokens": TensorSpec((B, 1), i32),
                "cache": self.cache_spec(B, S),
                "cur_len": TensorSpec((), i32)}


def build_model(cfg: ArchConfig,
                compute_dtype: torch.dtype = torch.bfloat16) -> Model:
    """A ``Model`` of ``cfg``; raises for a family the port has no model
    of."""
    if cfg.family != "audio":
        tf.check_family(cfg)
    return Model(cfg, compute_dtype)
