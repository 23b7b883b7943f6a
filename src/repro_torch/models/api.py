"""Model API of the port, as ``repro.models.api``:

    init(seed | generator, device)            -> params (f32 master)
    load(params, device)                      -> params cast once to compute_dtype
    train_logits(params, batch, chunk)        -> (logits (b, s, Vp), aux_loss)
    prefill(params, batch, ...)               -> (last_logits, cache)
    decode(params, batch, cache, cur_len)     -> (logits, cache), in place
    init_cache(batch, seq_len, device)        -> zero stacked cache: bf16 KV,
                                                 or RWKV states (WKV in f32);
                                                 a hybrid arch's is a tuple of
                                                 per-position dicts: KV, or
                                                 Mamba conv (bf16) and ssm
                                                 (f32) states

Every method that creates tensors runs on ``cuda`` unless the caller
passes ``device="cpu"``.  ``train_logits`` takes the f32 master
params (not ``load``'s bf16 copy) and casts them on every call, so that
gradients reach them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import cast, map_leaves


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
        return tf.init_lm(gen, self.cfg)

    def load(self, params: Dict, device: DeviceLike = None) -> Dict:
        """``params`` on ``device`` in the compute dtype, cast once, for
        serving: detached from autograd, so that trained master params
        (``requires_grad``) serve through the forward-only kernels."""
        return map_leaves(torch.Tensor.detach, cast(
            params, self.compute_dtype, resolve_device(device)))

    def train_logits(self, params: Dict, batch: Dict, chunk: int = 2048
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _, aux = tf.lm_apply(params, batch, self.cfg, mode="train",
                                     chunk=chunk,
                                     compute_dtype=self.compute_dtype)
        return logits, aux

    def prefill(self, params: Dict, batch: Dict, chunk: int = 2048,
                seq_capacity: int = 0):
        logits, cache, _ = tf.lm_apply(
            params, batch, self.cfg, mode="prefill", chunk=chunk,
            seq_capacity=seq_capacity, compute_dtype=self.compute_dtype)
        return logits, cache

    def decode(self, params: Dict, batch: Dict, cache: Dict, cur_len):
        logits, cache, _ = tf.lm_apply(
            params, batch, self.cfg, mode="decode", cache=cache,
            cur_len=cur_len, compute_dtype=self.compute_dtype)
        return logits, cache

    def init_cache(self, batch: int, seq_len: int, device: DeviceLike = None,
                   dtype: torch.dtype = torch.bfloat16):
        return tf.init_cache(self.cfg, batch, seq_len,
                             resolve_device(device), dtype)


def build_model(cfg: ArchConfig,
                compute_dtype: torch.dtype = torch.bfloat16) -> Model:
    tf.check_family(cfg)
    return Model(cfg, compute_dtype)
