"""Model API of the port, as ``repro.models.api``:

    init(seed | generator, device)            -> params (f32 master)
    load(params, device)                      -> params cast once to compute_dtype
    prefill(params, batch, ...)               -> (last_logits, cache)
    decode(params, batch, cache, cur_len)     -> (logits, cache), in place
    init_cache(batch, seq_len, device)        -> zero stacked bf16 KV cache

Every method that creates tensors runs on ``cuda`` unless the caller
passes ``device="cpu"``.  ``train_logits`` arrives with the training
slice (ROADMAP.md Queue 1 item 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import cast


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
        """``params`` on ``device`` in the compute dtype, cast once."""
        return cast(params, self.compute_dtype, resolve_device(device))

    def prefill(self, params: Dict, batch: Dict, chunk: int = 2048,
                seq_capacity: int = 0):
        return tf.lm_apply(params, batch, self.cfg, mode="prefill",
                           chunk=chunk, seq_capacity=seq_capacity,
                           compute_dtype=self.compute_dtype)

    def decode(self, params: Dict, batch: Dict, cache: Dict, cur_len):
        return tf.lm_apply(params, batch, self.cfg, mode="decode",
                           cache=cache, cur_len=cur_len,
                           compute_dtype=self.compute_dtype)

    def init_cache(self, batch: int, seq_len: int, device: DeviceLike = None,
                   dtype: torch.dtype = torch.bfloat16):
        return tf.init_cache(self.cfg, batch, seq_len,
                             resolve_device(device), dtype)


def build_model(cfg: ArchConfig,
                compute_dtype: torch.dtype = torch.bfloat16) -> Model:
    tf.check_family(cfg)
    return Model(cfg, compute_dtype)
