"""Serving steps: prefill (prompt -> cache) and greedy decode (one token
against the cache, updated in place)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.api import Model


def build_prefill_step(model: Model, chunk: int = 2048,
                       seq_capacity: int = 0) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, chunk=chunk,
                             seq_capacity=seq_capacity)
    return prefill_step


def build_decode_step(model: Model) -> Callable:
    """decode_step(params, batch) with batch = {tokens, cache, cur_len}.

    Returns (next_tokens (b, 1), logits, cache): greedy argmax over the
    padded vocab; the cache is updated in place.
    """
    def decode_step(params, batch):
        logits, cache = model.decode(params, {"tokens": batch["tokens"]},
                                     batch["cache"], batch["cur_len"])
        nxt = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
        return nxt, logits, cache
    return decode_step
