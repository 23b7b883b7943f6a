"""Serving steps: prefill (prompt -> cache) and greedy decode (one token
against the cache, updated in place).  Each takes the ``sharder`` the
model runs with, as ``repro.serve.step``: the identity for plain
tensors, a ``MeshSharder`` for params and caches on a device mesh."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.api import Model
from repro_torch.models.common import IDENTITY_SHARDER, Sharder


def build_prefill_step(model: Model, sharder: Sharder = IDENTITY_SHARDER,
                       chunk: int = 2048, seq_capacity: int = 0) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, chunk=chunk,
                             seq_capacity=seq_capacity, sharder=sharder)
    return prefill_step


def build_decode_step(model: Model, sharder: Sharder = IDENTITY_SHARDER
                      ) -> Callable:
    """decode_step(params, batch) with batch = {tokens, cache, cur_len}.

    Returns (next_tokens (b, 1), logits, cache): greedy argmax over the
    padded vocab; the cache is updated in place.
    """
    def decode_step(params, batch):
        logits, cache = model.decode(params, {"tokens": batch["tokens"]},
                                     batch["cache"], batch["cur_len"],
                                     sharder=sharder)
        # the vocab whole on each rank first: DTensor's argmax over a
        # split vocab (torch 2.13) fails for a batch of one
        last = sharder.ac(logits[:, -1].float(), ("batch", None))
        nxt = torch.argmax(last, dim=-1)[:, None]
        return nxt, logits, cache
    return decode_step
