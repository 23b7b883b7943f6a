"""Continuous-batching inference server of the port (vLLM-style slots).

The loop of ``repro.serve.server.BatchServer``: a fixed decode batch of
``slots``; waiting requests are prefilled one at a time (batch 1) and
their caches copied in place into free slots of the stacked cache;
every iteration advances all active slots by one token with one batched
decode step (a per-slot ``cur_len`` vector).  All scheduling is the pure
``SlotScheduler``'s, whose decision log stays on ``self.scheduler``.

Stats are plain attributes under the JAX server's names
(``tokens_out``, ``requests``, ``decode_steps``, ``latency``,
``tokens_per_decode_step``), plus the host time of each prefill and
decode step (``prefill_seconds``, ``decode_seconds``; each step ends by
reading its token back, which waits for the device).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import Model
from repro_torch.models.common import map_leaves
from repro_torch.serve.policy import SlotScheduler
from repro_torch.serve.step import build_decode_step, build_prefill_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    # filled by the server:
    output: List[int] = field(default_factory=list)
    submit_time: float = 0.0
    finish_time: float = 0.0


class BatchServer:
    def __init__(self, model: Model, params: Dict, slots: int = 4,
                 seq_capacity: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = model.load(params, self.device)
        self.slots = slots
        self.seq_capacity = seq_capacity
        self._prefill = build_prefill_step(model, seq_capacity=seq_capacity)
        self._decode = build_decode_step(model)
        self.scheduler: Optional[SlotScheduler] = None
        self.tokens_out = 0
        self.requests = 0
        self.decode_steps = 0
        self.latency: List[float] = []
        self.prefill_seconds: List[float] = []
        self.decode_seconds: List[float] = []

    @property
    def tokens_per_decode_step(self) -> float:
        return self.tokens_out / max(self.decode_steps, 1)

    def serve(self, requests: List[Request]) -> List[Request]:
        """Serve ``requests`` to completion; returns them in finish order.

        Requests must carry unique rids and prompts must fit
        ``seq_capacity``; the policy raises ``ValueError`` otherwise.
        """
        B, cap, dev = self.slots, self.seq_capacity, self.device
        cache = self.model.init_cache(B, cap, dev)
        cur_len = np.zeros((B,), np.int64)
        last_tok = np.zeros((B, 1), np.int64)
        by_rid = {r.rid: r for r in requests}
        sched = SlotScheduler(B, cap)
        self.scheduler = sched
        for r in requests:
            r.submit_time = time.perf_counter()
            sched.submit(r.rid, len(r.prompt), r.max_new_tokens)
        done: List[Request] = []

        def insert(slot: int, req: Request) -> None:
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt)[None],
                                     dtype=torch.int64, device=dev)
            logits, rcache = self._prefill(self.params, {"tokens": tokens})
            # every leaf (a hybrid arch's cache is a tuple of per-position
            # dicts) in place, in the leaf's dtype: recurrent states stay f32
            map_leaves(lambda c, r: c[:, slot].copy_(r[:, 0]), cache, rcache)
            tok = int(torch.argmax(logits[0, -1].float()))
            self.prefill_seconds.append(time.perf_counter() - t0)
            req.output.append(tok)
            last_tok[slot, 0] = tok
            cur_len[slot] = len(req.prompt)

        while not sched.idle():
            for slot, rid in sched.fill():
                insert(slot, by_rid[rid])
            t0 = time.perf_counter()
            nxt, _, cache = self._decode(self.params, {
                "tokens": torch.as_tensor(last_tok, device=dev),
                "cache": cache,
                "cur_len": torch.as_tensor(cur_len, device=dev),
            })
            nxt = nxt.cpu().numpy()
            self.decode_seconds.append(time.perf_counter() - t0)
            self.decode_steps += 1
            sched.note_step()
            for slot in sched.active_slots():
                req = by_rid[sched.active[slot]]
                tok = int(nxt[slot, 0])
                req.output.append(tok)
                self.tokens_out += 1
                cur_len[slot] += 1
                last_tok[slot, 0] = tok
                if sched.complete_token(slot, is_eos=tok == req.eos_token):
                    req.finish_time = time.perf_counter()
                    self.requests += 1
                    self.latency.append(req.finish_time - req.submit_time)
                    done.append(req)
        return done
