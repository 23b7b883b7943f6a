"""Deterministic synthetic data pipeline: a copy of
``repro.data.pipeline`` (numpy only), so that the port imports nothing of
the JAX package.  Batches are numpy arrays, identical to the JAX
package's for the same (seed, step).

Produces batches matching ``Model.input_specs`` exactly.  Determinism
contract (needed for fault-tolerant restart): batch(step) is a pure
function of (seed, step) — after a checkpoint restore at step k, the
pipeline regenerates the identical stream from k without any state.

The token stream is a order-2 Markov chain over the vocab (not iid
uniform) so that the cross-entropy actually *decreases* during the
example training runs — a learnable signal on CPU-scale models.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


class SyntheticPipeline:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                 learnable: bool = True):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.learnable = learnable
        # fixed random structure for the Markov stream
        rng = np.random.default_rng(seed)
        v = cfg.vocab_size
        self._period = rng.integers(2, 8)
        self._offsets = rng.integers(0, v, size=16)

    # -- token generation ------------------------------------------------
    def _tokens(self, rng, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab_size
        if not self.learnable:
            return rng.integers(0, v, size=(b, s), dtype=np.int64)
        # deterministic structure + noise: next = prev + offset[t%16] mod v
        start = rng.integers(0, v, size=(b, 1))
        steps = self._offsets[np.arange(s) % 16][None, :]
        toks = (start + np.cumsum(np.broadcast_to(steps, (b, s)), axis=1)) % v
        noise = rng.random((b, s)) < 0.05
        toks = np.where(noise, rng.integers(0, v, size=(b, s)), toks)
        return toks.astype(np.int64)

    # -- public ------------------------------------------------------------
    def batch(self, step: int, kind: Optional[str] = None) -> Dict[str, Any]:
        cfg, shape = self.cfg, self.shape
        kind = kind or shape.kind
        rng = np.random.default_rng((self.seed, step))
        B, S = shape.global_batch, shape.seq_len
        n_vis = cfg.n_vis if cfg.family == "vlm" else 0
        s_text = S - n_vis

        out: Dict[str, Any] = {}
        toks = self._tokens(rng, B, s_text + 1)     # +1 for next-token labels
        if kind == "train":
            out["tokens"] = toks[:, :-1].astype(np.int32)
            text_labels = toks[:, 1:]
            labels = np.zeros((B, S), np.int32)
            labels[:, n_vis:] = text_labels
            mask = np.zeros((B, S), np.float32)
            mask[:, n_vis:] = 1.0
            out["labels"] = labels
            out["mask"] = mask
        elif kind == "prefill":
            out["tokens"] = toks[:, :-1].astype(np.int32)
        else:  # decode
            out["tokens"] = toks[:, :1].astype(np.int32)
            out["cur_len"] = np.asarray(min(S - 1, s_text), np.int32)

        if cfg.family == "vlm" and kind != "decode":
            out["vision_embeds"] = rng.standard_normal(
                (B, cfg.n_vis, cfg.d_model)).astype(np.float32) * 0.1
        if cfg.family == "audio" and kind != "decode":
            out["enc_embeds"] = rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1
        return out
