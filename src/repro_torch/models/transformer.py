"""Decoder LM assembly of the port, dense family.

Mirrors ``repro.models.transformer``: parameters keep the stacked
leading layer axis, and a Python loop over layers takes the place of
``lax.scan``.  Two modes:

  prefill -> logits at the last position + a stacked KV cache
  decode  -> one-token step that updates the stacked cache IN PLACE

Other families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ROADMAP
from repro_torch.models import layers as ll
from repro_torch.models.common import cast, stack_inits


def check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{ROADMAP.get(cfg.family, 'ROADMAP.md Queue 1')}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg) -> Dict:
    """One decoder layer (norms + attention + MLP)."""
    return {
        "norm1": ll.init_norm(gen, cfg, cfg.d_model),
        "mixer": ll.init_attention(gen, cfg),
        "norm2": ll.init_norm(gen, cfg, cfg.d_model),
        "ffn": ll.init_mlp(gen, cfg),
    }


def init_lm(gen: torch.Generator, cfg) -> Dict:
    check_family(cfg)
    return {
        "embed": ll.init_embedding(gen, cfg),
        "layers": stack_inits(lambda g: init_layer(g, cfg), gen,
                              cfg.n_layers),
        "final_norm": ll.init_norm(gen, cfg, cfg.d_model),
    }


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def kv_capacity(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def cache_spec(cfg, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, TensorSpec]:
    """Shapes of the stacked decode cache (n_layers, b, kvh, S, hd)."""
    check_family(cfg)
    shp = (cfg.n_layers, batch, cfg.n_kv_heads, kv_capacity(cfg, seq_len),
           cfg.head_dim)
    return {"k": TensorSpec(shp, dtype), "v": TensorSpec(shp, dtype)}


def init_cache(cfg, batch: int, seq_len: int, device: torch.device,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for n, s in cache_spec(cfg, batch, seq_len, dtype).items()}


def make_positions(cfg, b: int, s: int, device: torch.device) -> torch.Tensor:
    """Sequential positions (b, s)."""
    if cfg.pos_scheme == "mrope":
        raise NotImplementedError(f"M-RoPE positions: {ROADMAP['vlm']}")
    return torch.arange(s, device=device).expand(b, s)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def apply_layer(p: Dict, x: torch.Tensor, cfg, positions, mode: str,
                cache: Optional[Dict], cur_len, chunk: int,
                seq_capacity: int) -> Tuple[torch.Tensor, Dict]:
    """Returns (x, new_cache_entry)."""
    rs = cfg.residual_scale
    h = ll.apply_norm(p["norm1"], x, cfg)
    if mode == "decode":
        mix, new_cache = ll.attention_decode(p["mixer"], h, cfg, cache,
                                             cur_len)
    else:
        mix, (k_raw, v_raw) = ll.attention_train(
            p["mixer"], h, cfg, positions, chunk=chunk, return_kv=True)
        new_cache = ll.kv_to_cache(k_raw, v_raw,
                                   kv_capacity(cfg, seq_capacity))
    x = x + rs * mix
    h2 = ll.apply_norm(p["norm2"], x, cfg)
    x = x + rs * ll.apply_mlp(p["ffn"], h2, cfg)
    return x, new_cache


def _layer(tree: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def decoder_forward(layers_params: Dict, x: torch.Tensor, cfg, positions,
                    mode: str, cache: Optional[Dict] = None, cur_len=None,
                    chunk: int = 2048, seq_capacity: int = 0
                    ) -> Tuple[torch.Tensor, Dict]:
    """Run the decoder stack.  Prefill returns a new stacked cache in the
    compute dtype; decode writes into ``cache`` in place and returns it."""
    seq_capacity = seq_capacity or x.shape[1]
    new = []
    for i in range(cfg.n_layers):
        lc = _layer(cache, i) if mode == "decode" else None
        x, nc = apply_layer(_layer(layers_params, i), x, cfg, positions,
                            mode, lc, cur_len, chunk, seq_capacity)
        new.append(nc)
    if mode == "decode":
        return x, cache
    return x, {n: torch.stack([c[n] for c in new]) for n in ("k", "v")}


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def lm_apply(params: Dict, batch: Dict, cfg, mode: str = "prefill",
             cache: Optional[Dict] = None, cur_len=None, chunk: int = 2048,
             seq_capacity: int = 0,
             compute_dtype: torch.dtype = torch.bfloat16
             ) -> Tuple[torch.Tensor, Dict]:
    """Unified LM entry.  Returns (logits (b, 1, Vp), cache).

    ``params`` should already be in ``compute_dtype`` (``Model.load`` and
    ``BatchServer`` cast once); leaves in another dtype are cast here,
    which the JAX function does on every call.
    """
    check_family(cfg)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r}: {ROADMAP['train']}")
    params = cast(params, compute_dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = ll.embed_tokens(params["embed"], tokens, cfg)
    positions = None
    if mode == "prefill":
        positions = make_positions(cfg, b, s, tokens.device)
    x, new_cache = decoder_forward(
        params["layers"], x, cfg, positions, mode=mode, cache=cache,
        cur_len=cur_len, chunk=chunk, seq_capacity=seq_capacity)
    x = ll.apply_norm(params["final_norm"], x[:, -1:], cfg)
    return ll.unembed(params["embed"], x, cfg), new_cache
