"""Decoder LM assembly of the port: the dense, MoE and RWKV (``ssm``)
families.

Mirrors ``repro.models.transformer``: parameters keep the stacked
leading layer axis, and a Python loop over layers takes the place of
``lax.scan``.  MoE layers return the load-balance aux loss, which
``decoder_forward`` sums over layers as the JAX function does.  RWKV
layers (time mix and channel mix, ``models/rwkv.py``) carry a recurrent
state instead of a KV cache.  Three modes:

  train   -> logits over all positions, each layer checkpointed
             (recomputed in the backward pass, as ``jax.checkpoint``)
  prefill -> logits at the last position + a stacked cache (KV, or the
             RWKV states)
  decode  -> one-token step that updates the stacked cache IN PLACE

Other families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ROADMAP
from repro_torch.models import layers as ll
from repro_torch.models import moe as me
from repro_torch.models import rwkv as rw
from repro_torch.models.common import cast, stack_inits

FAMILIES = ("dense", "moe", "ssm")
MODES = ("train", "prefill", "decode")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{ROADMAP.get(cfg.family, 'ROADMAP.md Queue 1')}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg) -> Dict:
    """One decoder layer (norms + attention + MLP or MoE, or norms + RWKV
    time mix and channel mix).  The stacked layers share one structure,
    so the JAX package builds and applies every one as layer 0
    (``is_moe_layer(0)``); so does the port."""
    if cfg.family == "ssm":
        blk = rw.init_rwkv_block(gen, cfg)
        return {"norm1": ll.init_norm(gen, cfg, cfg.d_model),
                "mixer": blk["time_mix"],
                "norm2": ll.init_norm(gen, cfg, cfg.d_model),
                "ffn": blk["channel_mix"]}
    norm1 = ll.init_norm(gen, cfg, cfg.d_model)
    mixer = ll.init_attention(gen, cfg)
    norm2 = ll.init_norm(gen, cfg, cfg.d_model)
    ffn = (me.init_moe(gen, cfg) if cfg.is_moe_layer(0)
           else ll.init_mlp(gen, cfg))
    return {"norm1": norm1, "mixer": mixer, "norm2": norm2, "ffn": ffn}


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
    """Shapes and dtypes of the stacked decode cache: k and v
    (n_layers, b, kvh, S, hd) in ``dtype``; for RWKV the token-shift
    states (n_layers, b, 1, d) in ``dtype`` and the WKV state
    (n_layers, b, h, n, n) in f32, as in JAX."""
    check_family(cfg)
    L = cfg.n_layers
    if cfg.family == "ssm":
        h, n = cfg.n_rwkv_heads, cfg.rwkv_head_size
        shift = TensorSpec((L, batch, 1, cfg.d_model), dtype)
        return {"shift_tm": shift, "shift_cm": shift,
                "wkv": TensorSpec((L, batch, h, n, n), torch.float32)}
    shp = (L, batch, cfg.n_kv_heads, kv_capacity(cfg, seq_len), cfg.head_dim)
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
                seq_capacity: int
                ) -> Tuple[torch.Tensor, Optional[Dict],
                           Optional[torch.Tensor]]:
    """Returns (x, new_cache_entry, aux_loss); the cache entry is None in
    train mode, and aux is None for a dense FFN or an RWKV layer, which
    add nothing (and launch nothing) to the sum."""
    if cfg.family == "ssm":
        return _apply_rwkv_layer(p, x, cfg, mode, cache)
    rs = cfg.residual_scale
    h = ll.apply_norm(p["norm1"], x, cfg)
    new_cache = None
    if mode == "decode":
        mix, new_cache = ll.attention_decode(p["mixer"], h, cfg, cache,
                                             cur_len)
    elif mode == "prefill":
        mix, (k_raw, v_raw) = ll.attention_train(
            p["mixer"], h, cfg, positions, chunk=chunk, return_kv=True)
        new_cache = ll.kv_to_cache(k_raw, v_raw,
                                   kv_capacity(cfg, seq_capacity))
    else:
        mix = ll.attention_train(p["mixer"], h, cfg, positions, chunk=chunk,
                                 mode="train")
    x = x + rs * mix
    h2 = ll.apply_norm(p["norm2"], x, cfg)
    aux = None
    if cfg.is_moe_layer(0):
        f, aux = me.apply_moe(p["ffn"], h2, cfg, mode=mode)
    else:
        f = ll.apply_mlp(p["ffn"], h2, cfg)
    x = x + rs * f
    return x, new_cache, aux


def _apply_rwkv_layer(p: Dict, x: torch.Tensor, cfg, mode: str,
                      cache: Optional[Dict]
                      ) -> Tuple[torch.Tensor, Optional[Dict], None]:
    """An RWKV layer.  Prefill returns the new states; decode writes them
    into ``cache`` (this layer's views of the stacked cache) in place,
    each cast to the cache leaf's dtype as JAX's update does.  The time
    mix runs at its own chunk (32), not the decoder's, as in JAX."""
    rs = cfg.residual_scale
    st = cache or {}
    h = ll.apply_norm(p["norm1"], x, cfg)
    mix, shift_tm, wkv = rw.apply_time_mix(
        p["mixer"], h, cfg, shift_state=st.get("shift_tm"),
        wkv_state=st.get("wkv"), mode=mode)
    x = x + rs * mix
    h2 = ll.apply_norm(p["norm2"], x, cfg)
    f, shift_cm = rw.apply_channel_mix(p["ffn"], h2, cfg,
                                       shift_state=st.get("shift_cm"))
    x = x + rs * f
    if mode == "train":
        return x, None, None
    new = {"shift_tm": shift_tm, "shift_cm": shift_cm, "wkv": wkv}
    if mode == "decode":
        for n, c in cache.items():
            c.copy_(new[n])
        return x, cache, None
    return x, new, None


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """The per-layer trees of a stacked tree, as views (a decode step
    writes its cache entries through them).  Each leaf is split by one
    ``unbind``, whose backward stacks the layers' gradients in one op
    (indexing layer by layer would add a full-size zero gradient per
    layer and leaf)."""
    split = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def decoder_forward(layers_params: Dict, x: torch.Tensor, cfg, positions,
                    mode: str, cache: Optional[Dict] = None, cur_len=None,
                    chunk: int = 2048, seq_capacity: int = 0
                    ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Run the decoder stack -> (x, cache, aux_loss summed over layers).
    Train returns no cache; prefill returns a new stacked cache in the
    compute dtype (RWKV's WKV state in f32); decode writes into ``cache``
    in place and returns it."""
    seq_capacity = seq_capacity or x.shape[1]
    new = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = _unstack(layers_params, cfg.n_layers)
    caches = (_unstack(cache, cfg.n_layers) if mode == "decode"
              else [None] * cfg.n_layers)
    for lp, lc in zip(per_layer, caches):
        if mode == "train":
            x, nc, a = checkpoint(apply_layer, lp, x, cfg, positions, mode,
                                  None, None, chunk, seq_capacity,
                                  use_reentrant=False)
        else:
            x, nc, a = apply_layer(lp, x, cfg, positions, mode, lc, cur_len,
                                   chunk, seq_capacity)
        if a is not None:
            aux = aux + a
        new.append(nc)
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        return x, cache, aux
    return x, {n: torch.stack([c[n] for c in new]) for n in new[0]}, aux


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def lm_apply(params: Dict, batch: Dict, cfg, mode: str = "prefill",
             cache: Optional[Dict] = None, cur_len=None, chunk: int = 2048,
             seq_capacity: int = 0,
             compute_dtype: torch.dtype = torch.bfloat16
             ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Unified LM entry.  Returns (logits, new_cache, aux_loss):

      train  : logits (b, s, Vp), no cache
      prefill: logits (b, 1, Vp) at the last position, + cache
      decode : logits (b, 1, Vp), + the cache updated in place

    Leaves not in ``compute_dtype`` are cast here, on every call, as the
    JAX function does: train mode takes the f32 master params (with
    ``requires_grad``), so the cast is part of the graph and the
    gradients reach them in f32.  Serving casts once beforehand
    (``Model.load``, ``BatchServer``), which makes the cast here free.
    """
    check_family(cfg)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; one of {MODES}")
    params = cast(params, compute_dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = ll.embed_tokens(params["embed"], tokens, cfg)
    positions = None
    if mode != "decode":
        positions = make_positions(cfg, b, s, tokens.device)
    x, new_cache, aux = decoder_forward(
        params["layers"], x, cfg, positions, mode=mode, cache=cache,
        cur_len=cur_len, chunk=chunk, seq_capacity=seq_capacity)
    if mode != "train":
        x = x[:, -1:]
    x = ll.apply_norm(params["final_norm"], x, cfg)
    return ll.unembed(params["embed"], x, cfg), new_cache, aux
