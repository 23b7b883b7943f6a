"""Whisper-style encoder-decoder of the port [arXiv:2212.04356], the twin
of ``repro.models.encdec``.

The conv/mel frontend is a stub, as in JAX: the encoder's input is the
precomputed frame embeddings ``enc_embeds`` (b, enc_seq, d_model) of a
batch.  The encoder is a bidirectional transformer over them; each
decoder layer adds causal self attention and cross attention whose keys
and values come from the encoder output.  Parameters keep the stacked
layer axes (``enc_layers``, ``dec_layers``), and Python loops over them
take the place of ``lax.scan``, as in ``models/transformer.py``.  Three
modes:

  train   -> logits over all positions; every encoder and decoder layer
             checkpointed (recomputed in the backward pass, as
             ``jax.checkpoint``)
  prefill -> logits at the last position and the cache: per decoder
             layer the self KV ring buffer and the cross attention's k
             and v (b, kvh, enc_seq, hd), written once here
  decode  -> one-token step: the self KV written IN PLACE, the cross
             cache only read

``sharder`` lays the residual stream out by ("batch", "seq") where the
JAX functions do: the encoder's input and each encoder layer's output,
each decoder layer's output and the embedded tokens.

On the card a prefill runs the flash kernel three ways: non-causal over
the frames in the encoder, causal in the decoder's self attention, and
non-causal over ``enc_seq`` keys in its cross attention.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as ll
from repro_torch.models.common import (IDENTITY_SHARDER, Sharder,
                                       TensorSpec, cast, param, stack_inits,
                                       zeros)
from repro_torch.models.transformer import (MODES, _stack_layer, _unstack,
                                            kv_capacity)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_enc_layer(gen: torch.Generator, cfg) -> Dict:
    return {"norm1": ll.init_norm(gen, cfg, cfg.d_model),
            "attn": ll.init_attention(gen, cfg),
            "norm2": ll.init_norm(gen, cfg, cfg.d_model),
            "ffn": ll.init_mlp(gen, cfg)}


def _init_dec_layer(gen: torch.Generator, cfg) -> Dict:
    return {"norm1": ll.init_norm(gen, cfg, cfg.d_model),
            "self_attn": ll.init_attention(gen, cfg),
            "norm_x": ll.init_norm(gen, cfg, cfg.d_model),
            "cross_attn": ll.init_attention(gen, cfg),
            "norm2": ll.init_norm(gen, cfg, cfg.d_model),
            "ffn": ll.init_mlp(gen, cfg)}


def init_encdec(gen: torch.Generator, cfg) -> Dict:
    return {
        "embed": ll.init_embedding(gen, cfg),
        "enc_pos": param(gen, (cfg.enc_seq, cfg.d_model), (None, "embed"),
                         scale=0.02),
        "enc_layers": stack_inits(lambda g: _init_enc_layer(g, cfg), gen,
                                  cfg.enc_layers),
        "enc_norm": ll.init_norm(gen, cfg, cfg.d_model),
        "dec_layers": stack_inits(lambda g: _init_dec_layer(g, cfg), gen,
                                  cfg.n_layers),
        "final_norm": ll.init_norm(gen, cfg, cfg.d_model),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _enc_layer(lp: Dict, x: torch.Tensor, cfg, positions, mode: str,
               chunk: int, sharder: Sharder) -> torch.Tensor:
    """One encoder layer.  Its k and v go to ``attention_train`` as
    ``kv``, as in JAX, so the frames attend each other with no mask."""
    h = ll.apply_norm(lp["norm1"], x, cfg)
    k = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wv"])
    x = x + ll.attention_train(lp["attn"], h, cfg, positions, chunk=chunk,
                               mode=mode, kv=(k, v, positions),
                               sharder=sharder)
    h2 = ll.apply_norm(lp["norm2"], x, cfg)
    x = x + ll.apply_mlp(lp["ffn"], h2, cfg, sharder)
    return sharder.ac(x, ("batch", "seq", None))


def encode(params: Dict, enc_embeds: torch.Tensor, cfg, mode: str = "prefill",
           chunk: int = 2048, sharder: Sharder = IDENTITY_SHARDER,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """enc_embeds (b, enc_seq, d), the stub frontend's output, in the
    params' dtype -> the encoder output (b, enc_seq, d).  ``dtype``
    casts each leaf where it is used, a layer's as the loop reaches
    it."""
    x = sharder.ac(enc_embeds + cast(params["enc_pos"], dtype),
                   ("batch", "seq", None))
    b, s, _ = x.shape
    positions = sharder.ac(torch.arange(s, device=x.device).expand(b, s),
                           ("batch", None))
    for lp in _unstack(params["enc_layers"], cfg.enc_layers):
        lp = cast(lp, dtype)
        if mode == "train":
            x = checkpoint(_enc_layer, lp, x, cfg, positions, mode, chunk,
                           sharder, use_reentrant=False)
        else:
            x = _enc_layer(lp, x, cfg, positions, mode, chunk, sharder)
        del lp
    return ll.apply_norm(cast(params["enc_norm"], dtype), x, cfg)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_kv(lp: Dict, enc_out: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's k and v (b, enc_seq, kvh, hd)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross_attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, lp["cross_attn"]["wv"])
    return k, v


def _decode_cross(lp: Dict, h: torch.Tensor, cfg, cross_cache: Dict
                  ) -> torch.Tensor:
    """Cross attention of one token over the cached k and v (b, kvh,
    enc_seq, hd), all of them (no mask, as in JAX: an empty slot reads
    zeros).  JAX divides the scores by an f32 array, which promotes
    them: the scores are cast to f32 before the divide here too."""
    b, hd = h.shape[0], cfg.head_dim
    kvh = cfg.n_kv_heads
    g = cfg.n_heads // kvh
    ck = cross_cache["k"].to(h.dtype)
    cv = cross_cache["v"].to(h.dtype)
    q = torch.einsum("bsd,dhk->bshk", h, lp["cross_attn"]["wq"])
    qg = q.reshape(b, kvh, g, hd)
    sc = torch.einsum("bkgd,bksd->bkgs", qg, ck).float() / math.sqrt(hd)
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", probs.to(h.dtype), cv)
    out = out.reshape(b, 1, cfg.n_heads, hd)
    return torch.einsum("bshk,hkd->bsd", out, lp["cross_attn"]["wo"])


def _dec_layer(lp: Dict, x: torch.Tensor, enc_out, cfg, positions,
               mode: str, lc, cur_len, chunk: int, seq_capacity: int,
               sharder: Sharder):
    """One decoder layer -> (x, its cache entry: None in train mode)."""
    h = ll.apply_norm(lp["norm1"], x, cfg)
    new_self = None
    if mode == "decode":
        a, new_self = ll.attention_decode(lp["self_attn"], h, cfg,
                                          lc["self"], cur_len, sharder)
    elif mode == "prefill":
        a, (kr, vr) = ll.attention_train(lp["self_attn"], h, cfg, positions,
                                         chunk=chunk, return_kv=True,
                                         sharder=sharder)
        new_self = ll.kv_to_cache(kr, vr, kv_capacity(cfg, seq_capacity),
                                  sharder)
    else:
        a = ll.attention_train(lp["self_attn"], h, cfg, positions,
                               chunk=chunk, mode="train", sharder=sharder)
    x = x + a
    hx = ll.apply_norm(lp["norm_x"], x, cfg)
    new_cross = None
    if mode == "decode":
        c = _decode_cross(lp, hx, cfg, lc["cross"])
        new_cross = lc["cross"]
    else:
        ck, cv = _cross_kv(lp, enc_out, cfg)
        enc_pos = torch.arange(enc_out.shape[1], device=x.device).expand(
            enc_out.shape[:2])
        c = ll.attention_train(lp["cross_attn"], hx, cfg, positions,
                               chunk=chunk, mode=mode, kv=(ck, cv, enc_pos),
                               sharder=sharder)
        if mode == "prefill":
            new_cross = {"k": ck.transpose(1, 2).contiguous(),
                         "v": cv.transpose(1, 2).contiguous()}
    x = x + c
    h2 = ll.apply_norm(lp["norm2"], x, cfg)
    x = sharder.ac(x + ll.apply_mlp(lp["ffn"], h2, cfg, sharder),
                   ("batch", "seq", None))
    if mode == "train":
        return x, None
    return x, {"self": new_self, "cross": new_cross}


def dec_forward(params: Dict, x: torch.Tensor, enc_out, cfg, positions,
                mode: str, cache: Any = None, cur_len=None, chunk: int = 2048,
                seq_capacity: int = 0, sharder: Sharder = IDENTITY_SHARDER,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, Any]:
    """The decoder stack -> (x, cache).  The cache is ``{"self": {k, v},
    "cross": {k, v}}``, each leaf stacked over the layers: None in train
    mode, new in prefill (each layer's entry written into it as the
    layer returns it, ``_stack_layer``), ``cache`` itself (written in
    place) in decode."""
    seq_capacity = seq_capacity or x.shape[1]
    n = cfg.n_layers
    layers = _unstack(params["dec_layers"], n)
    stacked = None
    for i, lp in enumerate(layers):
        lp = cast(lp, dtype)
        lc = sharder.decode_layer(cache, i) if mode == "decode" else None
        if mode == "train":
            x, _ = checkpoint(_dec_layer, lp, x, enc_out, cfg, positions,
                              mode, None, None, chunk, seq_capacity, sharder,
                              use_reentrant=False)
        else:
            x, nc = _dec_layer(lp, x, enc_out, cfg, positions, mode, lc,
                               cur_len, chunk, seq_capacity, sharder)
            if mode == "prefill":
                stacked = _stack_layer(stacked, i, n, nc)
            del nc
        del lc, lp
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, cache
    return x, stacked


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def encdec_apply(params: Dict, batch: Dict, cfg, mode: str = "prefill",
                 cache: Any = None, cur_len=None, chunk: int = 2048,
                 seq_capacity: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 sharder: Sharder = IDENTITY_SHARDER
                 ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (logits, cache, aux = 0), as ``lm_apply``.  A train or
    prefill batch holds ``tokens`` and ``enc_embeds``; a decode batch the
    tokens alone, each taking the learned position ``cur_len`` (an int
    or a (b,) tensor, per slot).  Leaves are cast to ``compute_dtype`` on
    every call, as ``lm_apply`` does: all first in train mode, where
    each is used in prefill and decode."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; one of {MODES}")
    if mode == "train":
        params = cast(params, compute_dtype)
    tokens = batch["tokens"]
    b, dev = tokens.shape[0], tokens.device
    enc_out = positions = None
    if mode == "decode":
        embed_pos = torch.as_tensor(cur_len, dtype=torch.int64,
                                    device=dev).reshape(-1, 1).expand(b, 1)
    else:
        enc_out = encode(params, batch["enc_embeds"].to(compute_dtype), cfg,
                         mode, chunk, sharder, compute_dtype)
        s = tokens.shape[1]
        positions = embed_pos = sharder.ac(
            torch.arange(s, device=dev).expand(b, s), ("batch", None))
    x = ll.embed_tokens(params["embed"], tokens, cfg, positions=embed_pos,
                        dtype=compute_dtype)
    x = sharder.ac(x, ("batch", "seq", None))
    x, new_cache = dec_forward(params, x, enc_out, cfg, positions, mode,
                               cache=cache, cur_len=cur_len, chunk=chunk,
                               seq_capacity=seq_capacity, sharder=sharder,
                               dtype=compute_dtype)
    if mode != "train":
        x = x[:, -1:]
    x = ll.apply_norm(cast(params["final_norm"], compute_dtype), x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return (ll.unembed(params["embed"], x, cfg, sharder, compute_dtype),
            new_cache, aux)


def encdec_cache_spec(cfg, batch: int, seq_len: int,
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The decode cache's shapes: self k and v (n_layers, b, kvh, S, hd),
    cross k and v (n_layers, b, kvh, enc_seq, hd)."""
    self_shp = (cfg.n_layers, batch, cfg.n_kv_heads,
                kv_capacity(cfg, seq_len), cfg.head_dim)
    cross_shp = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_seq,
                 cfg.head_dim)
    return {"self": {"k": TensorSpec(self_shp, dtype),
                     "v": TensorSpec(self_shp, dtype)},
            "cross": {"k": TensorSpec(cross_shp, dtype),
                      "v": TensorSpec(cross_shp, dtype)}}


def init_cache(cfg, batch: int, seq_len: int, device: torch.device,
               dtype: torch.dtype = torch.bfloat16) -> Dict:
    return zeros(encdec_cache_spec(cfg, batch, seq_len, dtype), device)
