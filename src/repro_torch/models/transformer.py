"""Decoder LM assembly of the port: the dense, MoE, RWKV (``ssm``),
hybrid (Jamba: Mamba + attention + MoE) and VLM (Qwen2-VL backbone)
families.

Mirrors ``repro.models.transformer``: parameters keep the stacked
leading layer axis, and a Python loop over layers takes the place of
``lax.scan``.  MoE layers return the load-balance aux loss, which
``decoder_forward`` sums over layers as the JAX function does.  RWKV
layers (time mix and channel mix, ``models/rwkv.py``) carry a recurrent
state instead of a KV cache.  A hybrid arch repeats a period of
``attn_every`` layers (Jamba: 8; attention at position ``attn_offset``,
Mamba elsewhere, ``models/mamba.py``; MoE where ``is_moe_layer``): its
parameters and caches are a tuple of one stacked tree per position,
each stacked over the periods, and the loop runs period by period,
position by position.  A VLM batch carries ``vision_embeds`` (b, n_vis,
d), the stub frontend's patch embeddings, which go in front of the
embedded text tokens; the merged sequence takes 3-D M-RoPE positions.
Three modes:

  train   -> logits over all positions, each layer checkpointed
             (recomputed in the backward pass, as ``jax.checkpoint``)
  prefill -> logits at the last position + a stacked cache (KV, the
             RWKV states, or per position KV or the Mamba conv and ssm
             states)
  decode  -> one-token step that updates the stacked cache IN PLACE,
             through per-layer views of the stacked leaves

``sharder`` lays the residual stream out by ("batch", "seq") where the
JAX functions do: after each mixer and each FFN, and after the embedding.

The audio family (whisper's encoder-decoder) is ``models/encdec.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as ll
from repro_torch.models import mamba as mm
from repro_torch.models import moe as me
from repro_torch.models import rwkv as rw
from repro_torch.models.common import (IDENTITY_SHARDER, Sharder,
                                       TensorSpec, cast, contiguous_strides,
                                       stack_inits, zeros)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
MODES = ("train", "prefill", "decode")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder LM "
                         f"family; one of {FAMILIES}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def layer_kind(cfg, layer_idx: int) -> str:
    """"rwkv", "mamba" or "attn": the mixer of layer ``layer_idx`` (of a
    hybrid arch, its position in the period)."""
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "hybrid" and not cfg.is_attn_layer(layer_idx):
        return "mamba"
    return "attn"


def period(cfg) -> int:
    """Layers per period: ``attn_every`` for a hybrid arch, else 1."""
    return cfg.attn_every if cfg.family == "hybrid" else 1


def init_layer(gen: torch.Generator, cfg, layer_idx: int = 0) -> Dict:
    """One decoder layer (norms + attention or Mamba + MLP or MoE, or
    norms + RWKV time mix and channel mix).  The stacked layers of a
    period-1 arch share one structure, so the JAX package builds and
    applies every one as layer 0 (``is_moe_layer(0)``); so does the port.
    A hybrid arch builds each position of its period as its own layer."""
    kind = layer_kind(cfg, layer_idx)
    if kind == "rwkv":
        blk = rw.init_rwkv_block(gen, cfg)
        return {"norm1": ll.init_norm(gen, cfg, cfg.d_model),
                "mixer": blk["time_mix"],
                "norm2": ll.init_norm(gen, cfg, cfg.d_model),
                "ffn": blk["channel_mix"]}
    norm1 = ll.init_norm(gen, cfg, cfg.d_model)
    mixer = (ll.init_attention(gen, cfg) if kind == "attn"
             else mm.init_mamba_block(gen, cfg))
    norm2 = ll.init_norm(gen, cfg, cfg.d_model)
    ffn = (me.init_moe(gen, cfg) if cfg.is_moe_layer(layer_idx)
           else ll.init_mlp(gen, cfg))
    return {"norm1": norm1, "mixer": mixer, "norm2": norm2, "ffn": ffn}


def init_decoder_layers(gen: torch.Generator, cfg):
    """Stacked layer params: one stacked tree, or for a hybrid arch a
    tuple of per-position trees each stacked over the periods."""
    if cfg.family == "hybrid":
        n_periods = cfg.n_layers // period(cfg)
        assert n_periods * period(cfg) == cfg.n_layers
        return tuple(
            stack_inits(lambda g, _pos=pos: init_layer(g, cfg, _pos), gen,
                        n_periods)
            for pos in range(period(cfg)))
    return stack_inits(lambda g: init_layer(g, cfg), gen, cfg.n_layers)


def init_lm(gen: torch.Generator, cfg) -> Dict:
    check_family(cfg)
    return {
        "embed": ll.init_embedding(gen, cfg),
        "layers": init_decoder_layers(gen, cfg),
        "final_norm": ll.init_norm(gen, cfg, cfg.d_model),
    }


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def kv_capacity(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def layer_cache_spec(cfg, layer_idx: int, n: int, batch: int, seq_len: int,
                     dtype: torch.dtype) -> Dict[str, TensorSpec]:
    """The cache of ``n`` stacked layers like layer ``layer_idx``: k and
    v (n, b, kvh, S, hd) in ``dtype``; for RWKV the token-shift states
    (n, b, 1, d) in ``dtype`` and the WKV state (n, b, h, hs, hs) in
    f32; for Mamba the conv state (n, b, d_conv - 1, d_inner) in
    ``dtype`` and the ssm state (n, b, d_inner, d_state) in f32, as in
    JAX."""
    kind = layer_kind(cfg, layer_idx)
    if kind == "rwkv":
        h, hs = cfg.n_rwkv_heads, cfg.rwkv_head_size
        shift = TensorSpec((n, batch, 1, cfg.d_model), dtype)
        return {"shift_tm": shift, "shift_cm": shift,
                "wkv": TensorSpec((n, batch, h, hs, hs), torch.float32)}
    if kind == "mamba":
        return {"conv": TensorSpec((n, batch, cfg.d_conv - 1, cfg.d_inner),
                                   dtype),
                "ssm": TensorSpec((n, batch, cfg.d_inner, cfg.d_state),
                                  torch.float32)}
    shp = (n, batch, cfg.n_kv_heads, kv_capacity(cfg, seq_len), cfg.head_dim)
    return {"k": TensorSpec(shp, dtype), "v": TensorSpec(shp, dtype)}


def cache_spec(cfg, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16):
    """Shapes and dtypes of the stacked decode cache: one stacked dict
    over the layers (``layer_cache_spec``), or for a hybrid arch a tuple
    of one per position of the period, each stacked over the periods."""
    check_family(cfg)
    if cfg.family == "hybrid":
        n_periods = cfg.n_layers // period(cfg)
        return tuple(layer_cache_spec(cfg, pos, n_periods, batch, seq_len,
                                      dtype) for pos in range(period(cfg)))
    return layer_cache_spec(cfg, 0, cfg.n_layers, batch, seq_len, dtype)


def init_cache(cfg, batch: int, seq_len: int, device: torch.device,
               dtype: torch.dtype = torch.bfloat16):
    return zeros(cache_spec(cfg, batch, seq_len, dtype), device)


def make_positions(cfg, b: int, s: int, device: torch.device,
                   n_vis: int = 0, offset: int = 0) -> torch.Tensor:
    """Sequential positions (b, s); for M-RoPE, 3-D positions (b, s, 3):
    vision token i at (0, i // grid, i % grid) over a square patch grid
    of side ``max(1, int(sqrt(n_vis)))``, each text token at its sequence
    index in all three coordinates (so a decode step at ``cur_len``
    needs no ``n_vis``); ``offset`` is added to every coordinate."""
    if cfg.pos_scheme != "mrope":
        return torch.arange(offset, offset + s, device=device).expand(b, s)
    grid = max(1, int(math.sqrt(max(n_vis, 1))))
    vis = torch.arange(n_vis, device=device)
    txt = torch.arange(n_vis, s, device=device)
    p3 = torch.stack([torch.cat([c, txt]) for c in (
        torch.zeros_like(vis), vis // grid, vis % grid)], dim=-1) + offset
    return p3.expand(b, s, 3)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def apply_layer(p: Dict, x: torch.Tensor, cfg, layer_idx: int, positions,
                mode: str, cache: Optional[Dict], cur_len, chunk: int,
                seq_capacity: int, n_vis: int = 0,
                sharder: Sharder = IDENTITY_SHARDER
                ) -> Tuple[torch.Tensor, Optional[Dict],
                           Optional[torch.Tensor]]:
    """Returns (x, new_cache_entry, aux_loss); the cache entry is None in
    train mode, and aux is None for a dense FFN or an RWKV layer, which
    add nothing (and launch nothing) to the sum.  ``layer_idx`` is the
    layer's position in its period (0 for a period-1 arch); ``n_vis``
    the vision tokens in front of the sequence (``attention_train``)."""
    kind = layer_kind(cfg, layer_idx)
    if kind == "rwkv":
        return _apply_rwkv_layer(p, x, cfg, mode, cache, sharder)
    rs = cfg.residual_scale
    h = ll.apply_norm(p["norm1"], x, cfg)
    new_cache = None
    if kind == "mamba":
        st = cache or {}
        mix, conv, ssm = mm.apply_mamba(
            p["mixer"], h, cfg, conv_state=st.get("conv"),
            ssm_state=st.get("ssm"), remat=(mode == "train"),
            sharder=sharder)
        if mode != "train":
            new_cache = _update(cache, {"conv": conv, "ssm": ssm}, mode,
                                sharder)
    elif mode == "decode":
        mix, new_cache = ll.attention_decode(p["mixer"], h, cfg, cache,
                                             cur_len, sharder)
    elif mode == "prefill":
        mix, (k_raw, v_raw) = ll.attention_train(
            p["mixer"], h, cfg, positions, chunk=chunk, return_kv=True,
            n_vis=n_vis, sharder=sharder)
        new_cache = ll.kv_to_cache(k_raw, v_raw,
                                   kv_capacity(cfg, seq_capacity), sharder)
        del k_raw, v_raw
    else:
        mix = ll.attention_train(p["mixer"], h, cfg, positions, chunk=chunk,
                                 mode="train", n_vis=n_vis, sharder=sharder)
    x = sharder.ac(x + rs * mix, ("batch", "seq", None))
    # the mixer's input and output (and its k and v) are not kept
    # through the FFN
    del h, mix
    h2 = ll.apply_norm(p["norm2"], x, cfg)
    aux = None
    if cfg.is_moe_layer(layer_idx):
        f, aux = me.apply_moe(p["ffn"], h2, cfg, mode=mode, sharder=sharder)
    else:
        f = ll.apply_mlp(p["ffn"], h2, cfg, sharder)
    x = sharder.ac(x + rs * f, ("batch", "seq", None))
    return x, new_cache, aux


def _update(cache: Optional[Dict], new: Dict, mode: str,
            sharder: Sharder = IDENTITY_SHARDER) -> Dict:
    """A recurrent layer's new states: returned as they are in prefill;
    in decode written into ``cache`` (this layer's tree of the stacked
    cache, ``Sharder.decode_layer``) in place by ``sharder.write_state_``,
    each cast to the cache leaf's dtype as JAX's update does, and
    ``cache`` returned."""
    if mode != "decode":
        return new
    for n, c in cache.items():
        sharder.write_state_(c, new[n])
    return cache


def _apply_rwkv_layer(p: Dict, x: torch.Tensor, cfg, mode: str,
                      cache: Optional[Dict], sharder: Sharder
                      ) -> Tuple[torch.Tensor, Optional[Dict], None]:
    """An RWKV layer; its states as ``_update`` keeps them.  The time
    mix runs at its own chunk (32), not the decoder's, as in JAX."""
    rs = cfg.residual_scale
    st = cache or {}
    h = ll.apply_norm(p["norm1"], x, cfg)
    mix, shift_tm, wkv = rw.apply_time_mix(
        p["mixer"], h, cfg, shift_state=st.get("shift_tm"),
        wkv_state=st.get("wkv"), mode=mode, sharder=sharder)
    x = sharder.ac(x + rs * mix, ("batch", "seq", None))
    h2 = ll.apply_norm(p["norm2"], x, cfg)
    f, shift_cm = rw.apply_channel_mix(p["ffn"], h2, cfg,
                                       shift_state=st.get("shift_cm"))
    x = sharder.ac(x + rs * f, ("batch", "seq", None))
    if mode == "train":
        return x, None, None
    return x, _update(cache, {"shift_tm": shift_tm, "shift_cm": shift_cm,
                              "wkv": wkv}, mode, sharder), None


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """The per-layer trees of a stacked parameter tree, as views.  Each
    leaf is split by one ``unbind``, whose backward stacks the layers'
    gradients in one op (indexing layer by layer would add a full-size
    zero gradient per layer and leaf); a DTensor leaf by
    ``_UnbindLayers``, whose backward keeps the leaf's split."""
    split = {k: _unstack(v, n) if isinstance(v, dict)
             else _UnbindLayers.apply(v) if isinstance(v, DTensor)
             else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


class _UnbindLayers(torch.autograd.Function):
    """``unbind(0)`` of a stacked DTensor leaf (layers, ...), whose
    backward stacks the layers' gradients on each rank's shards.

    DTensor's own ``unbind`` backward stacks the per-layer gradient
    DTensors, and its ``stack`` takes them replicated: every rank then
    reduces and gathers each layer's gradient whole and holds the
    stacked gradient at its global shape.  Here each layer's gradient is
    laid out as the leaf's layer is (``Shard(d + 1)`` of the leaf is
    ``Shard(d)`` of a layer), keeping a ``Partial`` where the leaf is
    replicated, so that a rank moves at most one layer's shard; the
    local gradients are stacked and wrapped in the leaf's placements,
    ``Partial`` included.  The one reduction of a partial sum is then
    the train step's (``shard_like_params``), on the rank's shard, as
    JAX's scan gradient over the stacked leaf is reduced once."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        ctx.shape = tuple(x.shape)
        return tuple(x.unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        mesh, shape = ctx.mesh, ctx.shape
        # a layer's placements: the leaf's split moved one dim down, and
        # on the dims that replicate the leaf, the gradients' own partial
        # sum (else replicated)
        layer = tuple(Shard(p.dim - 1) if p.is_shard()
                      else q if q.is_partial() else Replicate()
                      for p, q in zip(ctx.placements, grads[0].placements))
        locals_ = [(g if tuple(g.placements) == layer
                    else g.redistribute(mesh, layer)).to_local()
                   for g in grads]
        stacked = [Shard(p.dim + 1) if p.is_shard() else p for p in layer]
        return DTensor.from_local(torch.stack(locals_), mesh, stacked,
                                  run_check=False, shape=shape,
                                  stride=contiguous_strides(shape))


def _stack_layer(stacked: Any, i: int, n: int, entry: Any) -> Any:
    """Write layer ``i``'s cache entry (a dict tree) into entry ``i`` of
    the cache stacked over ``n`` layers, allocating the stacked leaves
    at the first entry written (``None`` before): each layer's entry is
    written as the layer returns it, as JAX's scan writes its stacked
    output, so that a prefill never holds its cache twice (all layers'
    entries and their ``torch.stack``).  The stacked leaves equal the
    stack bit for bit.  A DTensor leaf is laid out as the stack of its
    entries is, each entry's split one dim further in, and written on
    the local shards (DTensor refuses in-place writes into a split
    tensor, as ``MeshSharder.write_kv_`` notes)."""
    if isinstance(entry, dict):
        stacked = stacked or {}
        return {k: _stack_layer(stacked.get(k), i, n, v)
                for k, v in entry.items()}
    if not isinstance(entry, DTensor):
        if stacked is None:
            stacked = entry.new_empty((n,) + tuple(entry.shape))
        stacked.select(0, i).copy_(entry)
        return stacked
    if stacked is None:
        local = entry.to_local()
        shape = (n,) + tuple(entry.shape)
        stacked = DTensor.from_local(
            local.new_empty((n,) + tuple(local.shape)), entry.device_mesh,
            [Shard(p.dim + 1) if p.is_shard() else p
             for p in entry.placements],
            run_check=False, shape=shape, stride=contiguous_strides(shape))
    layer = tuple(Shard(p.dim - 1) if p.is_shard() else p
                  for p in stacked.placements)
    if tuple(entry.placements) != layer:
        entry = entry.redistribute(stacked.device_mesh, layer)
    stacked.to_local().select(0, i).copy_(entry.to_local())
    return stacked


def decoder_forward(layers_params, x: torch.Tensor, cfg, positions,
                    mode: str, cache=None, cur_len=None, chunk: int = 2048,
                    seq_capacity: int = 0, n_vis: int = 0,
                    dtype: Optional[torch.dtype] = None,
                    sharder: Sharder = IDENTITY_SHARDER
                    ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Run the decoder stack -> (x, cache, aux_loss summed over layers).
    ``dtype`` casts each layer's leaves as the loop reaches the layer,
    so that one layer's cast copy is alive at a time.
    Train returns no cache; prefill returns a new stacked cache in the
    compute dtype (the RWKV and ssm states in f32), each layer's entry
    written into it as the layer returns it (``_stack_layer``); decode
    writes into ``cache`` in place, layer by layer
    (``Sharder.decode_layer``: on a mesh that splits the cache's layers,
    one layer's rows moved at a time), and returns it.  A hybrid arch's
    params and cache are tuples over the positions of its period; the
    loop runs period by period, position by position, as the JAX scan
    over periods does."""
    seq_capacity = seq_capacity or x.shape[1]
    hybrid = cfg.family == "hybrid"
    n_pos = period(cfg)
    n_steps = cfg.n_layers // n_pos
    stacks = layers_params if hybrid else (layers_params,)
    per_layer = [_unstack(t, n_steps) for t in stacks]
    caches = cache if hybrid else (cache,)
    stacked: List[Optional[Dict]] = [None] * n_pos
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_steps):
        for pos in range(n_pos):
            lp = cast(per_layer[pos][i], dtype)
            lc = (sharder.decode_layer(caches[pos], i) if mode == "decode"
                  else None)
            if mode == "train":
                x, nc, a = checkpoint(apply_layer, lp, x, cfg, pos,
                                      positions, mode, None, None, chunk,
                                      seq_capacity, n_vis, sharder,
                                      use_reentrant=False)
            else:
                x, nc, a = apply_layer(lp, x, cfg, pos, positions, mode, lc,
                                       cur_len, chunk, seq_capacity, n_vis,
                                       sharder)
            if a is not None:
                aux = aux + a
            if mode == "prefill":
                stacked[pos] = _stack_layer(stacked[pos], i, n_steps, nc)
            # copied or written back: not kept into the next layer
            del nc, lc, lp
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        return x, cache, aux
    return x, tuple(stacked) if hybrid else stacked[0], aux


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def lm_apply(params: Dict, batch: Dict, cfg, mode: str = "prefill",
             cache=None, cur_len=None, chunk: int = 2048,
             seq_capacity: int = 0,
             compute_dtype: torch.dtype = torch.bfloat16,
             sharder: Sharder = IDENTITY_SHARDER
             ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Unified LM entry.  Returns (logits, new_cache, aux_loss):

      train  : logits (b, s, Vp), no cache
      prefill: logits (b, 1, Vp) at the last position, + cache
      decode : logits (b, 1, Vp), + the cache updated in place

    A VLM batch's ``vision_embeds`` (b, n_vis, d) are cast to the
    activations' dtype and put in front of the embedded tokens; s, the
    positions, the cache and train mode's labels and mask then cover
    ``n_vis + s_text``.

    Leaves not in ``compute_dtype`` are cast on every call, as the JAX
    function does: train mode takes the f32 master params (with
    ``requires_grad``) and casts them all first, so the cast is part of
    the graph, the gradients reach them in f32 and the embedding's
    gradient is summed in the compute dtype, as in JAX.  Prefill and
    decode cast where XLA's compiled form does: the table's gathered
    rows, each layer's leaves in the layer loop, the weight the
    unembedding projects by; no whole copy of the params is alive
    (the values are the cast-first order's, bit for bit).  Serving
    casts once beforehand (``Model.load``, ``BatchServer``), which
    makes every cast free.
    """
    check_family(cfg)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; one of {MODES}")
    if mode == "train":
        params = cast(params, compute_dtype)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = ll.embed_tokens(params["embed"], tokens, cfg, dtype=compute_dtype)
    n_vis = 0
    if "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(x.dtype)
        n_vis = vis.shape[1]
        x = torch.cat([vis, x], dim=1)
    s = x.shape[1]
    positions = None
    if mode != "decode":
        positions = make_positions(cfg, b, s, tokens.device, n_vis=n_vis)
        # laid out by batch, as XLA propagates them from their uses: on a
        # mesh the RoPE angles made from them are then each rank's rows
        positions = sharder.ac(positions, ("batch",)
                               + (None,) * (positions.dim() - 1))
    x = sharder.ac(x, ("batch", "seq", None))
    x, new_cache, aux = decoder_forward(
        params["layers"], x, cfg, positions, mode=mode, cache=cache,
        cur_len=cur_len, chunk=chunk, seq_capacity=seq_capacity,
        n_vis=n_vis, dtype=compute_dtype, sharder=sharder)
    if mode != "train":
        x = x[:, -1:]
    x = ll.apply_norm(cast(params["final_norm"], compute_dtype), x, cfg)
    return (ll.unembed(params["embed"], x, cfg, sharder, compute_dtype),
            new_cache, aux)
