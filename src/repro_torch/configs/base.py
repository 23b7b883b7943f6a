"""Architecture and shape configuration for the PyTorch port.

A copy of ``repro.configs.base`` (``ArchConfig``, ``ShapeConfig``,
``smoke``): the port imports nothing of the JAX package, so it keeps its
own copy of the plain dataclasses it needs.  Keep the two in step; the
port's tests compare the copies field for field.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class ArchConfig:
    """One model architecture, exactly as published."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    source: str                 # arXiv / hf citation string

    n_layers: int               # decoder layers
    d_model: int
    n_heads: int                # query heads (0 = attention-free)
    n_kv_heads: int             # GQA kv heads
    d_ff: int                   # per-expert d_ff for MoE archs
    vocab_size: int

    d_head: int = 0             # 0 -> d_model // n_heads

    # --- MoE ----------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE FFN on layers where l % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- attention flavour ---------------------------------------------
    rope_theta: float = 10000.0
    rope_pct: float = 1.0       # partial rotary (stablelm = 0.25)
    pos_scheme: str = "rope"    # rope | mrope | learned | none
    sliding_window: int = 0     # 0 = full attention
    qk_norm: bool = False

    # --- FFN / norm -----------------------------------------------------
    act: str = "swiglu"         # swiglu | gelu | sq_relu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5

    # --- SSM (mamba / rwkv) ----------------------------------------------
    d_state: int = 16           # mamba state per channel
    d_conv: int = 4             # mamba local conv taps
    expand: int = 2             # mamba d_inner = expand * d_model
    rwkv_head_size: int = 64

    # --- hybrid (jamba) ---------------------------------------------------
    attn_every: int = 0         # one attention layer per `attn_every` (else mamba)
    attn_offset: int = 0

    # --- encoder-decoder (whisper) / vlm (qwen2-vl) -----------------------
    enc_layers: int = 0
    enc_seq: int = 0            # fixed encoder frames (whisper: 1500)
    n_vis: int = 0              # vlm stub patch embeddings prepended

    tie_embeddings: bool = False
    residual_scale: float = 1.0  # minicpm depth-scaled residual

    # ----------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def is_moe_layer(self, layer: int) -> bool:
        if self.n_experts == 0:
            return False
        return layer % self.moe_every == self.moe_offset

    def is_attn_layer(self, layer: int) -> bool:
        """hybrid archs: which decoder layers are attention (vs mamba)."""
        if self.family != "hybrid":
            return not self.is_attention_free
        return self.attn_every > 0 and layer % self.attn_every == self.attn_offset

    # -- parameter counts (for MODEL_FLOPS = 6 N D) ------------------------
    def param_counts(self) -> Dict[str, float]:
        d, f = self.d_model, self.d_ff
        hd = self.head_dim
        counts: Dict[str, float] = {}
        counts["embed"] = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn_layer = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        ffn_mats = 3 if self.act == "swiglu" else 2
        dense_ffn = ffn_mats * d * f
        moe_ffn = self.n_experts * ffn_mats * d * f + d * self.n_experts
        mamba_layer = (d * 2 * self.d_inner            # in_proj
                       + self.d_inner * self.d_conv    # conv
                       + self.d_inner * (self.d_state * 2 + 1)  # x_proj-ish
                       + self.d_inner                  # dt
                       + self.d_inner * self.d_state   # A
                       + self.d_inner * d)             # out_proj
        rwkv_layer = 6 * d * d + 3 * d * 32            # r,k,v,g,o,ffn-ish lora
        total = counts["embed"]
        active = counts["embed"]
        for layer in range(self.n_layers):
            if self.family == "ssm":
                lp = rwkv_layer + 2 * d * f  # rwkv channel-mix (2 mats)
                la = lp
            else:
                mixer = attn_layer if self.is_attn_layer(layer) else mamba_layer
                if self.is_moe_layer(layer):
                    lp = mixer + moe_ffn
                    la = mixer + self.top_k * ffn_mats * d * f + d * self.n_experts
                else:
                    lp = mixer + dense_ffn
                    la = lp
            total += lp
            active += la
        enc_attn = 4 * d * d
        total += self.enc_layers * (enc_attn + 2 * d * f)
        active += self.enc_layers * (enc_attn + 2 * d * f)
        counts["total"] = float(total)
        counts["active"] = float(active)
        return counts

    def model_flops(self, tokens: float, backward: bool = True) -> float:
        """6 * N_active * D (2ND forward, 4ND backward)."""
        n = self.param_counts()["active"]
        mult = 6.0 if backward else 2.0
        return mult * n * tokens


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set; identical for every LM arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs with a sub-quadratic decode path (everything else skips long_500k)
SUBQUADRATIC = ("mixtral-8x22b", "rwkv6-7b", "jamba-v0.1-52b")


def cell_runnable(arch: "ArchConfig", shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) a runnable dry-run cell?  (False, why) if skipped."""
    if shape.name == "long_500k" and arch.name not in SUBQUADRATIC:
        return False, ("pure full-attention arch: O(S^2)/full-KV decode at "
                       "524288 is out of scope per assignment (documented in "
                       "DESIGN.md long_500k skip list)")
    return True, ""


# ---------------------------------------------------------------------------
# Smoke reduction
# ---------------------------------------------------------------------------

def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    changes: Dict[str, object] = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        d_ff=128,
        vocab_size=256,
        d_head=16,
        enc_seq=min(cfg.enc_seq, 16) if cfg.enc_seq else 0,
        enc_layers=min(cfg.enc_layers, 2),
        n_vis=4 if cfg.n_vis else 0,
        rwkv_head_size=16,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
    )
    if cfg.n_heads:
        changes["n_heads"] = 4
        changes["n_kv_heads"] = max(1, round(4 * cfg.n_kv_heads / cfg.n_heads))
    if cfg.n_experts:
        changes["n_experts"] = 4
        changes["top_k"] = min(cfg.top_k, 2)
    if cfg.family == "hybrid":
        changes["n_layers"] = max(cfg.attn_every, 4)
    return replace(cfg, **changes)


def smoke_shape(kind: str = "train") -> ShapeConfig:
    return {
        "train": ShapeConfig("smoke_train", 32, 4, "train"),
        "prefill": ShapeConfig("smoke_prefill", 32, 2, "prefill"),
        "decode": ShapeConfig("smoke_decode", 32, 4, "decode"),
    }[kind]
