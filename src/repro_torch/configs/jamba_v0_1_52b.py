"""Jamba-v0.1 (52B): hybrid Mamba + attention (1:7) with 16-expert top-2
MoE on alternate layers [arXiv:2403.19887; hf].

Layer pattern (period 8, as published): attention at layer index 4 of
each 8-layer block, Mamba elsewhere; MoE FFN every other layer.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    capacity_factor=1.0,     # system knob (not an arch param): fits HBM
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    d_state=16,
    d_conv=4,
    expand=2,
    act="swiglu",
    norm="rmsnorm",
    pos_scheme="none",         # jamba uses no positional encoding
)
