"""Mixtral-8x22B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
)
