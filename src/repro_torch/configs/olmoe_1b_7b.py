"""OLMoE-1B-7B: 64-expert top-8 MoE [arXiv:2409.02060; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    qk_norm=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
)
