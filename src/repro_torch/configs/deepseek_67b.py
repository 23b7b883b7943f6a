"""DeepSeek-67B: deep llama-arch dense decoder [arXiv:2401.02954; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab_size=102400,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
)
