"""RWKV-6 (Finch) 7B: attention-free, data-dependent-decay linear
recurrence [arXiv:2404.05892; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b",
    n_layers=32,
    d_model=4096,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_size=64,
    act="relu_sq_channelmix",  # rwkv channel-mix uses relu^2
    norm="layernorm",
    pos_scheme="none",
)
