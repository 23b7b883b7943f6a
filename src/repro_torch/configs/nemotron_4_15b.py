"""Nemotron-4-15B: dense decoder, GQA, squared-ReLU MLP
[arXiv:2402.16819; unverified]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819 (unverified tier)",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=256000,
    act="sq_relu",
    norm="layernorm",
    rope_theta=10000.0,
)
