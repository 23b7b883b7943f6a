"""MiniCPM-2B: llama-like dense decoder trained with the WSD schedule
[arXiv:2404.06395; hf].

The WSD (warmup-stable-decay) learning-rate schedule is the
paper-specific training feature; it is implemented in
``repro_torch.optim.schedule.wsd_schedule`` and selected by this config.
MiniCPM ties input/output embeddings and scales residual branches by
1.4/sqrt(n_layers) (mu-p inspired depth scaling).
"""

import math

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395; hf:openbmb/MiniCPM-2B-sft-bf16",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab_size=122753,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(40),
)
