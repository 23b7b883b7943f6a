"""Qwen2-VL-7B backbone: M-RoPE (3-D rotary sections), dynamic-resolution
vision [arXiv:2409.12191; hf].

Per the assignment, ``[vlm]`` entries specify the transformer BACKBONE
only; the ViT/patch-embedding frontend is a STUB — ``input_specs()``
provides precomputed patch embeddings of shape (batch, n_vis, d_model)
that the model merges in front of the text tokens, and 3-D (t/h/w)
M-RoPE position ids for the merged sequence.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    pos_scheme="mrope",
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    n_vis=256,
)
