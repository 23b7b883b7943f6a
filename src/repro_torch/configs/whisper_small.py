"""Whisper-small: encoder-decoder audio transformer [arXiv:2212.04356;
unverified].

Per the assignment the conv/mel frontend is a STUB: ``input_specs()``
provides precomputed encoder frame embeddings (batch, 1500, d_model);
the 12-layer encoder runs full self-attention over them and the
12-layer decoder adds cross-attention.  Decode shapes run (it has a
decoder); ``train_4k`` trains the decoder at seq_len with the encoder
at its fixed 1500 frames.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356; hf:openai/whisper-small (unverified tier)",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    enc_layers=12,
    enc_seq=1500,
    pos_scheme="learned",
    act="gelu",
    norm="layernorm",
)
