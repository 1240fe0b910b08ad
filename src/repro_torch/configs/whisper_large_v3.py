"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].

32L = 32 encoder + 32 decoder layers (true whisper-large topology); the
audio conv stem is a stub (input_specs supplies frame embeddings,
enc_len = seq_len // 4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    block="encdec", rope="none", act="gelu", norm="ln", frontend="audio",
)
