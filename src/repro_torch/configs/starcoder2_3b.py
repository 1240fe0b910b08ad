"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173; hf].

StarCoder2 uses LayerNorm + GELU MLP (4×) rather than RMS/SwiGLU.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152,
    rope="rope", act="gelu", norm="ln",
)
