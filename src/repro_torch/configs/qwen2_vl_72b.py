"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only (per assignment): the vision tower is a stub — input_specs
supplies precomputed patch embeddings merged into the token stream; M-RoPE
runs on supplied 3-D position ids.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    rope="mrope", act="swiglu", norm="rms", frontend="vision",
)
