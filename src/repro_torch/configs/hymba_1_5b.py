"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

Every block runs SWA attention and a selective-SSM head in parallel on the
same normed input, merged with learned per-branch scales. Deviation from the
paper (DESIGN.md §7): the 3 designated global-attention layers are modeled
as SWA too (uniform scan structure); meta tokens are omitted.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    block="hymba", ssm_state=16, window=1024,
    rope="rope", act="swiglu", norm="rms",
    sub_quadratic=True,
    # q_chunk 256 keeps each sliding-window slice at window + 256 columns
    # (80% of them inside the window) instead of window + 1024 (50%)
    q_chunk=256,
)
