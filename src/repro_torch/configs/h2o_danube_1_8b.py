"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818; hf].

Sliding-window attention ⇒ bounded KV cache ⇒ eligible for long_500k decode.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab=32000,
    window=4096, rope="rope", act="swiglu", norm="rms",
    sub_quadratic=True,
)
