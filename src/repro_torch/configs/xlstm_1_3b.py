"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48 layers as 6 superblocks of 7 mLSTM + 1 sLSTM (slstm_every=8). d_ff=0:
the mLSTM block carries its own ×2 up/down projection; no separate FFN.
Recurrent state ⇒ eligible for long_500k decode.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304,
    block="xlstm", slstm_every=8,
    rope="none", act="swiglu", norm="rms",
    sub_quadratic=True,
)
