"""xLSTM-1.3B [arXiv:2405.04517; unverified]: mLSTM + sLSTM blocks.

d_ff=0 per the assignment (mLSTM blocks carry their own up-projection).
sLSTM every 8th block (the 7:1 mixture of the paper).  sub-quadratic state
=> runs long_500k.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm_1_3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    slstm_every=8,
    notes="mLSTM matrix memory chunk-scanned; sLSTM is the documented II floor.",
))
