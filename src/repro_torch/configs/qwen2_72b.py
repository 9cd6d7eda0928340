"""Qwen2-72B [arXiv:2407.10671; hf]: dense GQA, QKV bias."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2_72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    notes="GQA kv=8 + QKV bias; the TP/ZeRO-dominant arch in the pool.",
))
