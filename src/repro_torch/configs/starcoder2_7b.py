"""StarCoder2-7B [arXiv:2402.19173; hf]: dense GQA decoder, RoPE."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2_7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128,
    rope_theta=1e5, mlp_gated=False,
    notes="GQA kv=4, RoPE, non-gated GeLU MLP per the public config.",
))
