"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: qwen1.5 arch (MHA, QKV bias)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1_5_7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    notes="qwen1.5-style: MHA (kv=32), QKV bias, large rope theta.",
))
