"""Granite-3.0-1B-A400M [hf:ibm-granite]: 32 experts top-8, every layer."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite_moe_1b", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=32, experts_per_token=8, moe_every=1,
    notes="fine-grained MoE: small experts, top-8.",
))
