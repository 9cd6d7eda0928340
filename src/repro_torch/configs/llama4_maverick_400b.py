"""Llama4-Maverick-400B-A17B [hf:meta-llama (Scout sibling); unverified].

48 layers, MoE every 2nd layer: 128 experts top-1 + shared expert
(interleaved MoE, early-fusion multimodal backbone -- text path here).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4_maverick_400b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=128, experts_per_token=1, moe_every=2, shared_expert=True,
    rope_theta=5e5,
    notes="MoE 128e top-1 interleaved every 2nd layer + shared expert.",
))
