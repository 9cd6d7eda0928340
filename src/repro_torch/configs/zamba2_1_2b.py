"""Zamba2-1.2B [arXiv:2411.15242; hf]: Mamba2 backbone + shared attention.

38 Mamba2 blocks; ONE shared attention+MLP block (single weight set) applied
every `attn_every` blocks -- the assignment's 'shared attn blocks'.
sub-quadratic => runs the long_500k shape.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2_1_2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_heads=32, ssm_expand=2, attn_every=6,
    notes="Mamba2 + shared attn; POM chunked-scan showcase arch.",
))
