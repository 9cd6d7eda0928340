"""MusicGen-large [arXiv:2306.05284; hf]: decoder-only over EnCodec tokens.

Modality frontend is a stub per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model); training/decode operate on the
transformer backbone only (vocab = 2048 EnCodec codes).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen_large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    frontend="encodec_frames",
    notes="backbone only; EnCodec frame embeddings arrive precomputed.",
))
