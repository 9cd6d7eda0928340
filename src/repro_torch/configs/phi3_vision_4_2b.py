"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini text backbone; the CLIP image tower is a stub per the assignment:
input_specs() provides precomputed patch embeddings merged into the token
stream.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3_vision_4_2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    frontend="clip_patches",
    notes="backbone only; CLIP patch embeddings arrive precomputed.",
))
