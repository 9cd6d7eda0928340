"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family]: small llama-arch."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm_360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    tie_embeddings=True,
    notes="llama-arch small; the end-to-end training example arch.",
))
