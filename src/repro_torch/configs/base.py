"""Config system of the PyTorch port: model architectures and their registry.

A copy of ``repro.configs.base`` (``ParallelConfig`` field for field) with
two changes: ``param_count`` counts the port's own module on the ``meta``
device, and the fields that only steer JAX compilation (``use_pallas``,
``scan_layers``, ``unroll_inner_scans``, ``attn_chunk``) are gone -- the
port always dispatches through ``repro_torch.kernels.ops``, by the device
of the tensors.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp_gated: bool = True         # SwiGLU (True) vs GeLU 2-matrix (False)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # MoE layer every k-th layer (1 = all)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / xLSTM) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    # --- hybrid (zamba2): shared attention block every k SSM blocks ---
    attn_every: int = 0
    # --- xLSTM: sLSTM block every k mLSTM blocks ---
    slstm_every: int = 0
    # --- modality frontend stubs (embeddings arrive precomputed) ---
    frontend: Optional[str] = None  # 'encodec_frames' | 'clip_patches'
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optim_state_dtype: str = "float32"   # first moment (m)
    optim_second_dtype: str = "float32"  # second moment (v)
    logits_dtype: str = "float32"        # unembed matmul precision
    remat: str = "full"            # 'none' | 'full' | 'dots'
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Embedding tables padded to a multiple of 2048; pad logits are
        masked to -1e30 in unembed."""
        m = 2048
        return -(-self.vocab_size // m) * m

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Exact total parameters of the port's module, built on ``meta``
        (no storage is allocated)."""
        from repro_torch.models.model import Model
        model = Model(self, device="meta")
        return sum(p.numel() for p in model.parameters())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        n_moe = self.num_layers // self.moe_every
        g = 3 if self.mlp_gated else 2
        inactive = n_moe * (self.num_experts - self.experts_per_token) * g * d * self.d_ff
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


# the four assigned LM shapes (one set for all ten archs)
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    dp: int = 1
    tp: int = 1
    pods: int = 1
    zero1: bool = True             # shard optimizer state over data axis
    fsdp: bool = True              # shard params+grads over data axis too
    grad_compression: bool = False # int8 + error feedback DP sync
    seq_shard_decode: bool = True  # shard long KV over model axis (SP)
    pp_stages: int = 1             # GPipe over the pod axis when > 1
    microbatches: int = 1


ARCH_IDS = [
    "starcoder2_7b", "codeqwen1_5_7b", "smollm_360m", "qwen2_72b",
    "musicgen_large", "zamba2_1_2b", "llama4_maverick_400b",
    "granite_moe_1b", "xlstm_1_3b", "phi3_vision_4_2b",
]

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    for a in ARCH_IDS:
        get_config(a)
    return dict(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test scale-down of the same family (same numbers as the JAX
    package's ``reduced``)."""
    small = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.family in ("ssm", "hybrid") else 0,
        attn_every=2 if cfg.attn_every else 0,
        slstm_every=2 if cfg.slstm_every else 0,
        dtype="float32",
        param_dtype="float32",
        remat="none",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
