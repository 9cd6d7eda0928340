"""Model of the port: init / forward / KV-cache decode, dense family.

The port of ``repro.models.model`` for the dense family (and the audio and
vlm families, which are the dense stack behind a frontend stub).  Layers are
an ``nn.ModuleList`` walked by a Python loop; the JAX package stacks them
and scans.  The moe, hybrid and ssm families raise ``NotImplementedError``:
they are ROADMAP Queue 1 items 4 and 5.

The cache keeps the JAX layout ``{"k", "v"}: (L, B, Hkv, S, hd)``;
``decode_step`` writes each new k/v into it in place and returns it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from . import layers as L

Cache = Dict[str, torch.Tensor]

DENSE_FAMILIES = ("dense", "audio", "vlm")
_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 4 (MoE and grouped_matmul)",
    "hybrid": "ROADMAP Queue 1 item 5 (hybrid and ssm with ssm_scan)",
    "ssm": "ROADMAP Queue 1 item 5 (hybrid and ssm with ssm_scan)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: {_NOT_PORTED[cfg.family]}")
    if cfg.family not in DENSE_FAMILIES:
        raise ValueError(cfg.family)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        pdt = L.dtype_of(cfg.param_dtype)
        self.ln1 = L.RMSNorm(cfg.d_model, pdt, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, pdt, device)
        self.mlp = L.MLP(cfg, device)


class Model(nn.Module):
    """Parameters of one model; ``device="meta"`` allocates nothing."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_family(cfg)
        device = device if str(device) == "meta" else resolve_device(device)
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, L.dtype_of(cfg.param_dtype), device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "Model":
        """The JAX package's distributions (normal * d^-1/2 projections,
        normal * 0.02 embeddings, unit norms, zero biases) drawn from
        ``generator``.  The numbers differ from ``jax.random``'s."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """A model with seeded random weights on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, dev).reset_parameters(g)


def _dense_block(bp: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention_apply(bp.attn, L.rmsnorm(bp.ln1, x, cfg.norm_eps), cfg, positions)
    return x + L.mlp_apply(bp.mlp, L.rmsnorm(bp.ln2, x, cfg.norm_eps))


@torch.no_grad()
def forward(model: Model, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, Vpad) f32, aux_loss scalar)."""
    cfg = model.cfg
    if embeds is not None:
        x = L.frontend_apply(cfg, embeds).to(L.dtype_of(cfg.dtype))
        b, s = x.shape[:2]
    else:
        x = L.embed_apply(model.embed, tokens).to(L.dtype_of(cfg.dtype))
        b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for bp in model.blocks:
        x = _dense_block(bp, x, cfg, positions)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = L.unembed_apply(model.embed, x, cfg.vocab_size, L.dtype_of(cfg.logits_dtype))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> Cache:
    _check_family(cfg)
    dt = dtype or L.dtype_of(cfg.dtype)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


@torch.no_grad()
def decode_step(model: Model, cache: Cache, token: torch.Tensor, pos: torch.Tensor,
                decode_attention: Optional[L.DecodeAttentionFn] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """token: (B,) int; pos: (B,) current positions, each in [0, max_seq)
    (not checked here: that would wait for the device on every step).
    Returns (logits (B, Vpad), cache), the cache updated in place.
    ``decode_attention`` overrides the attention function (default
    ``ops.decode_attention``)."""
    cfg = model.cfg
    x = L.embed_apply(model.embed, token[:, None]).to(L.dtype_of(cfg.dtype))
    for i, bp in enumerate(model.blocks):
        h = L.rmsnorm(bp.ln1, x, cfg.norm_eps)
        o, _, _ = L.attention_decode(bp.attn, h, cfg, cache["k"][i], cache["v"][i], pos,
                                     decode_attention)
        x = x + o
        x = x + L.mlp_apply(bp.mlp, L.rmsnorm(bp.ln2, x, cfg.norm_eps))
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = L.unembed_apply(model.embed, x, cfg.vocab_size, L.dtype_of(cfg.logits_dtype))
    return logits[:, 0, :], cache
