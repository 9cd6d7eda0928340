"""Model of the port: init / forward / cached decode for every family.

The port of ``repro.models.model``.  Layers are ``nn.ModuleList``s walked
by Python loops where the JAX package stacks them and scans:
  * dense (and audio, vlm: the dense stack behind a frontend stub):
    ``blocks[i]`` = {ln1, attn, ln2, mlp};
  * moe: super-blocks of ``moe_every`` layers, ``blocks[i].l{j}``, the last
    layer of each with an MoE FFN (``moe``), the others a dense MLP;
  * hybrid (zamba2): ``blocks[i]`` = {ln, mamba}, and one ``shared_attn``
    block (one weight set) after every ``attn_every``-th block;
  * ssm (xLSTM): ``blocks[i]`` = {ln, mlstm, ln_s, slstm}, the sLSTM applied
    after every ``slstm_every``-th block.
Submodules carry the JAX leaves' names, so ``convert.from_jax_params`` is a
name map.

The caches keep the JAX layouts: dense ``{"k", "v"}: (L, B, Hkv, S, hd)``;
moe ``{"l{j}": {"k", "v"}}`` stacked over super-blocks; hybrid
``{"ssm": {"h", "conv"}, "shared_kv": {"k", "v"}}`` (one KV cache per
shared-attention site); ssm ``{"mlstm": {"C", "n"}, "slstm": {"c", "n"}}``.
``decode_step`` updates the cache in place and returns it.

Training: parameters are made with ``requires_grad=False`` (serving records
nothing); a trainer calls ``model.requires_grad_(True)``.  ``forward`` is
differentiable and ``loss_fn`` is the reference's loss; ``decode_step``
stays under ``torch.no_grad()``.

Inside a mesh context the model's parameters are this rank's shards
(``distributed.step.place_params``), the batch and caches its batch shard,
and each layer issues its collectives (``models/layers.py``, ``moe.py``,
``mamba2.py``); ``shard_hint`` stands at the reference's sites.  The loss
is global: ``sum(nll * mask)`` over ``sum(mask)``, both summed over the
batch shards, with the cross-entropy over a vocab-sharded axis
(``collectives.vocab_nll``).  Under sequence parallelism (``MeshContext.sp``)
the tokens, the residual stream between the blocks, the logits and the
labels are this rank's chunk of the sequence (every ``shard_hint`` asserts
it), RoPE takes the whole sequence's positions, and the loss's sums run
over the sequence shards too (``collectives.token_sum``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import shard_hint
from . import layers as L
from . import mamba2 as M
from . import moe as MOE
from . import xlstm as XL

Cache = Dict[str, object]

FAMILIES = ("dense", "audio", "vlm", "moe", "hybrid", "ssm")


class Block(nn.Module):
    """Attention + FFN: a dense MLP, or an MoE when ``moe`` is set."""

    def __init__(self, cfg: ModelConfig, device, moe: bool = False):
        super().__init__()
        pdt = L.dtype_of(cfg.param_dtype)
        self.ln1 = L.RMSNorm(cfg.d_model, pdt, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, pdt, device)
        if moe:
            self.moe = MOE.MoE(cfg, device)
        else:
            self.mlp = L.MLP(cfg, device)


class MoESuperBlock(nn.Module):
    """``moe_every`` layers ``l0 .. l{moe_every - 1}``; the last has the MoE."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        for j in range(cfg.moe_every):
            self.add_module(f"l{j}", Block(cfg, device, moe=j == cfg.moe_every - 1))

    def layers(self):
        return [getattr(self, f"l{j}") for j in range(len(self._modules))]


class HybridBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, L.dtype_of(cfg.param_dtype), device)
        self.mamba = M.Mamba2(cfg, device)


class XLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        pdt = L.dtype_of(cfg.param_dtype)
        self.ln = L.RMSNorm(cfg.d_model, pdt, device)
        self.mlstm = XL.MLSTM(cfg, device)
        self.ln_s = L.RMSNorm(cfg.d_model, pdt, device)
        self.slstm = XL.SLSTM(cfg, device)


def num_blocks(cfg: ModelConfig) -> int:
    """Entries of ``Model.blocks`` (the JAX tree's stacked leading axis)."""
    return cfg.num_layers // cfg.moe_every if cfg.family == "moe" else cfg.num_layers


class Model(nn.Module):
    """Parameters of one model; ``device="meta"`` allocates nothing."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(cfg.family)
        device = device if str(device) == "meta" else resolve_device(device)
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        block = {"moe": MoESuperBlock, "hybrid": HybridBlock,
                 "ssm": XLSTMBlock}.get(cfg.family, Block)
        self.blocks = nn.ModuleList(block(cfg, device) for _ in range(num_blocks(cfg)))
        if cfg.family == "hybrid" and cfg.attn_every:
            self.shared_attn = Block(cfg, device)
        self.final_norm = L.RMSNorm(cfg.d_model, L.dtype_of(cfg.param_dtype), device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "Model":
        """The JAX package's distributions (normal * d^-1/2 projections,
        normal * 0.02 embeddings, 0.1 conv taps, unit norms, zero biases and
        SSM decay offsets) drawn from ``generator``.  The numbers differ from
        ``jax.random``'s."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """A model with seeded random weights on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, dev).reset_parameters(g)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------
def _attn_ffn(bp: Block, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """One attention + FFN layer; returns (x, MoE aux loss or None)."""
    x = x + L.attention_apply(bp.attn, L.rmsnorm(bp.ln1, x, cfg.norm_eps), cfg, positions)
    h = L.rmsnorm(bp.ln2, x, cfg.norm_eps)
    if hasattr(bp, "moe"):
        y, aux = MOE.moe_apply(bp.moe, h, cfg)
        return shard_hint(x + y, ("batch", "seq", "embed")), aux
    return shard_hint(x + L.mlp_apply(bp.mlp, h), ("batch", "seq", "embed")), None


def _every(i: int, k: int) -> bool:
    """Whether block i (0-based) is the last of a group of k (k = 0: never)."""
    return bool(k) and (i + 1) % k == 0


def _dense_block(bp: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    return _attn_ffn(bp, x, cfg, positions)[0]


def _moe_block(bp: Block, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A super-block of ``moe_every`` layers: (x, the sum of its MoE layers'
    aux losses)."""
    with telemetry.span("repro.block"):     # inside the remat: runs again in the recompute
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in bp.layers():
            x, a = _attn_ffn(blk, x, cfg, positions)
            if a is not None:
                aux = aux + a
    return x, aux


def _hybrid_block(bp: Block, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  shared: Optional[Block]) -> torch.Tensor:
    """A Mamba2 block, then the shared attention block where this is one of
    its sites (``shared`` not None)."""
    x = x + M.mamba2_apply(bp.mamba, L.rmsnorm(bp.ln, x, cfg.norm_eps), cfg)
    if shared is not None:
        x, _ = _attn_ffn(shared, x, cfg, positions)
    return shard_hint(x, ("batch", "seq", "embed"))


def _xlstm_block(bp: Block, x: torch.Tensor, cfg: ModelConfig, with_slstm: bool) -> torch.Tensor:
    """An mLSTM block, then its sLSTM block where it has one."""
    x = x + XL.mlstm_apply(bp.mlstm, L.rmsnorm(bp.ln, x, cfg.norm_eps), cfg)
    if with_slstm:
        x = x + XL.slstm_apply(bp.slstm, L.rmsnorm(bp.ln_s, x, cfg.norm_eps), cfg)
    return shard_hint(x, ("batch", "seq", "embed"))


_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm, torch.ops.aten.matmul)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: a matrix product's
    output is kept, everything else (the kernels' autograd Functions too)
    runs again in the backward."""
    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """The reference's ``jax.checkpoint`` around a block (``cfg.remat``):
    "none" runs ``fn`` as it is; "full" keeps only the block's inputs and
    runs it again in the backward (``torch.utils.checkpoint``, non-reentrant;
    the blocks draw no random numbers, so no RNG state is stashed); "dots"
    keeps the matrix products' outputs besides (selective checkpointing
    with ``_save_dots``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def forward(model: Model, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, Vpad) f32, aux_loss scalar f32: the MoE
    load-balance loss summed over layers, 0 for other families).

    Differentiable: with grad mode on, every family's blocks run under
    ``_remat`` (``cfg.remat``), as the reference's do (a moe super-block, a
    hybrid block with its shared-attention site, an xLSTM block with its
    sLSTM), and the kernels through their backward passes."""
    cfg = model.cfg
    grad = torch.is_grad_enabled()
    dense_block, moe_block, hybrid_block, xlstm_block = (
        _remat(fn, cfg) if grad else fn
        for fn in (_dense_block, _moe_block, _hybrid_block, _xlstm_block))
    if embeds is not None:
        x = L.frontend_apply(cfg, embeds).to(L.dtype_of(cfg.dtype))
        b, s = x.shape[:2]
    else:
        x = L.embed_apply(model.embed, tokens).to(L.dtype_of(cfg.dtype))
        b, s = tokens.shape
    # the whole sequence's positions (under SP this rank holds s of them)
    s_all = s * C.seq_shards()
    positions = torch.arange(s_all, device=x.device)[None, :].expand(b, s_all)
    x = shard_hint(x, ("batch", "seq", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    for i, bp in enumerate(model.blocks):
        if cfg.family == "moe":
            x, a = moe_block(bp, x, cfg, positions)
            aux = aux + a
        elif cfg.family == "hybrid":
            x = hybrid_block(bp, x, cfg, positions,
                             model.shared_attn if _every(i, cfg.attn_every) else None)
        elif cfg.family == "ssm":
            x = xlstm_block(bp, x, cfg, _every(i, cfg.slstm_every))
        else:
            x = dense_block(bp, x, cfg, positions)
    with telemetry.span("repro.loss"):
        x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
        logits = L.unembed_apply(model.embed, x, cfg.vocab_size, L.dtype_of(cfg.logits_dtype))
    return shard_hint(logits, ("batch", "seq", "vocab")), aux


def loss_fn(model: Model, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``batch["mask"]`` (default: every
    position) plus 0.01 x the MoE aux loss.  Returns (total, {"loss", "aux",
    "ppl_log"}), the metrics detached 0-d tensors."""
    logits, aux = forward(model, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
    with telemetry.span("repro.loss"):
        labels = batch["labels"].long()
        tp = L.vocab_tp(model.embed, out=True)
        if tp is not None and tp.local and C.seq_group() is None:
            nll = C.vocab_nll(logits, labels, tp)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
            nll = lse - gold
        mask = batch.get("mask")
        mask = torch.ones_like(nll) if mask is None else mask.float()
        loss = C.token_sum(torch.sum(nll * mask)) / torch.clamp(C.token_sum(torch.sum(mask)),
                                                                min=1.0)
    total = loss + 0.01 * aux
    loss = loss.detach()
    return total, {"loss": loss, "aux": aux.detach(), "ppl_log": loss}


# --------------------------------------------------------------------------
# decode: cache init + single-token step
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> Cache:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    dt = dtype or L.dtype_of(cfg.dtype)
    dev = resolve_device(device)

    def kv(n):
        shape = (n, batch, cfg.num_kv_heads, max_seq, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    if cfg.family == "moe":
        return {f"l{j}": kv(num_blocks(cfg)) for j in range(cfg.moe_every)}
    if cfg.family == "hybrid":
        cache: Cache = {"ssm": M.mamba2_init_state(cfg, batch, cfg.num_layers, dev)}
        if cfg.attn_every:
            cache["shared_kv"] = kv(cfg.num_layers // cfg.attn_every)
        return cache
    if cfg.family == "ssm":
        return {"mlstm": XL.mlstm_init_state(cfg, batch, cfg.num_layers, dev),
                "slstm": XL.slstm_init_state(cfg, batch, cfg.num_layers, dev)}
    return kv(cfg.num_layers)


def _attn_ffn_decode(bp: Block, x: torch.Tensor, cfg: ModelConfig, ck: torch.Tensor,
                     cv: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(bp.ln1, x, cfg.norm_eps)
    o, _, _ = L.attention_decode(bp.attn, h, cfg, ck, cv, pos)
    x = x + o
    h = L.rmsnorm(bp.ln2, x, cfg.norm_eps)
    if hasattr(bp, "moe"):
        return x + MOE.moe_apply(bp.moe, h, cfg)[0]
    return x + L.mlp_apply(bp.mlp, h)


@torch.no_grad()
def decode_step(model: Model, cache: Cache, token: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """token: (B,) int; pos: (B,) current positions, each in [0, max_seq)
    (not checked here: that would wait for the device on every step).
    Returns (logits (B, Vpad), cache), the cache updated in place."""
    cfg = model.cfg
    x = L.embed_apply(model.embed, token[:, None]).to(L.dtype_of(cfg.dtype))
    site = 0
    for i, bp in enumerate(model.blocks):
        if cfg.family == "moe":
            for j, blk in enumerate(bp.layers()):
                c = cache[f"l{j}"]
                x = _attn_ffn_decode(blk, x, cfg, c["k"][i], c["v"][i], pos)
        elif cfg.family == "hybrid":
            st = cache["ssm"]
            x = x + M.mamba2_decode(bp.mamba, L.rmsnorm(bp.ln, x, cfg.norm_eps),
                                    st["h"][i], st["conv"][i], cfg)
            if _every(i, cfg.attn_every):
                kv = cache["shared_kv"]
                x = _attn_ffn_decode(model.shared_attn, x, cfg, kv["k"][site], kv["v"][site],
                                     pos)
                site += 1
        elif cfg.family == "ssm":
            m, s = cache["mlstm"], cache["slstm"]
            x = x + XL.mlstm_decode(bp.mlstm, L.rmsnorm(bp.ln, x, cfg.norm_eps),
                                    m["C"][i], m["n"][i], cfg)
            if _every(i, cfg.slstm_every):
                x = x + XL.slstm_decode(bp.slstm, L.rmsnorm(bp.ln_s, x, cfg.norm_eps),
                                        s["c"][i], s["n"][i], cfg)
        else:
            x = _attn_ffn_decode(bp, x, cfg, cache["k"][i], cache["v"][i], pos)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = L.unembed_apply(model.embed, x, cfg.vocab_size, L.dtype_of(cfg.logits_dtype))
    return logits[:, 0, :], cache
