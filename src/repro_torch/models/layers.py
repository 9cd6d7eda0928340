"""Shared dense model layers: RMSNorm, RoPE, GQA attention, SwiGLU/GeLU MLP,
embeddings.

The port of ``repro.models.layers`` (dense parts).  Parameters live in
``nn.Module``s under the JAX package's names and layouts: weights are
``(d_in, d_out)`` and used as ``x @ W``; attention tensors are
``(B, H, S, D)``.  The layer functions are plain functions on tensors.
Attention always goes through ``repro_torch.kernels.ops``, which picks the
CUDA kernel or the plain version by the device of the tensors.

Inside a mesh context (``distributed.sharding.use_mesh``) each layer runs on
this rank's shard (``distributed/collectives.py``): attention on its heads
(the ``wq``/``wk``/``wv`` columns, the ``wo`` rows), the MLP on its columns,
the embedding and unembedding on a vocab range, every parameter gathered
over ``data`` where it is used.  Where the reference's shard splits a head
(``logical_to_sharding`` tests divisibility on the flattened dimension:
smollm_360m's 15 query and 5 KV heads of 64 at ``model`` 2), attention
gathers its weights over ``model`` too and computes replicated.  The kernels
see plain local tensors.  With no mesh context every function computes
exactly what it did before.

Under sequence parallelism (``MeshContext.sp``) the residual stream is this
rank's chunk of the sequence: ``rmsnorm`` runs on those rows; attention
and the MLP enter through ``copy_to_model``'s all-gather along the
sequence (RoPE then takes the whole sequence's positions, which the model
passes down) and leave through ``reduce_from_model``'s reduce-scatter; the
embedding gathers the token ids and reduce-scatters the looked-up rows.
The unembedding applies this rank's rows to the whole table, gathered over
``model`` with a reduce-scatter backward, so the logits come out as the
reference lays them out, ``("batch", "seq", "vocab")`` with ``model`` on
the sequence and the vocab whole; the loss is then the plain
cross-entropy over the local rows (no vocab-parallel one).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops

NEG_INF = -1e30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(shape, std, dtype, device, generator) -> torch.Tensor:
    """N(0, std^2) drawn in f32 from ``generator``, cast to ``dtype``."""
    return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)


# --------------------------------------------------------------------------
# norm / rope
# --------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.scale)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5, tp=None) -> torch.Tensor:
    """Over the last dim; with ``tp`` local, ``x`` and the scale are that
    dim's model shard and the mean is taken over every shard.  Row-wise, so
    under SP it runs on this rank's sequence rows as it is."""
    xf = x.float()
    var = C.mean_over_model(torch.mean(xf * xf, dim=-1, keepdim=True), tp)
    out = xf * torch.rsqrt(var + eps)
    return (out * C.param(p.scale, tp).float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, D) with D even; positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    if positions.dim() == 1:
        positions = positions[None]
    positions = positions[:, None, :]                  # broadcast over heads
    # the frequencies correctly rounded to f32, as XLA folds the reference's
    # constant: PyTorch's f32 pow is 1 ulp off at some, which a position of
    # 10^5 turns into 10^-3 of a rotation
    freqs = (1.0 / (theta ** (torch.arange(0, half, dtype=torch.float64,
                                           device=x.device) / half))).float()
    ang = positions[..., None].float() * freqs         # (B, 1, S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.num_heads, cfg.num_kv_heads
        pdt = dtype_of(cfg.param_dtype)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=pdt, device=device),
                                requires_grad=False)
        self.wq, self.wk = param(d, h * hd), param(d, kv * hd)
        self.wv, self.wo = param(d, kv * hd), param(h * hd, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = param(h * hd), param(kv * hd), param(kv * hd)

    def reset_parameters(self, generator=None):
        std = self.cfg.d_model ** -0.5
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(self, name)
            w.copy_(_normal(w.shape, std, w.dtype, w.device, generator))
        if self.cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                nn.init.zeros_(getattr(self, name))


def _attention_tp(p: Attention, cfg: ModelConfig):
    """The layer's ``TP``: local on whole query and KV heads."""
    cols = [(p.wq, 1), (p.wk, 1), (p.wv, 1), (p.wo, 0)]
    if cfg.qkv_bias:
        cols += [(p.bq, 0), (p.bk, 0), (p.bv, 0)]
    return C.tp(*cols, divides=(cfg.num_heads, cfg.num_kv_heads))


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, tp):
    """(q, k, v) of this rank's heads, rope applied; ``x`` already through
    f where the layer is local."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    n = tp.size if tp is not None else 1
    q, k, v = x @ C.param(p.wq, tp), x @ C.param(p.wk, tp), x @ C.param(p.wv, tp)
    if cfg.qkv_bias:
        q, k, v = q + C.param(p.bq, tp), k + C.param(p.bk, tp), v + C.param(p.bv, tp)
    q = q.reshape(b, s, cfg.num_heads // n, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads // n, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads // n, hd).transpose(1, 2)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def attention_apply(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full (train/prefill) causal attention through the flash kernel.
    ``positions`` (B, S) are the whole sequence's (under SP ``x`` holds
    this rank's S / model rows, gathered on entry)."""
    with telemetry.span("repro.attention"):
        tp = _attention_tp(p, cfg)
        q, k, v = _qkv(p, C.copy_to_model(x, tp), cfg, positions, tp)
        o = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
        b, h, s, hd = o.shape
        o = o.transpose(1, 2).reshape(b, s, h * hd)
        return C.reduce_from_model(o @ C.param(p.wo, tp), tp)


def attention_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, d); cache: (B, KV, S, hd); pos: (B,) int.

    The new k/v are written at ``pos`` in place, into ``cache_k`` and
    ``cache_v`` themselves (the JAX package rewrites the whole cache through
    a one-hot select, since its arrays are immutable).  In a mesh context
    the cache holds this rank's KV heads where the layer is local."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    tp = _attention_tp(p, cfg)
    q, k, v = _qkv(p, C.copy_to_model(x, tp), cfg, pos[:, None], tp)
    if k.shape[1] != cache_k.shape[1]:
        raise ValueError(f"the cache holds {cache_k.shape[1]} KV heads, the layer {k.shape[1]}")
    rows = torch.arange(b, device=x.device)
    cache_k[rows, :, pos] = k[:, :, 0, :].to(cache_k.dtype)
    cache_v[rows, :, pos] = v[:, :, 0, :].to(cache_v.dtype)
    length = (pos + 1).to(torch.int32)
    o = ops.decode_attention(q[:, :, 0, :].contiguous(), cache_k, cache_v, length=length)
    o = o.reshape(b, 1, q.shape[1] * hd) @ C.param(p.wo, tp)
    return C.reduce_from_model(o, tp), cache_k, cache_v


# --------------------------------------------------------------------------
# SwiGLU / GeLU MLP
# --------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        pdt = dtype_of(cfg.param_dtype)
        self.wi = nn.Parameter(torch.empty(d, f, dtype=pdt, device=device), requires_grad=False)
        self.wo = nn.Parameter(torch.empty(f, d, dtype=pdt, device=device), requires_grad=False)
        if cfg.mlp_gated:
            self.wg = nn.Parameter(torch.empty(d, f, dtype=pdt, device=device),
                                   requires_grad=False)
        else:
            self.wg = None

    def reset_parameters(self, generator=None):
        d, f = self.wi.shape
        self.wi.copy_(_normal(self.wi.shape, d ** -0.5, self.wi.dtype, self.wi.device, generator))
        if self.wg is not None:
            self.wg.copy_(_normal(self.wg.shape, d ** -0.5, self.wg.dtype, self.wg.device,
                                  generator))
        self.wo.copy_(_normal(self.wo.shape, f ** -0.5, self.wo.dtype, self.wo.device, generator))


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    cols = [(p.wi, 1), (p.wo, 0)] + ([(p.wg, 1)] if p.wg is not None else [])
    tp = C.tp(*cols)
    x = C.copy_to_model(x, tp)
    if p.wg is not None:
        h = F.silu(x @ C.param(p.wg, tp)) * (x @ C.param(p.wi, tp))
    else:
        h = F.gelu(x @ C.param(p.wi, tp), approximate="tanh")    # jax.nn.gelu's default
    return C.reduce_from_model(h @ C.param(p.wo, tp), tp)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        pdt = dtype_of(cfg.param_dtype)
        shape = (cfg.padded_vocab_size, cfg.d_model)
        self.tok = nn.Parameter(torch.empty(shape, dtype=pdt, device=device), requires_grad=False)
        if cfg.tie_embeddings:
            self.out = None
        else:
            self.out = nn.Parameter(torch.empty(shape, dtype=pdt, device=device),
                                    requires_grad=False)

    def reset_parameters(self, generator=None):
        for w in (self.tok, self.out):
            if w is not None:
                w.copy_(_normal(w.shape, 0.02, w.dtype, w.device, generator))


def vocab_tp(p: Embed, out: bool = False):
    """The ``TP`` of the embedding (``out``: the unembedding) table: local
    on a vocab range."""
    w = p.out if out and p.out is not None else p.tok
    return C.tp((w, 0))


def embed_apply(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    tp = vocab_tp(p)
    if tp is not None and tp.local:
        return C.vocab_embed(C.param(p.tok, tp), tokens, tp)
    return C.param(p.tok, tp)[tokens]


def unembed_apply(p: Embed, x: torch.Tensor, vocab_size: int,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Logits (B, S, Vpad) in f32; padded vocab columns are -1e30.  In a
    mesh context: this rank's vocab range (B, S, Vpad / model); under SP
    its sequence rows and the whole vocab (B, S / model, Vpad)."""
    table = p.out if p.out is not None else p.tok
    if C.seq_group() is not None:             # SP: this rank's rows, the whole table
        w, first = C.param(table, rows=True), 0
    else:
        tp = vocab_tp(p, out=True)
        w = C.param(table, tp)
        x = C.copy_to_model(x, tp)
        first = tp.rank * w.shape[0] if tp is not None else 0
    logits = (x.to(compute_dtype) @ w.to(compute_dtype).T).float()
    if first + w.shape[0] > vocab_size:
        logits[..., max(vocab_size - first, 0):] = NEG_INF
    return logits


def frontend_apply(cfg: ModelConfig, embeddings: torch.Tensor) -> torch.Tensor:
    """Identity pass-through of precomputed embeddings: (B, S, d)."""
    if embeddings.shape[-1] != cfg.d_model:
        raise ValueError(f"embeddings width {embeddings.shape[-1]} != d_model {cfg.d_model}")
    return embeddings
