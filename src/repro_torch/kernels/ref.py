"""Plain PyTorch versions of the port's kernels (the port's ``ref.py``).

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the path a wrapper takes for tensors on the CPU.  They
compute in f32 and return the query's dtype.

One deliberate difference from the JAX package's ``ref``: a query row that
sees no key (``length == 0``, or a causal row before the first key) returns
0, as the kernels' ``l == 0`` guard intends, where ``repro.kernels.ref``
returns NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _softmax_av(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis of ``s`` restricted to ``mask``, times v;
    rows with no True in ``mask`` give 0."""
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), dtype=s.dtype, device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v)
    return o / torch.where(l == 0, torch.ones_like(l), l)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) with GQA broadcast.

    Causal: query i attends to keys j <= i + (Skv - Sq) (aligned suffixes)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kr.transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kj = torch.arange(skv, device=q.device)[None, :]
        mask = (kj <= qi).expand(b, hq, sq, skv)
    else:
        mask = torch.ones(b, hq, sq, skv, dtype=torch.bool, device=q.device)
    return _softmax_av(s, mask, vr).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode. q: (B, Hq, D), k/v: (B, Hkv, S, D).

    ``length``: (B,) valid KV prefix per batch row (None = full)."""
    b, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kr) * scale
    if length is None:
        mask = torch.ones(b, hq, s_len, dtype=torch.bool, device=q.device)
    else:
        pos = torch.arange(s_len, device=q.device)
        mask = (pos[None, :] < length.to(q.device)[:, None])[:, None, :].expand(b, hq, s_len)
    o = _softmax_av(s[:, :, None, :], mask[:, :, None, :], vr)
    return o[:, :, 0, :].to(q.dtype)
