"""Plain PyTorch versions of the port's kernels (the port's ``ref.py``).

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the path a wrapper takes for tensors on the CPU.  They
compute in f32 (the contraction in f64 for f64 arrays) and return their
input's dtype.

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


def offset_grid(trips, coefs, base: int, device) -> torch.Tensor:
    """Flattened element offsets ``base + sum_d idx_d * coef_d`` over the box
    of ``trips``, the first dim outermost (contiguous int64)."""
    off = torch.full((), base, dtype=torch.long, device=device)
    for t, c in zip(trips, coefs):
        off = off[..., None] + torch.arange(t, device=device) * c
    return off.reshape(-1).contiguous()


def _strided(t: torch.Tensor, trips, coefs, base: int, lane: Optional[int]) -> tuple:
    """The view of ``t`` at the element offsets ``base + sum_d idx_d * coef_d``
    over the dims with a nonzero coefficient (a leading lane dim of stride
    ``lane`` when given): ``(view, [(position, dim)])``.  A dim with a
    negative coefficient is walked from its far end with the positive
    stride, so its axis runs reversed (``flip`` it back)."""
    size, stride, dims, neg = [], [], [], []
    if lane is not None:
        size, stride = [t.numel() // lane], [lane]
    for d, (n, c) in enumerate(zip(trips, coefs)):
        if c:
            if c < 0:
                base += c * (n - 1)
                neg.append(len(size))
            size.append(n)
            stride.append(abs(c))
            dims.append(d)
    flat = t.reshape(-1)
    return flat.as_strided(size, stride, flat.storage_offset() + base), dims, neg


def contraction(desc, x: torch.Tensor, y: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.contraction``: X, Y and D as strided views
    over the statement's dims (no copies where the coefficients allow it),
    ``einsum`` over the dims each operand moves with in f32 (f64 for f64
    D), added to D's initial contents and cast to D's dtype.  A reduction
    dim neither operand moves with multiplies the sum by its trip count; an
    output dim neither moves with broadcasts.  Lanes as in the wrapper: a
    tensor of ``k * numel`` elements holds k lanes, one lane is shared.
    D's store must be injective, as the kernel requires."""
    acc = torch.float64 if init.dtype == torch.float64 else torch.float32
    batch = init.numel() // desc.o_numel
    out = init.clone()
    if batch * desc.points * desc.red_points == 0:
        return out
    trips = desc.out_trips + desc.red_trips
    n_out = len(desc.out_trips)
    letters = [chr(ord("a") + i) if i < 26 else chr(ord("A") + i - 26)
               for i in range(len(trips))]
    ops, subs = [], []
    for t, numel, coefs, base in ((x, desc.x_numel, desc.out_x + desc.red_x, desc.x0),
                                  (y, desc.y_numel, desc.out_y + desc.red_y, desc.y0)):
        lane = numel if batch > 1 and t.numel() == batch * numel else None
        v, dims, neg = _strided(t, trips, coefs, base, lane)
        ops.append(v.flip(neg).to(acc) if neg else v.to(acc))
        subs.append(("Z" if lane else "") + "".join(letters[d] for d in dims))
    moved = set(subs[0]) | set(subs[1])
    kept = [d for d in range(n_out) if letters[d] in moved]
    lead = "Z" if "Z" in moved else ""
    s = torch.einsum(f"{subs[0]},{subs[1]}->{lead}{''.join(letters[d] for d in kept)}", *ops)
    for d in range(n_out, len(trips)):
        if letters[d] not in moved:
            s = s * trips[d]
    s = s.reshape(((batch if lead else 1,) if batch > 1 else ()) +
                  tuple(n if d in kept else 1 for d, n in enumerate(desc.out_trips)))
    ov, dims, neg = _strided(out, desc.out_trips, desc.out_o, desc.o0,
                             desc.o_numel if batch > 1 else None)
    if len(dims) != n_out:
        raise ValueError("contraction: D's store does not move with every output dim")
    cur = ov.flip(neg) if neg else ov
    new = (cur.to(acc) + s).to(init.dtype)
    ov.copy_(new.flip(neg) if neg else new)
    return out


def probe(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.probe``: ``x + 1``."""
    return x + 1
