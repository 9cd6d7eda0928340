"""Shape-only calls of the kernels: what a dry run counts for them.

A kernel wrapper given ``meta`` tensors launches nothing and runs no plain
version (the plain scan loops over S): it returns empty outputs of the
shapes the kernel writes and adds the kernel's work here.  The work is that
of the kernel's roofline bound, as ``PERF.md`` reckons it: the bytes of
each input read once and each output written once, and the operations the
algorithm needs on them (a causal attention's visible half; a decode's
whole cache, since a ``meta`` length has no value).  Any other device
goes its own way: a CPU tensor to the plain version, a CUDA tensor to the
kernel.

``counts``: {kernel name: [calls, FLOPs, bytes]}, process-wide, as the
wrappers' launch counts are; ``reset()`` clears it.
"""
from __future__ import annotations

from typing import Dict, List

import torch

counts: Dict[str, List[float]] = {}


def reset() -> None:
    counts.clear()


def add(name: str, flops: float, byts: float) -> None:
    c = counts.setdefault(name, [0, 0.0, 0.0])
    c[0] += 1
    c[1] += float(flops)
    c[2] += float(byts)


def totals() -> Dict[str, float]:
    """{"flops", "bytes"} summed over every kernel."""
    return {"flops": sum(c[1] for c in counts.values()),
            "bytes": sum(c[2] for c in counts.values())}


def _visible(sq: int, skv: int, causal: bool) -> int:
    """Query-key pairs a (causal) attention computes: query i sees keys
    j <= i + (skv - sq)."""
    if not causal:
        return sq * skv
    off = skv - sq
    lo = min(sq, max(0, -off))             # rows [0, lo) see no key
    hi = min(sq, max(lo, skv - off - 1))   # rows [lo, hi) see i + off + 1, the rest skv
    return (hi - lo) * (lo + hi + 2 * off + 1) // 2 + (sq - hi) * skv


def decode_attention(q: torch.Tensor, k: torch.Tensor, lse: bool) -> tuple:
    """(FLOPs, bytes): K and V read once, q read and o (and lse) written."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    es = q.element_size()
    return 4.0 * b * hq * s * d, (2 * b * hkv * s * d + 2 * b * hq * d) * es + 4 * b \
        + (4 * b * hq if lse else 0)


def attention(q: torch.Tensor, k: torch.Tensor, causal: bool, lse: bool) -> tuple:
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    byts = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * q.element_size()
    return 4.0 * d * b * hq * _visible(sq, skv, causal), byts + (4 * b * hq * sq if lse else 0)


def attention_backward(q: torch.Tensor, k: torch.Tensor, causal: bool) -> tuple:
    """q, k, v, o, dO and lse read once, dq, dk, dv written once; the five
    products of the backward, 2.5x the forward's operations."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    byts = (4 * b * hq * sq * d + 4 * b * hkv * skv * d) * q.element_size() + 4 * b * hq * sq
    return 2.5 * 4.0 * d * b * hq * _visible(sq, skv, causal), byts


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> tuple:
    e, cap, d = x.shape
    f = w.shape[2]
    return 2.0 * e * cap * d * f, (e * cap * d + e * d * f + e * cap * f) * x.element_size()


def grouped_matmul_backward(x: torch.Tensor, w: torch.Tensor, needs: tuple) -> tuple:
    """dX = dY W^T and dW = X^T dY, each where asked for: each reads two of
    x, w, dY and writes the third's shape, a product as large as the
    forward's."""
    e, cap, d = x.shape
    f = w.shape[2]
    n = sum(bool(need) for need in needs[:2])
    byts = (e * cap * d + e * d * f + e * cap * f) * x.element_size()
    return n * 2.0 * e * cap * d * f, n * byts


def ssm_scan(x: torch.Tensor, b: torch.Tensor, groups: int) -> tuple:
    """x, a, b, c read once (b and c once a B/C group: ``groups`` a batch),
    y and h written."""
    bsz, s, nh, p = x.shape
    n = b.shape[3]
    byts = 2 * bsz * s * nh * p * x.element_size() + 4 * bsz * s * nh \
        + 8 * bsz * s * groups * n + 4 * bsz * nh * n * p
    return 4.0 * bsz * s * nh * n * p, byts


def ssm_scan_backward(x: torch.Tensor, b: torch.Tensor, groups: int) -> tuple:
    """x, a, b, c, dy read once; dx, da, db, dc written once; three scans'
    products (the decay gradient's sum: its parts and a read, da written)."""
    bsz, s, nh, p = x.shape
    n = b.shape[3]
    byts = (2 * bsz * s * nh * p * x.element_size() + 8 * bsz * s * nh
            + 8 * bsz * s * groups * n + 8 * bsz * s * nh * n) + 4 * 3 * bsz * s * nh
    return 3 * 4.0 * bsz * s * nh * n * p + 2.0 * bsz * s * nh, byts


def slstm_scan(z: torch.Tensor, save: bool) -> tuple:
    """z, i, f, o read once, y written (c and n too where a gradient is asked
    for); three multiplies, an add and a division a lane and step (c_t and
    y_t), a multiply and an add a head and step (n_t)."""
    b, s, h, hd = z.shape
    lanes, heads = b * s * h * hd, b * s * h
    byts = 4 * (2 * lanes + 3 * heads) + (4 * (lanes + heads) if save else 0)
    return 5.0 * lanes + 2.0 * heads, byts


def slstm_scan_backward(z: torch.Tensor) -> tuple:
    """z, c, dy read and dz written a lane and step, i, f, o, n read and di,
    df, do written a head and step; eleven operations a lane and step (dC_t,
    dz_t, three products and their sums over the lanes), about twelve a head
    and step (the dN chain and the three scalar gradients)."""
    b, s, h, hd = z.shape
    lanes, heads = b * s * h * hd, b * s * h
    return 11.0 * lanes + 12.0 * heads, 4 * (4 * lanes + 7 * heads)


def matmul(x: torch.Tensor, y: torch.Tensor) -> tuple:
    m, k = x.shape
    n = y.shape[1]
    return 2.0 * m * n * k, (m * k + k * n + m * n) * x.element_size()


def jacobi2d(x: torch.Tensor, steps: int) -> tuple:
    """The grid read and written once (one pass), five operations a point a
    sweep."""
    m, n = x.shape
    return 5.0 * steps * max(m - 2, 0) * max(n - 2, 0), 2 * m * n * x.element_size()
