"""The Mamba2 scan's backward (``repro_torch.kernels.ssm_scan.scan_backward``).

Operations: three scans' products, 3 x 4 B S H N P, and the decay
gradient's reverse sum, 2 B S H (the arithmetic of ``kernels/meta.py``).
Bytes: x and dy read, dx written (x's dtype); a read and da written; b and
c read a B/C group (b's head axis, one group where it broadcasts over the
heads) and db and dc written in b's shape (a head where b broadcasts or
has one a head, a group where it holds G), in float32; dh_final read
where given.  The products
take float32 operands, so the peak is the TF32 rate."""
from __future__ import annotations

import torch

from perfbench.lib import peaks


def count(x, a, b, c, dy, dh_final=None, saved=None, needs=(True, True, True, True)):
    bsz, s, nh, p = x.shape
    n = b.shape[3]
    groups = 1 if b.stride(2) == 0 else b.shape[2]
    es = x.element_size()
    need_x, need_a, need_b, need_c = needs
    rows, heads = bsz * s * nh * p, bsz * s * nh
    byts = (2 + need_x) * rows * es + 4 * heads * (1 + need_a) \
        + 8 * bsz * s * groups * n + 4 * bsz * s * b.shape[2] * n * (need_b + need_c)
    if dh_final is not None:
        byts += 4 * bsz * nh * n * p
    flops = 3 * 4.0 * bsz * s * nh * n * p + 2.0 * heads
    return flops, float(byts), peaks.for_dtype(torch.float32)
