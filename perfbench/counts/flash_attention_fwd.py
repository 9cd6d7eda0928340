"""Flash attention's forward (``repro_torch.kernels.flash_attention.
flash_attention``, as ``ops`` calls it).  Operations: 4 D a visible
query-key pair (Q K^T and P V), a causal attention's visible pairs only.
Bytes: q, k, v read, o written, lse written where asked for
(``kernels/meta.py``)."""
from __future__ import annotations

from perfbench.lib import peaks


def visible(sq: int, skv: int, causal: bool) -> int:
    """Query-key pairs a (causal) attention computes: query i sees keys
    j <= i + (skv - sq)."""
    if not causal:
        return sq * skv
    off = skv - sq
    lo = min(sq, max(0, -off))
    hi = min(sq, max(lo, skv - off - 1))
    return (hi - lo) * (lo + hi + 2 * off + 1) // 2 + (sq - hi) * skv


def count(q, k, v, *, causal=True, scale=None, bq=None, bkv=None, return_lse=False):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    byts = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * q.element_size()
    if return_lse:
        byts += 4 * b * hq * sq
    return 4.0 * d * b * hq * visible(sq, skv, causal), float(byts), peaks.for_dtype(q.dtype)
