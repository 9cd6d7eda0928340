"""Flash-decode attention: one new token per (batch, query head) against a
KV cache with a per-row valid length.

Replaces the Pallas TPU kernel ``_decode_kernel`` of
``src/repro/kernels/decode_attention.py`` with the hand-written CUDA kernel
``csrc/decode_attention.cu``.

* Bound on the H100: bytes.  The work is ~group FLOPs per byte of the valid
  K/V prefix, far below the card's ~295 FLOP/byte balance point.
* Design: split KV.  Each (batch, kv head) gets ``splits`` CTAs, one
  thread-block cluster, that share its valid prefix and serve all
  ``group`` query heads (``autotune.decode_heads_per_cta`` at a time: the
  whole group for groups up to 8), so every valid KV row is read
  from device memory once and B x Hkv x splits CTAs fill the SMs.  Each lane
  loads 16 bytes of a K or V row into registers; the online softmax and the
  accumulator run in f32 registers; the partials (max, sum, acc) merge by
  shuffles, through shared memory, and across the cluster through
  distributed shared memory, always in the same order, so a call gives the
  same bits every time.  One launch a call, nothing allocated but the
  output.  ``autotune.pom_decode_schedule`` picks ``splits`` from the
  shapes (never from ``length``: the host does not sync).  The TPU
  kernel walks and masks the whole cache and asserts ``S % bkv == 0``; any
  S works here.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.decode_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .autotune import DECODE_MAX_SPLITS, HEAD_DIMS, decode_heads_per_cta, pom_decode_schedule
from .ref import decode_attention as decode_attention_plain

launches = 0          # kernel launches through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}


def _kernel(name: str = "decode_attention_launch"):
    """The C entry point ``name`` of the decode library: the launch, or
    ``decode_attention_max_clusters``."""
    if name not in _FN:
        import ctypes
        fn = getattr(_build.load("decode_attention"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "decode_attention_launch":
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        else:
            fn.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        fn.restype = i
        _FN[name] = fn
    return _FN[name]


def max_active_clusters(d: int, heads: int, splits: int, dtype: torch.dtype) -> int:
    """How many clusters of ``splits`` CTAs of the (dtype, d, heads) kernel
    the current card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes
    n = ctypes.c_int(0)
    rc = _kernel("decode_attention_max_clusters")(d, heads, splits, _DTYPES[dtype],
                                                  ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {rc}")
    return n.value


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None, splits: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, D), k/v: (B, Hkv, S, D), length: (B,) -> (B, Hq, D).

    ``splits`` CTAs (1-8) share each (batch, kv head); without it,
    ``pom_decode_schedule``'s."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length=length, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "need all float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if length.shape != (b,) or length.dtype != torch.int32 or length.device != q.device \
            or not length.is_contiguous():
        raise ValueError("decode_attention: length must be a contiguous (B,) int32 "
                         "tensor on q's device")
    group = hq // hkv
    if splits is None:
        splits = pom_decode_schedule(b * hkv, s, group, d, q.element_size()).splits
    if not 1 <= splits <= DECODE_MAX_SPLITS:
        raise ValueError(f"decode_attention: splits {splits} not in 1..{DECODE_MAX_SPLITS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                   out.data_ptr(), b, hq, hkv, s, d, decode_heads_per_cta(group), splits,
                   scale * math.log2(math.e), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
