"""Flash-decode attention: one new token per (batch, query head) against a
KV cache with a per-row valid length.

Replaces the Pallas TPU kernel ``_decode_kernel`` of
``src/repro/kernels/decode_attention.py`` with the hand-written CUDA kernel
``csrc/decode_attention.cu``.

* Bound on the H100: bytes.  The work is ~group FLOPs per byte of the valid
  K/V prefix, far below the card's ~295 FLOP/byte balance point.
* Design: one block per (batch, kv head) serves all ``group`` query heads,
  so every valid KV row is read from device memory once; the KV walk is a
  loop inside the block that stops at ``length[b]`` (the TPU kernel walks and
  masks the whole cache, and asserts ``S % bkv == 0``; any S works here).
  m, l and acc are f32 in shared memory, reductions are warp shuffles.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.decode_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .autotune import HEAD_DIMS, decode_smem_bytes
from .ref import decode_attention as decode_attention_plain
from repro_torch.core.cost_model import H100

launches = 0          # kernel launches through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("decode_attention").decode_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None, bkv: int = 64) -> torch.Tensor:
    """q: (B, Hq, D), k/v: (B, Hkv, S, D), length: (B,) -> (B, Hq, D)."""
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
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if length.shape != (b,) or length.dtype != torch.int32 or length.device != q.device \
            or not length.is_contiguous():
        raise ValueError("decode_attention: length must be a contiguous (B,) int32 "
                         "tensor on q's device")
    if decode_smem_bytes(hq // hkv, d, bkv) > H100.smem_bytes:
        raise ValueError(f"decode_attention: group {hq // hkv}, head_dim {d}, bkv {bkv} "
                         "exceed the shared memory of one block")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                   out.data_ptr(), b, hq, hkv, s, d, bkv, scale, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
