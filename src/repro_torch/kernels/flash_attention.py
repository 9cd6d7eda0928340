"""Flash attention (prefill) with native GQA and an aligned-suffix causal mask.

Replaces the Pallas TPU kernel ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` with the hand-written CUDA kernel
``csrc/flash_attention.cu``.

* Bound on the H100: at the port's prefill shapes (smollm_360m: Hq 15,
  Hkv 5, D 64, bf16, S 512, causal) the bytes of q, k, v and o take longer
  at 3.35 TB/s than the causal FLOPs at the bf16 tensor-core rate, so the
  bound is bytes.
* Design: one block per (b * Hq + h, q tile of ``bq`` rows); the KV tiles are
  staged in shared memory in a loop inside the block, with the online
  softmax per row in f32.  KV tiles wholly above the causal diagonal are
  skipped.  The kv head is computed as ``h // (Hq // Hkv)`` from an explicit
  (b, h) split.  Ragged Sq and Skv are masked rather than asserted.  This
  first version computes on the CUDA cores; tensor cores (wgmma) and TMA are
  later work.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .autotune import FLASH_BKV, FLASH_BQ, HEAD_DIMS
from .ref import attention as flash_attention_plain

launches = 0          # kernel launches through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("flash_attention").flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bq: int = 64, bkv: int = 64) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if d not in HEAD_DIMS or bq not in FLASH_BQ or bkv not in FLASH_BKV:
        raise ValueError(f"flash_attention: head_dim {d}, bq {bq}, bkv {bkv} not among "
                         f"{HEAD_DIMS}, {FLASH_BQ}, {FLASH_BKV}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "need all float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, hq, hkv, sq, skv, d, bq, bkv, int(causal), scale,
                   _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
