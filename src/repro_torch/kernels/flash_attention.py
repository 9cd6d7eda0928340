"""Flash attention (prefill) with native GQA and an aligned-suffix causal mask.

Replaces the Pallas TPU kernel ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` (:27) with the hand-written CUDA
kernels of ``csrc/flash_attention.cu``.

* Bound on the H100: at the port's prefill shapes (smollm_360m: Hq 15,
  Hkv 5, D 64, bf16, S 512, causal) the bytes of q, k, v and o take longer
  at 3.35 TB/s than the causal FLOPs at the bf16 tensor-core rate, so the
  bound is bytes.
* Design: one block per (b * Hq + h, q tile); the KV tiles are a loop inside
  the block with the online softmax per row in f32.  KV tiles wholly above
  the causal diagonal are skipped.  The kv head is ``h // (Hq // Hkv)``.
  Ragged Sq and Skv are masked rather than asserted.  Two routes, chosen by
  ``autotune.attention_route`` from the shape, the dtype and the alignment:

  - tensor cores: bf16 with D in ``FLASH_TC_DIMS`` (64, 128) and 16-byte
    aligned q, k, v.  128-row q tiles on two consumer warpgroups, K and V
    through a two-stage TMA ring, S = Q K^T and O += P V on wgmma with P
    rounded to bf16 in registers.  One tile, ``autotune.FLASH_TC_TILES``.
  - CUDA cores: f32, D 32 and any other shape or pointer, computing in f32
    with K and V staged in shared memory.  Tiles ``FLASH_BQ`` x
    ``FLASH_BKV``.

  The tile names its route (the tensor-core tile is 128 rows tall), so a
  caller may run a CUDA-core tile on a shape the tensor cores take, as the
  tests do; ``ops.attention`` always follows ``attention_route``.
* Tolerance of the tensor-core route: the TPU kernel sums f32 products of
  f32-cast operands; this route rounds P to bf16 before P V, as every
  Hopper flash kernel does.  P lies in [0, 1] and rounds to 2^-9 relative,
  and the output is a P-weighted mean of V rows, so the rounding moves it
  by at most ~2^-9 of max |V| before its own bf16 rounding (2^-9 relative):
  well inside the bf16 tolerance of 2e-2 it is held to.

A CUDA tensor goes to a kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .autotune import (FLASH_BKV, FLASH_BQ, FLASH_NAIVE, FLASH_TC_NAIVE, FLASH_TC_TILES,
                       HEAD_DIMS, TENSOR_CORES, attention_route)
from .ref import attention as flash_attention_plain

# kernel launches through this wrapper, process-wide: all of them, and those
# of the tensor-core route (the rest took the CUDA cores)
launches = 0
launches_tc = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}


def _kernel(tc: bool = False):
    """The C entry point of the CUDA-core route, or (``tc``) of the
    tensor-core route."""
    if tc not in _FN:
        import ctypes
        lib = _build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        if tc:
            fn = lib.flash_attention_tc_launch
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        else:
            fn = lib.flash_attention_launch
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        _FN[tc] = fn
    return _FN[tc]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bq: Optional[int] = None, bkv: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    (bq, bkv) is the tile of ``FLASH_TC_TILES`` (tensor cores) or one of
    ``FLASH_BQ`` x ``FLASH_BKV`` (CUDA cores); without one, the fixed tile of
    the route ``attention_route`` picks."""
    global launches, launches_tc
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "need all float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    aligned = not (q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16)
    route = attention_route(sq, skv, d, q.element_size(), aligned)
    tile = (bq, bkv)
    if tile == (None, None):
        tile = FLASH_TC_NAIVE if route == TENSOR_CORES else FLASH_NAIVE
    tc = tile in FLASH_TC_TILES
    if tc and route != TENSOR_CORES:
        raise ValueError(f"flash_attention: tensor-core tile {tile} for D {d} {q.dtype} "
                         f"(16-byte aligned: {aligned}): the route needs bf16, D 64 or 128 "
                         "and 16-byte aligned q, k and v")
    if not tc and (d not in HEAD_DIMS or tile[0] not in FLASH_BQ or tile[1] not in FLASH_BKV):
        raise ValueError(f"flash_attention: head_dim {d}, tile {tile} not among "
                         f"{HEAD_DIMS}, {FLASH_BQ} x {FLASH_BKV} or {FLASH_TC_TILES}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, d,
            *tile, int(causal), scale)
    if tc:
        rc = _kernel(True)(*args, stream)
    else:
        rc = _kernel()(*args, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_tc += tc
    return out
