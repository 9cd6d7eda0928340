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
to the plain version ``ref.attention``; a ``meta`` tensor to a shape-only
branch that counts the kernel's work (``meta.py``).

**The backward** (``flash_attention_backward``, ``csrc/flash_attention_bwd.cu``;
``FlashAttention`` is the ``torch.autograd.Function`` that joins the two):

* Computes dq, dk, dv of the forward from q, k, v, its output o, each
  row's log-sum-exp (``flash_attention(..., return_lse=True)``, f32, natural
  log) and the output gradient: P = exp(S scale - lse), dV = sum over the
  group of P^T dO, dP = dO V^T, Delta = rowsum(dO o O), dS = P o (dP -
  Delta), dQ = scale dS K, dK = scale sum over the group of dS^T Q
  (``ref.attention_backward`` is the same formula in plain PyTorch).
* No TPU counterpart: the reference trains on its pure-jnp attention
  (``use_pallas`` False) and XLA differentiates it, with no ``custom_vjp``
  and no backward Pallas kernel.  The port's training step on the card runs
  the flash forward, so it needs this gradient, and never builds the
  Sq x Skv score matrix.
* Bound on the H100: at smollm_360m's training shape (B 8, Hq 15, Hkv 5,
  S 256, D 64, bf16, causal) reading q, k, v, o, dO, lse and writing dq,
  dk, dv (~21 MB) take longer at 3.35 TB/s than the five causal products
  (~2.5x the forward's operations) at the bf16 tensor-core rate: bytes.
* Design: deterministic and free of atomics, on two routes chosen by
  ``autotune.attention_bwd_route``.  The tensor cores (bf16 at D 64 with
  16-byte aligned q, k, v, o, do and lse), two kernels on TMA and wgmma: dQ
  with one block per (b, q head, 64-row query tile), Delta folded into its
  prologue, a producer warp streaming K and V through a TMA ring and S, dP
  and dQ += dS K on wgmma (dS from registers); then dK and dV on a
  persistent grid (a block an SM) walking (b, kv head, 64-key tile) items,
  the longest first, a producer warp loading each item's K and V and
  streaming each step's Q, dO, lse and Delta through a four-stage ring,
  and two consumer warpgroups taking an item's (query head, query tile)
  steps in turn, whose sums meet in shared memory in a fixed order.  P and
  dS round to bf16 as the forward rounds P.  The CUDA cores (f32, D 32 and
  128, misaligned operands), three kernels: Delta in f32, one warp a row; dK and dV with
  one block per (b, kv head, key tile), K and V staged in shared memory,
  looping over the group's query heads and the query tiles on or below the
  diagonal with dK and dV in f32 registers; dQ with one block per (b, q
  head, query tile) looping over the key tiles; tiles
  ``autotune.FLASH_BWD_TILES``.  One ``launches_bwd`` count a call, and
  ``launches_bwd_tc`` of those on the tensor cores.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from . import meta as _meta
from .autotune import (CUDA_CORES, FLASH_BKV, FLASH_BQ, FLASH_NAIVE, FLASH_TC_NAIVE,
                       FLASH_TC_TILES, HEAD_DIMS, TENSOR_CORES, attention_bwd_route,
                       attention_route)
from .ref import attention as flash_attention_plain
from .ref import attention_backward as flash_attention_backward_plain
from .ref import attention_lse as flash_attention_lse_plain

# kernel launches through the forward wrapper, process-wide: all of them, and
# those of the tensor-core route (the rest took the CUDA cores); and calls of
# the backward wrapper (three kernels each)
launches = 0
launches_tc = 0
launches_bwd = 0
launches_bwd_tc = 0

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
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        else:
            fn = lib.flash_attention_launch
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        _FN[tc] = fn
    return _FN[tc]


def _check_qkv(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **more) -> None:
    """Raises on what the kernels do not take: a device other than cuda,
    shapes that do not match, mixed or unsupported dtypes, a tensor on
    another device or not contiguous (q, k, v and ``more``)."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{fn}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"{fn}: q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{fn}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "need all float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bq: Optional[int] = None, bkv: Optional[int] = None,
                    return_lse: bool = False):
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D), and with
    ``return_lse`` also each row's log-sum-exp (B, Hq, Sq) f32 (-inf for a
    row that sees no key), as the backward needs it.

    (bq, bkv) is the tile of ``FLASH_TC_TILES`` (tensor cores) or one of
    ``FLASH_BQ`` x ``FLASH_BKV`` (CUDA cores); without one, the fixed tile of
    the route ``attention_route`` picks."""
    global launches, launches_tc
    if q.device.type == "cpu":
        if return_lse:
            return flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type == "meta":
        _meta.add("flash_attention", *_meta.attention(q, k, causal, return_lse))
        out = torch.empty_like(q)
        return (out, q.new_empty(q.shape[:3], dtype=torch.float32)) if return_lse else out
    _check_qkv("flash_attention", q, k, v)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
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
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, b, hq, hkv, sq, skv, d,
            *tile, int(causal), scale)
    if tc:
        rc = _kernel(True)(*args, stream)
    else:
        rc = _kernel()(*args, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_tc += tc
    return (out, lse) if return_lse else out


def _bwd_kernel(tc: bool):
    """The C entry point of the backward (``csrc/flash_attention_bwd.cu``) on
    the CUDA cores, or (``tc``) on the tensor cores."""
    key = ("bwd", tc)
    if key not in _FN:
        import ctypes
        lib = _build.load("flash_attention_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        if tc:
            fn = lib.flash_attention_bwd_tc_launch
            fn.argtypes = [p] * 10 + [i] * 7 + [ctypes.c_float, p]
        else:
            fn = lib.flash_attention_bwd_launch
            fn.argtypes = [p] * 10 + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = i
        _FN[key] = fn
    return _FN[key]


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, scale: Optional[float] = None,
                             route: Optional[str] = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` for the output gradient
    ``do``, from its output ``o`` and ``lse`` (B, Hq, Sq) f32.  Each in its
    input's dtype; a query head's share of dk, dv is summed into its kv
    head.

    ``route``: the route ``attention_bwd_route`` picks for the shape, the
    dtype and the alignment of q, k, v, o, do and lse (the tensor cores for
    bf16 at D 64), or ``CUDA_CORES`` to force the CUDA-core kernels, as the
    tests do; ``TENSOR_CORES`` where the route does not take the input
    raises."""
    global launches_bwd, launches_bwd_tc
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal, scale=scale)
    if q.device.type == "meta":
        _meta.add("flash_attention_bwd", *_meta.attention_backward(q, k, causal))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_qkv("flash_attention_backward", q, k, v, o=o, do=do, lse=lse)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: o{tuple(o.shape)} {o.dtype} and "
                         f"do{tuple(do.shape)} {do.dtype} must match q{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse{tuple(lse.shape)} {lse.dtype}, "
                         f"need ({b}, {hq}, {sq}) float32")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_backward: head_dim {d} not among {HEAD_DIMS}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, o, do, lse))
    best = attention_bwd_route(sq, skv, d, q.element_size(), aligned)
    if route is None:
        route = best
    if route not in (TENSOR_CORES, CUDA_CORES) or (route == TENSOR_CORES and best != route):
        raise ValueError(f"flash_attention_backward: route {route!r} for D {d} {q.dtype} "
                         f"(16-byte aligned: {aligned}); the tensor cores need bf16, D 64 and "
                         "16-byte aligned q, k, v, o, do and lse")
    tc = route == TENSOR_CORES
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    delta = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, hq, hkv, sq, skv, d, int(causal), scale)
    if tc:
        rc = _bwd_kernel(True)(*args, stream)
    else:
        rc = _bwd_kernel(False)(*args, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: CUDA error {rc}")
    launches_bwd += 1
    launches_bwd_tc += tc
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel run with an lse
    buffer, the backward kernel on the saved q, k, v, o and lse (on a CPU
    tensor, ``ref.attention_lse`` and ``ref.attention_backward``).

    ``FlashAttention.apply(q, k, v, causal, scale, bq, bkv)``; ``scale``,
    ``bq`` and ``bkv`` may be None as in ``flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bq, bkv):
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale, bq=bq, bkv=bkv,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do.contiguous(),
                                              causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None
