"""Grouped (per-expert) matmul of the MoE layers: (E, cap, d) @ (E, d, f).

Replaces the Pallas TPU kernel ``_gmm_kernel`` / ``grouped_matmul`` of
``src/repro/kernels/grouped_matmul.py`` (:18, :32) with the hand-written
CUDA kernels of ``csrc/grouped_matmul.cu``.

* Bound on the H100: bytes of the expert weights at decode (granite_moe_1b
  at batch 8: cap 8, 32 MiB a call, 0.0103 ms at 3.35 TB/s) and at the
  forward's capacities too (cap 640 at 4 x 512 tokens: 0.0288 ms of bytes
  against 0.0217 ms of tensor-core operations).
* Design: one block per (expert, m tile, n tile); the k axis, sequential on
  the TPU, is a loop inside the block with f32 sums in registers.  Two
  routes, chosen by ``autotune.gmm_route`` from the shape, the dtype and
  the operands' alignment:

  - tensor cores: bf16 with d and f multiples of 8 (16-byte row strides,
    what TMA needs) and 16-byte aligned x and w.  The mainloop of
    ``csrc/hopper_gemm.cuh`` with the expert in ``blockIdx.z`` and 3-D TMA
    descriptors, so a cap or d tail reads zeros, not the next expert.
    Tiles ``autotune.GMM_TC_TILES``, (bm, bn, bk) with bm >= 64: at decode
    the schedule picks the width that fills the SMs.
  - CUDA cores: f32 (TF32 would break its 1e-4 tolerance) and any bf16
    shape or pointer TMA cannot describe (d = 500, a misaligned operand).  Every edge masked; the tile
    height ``bm`` of ``autotune.GMM_BM`` follows cap (8 rows at decode, 128
    at the forward).

  ``tile=(bm, bn, bk)`` names the tensor-core route, ``bm=`` the CUDA-core
  route (a caller may run it on a shape the tensor cores take, as the tests
  do); ``ops.grouped_matmul`` always follows ``gmm_route``.

A CUDA tensor goes to a kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.grouped_matmul``.

The gradient (``GroupedMatmul``; no TPU counterpart: the reference lets XLA
differentiate its pure-jnp grouped matmul) is two more grouped matmuls on
the same kernels, dX = dY W^T and dW = X^T dY, each on a contiguous copy of
its transposed operand and with the tile ``autotune.pom_gmm_schedule``
picks for its shape (``grouped_matmul_backward``).  dW contracts over cap,
a multiple of 8 (``models.moe.capacity``), so bf16 keeps the tensor cores.
"""
from __future__ import annotations

import torch

from . import _build
from .autotune import (GMM_BM, GMM_NAIVE_BM, GMM_TC_NAIVE, GMM_TC_TILES, TENSOR_CORES, gmm_route,
                       pom_gmm_schedule)
from .ref import grouped_matmul as grouped_matmul_plain
from .ref import grouped_matmul_backward as grouped_matmul_backward_plain

# kernel launches, process-wide: through ``grouped_matmul``, all of them and
# those of the tensor-core route (the rest took the CUDA cores); and the same
# for the launches of ``grouped_matmul_backward`` (dX and dW, one each)
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
        lib = _build.load("grouped_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        if tc:
            fn = lib.grouped_matmul_tc_launch
            fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        else:
            fn = lib.grouped_matmul_launch
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        _FN[tc] = fn
    return _FN[tc]


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int | None = None,
                   tile: tuple | None = None) -> torch.Tensor:
    """x: (E, cap, d) @ w: (E, d, f) -> (E, cap, f) in x's dtype, f32 sums.

    ``tile`` (a tile of ``GMM_TC_TILES``) runs the tensor cores, ``bm`` (a
    height of ``GMM_BM``) the CUDA cores; with neither, the fixed tile of
    the route ``gmm_route`` picks."""
    global launches, launches_tc
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w)
    out, tc = _launch(x, w, bm, tile)
    launches += 1
    launches_tc += tc
    return out


def pom_tile(x: torch.Tensor, w: torch.Tensor) -> dict:
    """The tile ``autotune.pom_gmm_schedule`` picks for these operands (its
    route from their shape, dtype and alignment), as ``grouped_matmul``'s
    keyword argument ``tile`` (tensor cores) or ``bm`` (CUDA cores)."""
    e, cap, d = x.shape
    s = pom_gmm_schedule(e, cap, d, w.shape[2], x.element_size(),
                         aligned=not (x.data_ptr() % 16 or w.data_ptr() % 16))
    return {"tile": (s.bm, s.bn, s.bk)} if s.route == TENSOR_CORES else {"bm": s.bm}


def _launch(x: torch.Tensor, w: torch.Tensor, bm=None, tile=None) -> tuple:
    """One launch on CUDA tensors (not counted): (out, whether it took the
    tensor cores)."""
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_matmul: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: dtypes {x.dtype}/{w.dtype}; need both float32 "
                        "or both bfloat16")
    if w.device != x.device:
        raise ValueError(f"grouped_matmul: w on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: x and w must be contiguous")
    e, cap, d = x.shape
    f = w.shape[2]
    aligned = not (x.data_ptr() % 16 or w.data_ptr() % 16)
    route = gmm_route(e, cap, d, f, x.element_size(), aligned)
    if bm is not None and tile is not None:
        raise ValueError("grouped_matmul: give bm (CUDA cores) or tile (tensor cores), "
                         "not both")
    if bm is None and tile is None:
        if route == TENSOR_CORES:
            tile = GMM_TC_NAIVE
        else:
            bm = GMM_NAIVE_BM
    tc = tile is not None
    if tc:
        tile = tuple(tile)
        if tile not in GMM_TC_TILES:
            raise ValueError(f"grouped_matmul: tile {tile} not in {GMM_TC_TILES}")
        if not aligned:
            raise ValueError("grouped_matmul: the tensor-core route needs 16-byte aligned "
                             "x and w")
        if route != TENSOR_CORES:
            raise ValueError(f"grouped_matmul: tensor-core tile {tile} for E{e} cap{cap} d{d} "
                             f"f{f} {x.dtype}: the route needs bf16 with d and f multiples "
                             "of 8")
    elif bm not in GMM_BM:
        raise ValueError(f"grouped_matmul: bm {bm} not in {GMM_BM}")
    out = torch.empty((e, cap, f), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tc:
        rc = _kernel(True)(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, cap, d, f, *tile,
                           stream)
    else:
        rc = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, cap, d, f, bm,
                       _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error {rc}")
    return out, tc


def grouped_matmul_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                            needs: tuple = (True, True)) -> tuple:
    """(dx, dw) of ``grouped_matmul(x, w)`` for the output gradient ``dy``
    (E, cap, f), in x's and w's dtypes (x's and w's must agree, as the
    forward requires), each None where ``needs`` (x, w) does not ask for it.
    On the card dx = grouped_matmul(dy, w^T) and dw = grouped_matmul(x^T,
    dy), each transposed operand copied to contiguous and each product on
    the tile of ``pom_tile``; on the CPU ``ref.grouped_matmul_backward``."""
    global launches_bwd, launches_bwd_tc
    if x.device.type == "cpu":
        return tuple(g if need else None
                     for g, need in zip(grouped_matmul_backward_plain(x, w, dy), needs))
    dy = dy.to(x.dtype).contiguous()
    grads = []
    for need, lhs, rhs in ((needs[0], dy, w.transpose(1, 2)), (needs[1], x.transpose(1, 2), dy)):
        if not need:
            grads.append(None)
            continue
        lhs, rhs = lhs.contiguous(), rhs.contiguous()
        g, tc = _launch(lhs, rhs, **pom_tile(lhs, rhs))
        launches_bwd += 1
        launches_bwd_tc += tc
        grads.append(g)
    return tuple(grads)


class GroupedMatmul(torch.autograd.Function):
    """The grouped matmul with its gradient: the forward kernel, and
    ``grouped_matmul_backward`` on the saved x and w.
    ``GroupedMatmul.apply(x, w, tile)``: ``tile`` is ``grouped_matmul``'s
    keyword arguments for the forward (``pom_tile``'s, or {} for the fixed
    tile of the route)."""

    @staticmethod
    def forward(ctx, x, w, tile):
        ctx.save_for_backward(x, w)
        return grouped_matmul(x, w, **tile)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = grouped_matmul_backward(x, w, dy, needs=tuple(ctx.needs_input_grad[:2]))
        return dx, dw, None
