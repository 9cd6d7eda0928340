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

Row counts: ``rows``, a device int32 array (E,) of each expert's filled
rows (the MoE dispatch's, where capacity pads every expert to cap), makes
the rows of out[e] at or past rows[e] zeros, whatever x holds there.  Both
routes skip those tiles' products and store their zeros, so three
quarters of the tiles of a dropless forward at granite's training shape
run no mainloop.

A CUDA tensor goes to a kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.grouped_matmul``; a ``meta`` tensor to a shape-only
branch that counts the kernel's work (``meta.py``, every row: dense).

The gradient (``GroupedMatmul``; no TPU counterpart: the reference lets XLA
differentiate its pure-jnp grouped matmul) is two more grouped matmuls on
the same kernels, dX = dY W^T and dW = X^T dY (``grouped_matmul_backward``),
each reading the saved x and w where they lie: the tensor-core route reads
w as a K-major B operand and x as an MN-major A operand (wgmma's transpose
bits), the CUDA-core route indexes them.  No transposed operand is copied.
Both products take the forward's route (bf16 with d and f multiples of 8,
x and w aligned: cap needs no multiple of 8, since dW's contraction over
cap is a row count of TMA boxes) with the tiles of
``autotune.gmm_bwd_schedules``.  The backward takes no row counts: it is
the dense product's, the masked one's wherever dy's rows past the counts
are zero, as the MoE's are (no kept pair reads them).
"""
from __future__ import annotations

import torch

from . import _build
from . import meta as _meta
from .autotune import (GMM_BM, GMM_NAIVE_BM, GMM_TC_NAIVE, GMM_TC_TILES, TENSOR_CORES,
                       gmm_bwd_schedules, gmm_route, pom_gmm_schedule)
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
# the kernels' operand layouts: out = x @ w, x @ w^T (w stored (E, f, d)),
# x^T @ w (x stored (E, d, cap))
_FORWARD, _W_T, _X_T = 0, 1, 2
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
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        else:
            fn = lib.grouped_matmul_launch
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        _FN[tc] = fn
    return _FN[tc]


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None, *,
                   bm: int | None = None, tile: tuple | None = None) -> torch.Tensor:
    """x: (E, cap, d) @ w: (E, d, f) -> (E, cap, f) in x's dtype, f32 sums;
    with ``rows`` (E,) int32 on x's device, the rows of out[e] at or past
    rows[e] are zeros.

    ``tile`` (a tile of ``GMM_TC_TILES``) runs the tensor cores, ``bm`` (a
    height of ``GMM_BM``) the CUDA cores; with neither, the fixed tile of
    the route ``gmm_route`` picks."""
    global launches, launches_tc
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, rows)
    if x.device.type == "meta":
        _meta.add("grouped_matmul", *_meta.grouped_matmul(x, w))
        return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))
    out, tc = _launch(x, w, rows, bm, tile)
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


def _check(x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None) -> None:
    """Raises on operands the kernels do not take: a device other than
    cuda, shapes that do not chain, mixed or unsupported dtypes, an operand
    on another device or not contiguous, row counts that are not (E,)
    int32 on x's device."""
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
    if rows is not None and (rows.shape != (x.shape[0],) or rows.dtype != torch.int32
                             or rows.device != x.device or not rows.is_contiguous()):
        raise ValueError(f"grouped_matmul: rows {rows.dtype}{tuple(rows.shape)} on "
                         f"{rows.device}; need contiguous int32 ({x.shape[0]},) on {x.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, rows=None, bm=None, tile=None) -> tuple:
    """One launch on CUDA tensors (not counted): (out, whether it took the
    tensor cores)."""
    _check(x, w, rows)
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
    return _run(x, w, e, cap, d, f, _FORWARD, tile, bm, rows), tc


def _run(x: torch.Tensor, w: torch.Tensor, e: int, m: int, k: int, n: int, layout: int,
         tile, bm, rows=None) -> torch.Tensor:
    """One launch of (e, m, k) @ (e, k, n) -> (e, m, n) in the operand
    ``layout`` (x and w as they lie), on the tensor-core ``tile`` or, where
    it is None, the CUDA-core height ``bm``; the rows of out[e] at or past
    ``rows[e]`` zeros where row counts are given."""
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counts = None if rows is None else rows.data_ptr()
    if tile is not None:
        rc = _kernel(True)(x.data_ptr(), w.data_ptr(), out.data_ptr(), counts, e, m, k, n,
                           *tile, layout, stream)
    else:
        rc = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), counts, e, m, k, n, bm,
                       _DTYPES[x.dtype], layout, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error {rc}")
    return out


def grouped_matmul_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                            needs: tuple = (True, True)) -> tuple:
    """(dx, dw) of ``grouped_matmul(x, w)`` for the output gradient ``dy``
    (E, cap, f), in x's and w's dtypes (x's and w's must agree, as the
    forward requires), each None where ``needs`` (x, w) does not ask for it.
    On the card dx = dy w^T and dw = x^T dy, one launch each on the tiles of
    ``gmm_bwd_schedules``, reading x and w in place (dy is copied only where
    it is not contiguous in x's dtype); on the CPU
    ``ref.grouped_matmul_backward``."""
    global launches_bwd, launches_bwd_tc
    if x.device.type == "cpu":
        return tuple(g if need else None
                     for g, need in zip(grouped_matmul_backward_plain(x, w, dy), needs))
    if x.device.type == "meta":
        _meta.add("grouped_matmul_bwd", *_meta.grouped_matmul_backward(x, w, needs))
        return tuple(torch.empty_like(t) if need else None for t, need in zip((x, w), needs))
    _check(x, w)
    e, cap, d = x.shape
    f = w.shape[2]
    if dy.shape != (e, cap, f) or dy.device != x.device:
        raise ValueError(f"grouped_matmul_backward: dy{tuple(dy.shape)} on {dy.device}, need "
                         f"({e}, {cap}, {f}) on {x.device}")
    dy = dy.to(x.dtype).contiguous()
    aligned = not (x.data_ptr() % 16 or w.data_ptr() % 16 or dy.data_ptr() % 16)
    grads = []
    # dX (e, cap, d) = dY (e, cap, f) W^T: w read as B K-major; dW (e, d, f) =
    # X^T dY: x read as A MN-major
    for need, lhs, rhs, (m, k, n), layout, sched in zip(
            needs, (dy, x), (w, dy), ((cap, f, d), (d, cap, f)), (_W_T, _X_T),
            gmm_bwd_schedules(e, cap, d, f, x.element_size(), aligned=aligned)):
        if not need:
            grads.append(None)
            continue
        tc = sched.route == TENSOR_CORES
        grads.append(_run(lhs, rhs, e, m, k, n, layout, (sched.bm, sched.bn, sched.bk)
                          if tc else None, sched.bm))
        launches_bwd += 1
        launches_bwd_tc += tc
    return tuple(grads)


class GroupedMatmul(torch.autograd.Function):
    """The grouped matmul with its gradient: the forward kernel, and
    ``grouped_matmul_backward`` on the saved x and w.
    ``GroupedMatmul.apply(x, w, tile, rows)``: ``tile`` is ``grouped_matmul``'s
    keyword arguments for the forward (``pom_tile``'s, or {} for the fixed
    tile of the route), ``rows`` its row counts or None.  The backward is
    dense (the module docstring says when that is the masked product's)."""

    @staticmethod
    def forward(ctx, x, w, tile, rows=None):
        ctx.save_for_backward(x, w)
        return grouped_matmul(x, w, rows, **tile)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = grouped_matmul_backward(x, w, dy, needs=tuple(ctx.needs_input_grad[:2]))
        return dx, dw, None, None
