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
"""
from __future__ import annotations

import torch

from . import _build
from .autotune import GMM_BM, GMM_NAIVE_BM, GMM_TC_NAIVE, GMM_TC_TILES, TENSOR_CORES, gmm_route
from .ref import grouped_matmul as grouped_matmul_plain

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
    launches += 1
    launches_tc += tc
    return out
