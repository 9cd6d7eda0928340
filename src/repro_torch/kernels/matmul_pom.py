"""POM-scheduled tiled matmul: (M, K) @ (K, N) with f32 sums.

Replaces the Pallas TPU kernel ``_matmul_kernel`` / ``matmul`` of
``src/repro/kernels/matmul_pom.py`` (:26, :39) with the hand-written CUDA
kernels of ``csrc/matmul_pom.cu``.

* Bound on the H100: operations at the sizes it is called with (2 M N K
  against M K + K N + M N elements): 0.139 ms at 4096^3 in bf16 on the
  tensor cores (989 TFLOP/s), 2.05 ms in f32 on the CUDA cores (67).
* Design: one block per (bm, bn) output tile; the k axis, sequential on
  the TPU (f32 scratch zeroed at the first k step, flushed at the last), is
  a loop inside the block with the f32 sums in registers.  Two routes,
  chosen by ``autotune.matmul_route`` from the shape, the dtype and the
  operands' alignment:

  - tensor cores: bf16 with K and N multiples of 8 (16-byte row strides,
    what TMA needs) and 16-byte aligned x and y.  The mainloop of
    ``csrc/hopper_gemm.cuh``: TMA loads into a ring of swizzled stages,
    wgmma, zero-filled tails.  Tiles ``autotune.MATMUL_TC_TILES``.
  - CUDA cores: f32 (TF32 would break its 1e-4 tolerance) and any bf16
    shape or pointer TMA cannot describe (K = 70, an operand 8 bytes off a
    16-byte boundary).  Every edge masked.  Tiles
    ``autotune.MATMUL_TILES``.

  The tile names its route (the tensor-core tiles are 64 deep, the
  CUDA-core ones 16 or 32), so a caller may also run a CUDA-core tile on a
  shape the tensor cores take, as the tests and ``tools/matmul_tiles.py``
  do; ``ops.matmul`` always follows ``matmul_route``.

A CUDA tensor goes to a kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.matmul``.
"""
from __future__ import annotations

import torch

from . import _build
from .autotune import (MATMUL_NAIVE, MATMUL_TC_NAIVE, MATMUL_TC_TILES, MATMUL_TILES,
                       TENSOR_CORES, matmul_route)
from .ref import matmul as matmul_plain

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
        lib = _build.load("matmul_pom")
        p, i = ctypes.c_void_p, ctypes.c_int
        if tc:
            fn = lib.matmul_pom_tc_launch
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        else:
            fn = lib.matmul_pom_launch
            fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        _FN[tc] = fn
    return _FN[tc]


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int | None = None, bn: int | None = None,
           bk: int | None = None) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, f32 sums.

    (bm, bn, bk) is a tile of ``MATMUL_TC_TILES`` (tensor cores) or of
    ``MATMUL_TILES`` (CUDA cores); without one, the fixed tile of the route
    ``matmul_route`` picks."""
    global launches, launches_tc
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {x.device}")
    if x.dim() != 2 or y.dim() != 2 or y.shape[0] != x.shape[1]:
        raise ValueError(f"matmul: bad shapes x{tuple(x.shape)} y{tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"matmul: dtypes {x.dtype}/{y.dtype}; need both float32 or both "
                        "bfloat16")
    if y.device != x.device:
        raise ValueError(f"matmul: y on {y.device}, x on {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul: x and y must be row-major contiguous")
    m, k = x.shape
    n = y.shape[1]
    aligned = not (x.data_ptr() % 16 or y.data_ptr() % 16)
    route = matmul_route(m, n, k, x.element_size(), aligned)
    tile = (bm, bn, bk)
    if tile == (None, None, None):
        tile = MATMUL_TC_NAIVE if route == TENSOR_CORES else MATMUL_NAIVE
    tc = tile in MATMUL_TC_TILES
    if not tc and tile not in MATMUL_TILES:
        raise ValueError(f"matmul: tile {tile} not in {MATMUL_TC_TILES + MATMUL_TILES}")
    if tc and not aligned:
        raise ValueError("matmul: the tensor-core route needs 16-byte aligned x and y")
    if tc and route != TENSOR_CORES:
        raise ValueError(f"matmul: tensor-core tile {tile} for {m}x{k}x{n} {x.dtype}: the "
                         "route needs bf16 with K and N multiples of 8")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tc:
        rc = _kernel(True)(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, *tile, stream)
    else:
        rc = _kernel()(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, *tile,
                       _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_tc += tc
    return out
