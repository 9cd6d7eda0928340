"""POM-scheduled tiled matmul: (M, K) @ (K, N) with f32 sums.

Replaces the Pallas TPU kernel ``_matmul_kernel`` / ``matmul`` of
``src/repro/kernels/matmul_pom.py`` (:26, :39) with the hand-written CUDA
kernels of ``csrc/matmul_pom.cu``.

* Bound on the H100: operations at the sizes it is called with (2 M N K
  against M K + K N + M N elements): 0.139 ms at 4096^3 in bf16 on the
  tensor cores (989 TFLOP/s), 2.05 ms in f32 on the CUDA cores (67).
* Design: one block per (bm, bn) output tile; the k axis, sequential on
  the TPU (f32 scratch zeroed at the first k step, flushed at the last), is
  a loop inside the block with the f32 sums in registers.  Three routes,
  chosen by ``autotune.matmul_route`` from the shape, the dtype and the
  operands' alignment:

  - tensor cores: bf16 with K and N multiples of 8 (16-byte row strides,
    what TMA needs) and 16-byte aligned x and y.  The mainloop of
    ``csrc/hopper_gemm.cuh``: TMA loads into a ring of swizzled stages,
    wgmma, zero-filled tails.  Tiles ``autotune.MATMUL_TC_TILES``.
  - the ring: f32 with K and N multiples of 4 and 16-byte aligned x and y.
    The contraction's mainloop (``csrc/strided_gemm.cuh``): a four-stage
    shared-memory ring fed by 16-byte copies, one barrier a k step, its one
    tile ``autotune.MATMUL_RING_TILE``.  No TF32 (its 1e-4 tolerance).
  - CUDA cores: every other f32 shape or pointer and any bf16 shape or
    pointer TMA cannot describe (K = 70, an operand 8 bytes off a 16-byte
    boundary).  Every edge masked.  Tiles ``autotune.MATMUL_TILES``.

  The ring and the CUDA-core tiles sum each output in k order in one f32
  FMA chain, so on a shape both take they give the same bits.

  ``route`` names the kernel; without it a tile names its route (the
  tensor-core tiles are 64 deep, the CUDA-core ones 16 or 32; the ring's
  tile is also a CUDA-core tile, so the ring runs only by its route), and
  without a tile the route is ``matmul_route``'s.  So a caller may run a
  CUDA-core tile on a shape another route takes, as the tests and
  ``tools/matmul_tiles.py`` do; ``ops.matmul`` always follows
  ``matmul_route``.

A CUDA tensor goes to a kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.matmul``; a ``meta`` tensor to a shape-only
branch that counts the kernel's work (``meta.py``).
"""
from __future__ import annotations

import torch

from . import _build
from . import meta as _meta
from .autotune import (CUDA_CORES, MATMUL_NAIVE, MATMUL_RING_TILE, MATMUL_TC_NAIVE,
                       MATMUL_TC_TILES, MATMUL_TILES, RING, TENSOR_CORES, matmul_route)
from .ref import matmul as matmul_plain

# kernel launches through this wrapper, process-wide: all of them, and those
# of the tensor-core route and of the ring (the rest took the CUDA-core tiles)
launches = 0
launches_tc = 0
launches_ring = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}


def _kernel(route: str = CUDA_CORES):
    """The C entry point of ``route``."""
    if route not in _FN:
        import ctypes
        lib = _build.load("matmul_pom")
        p, i = ctypes.c_void_p, ctypes.c_int
        if route == TENSOR_CORES:
            fn = lib.matmul_pom_tc_launch
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        elif route == RING:
            fn = lib.matmul_pom_ring_launch
            fn.argtypes = [p, p, p, i, i, i, p]
        else:
            fn = lib.matmul_pom_launch
            fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        _FN[route] = fn
    return _FN[route]


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int | None = None, bn: int | None = None,
           bk: int | None = None, route: str | None = None) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, f32 sums.

    ``route`` is ``TENSOR_CORES``, ``RING`` or ``CUDA_CORES``, and (bm, bn,
    bk) a tile of it: of ``MATMUL_TC_TILES``, ``MATMUL_RING_TILE`` or
    ``MATMUL_TILES``.  Without a route, the tile's (a tensor-core or a
    CUDA-core tile), or without either ``matmul_route``'s; without a tile,
    the fixed tile of the route."""
    global launches, launches_tc, launches_ring
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    if x.device.type == "meta":
        _meta.add("matmul_pom", *_meta.matmul(x, y))
        return x.new_empty((x.shape[0], y.shape[1]))
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
    tile = (bm, bn, bk)
    if route is None:
        route = (matmul_route(m, n, k, x.element_size(), aligned) if tile == (None,) * 3 else
                 TENSOR_CORES if tile in MATMUL_TC_TILES else CUDA_CORES)
    tiles = {TENSOR_CORES: MATMUL_TC_TILES, RING: (MATMUL_RING_TILE,),
             CUDA_CORES: MATMUL_TILES}.get(route)
    if tiles is None:
        raise ValueError(f"matmul: route {route!r} not one of {TENSOR_CORES!r}, {RING!r}, "
                         f"{CUDA_CORES!r}")
    if tile == (None,) * 3:
        tile = {TENSOR_CORES: MATMUL_TC_NAIVE, RING: MATMUL_RING_TILE}.get(route, MATMUL_NAIVE)
    if tile not in tiles:
        raise ValueError(f"matmul: tile {tile} is not a tile of the {route} route: {tiles}")
    if route != CUDA_CORES and matmul_route(m, n, k, x.element_size(), aligned) != route:
        raise ValueError(f"matmul: the {route} route does not take {m}x{k}x{n} {x.dtype} "
                         f"(aligned={aligned}): the tensor cores take bf16 with K and N "
                         "multiples of 8, the ring f32 with K and N multiples of 4, both with "
                         "16-byte aligned x and y")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == TENSOR_CORES:
        rc = _kernel(route)(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, *tile, stream)
    elif route == RING:
        rc = _kernel(route)(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, stream)
    else:
        rc = _kernel(route)(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, *tile,
                            _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_tc += route == TENSOR_CORES
    launches_ring += route == RING
    return out
