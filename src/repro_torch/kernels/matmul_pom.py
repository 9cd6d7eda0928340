"""POM-scheduled tiled matmul: (M, K) @ (K, N) with f32 sums.

Replaces the Pallas TPU kernel ``_matmul_kernel`` / ``matmul`` of
``src/repro/kernels/matmul_pom.py`` (:26, :39) with the hand-written CUDA
kernel ``csrc/matmul_pom.cu``.

* Bound on the H100: operations at the sizes it is called with (2 M N K
  against M K + K N + M N elements); this first version computes on the f32
  CUDA cores, so in bf16 it stays far from the tensor-core bound.
* Design: one block per (bm, bn) output tile; the k axis, sequential on the
  TPU (f32 scratch zeroed at the first k step, flushed at the last), is a
  loop inside the block with the f32 sums in registers.  The tile comes
  from ``autotune.pom_matmul_schedule`` and must be one of
  ``autotune.MATMUL_TILES``.  Every edge is masked, so M, N and K need not
  be multiples of anything (the TPU wrapper copies zero-padded inputs).

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.matmul``.
"""
from __future__ import annotations

import torch

from . import _build
from .autotune import MATMUL_NAIVE, MATMUL_TILES
from .ref import matmul as matmul_plain

launches = 0          # kernel launches through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("matmul_pom").matmul_pom_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = MATMUL_NAIVE[0],
           bn: int = MATMUL_NAIVE[1], bk: int = MATMUL_NAIVE[2]) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, f32 sums."""
    global launches
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
    if (bm, bn, bk) not in MATMUL_TILES:
        raise ValueError(f"matmul: tile {(bm, bn, bk)} not in {MATMUL_TILES}")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
                   _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
