"""Jacobi-2D stencil: ``steps`` sweeps of 0.2 * (N + S + W + E + C) over
the interior of (M, N), the boundary passing through.

Replaces the Pallas TPU kernel ``_jacobi_kernel`` / ``jacobi2d_step`` /
``jacobi2d`` of ``src/repro/kernels/stencil.py`` (:19, :37, :61) with the
hand-written CUDA kernel ``csrc/stencil.cu``.

* Bound on the H100: bytes (each sweep reads and writes M N cells once).
* Design: one launch per sweep, as the TPU wrapper launches once per step,
  ping-ponging between two buffers.  Each block loads a 32 x 32 tile and
  its one-cell halo through masked loads; no state crosses blocks (the TPU
  grid axis is "arbitrary" but carries nothing), so any M and N run (the
  TPU wrapper asserts M % 128 == 0 above 128 rows).  The math is f32, with
  one rounding to x's dtype a sweep, as on the TPU.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.jacobi2d``.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import jacobi2d as jacobi2d_plain

launches = 0          # kernel launches (one per sweep) through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("stencil").jacobi2d_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def jacobi2d(x: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """``steps`` sweeps of x (M, N); ``steps = 0`` returns x."""
    global launches
    if x.device.type == "cpu":
        return jacobi2d_plain(x, steps)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi2d: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"jacobi2d: x must be 2-D, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"jacobi2d: dtype {x.dtype}; need float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("jacobi2d: x must be row-major contiguous")
    if steps < 0:
        raise ValueError(f"jacobi2d: steps must be >= 0, got {steps}")
    if steps == 0 or x.numel() == 0:
        return x
    m, n = x.shape
    bufs = [torch.empty_like(x) for _ in range(min(steps, 2))]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    for s in range(steps):
        dst = bufs[s % 2]
        rc = _kernel()(src.data_ptr(), dst.data_ptr(), m, n, _DTYPES[x.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"jacobi2d kernel launch failed: CUDA error {rc}")
        launches += 1
        src = dst
    return src
