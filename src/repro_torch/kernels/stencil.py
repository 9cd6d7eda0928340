"""Jacobi-2D stencil: ``steps`` sweeps of 0.2 * (N + S + W + E + C) over
the interior of (M, N), the boundary passing through.

Replaces the Pallas TPU kernel ``_jacobi_kernel`` / ``jacobi2d_step`` /
``jacobi2d`` of ``src/repro/kernels/stencil.py`` (:19, :37, :61) with the
hand-written CUDA kernels of ``csrc/stencil.cu``.

* Bound on the H100: bytes (each pass reads and writes M N cells once).
* Design: up to T sweeps a launch, ceil(steps / T) launches a call (the TPU
  wrapper launches once per sweep), ping-ponging between two buffers.  A
  block of the multi-sweep kernel loads its tile and a halo of T cells into
  shared memory once, sweeps T times there and writes its tile once; T and
  the tile come from ``autotune.pom_jacobi_schedule``.  T = 1 runs the
  single-sweep kernel (32 x 32 tiles and a one-cell halo).  No state
  crosses blocks, so any M and N run (the TPU wrapper asserts M % 128 == 0
  above 128 rows).  The math is f32, with one rounding to x's dtype a sweep,
  as on the TPU, so every T gives the bits of ``steps`` single sweeps.

A CUDA tensor goes to the kernels (or the wrapper raises); a CPU tensor
goes to the plain version ``ref.jacobi2d``; a ``meta`` tensor to a
shape-only branch that counts the kernels' work (``meta.py``).
"""
from __future__ import annotations

import torch

from . import _build
from . import meta as _meta
from .autotune import JACOBI_MAX_WIDTH, JACOBI_TILE, JACOBI_TILES, jacobi_plan, \
    jacobi_smem_bytes, pom_jacobi_schedule
from .ref import jacobi2d as jacobi2d_plain
from repro_torch.core.cost_model import H100

launches = 0          # kernel launches (one per T sweeps) through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def _kernel(name: str):
    """The C entry point ``name`` of the stencil library: ``jacobi2d_launch``
    (one sweep) or ``jacobi2d_sweeps_launch`` (T sweeps)."""
    if name not in _FNS:
        import ctypes
        fn = getattr(_build.load("stencil"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, p, i, i, i, p] if name == "jacobi2d_launch"
                       else [p, p, i, i, i, i, i, i, p])
        fn.restype = i
        _FNS[name] = fn
    return _FNS[name]


def jacobi2d(x: torch.Tensor, steps: int = 1, *, sweeps: int = 0,
             tile: tuple = None) -> torch.Tensor:
    """``steps`` sweeps of x (M, N); ``steps = 0`` returns x.  ``sweeps``
    (T) and ``tile`` default to ``autotune.pom_jacobi_schedule``'s; a launch
    runs up to T sweeps (T = 1 on the single-sweep kernel)."""
    global launches
    if x.device.type == "cpu":
        return jacobi2d_plain(x, steps)
    if x.device.type == "meta":
        _meta.add("stencil", *_meta.jacobi2d(x, steps))
        return torch.empty_like(x)
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
    if not sweeps:
        sc = pom_jacobi_schedule(m, n, steps, x.element_size())
        sweeps, tile = sc.sweeps, sc.tile
    tile = tuple(tile or (JACOBI_TILE if sweeps == 1 else JACOBI_TILES[-1]))
    if sweeps < 1:
        raise ValueError(f"jacobi2d: sweeps a launch must be >= 1, got {sweeps}")
    if sweeps > 1 and (tile not in JACOBI_TILES
                       or jacobi_smem_bytes(tile, sweeps) > H100.smem_bytes
                       or tile[1] + 2 * sweeps > JACOBI_MAX_WIDTH):
        raise ValueError(f"jacobi2d: {sweeps} sweeps a launch on tile {tile}: the tile is not "
                         f"one of {JACOBI_TILES} or the halo does not fit in shared memory")
    plan = jacobi_plan(steps, sweeps)
    bufs = [torch.empty_like(x) for _ in range(min(len(plan), 2))]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dt = _DTYPES[x.dtype]
    src = x
    for i, t in enumerate(plan):
        dst = bufs[i % 2]
        if t == 1:
            rc = _kernel("jacobi2d_launch")(src.data_ptr(), dst.data_ptr(), m, n, dt, stream)
        else:
            rc = _kernel("jacobi2d_sweeps_launch")(src.data_ptr(), dst.data_ptr(), m, n, t,
                                                   tile[0], tile[1], dt, stream)
        if rc != 0:
            raise RuntimeError(f"jacobi2d kernel launch failed: CUDA error {rc}")
        launches += 1
        src = dst
    return src
