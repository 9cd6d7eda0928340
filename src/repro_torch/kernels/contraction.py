"""One scheduled POM contraction statement ``D = D + X * Y`` of any rank.

Replaces the Pallas TPU kernel ``kernel`` of ``src/repro/core/backend_pallas.py``
(:286, built in ``_lower_stmt_pallas_compute``) with the hand-written CUDA
kernel ``csrc/contraction.cu``.

* What it takes: a ``ContractionDesc`` from the lowering
  (``repro_torch.core.backend_cuda``), which has linearised every access:
  per statement dim, the offset coefficient of X, Y and D; output dims (those
  in the store access) and reduction dims (the rest) with their trip counts;
  a constant offset per array that folds in the lower bounds.  Tensors are
  contiguous, all of D's dtype (f32, bf16 or f64), and carry an optional
  leading batch: a tensor of ``B * numel`` elements is B lanes, one of
  ``numel`` elements is shared by every lane.
* Bound on the H100: operations at the gemm sizes of the compile path
  (2 n^3 f32 FLOPs on CUDA cores, TF32 off), bytes for matrix-vector shapes.
* Design: two kernels in one source.  GEMM-shaped statements (every output
  dim moves X or Y but not both; M and N at least one 128 tile; f32 or
  bf16) take a shared-memory tiled kernel: 128 x 128 output tiles, 8 x 8
  outputs per thread in registers, X and Y gathered through per-statement
  offset tables (``gemm_tables``).  Every other statement takes the generic
  kernel: one thread per output point, the DSE's block dims innermost, the
  reduction (grid and block dims) a loop inside the thread.  Both sum each
  output's products in k order in f32 (f64 for f64) and cast once.  See the
  source note in the ``.cu`` file.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.contraction``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .ref import contraction as contraction_plain
from .ref import offset_grid

MAX_DIMS = 16                 # descriptor capacity per dim class (kMaxDims)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

launches = 0          # kernel launches through this wrapper, process-wide

_FN = None
_GEMM_FN = None
TILE = 128            # the tiled kernel's output tile edge (kBM = kBN in the .cu)
GEMM_MIN = TILE       # M and N from which a GEMM-shaped statement takes the tiled
                      # kernel: each fills at least one whole tile
_TABLES: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
_TABLES_MAX = 256


@dataclass(frozen=True)
class ContractionDesc:
    """A linearised contraction statement (see the module docstring).

    ``out_*`` lists the output dims outermost first (the DSE's grid dims,
    then its block dims), ``red_*`` the reduction dims; ``*_x``, ``*_y`` and
    ``out_o`` are element offsets per unit step of the dim in X, Y and D.
    ``x_numel``/``y_numel``/``o_numel`` are one lane's array sizes."""
    out_trips: Tuple[int, ...]
    out_x: Tuple[int, ...]
    out_y: Tuple[int, ...]
    out_o: Tuple[int, ...]
    red_trips: Tuple[int, ...]
    red_x: Tuple[int, ...]
    red_y: Tuple[int, ...]
    x0: int
    y0: int
    o0: int
    x_numel: int
    y_numel: int
    o_numel: int

    @property
    def points(self) -> int:
        n = 1
        for t in self.out_trips:
            n *= t
        return n

    @property
    def red_points(self) -> int:
        n = 1
        for t in self.red_trips:
            n *= t
        return n

    def flops(self) -> int:
        """Multiply-adds x 2 that one lane of the statement performs."""
        return 2 * self.points * self.red_points


class _C(ctypes.Structure):
    """The C ``ContractionDesc`` of ``csrc/contraction.cu``."""
    _fields_ = [("n_out", ctypes.c_int32), ("n_red", ctypes.c_int32)] + [
        (f, ctypes.c_int64 * MAX_DIMS)
        for f in ("out_trip", "out_x", "out_y", "out_o", "red_trip", "red_x", "red_y")
    ] + [(f, ctypes.c_int64) for f in ("x0", "y0", "o0", "batch", "bx", "by", "bo",
                                        "points", "red_points")]


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("contraction").contraction_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.POINTER(_C), ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _gemm_kernel():
    global _GEMM_FN
    if _GEMM_FN is None:
        fn = _build.load("contraction").contraction_gemm_launch
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_void_p), i64, i64, i64, i64,
                       i64, i64, i64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _GEMM_FN = fn
    return _GEMM_FN


def gemm_view(desc: ContractionDesc) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(M dims, N dims) when the statement is GEMM-shaped: every output dim
    leaves Y constant (an M dim) or X constant (an N dim), and both M and N
    reach ``GEMM_MIN``.  ``None`` otherwise."""
    m_dims, n_dims = [], []
    for i, (cx, cy) in enumerate(zip(desc.out_x, desc.out_y)):
        if cy == 0:
            m_dims.append(i)
        elif cx == 0:
            n_dims.append(i)
        else:
            return None
    m = n = 1
    for i in m_dims:
        m *= desc.out_trips[i]
    for i in n_dims:
        n *= desc.out_trips[i]
    if m < GEMM_MIN or n < GEMM_MIN or desc.red_points == 0:
        return None
    return tuple(m_dims), tuple(n_dims)


def gemm_tables(desc: ContractionDesc, view, device) -> Tuple[torch.Tensor, ...]:
    """The six offset tables (mx, mo, ny, no, kx, ky) of a GEMM-shaped
    statement, built once per descriptor and device."""
    key = (desc, str(device))
    hit = _TABLES.get(key)
    if hit is not None:
        return hit
    m_dims, n_dims = view
    pick = lambda vals, dims: [vals[i] for i in dims]  # noqa: E731
    mt, nt = pick(desc.out_trips, m_dims), pick(desc.out_trips, n_dims)
    tabs = (offset_grid(mt, pick(desc.out_x, m_dims), desc.x0, device),
            offset_grid(mt, pick(desc.out_o, m_dims), desc.o0, device),
            offset_grid(nt, pick(desc.out_y, n_dims), desc.y0, device),
            offset_grid(nt, pick(desc.out_o, n_dims), 0, device),
            offset_grid(desc.red_trips, desc.red_x, 0, device),
            offset_grid(desc.red_trips, desc.red_y, 0, device))
    if len(_TABLES) >= _TABLES_MAX:
        _TABLES.clear()
    _TABLES[key] = tabs
    return tabs


def _lanes(t: torch.Tensor, numel: int, name: str) -> int:
    """How many lanes of ``numel`` elements ``t`` holds."""
    if numel <= 0 or t.numel() % numel:
        raise ValueError(f"contraction: {name} has {t.numel()} elements, "
                         f"not a multiple of {numel}")
    return t.numel() // numel


def _batch_stride(t: torch.Tensor, numel: int, batch: int, name: str) -> int:
    """Element stride between lanes of ``t``: ``numel``, or 0 when shared."""
    n = _lanes(t, numel, name)
    if n == batch:
        return numel if batch > 1 else 0
    if n == 1:
        return 0
    raise ValueError(f"contraction: {name} holds {n} lanes, D holds {batch}")


def _to_c(desc: ContractionDesc, batch: int, bx: int, by: int, bo: int) -> _C:
    c = _C()
    c.n_out, c.n_red = len(desc.out_trips), len(desc.red_trips)
    for field, vals in (("out_trip", desc.out_trips), ("out_x", desc.out_x),
                        ("out_y", desc.out_y), ("out_o", desc.out_o),
                        ("red_trip", desc.red_trips), ("red_x", desc.red_x),
                        ("red_y", desc.red_y)):
        arr = getattr(c, field)
        for i, v in enumerate(vals):
            arr[i] = v
    c.x0, c.y0, c.o0 = desc.x0, desc.y0, desc.o0
    c.batch, c.bx, c.by, c.bo = batch, bx, by, bo
    c.points, c.red_points = desc.points, desc.red_points
    return c


def contraction(desc: ContractionDesc, x: torch.Tensor, y: torch.Tensor,
                init: torch.Tensor) -> torch.Tensor:
    """D's updated contents: ``init`` plus the statement's sum of products.

    ``init`` is not modified.  Returns a new tensor of ``init``'s shape and
    dtype."""
    global launches
    if init.device.type == "cpu":
        return contraction_plain(desc, x, y, init)
    if init.device.type != "cuda":
        raise ValueError(f"contraction: unsupported device {init.device}")
    if len(desc.out_trips) > MAX_DIMS or len(desc.red_trips) > MAX_DIMS:
        raise ValueError(f"contraction: more than {MAX_DIMS} output or reduction dims")
    if init.dtype not in DTYPES or x.dtype != init.dtype or y.dtype != init.dtype:
        raise TypeError(f"contraction: dtypes x {x.dtype}, y {y.dtype}, D {init.dtype}; "
                        "need one of float32, bfloat16, float64 for all three")
    for name, t in (("x", x), ("y", y)):
        if t.device != init.device:
            raise ValueError(f"contraction: {name} on {t.device}, D on {init.device}")
    for name, t in (("x", x), ("y", y), ("D", init)):
        if not t.is_contiguous():
            raise ValueError(f"contraction: {name} must be contiguous")
    batch = _lanes(init, desc.o_numel, "D")
    bx = _batch_stride(x, desc.x_numel, batch, "x")
    by = _batch_stride(y, desc.y_numel, batch, "y")
    out = init.clone()
    if batch * desc.points == 0:
        return out
    bo = desc.o_numel if batch > 1 else 0
    stream = torch.cuda.current_stream(init.device).cuda_stream
    view = gemm_view(desc) if init.dtype != torch.float64 and batch <= 65535 else None
    if view is not None:
        tabs = gemm_tables(desc, view, init.device)
        ptrs = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in tabs])
        rc = _gemm_kernel()(x.data_ptr(), y.data_ptr(), out.data_ptr(), ptrs,
                            tabs[0].numel(), tabs[2].numel(), tabs[4].numel(), batch,
                            bx, by, bo, DTYPES[init.dtype], stream)
    else:
        c = _to_c(desc, batch, bx, by, bo)
        rc = _kernel()(x.data_ptr(), y.data_ptr(), out.data_ptr(), ctypes.byref(c),
                       DTYPES[init.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"contraction kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
