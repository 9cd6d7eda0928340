"""Chunked selective scan (Mamba2 / SSD form) of the hybrid and ssm families.

Replaces the Pallas TPU kernel ``_ssm_kernel`` / ``ssm_scan`` of
``src/repro/kernels/ssm_scan.py`` (:28, :73) with the hand-written CUDA
kernel ``csrc/ssm_scan.cu``.

* Bound on the H100: operations (f32 on the CUDA cores) at zamba2's and
  xlstm's shapes: per chunk of L steps, L^2 N + L^2 P + 2 L N P
  multiply-adds on L (P + 2 N + 1) inputs.
* Design: one block per (b * h, P tile).  The chunk axis, sequential on the
  TPU, is a loop inside the block that carries h (N x P tile, f32) in shared
  memory; B and C are streamed over N in tiles of 32, so xlstm's N = 512
  fits.  ``autotune.pom_scan_schedule`` picks the chunk length and the P
  tile.  The tail chunk is padded (a = 1, b = 0, x = 0), so any S runs (the
  TPU kernel asserts S % L == 0).  b and c may broadcast one group over the
  heads with a head stride of 0 (zamba2), without copies.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.ssm_scan``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .autotune import SCAN_CHUNKS, SCAN_PTILES, scan_smem_bytes
from .ref import ssm_scan as ssm_scan_plain
from repro_torch.core.cost_model import H100

launches = 0          # kernel launches through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("ssm_scan").ssm_scan_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.POINTER(ctypes.c_int64),
                       i, i, i, i, i, i, i, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 64, p_tile: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P), a: (B, S, H), b/c: (B, S, H, N) -> (y (B, S, H, P) in
    x's dtype, final h (B, H, N, P) f32), from h = 0."""
    global launches
    if x.device.type == "cpu":
        return ssm_scan_plain(x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape \
            or a.shape != x.shape[:3] or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"ssm_scan: bad shapes x{tuple(x.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)}")
    bsz, s, nh, p = x.shape
    n = b.shape[3]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan: x is {x.dtype}; need float32 or bfloat16")
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} is {t.dtype}; need float32")
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"ssm_scan: the last dim of {name} must be contiguous")
    if chunk not in SCAN_CHUNKS or p_tile not in SCAN_PTILES:
        raise ValueError(f"ssm_scan: chunk {chunk} / P tile {p_tile} not in "
                         f"{SCAN_CHUNKS} / {SCAN_PTILES}")
    if scan_smem_bytes(chunk, p_tile, n) > H100.smem_bytes:
        raise ValueError(f"ssm_scan: chunk {chunk}, P tile {p_tile}, N {n} exceed the "
                         "shared memory of one block")
    y = torch.empty((bsz, s, nh, p), dtype=x.dtype, device=x.device)
    h = torch.empty((bsz, nh, n, p), dtype=torch.float32, device=x.device)
    import ctypes
    strides = (ctypes.c_int64 * 12)(*[st for t in (x, a, b, c) for st in t.stride()[:3]])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                   h.data_ptr(), strides, bsz, nh, s, p, n, chunk, p_tile, _DTYPES[x.dtype],
                   stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, h
