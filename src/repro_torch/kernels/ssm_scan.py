"""Chunked selective scan (Mamba2 / SSD form) of the hybrid and ssm families.

Replaces the Pallas TPU kernel ``_ssm_kernel`` / ``ssm_scan`` of
``src/repro/kernels/ssm_scan.py`` (:28, :73) with the hand-written CUDA
kernels of ``csrc/ssm_scan.cu``.

* Bound on the H100: the products on the tensor cores at zamba2's and
  xlstm's shapes (C B^T, the chunk states, the intra-chunk output and the
  readout of the carried state), and the device traffic of the chunk states.
* Design: the TPU grid's sequential chunk axis becomes the SSD
  decomposition, four device kernels a call (one ``launches`` count): C B^T
  once per (batch, B/C group, chunk) in tiles on and below the diagonal (so
  once for all of zamba2's 32 heads), each chunk's N x P state, a pass over
  the chunk states (sequential only over the chunks, parallel over b * h *
  N * P), and the readout (parallel over (b * h, chunk, P tile)).  The
  products run as mma.sync TF32 with every f32 operand split into two TF32
  parts (three passes; two for the products with a bf16 x, which is exact
  in TF32), so the result keeps f32 accuracy; tiles stream through shared
  memory with cp.async, two stages deep.  ``autotune.pom_scan_schedule``
  picks the chunk length and the P tile.  The tail chunk is padded (a = 1,
  b = c = 0, x = 0), so any S runs (the TPU kernel asserts S % L == 0).  b
  and c may broadcast one group over the heads with a head stride of 0
  (zamba2), without copies.  x's dtype names the precision route
  (``autotune.SCAN_ROUTES``).

A CUDA tensor goes to the kernels (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.ssm_scan``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .autotune import SCAN_NAIVE, SCAN_TILES, scan_smem_bytes
from .ref import ssm_scan as ssm_scan_plain
from repro_torch.core.cost_model import H100

launches = 0          # calls through this wrapper (four device kernels each), process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("ssm_scan").ssm_scan_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_int64),
                       i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def bc_groups(b: torch.Tensor, c: torch.Tensor) -> int:
    """B/C groups a batch: 1 where b and c both broadcast one group over the
    heads (a head stride of 0, or one head), else the number of heads."""
    nh = b.shape[2]
    return 1 if nh == 1 or (b.stride(2) == 0 and c.stride(2) == 0) else nh


def ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = SCAN_NAIVE[0],
             p_tile: int = SCAN_NAIVE[1]) -> Tuple[torch.Tensor, torch.Tensor]:
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
    if (chunk, p_tile) not in SCAN_TILES:
        raise ValueError(f"ssm_scan: (chunk {chunk}, P tile {p_tile}) not in {SCAN_TILES}")
    if scan_smem_bytes(chunk, p_tile) > H100.smem_bytes:
        raise ValueError(f"ssm_scan: chunk {chunk}, P tile {p_tile} exceed the shared memory "
                         "of one block")
    groups = bc_groups(b, c)
    nc = -(-s // chunk)
    y = torch.empty((bsz, s, nh, p), dtype=x.dtype, device=x.device)
    h = torch.empty((bsz, nh, n, p), dtype=torch.float32, device=x.device)
    gmat = torch.empty((bsz * groups * nc * chunk * chunk,), dtype=torch.float32,
                       device=x.device)
    states = torch.empty((bsz * nh * nc * n * p,), dtype=torch.float32, device=x.device)
    cums = torch.empty((bsz * nh * nc * chunk,), dtype=torch.float32, device=x.device)
    import ctypes
    strides = (ctypes.c_int64 * 12)(*[st for t in (x, a, b, c) for st in t.stride()[:3]])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                   h.data_ptr(), gmat.data_ptr(), states.data_ptr(), cums.data_ptr(), strides,
                   bsz, nh, s, p, n, groups, chunk, p_tile, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, h
