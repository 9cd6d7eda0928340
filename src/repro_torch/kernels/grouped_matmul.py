"""Grouped (per-expert) matmul of the MoE layers: (E, cap, d) @ (E, d, f).

Replaces the Pallas TPU kernel ``_gmm_kernel`` / ``grouped_matmul`` of
``src/repro/kernels/grouped_matmul.py`` (:18, :32) with the hand-written
CUDA kernel ``csrc/grouped_matmul.cu``.

* Bound on the H100: bytes of the expert weights at decode (granite_moe_1b
  at batch 8: cap 8), operations at the forward's capacities (cap 640 at
  4 x 512 tokens; f32 CUDA cores in this first version).
* Design: one block per (expert, m tile, n tile); the k axis, sequential on
  the TPU, is a loop inside the block with f32 sums in registers.  The tile
  height ``bm`` follows cap (``autotune.pom_gmm_schedule``: 8 rows at
  decode, 128 at the forward), and every edge is masked, so cap, d and f
  need not be multiples of anything (the TPU kernel asserts they are).

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.grouped_matmul``.
"""
from __future__ import annotations

import torch

from . import _build
from .autotune import GMM_BM
from .ref import grouped_matmul as grouped_matmul_plain

launches = 0          # kernel launches through this wrapper, process-wide

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("grouped_matmul").grouped_matmul_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        _FN = fn
    return _FN


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 64) -> torch.Tensor:
    """x: (E, cap, d) @ w: (E, d, f) -> (E, cap, f) in x's dtype, f32 sums."""
    global launches
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
    if bm not in GMM_BM:
        raise ValueError(f"grouped_matmul: bm {bm} not in {GMM_BM}")
    e, cap, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, cap, f), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, cap, d, f, bm,
                   _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
