"""The once-per-process CUDA toolchain probe: ``o = x + 1`` on 8 f32.

Replaces the Pallas TPU probe ``_probe_kernel`` of
``src/repro/core/backend_pallas.py`` (:150, behind ``mosaic_supported``) with
the hand-written CUDA kernel ``csrc/probe.cu``.  It is CUDA rather than
Triton on purpose: it must exercise the toolchain the contraction kernel
uses (``nvcc`` -> plain-C ``.so`` -> ``ctypes``).

* Bound on the H100: launch latency; 64 bytes of work.
* Design: one thread per element, one launch.

A CUDA tensor goes to the kernel (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.probe``.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import probe as probe_plain

launches = 0          # kernel launches through this wrapper, process-wide

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        import ctypes
        fn = _build.load("probe").probe_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def probe(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a contiguous float32 vector."""
    global launches
    if x.device.type == "cpu":
        return probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("probe: needs a non-empty contiguous float32 vector")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
