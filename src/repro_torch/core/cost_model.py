"""Roofline model of one NVIDIA H100 SXM, for kernel schedules.

The port of the roofline part of ``repro.core.cost_model`` (``TpuSpec``,
``RooflineTerms``, ``TpuModel``).  Figures are NVIDIA's data-sheet numbers
for the H100 SXM at its 700 W limit: 989e12 dense bf16 tensor-core FLOP/s,
67e12 f32 FLOP/s outside the tensor cores, 3.35e12 B/s of HBM3, 232,448 B
of shared memory a block can use, 132 SMs.  A card set below 700 W runs
slower than these peaks.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HopperSpec:
    peak_flops_bf16: float = 989e12    # dense tensor cores, bf16/fp16
    peak_flops_f32: float = 67e12      # CUDA cores, no tensor cores
    hbm_bw: float = 3.35e12            # bytes/s
    smem_bytes: int = 232_448          # dynamic shared memory a block can use
    num_sms: int = 132


H100 = HopperSpec()


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)


class HopperModel:
    """Roofline estimates for kernels on one H100."""

    def __init__(self, spec: HopperSpec = H100):
        self.spec = spec

    def kernel_terms(self, flops: float, hbm_bytes: float,
                     tensor_cores: bool = True) -> RooflineTerms:
        peak = self.spec.peak_flops_bf16 if tensor_cores else self.spec.peak_flops_f32
        return RooflineTerms(flops / peak, hbm_bytes / self.spec.hbm_bw)
