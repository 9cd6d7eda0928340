"""``grouped_matmul_bwd_roofline``: the share of its roofline that ``repro_torch.kernels.grouped_matmul.grouped_matmul_backward``
reaches in the traced window (counts: ``perfbench/counts/grouped_matmul_bwd.py``)."""
from __future__ import annotations

from perfbench.lib.trace import KernelSpan, roofline

SPAN = KernelSpan("repro_torch.kernels.grouped_matmul", "grouped_matmul_backward", "grouped_matmul_bwd")


def read(name, trace):
    return roofline(trace, SPAN)
