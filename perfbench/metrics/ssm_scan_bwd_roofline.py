"""``ssm_scan_bwd_roofline``: the share of its roofline that ``repro_torch.kernels.ssm_scan.scan_backward``
reaches in the traced window (counts: ``perfbench/counts/ssm_scan_bwd.py``)."""
from __future__ import annotations

from perfbench.lib.trace import KernelSpan, roofline

SPAN = KernelSpan("repro_torch.kernels.ssm_scan", "scan_backward", "ssm_scan_bwd")


def read(name, trace):
    return roofline(trace, SPAN)
