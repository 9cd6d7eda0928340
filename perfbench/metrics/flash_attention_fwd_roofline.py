"""``flash_attention_fwd_roofline``: the share of its roofline that ``repro_torch.kernels.ops._flash_cuda``
reaches in the traced window (counts: ``perfbench/counts/flash_attention_fwd.py``)."""
from __future__ import annotations

from perfbench.lib.trace import KernelSpan, roofline

SPAN = KernelSpan("repro_torch.kernels.ops", "_flash_cuda", "flash_attention_fwd")


def read(name, trace):
    return roofline(trace, SPAN)
