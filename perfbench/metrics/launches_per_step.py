"""``launches_per_step.<kind>``: device activities (kernels, copies,
memsets) in the traced window over its steps."""
from __future__ import annotations


def read(name, trace):
    if not trace.launches or not trace.steps:
        return None
    return trace.launches / trace.steps
