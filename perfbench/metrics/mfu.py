"""``mfu.<kind>``: model FLOPs of the traced window's steps (the
configuration's count, ``perfbench/counts/model_<reference>.py`` or
``model.py``) over its wall time and the card's dense bf16 peak, in %.
The float32 unembedding is held to the same peak.  Nothing where the
configuration has no count."""
from __future__ import annotations

from perfbench.lib import peaks


def read(name, trace):
    flops = trace.info.get("flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * peaks.MODEL_PEAK)
