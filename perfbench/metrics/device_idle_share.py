"""``device_idle_share.<kind>``: the share of the traced window in which no
operation ran on the card (one minus the union of the device intervals), in
%."""
from __future__ import annotations


def read(name, trace):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
