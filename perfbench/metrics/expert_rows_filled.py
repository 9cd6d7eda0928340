"""``expert_rows_filled.<kind>``: the share of the rows the MoE layers'
grouped matmuls run that hold a kept (token, choice) pair, in %, from the
program's own counters (``repro_torch.core.telemetry.REGISTRY``'s
``moe.rows_filled`` over ``moe.rows_computed``).  ``moe_apply`` counts
only while a sink records, which in a run of a cell is its traced window
alone, and only in the forward run, not the remat's re-run.  None where the
program counts no such rows (a program without the counters, or a model
without experts)."""
from __future__ import annotations

from repro_torch.core.telemetry import REGISTRY


def read(name, trace):
    counts = REGISTRY.counter_values("moe.")
    if not counts.get("moe.rows_computed"):
        return None
    return 100.0 * counts.get("moe.rows_filled", 0) / counts["moe.rows_computed"]
