"""The table of peaks (``perfbench/peaks.json``): one H100's data-sheet
rates.  A float32 operand of a tensor-core product is held to the TF32 rate
(the card's fastest way to multiply float32 data), bfloat16 and float16 to
the dense 16-bit rate."""
from __future__ import annotations

import json
from pathlib import Path

import torch

_TABLE = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())
FLOPS_PER_S = {k: float(v) for k, v in _TABLE["flops_per_s"].items()}
BYTES_PER_S = float(_TABLE["bytes_per_s"])
MODEL_PEAK = FLOPS_PER_S["bfloat16"]


def for_dtype(dtype: torch.dtype) -> float:
    """The product rate that bounds a kernel whose operands are ``dtype``."""
    return FLOPS_PER_S["tf32"] if dtype == torch.float32 else FLOPS_PER_S["bfloat16"]
