"""PyTorch + CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The port imports ``torch`` and numpy, never ``jax`` and never ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
host without a card they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

# f32 matrix products in full f32 on the card, never TF32 (PyTorch's default
# for matmul, cuDNN's is TF32): the port is held to f32 tolerances.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and none is present; the CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
