"""Public wrappers over the port's kernels (the ``ops.py`` contract).

Every op takes ``schedule='pom' | 'naive'`` (POM-DSE block sizes from
``autotune`` vs fixed defaults).  There is no ``impl`` and no ``interpret``:
the device of the tensors decides.  A CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version.
"""
from __future__ import annotations

from .autotune import pom_attention_schedule, pom_decode_schedule
from .decode_attention import decode_attention as _decode_cuda
from .flash_attention import flash_attention as _flash_cuda


def attention(q, k, v, *, causal: bool = True, schedule: str = "pom"):
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    if schedule == "pom":
        s = pom_attention_schedule(q.shape[2], k.shape[2], q.shape[3],
                                   q.element_size(), causal)
        bq, bkv = s.bq, s.bkv
    elif schedule == "naive":
        bq = bkv = 64
    else:
        raise ValueError(f"schedule must be 'pom' or 'naive', got {schedule!r}")
    return _flash_cuda(q, k, v, causal=causal, bq=bq, bkv=bkv)


def decode_attention(q, k, v, *, length=None, schedule: str = "pom"):
    """q: (B, Hq, D), k/v: (B, Hkv, S, D), length: (B,) int32 -> (B, Hq, D)."""
    if schedule == "pom":
        bkv = pom_decode_schedule(k.shape[2], q.shape[2], q.shape[1] // k.shape[1],
                                  q.element_size()).bkv
    elif schedule == "naive":
        bkv = 64
    else:
        raise ValueError(f"schedule must be 'pom' or 'naive', got {schedule!r}")
    return _decode_cuda(q, k, v, length=length, bkv=bkv)
