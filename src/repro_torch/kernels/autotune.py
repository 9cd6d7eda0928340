"""POM stage-2 DSE applied to the port's kernel schedules on the H100 model.

The same bottleneck-oriented search as the JAX package's autotuner (one
loop per block dimension, every candidate scored by the roofline model, the
one with the smallest bound kept), retargeted at Hopper: the resource
constraint is the shared-memory footprint of the port's own kernels (at
most 232,448 bytes a block), and the block sizes are the ones those kernels
are compiled for.  Ties in the bound go to fewer sequential KV steps, then to
the smaller footprint (more blocks resident on an SM).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.cost_model import H100, HopperModel, HopperSpec, RooflineTerms

# block sizes compiled into csrc/flash_attention.cu and csrc/decode_attention.cu
FLASH_BQ = (32, 64)
FLASH_BKV = (32, 64, 128)
DECODE_BKV = (32, 64, 128, 256)
HEAD_DIMS = (32, 64, 128)


def flash_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Dynamic shared memory of one flash-attention block (f32 tiles)."""
    return 4 * (bq * (d + 1) + bkv * (d + 1) + bkv * d + bq * (bkv + 1) + 3 * bq)


def decode_smem_bytes(group: int, d: int, bkv: int) -> int:
    """Dynamic shared memory of one decode-attention block (f32): q, acc,
    p, the softmax state and the staged K (padded) and V tiles."""
    return 4 * (2 * group * d + group * bkv + 3 * group + bkv * (d + 1) + bkv * d)


@dataclass(frozen=True)
class MatmulSchedule:
    bm: int
    bn: int
    bk: int
    terms: RooflineTerms
    smem_bytes: int


def _pow2(lo: int, hi: int) -> List[int]:
    out, b = [], lo
    while b <= hi:
        out.append(b)
        b *= 2
    return out


@functools.lru_cache(maxsize=4096)
def pom_matmul_schedule(m: int, n: int, k: int, dtype_bytes: int = 2,
                        spec: HopperSpec = H100) -> MatmulSchedule:
    """Pick (bm, bn, bk) minimising the dominant roofline term.

    Device-memory traffic: reads = m*k*ceil(n/bn) + k*n*ceil(m/bm), write m*n.
    Shared memory: two stages of (bm*bk + bk*bn) input tiles; the f32
    accumulator lives in registers and may take at most half the register
    file (bm*bn <= 32768).  bm, bn are multiples of the 64-row wgmma tile,
    bk of its 16-element bf16 depth.  No port kernel takes these yet: the
    matmul kernel is still to be ported."""
    model = HopperModel(spec)
    best: Optional[MatmulSchedule] = None
    for bm in _pow2(64, 256):
        for bn in _pow2(64, 256):
            if bm * bn > 32768:
                continue
            for bk in _pow2(32, 128):
                smem = 2 * (bm * bk + bk * bn) * dtype_bytes
                if smem > spec.smem_bytes:
                    continue
                reads = m * k * (-(-n // bn)) + k * n * (-(-m // bm))
                terms = model.kernel_terms(2.0 * m * n * k, (reads + m * n) * dtype_bytes)
                cand = MatmulSchedule(bm, bn, bk, terms, smem)
                if best is None or cand.terms.bound_s < best.terms.bound_s:
                    best = cand
    assert best is not None
    return best


@dataclass(frozen=True)
class AttentionSchedule:
    bq: int
    bkv: int
    terms: RooflineTerms
    smem_bytes: int


@functools.lru_cache(maxsize=4096)
def pom_attention_schedule(sq: int, skv: int, d: int, dtype_bytes: int = 2,
                           causal: bool = True,
                           spec: HopperSpec = H100) -> AttentionSchedule:
    """Flash-attention block sizes (bq, bkv) for ``csrc/flash_attention.cu``.

    K and V are modelled as re-read once per q tile, so a larger bq moves
    fewer bytes; a larger bkv means fewer steps of the softmax recurrence
    (the POM split factor).  The kernel computes on the CUDA cores in f32,
    so FLOPs are charged at the f32 rate.  The kernel takes head_dim in
    ``HEAD_DIMS``; its wrapper rejects others."""
    model = HopperModel(spec)
    frac = 0.5 if causal and sq == skv else 1.0
    best, best_key = None, None
    for bq in FLASH_BQ:
        for bkv in FLASH_BKV:
            smem = flash_smem_bytes(bq, bkv, d)
            if smem > spec.smem_bytes:
                continue
            q_tiles = -(-sq // bq)
            flops = 4.0 * sq * skv * d * frac
            byts = (2 * sq * d + 2 * skv * d * q_tiles * frac) * dtype_bytes
            terms = model.kernel_terms(flops, byts, tensor_cores=False)
            key = (terms.bound_s, -(-skv // bkv), smem)
            if best is None or key < best_key:
                best, best_key = AttentionSchedule(bq, bkv, terms, smem), key
    assert best is not None
    return best


@dataclass(frozen=True)
class DecodeSchedule:
    bkv: int
    terms: RooflineTerms
    smem_bytes: int


@functools.lru_cache(maxsize=4096)
def pom_decode_schedule(skv: int, d: int, group: int, dtype_bytes: int = 2,
                        spec: HopperSpec = H100) -> DecodeSchedule:
    """KV tile length for ``csrc/decode_attention.cu`` (one block per
    (batch, kv head), serving ``group`` query heads).  Every tile length
    moves the same bytes, so the search settles on the fewest tile steps
    whose footprint fits."""
    model = HopperModel(spec)
    best, best_key = None, None
    for bkv in DECODE_BKV:
        smem = decode_smem_bytes(group, d, bkv)
        if smem > spec.smem_bytes:
            continue
        flops = 4.0 * group * skv * d
        byts = (2 * skv * d + 2 * group * d) * dtype_bytes
        terms = model.kernel_terms(flops, byts, tensor_cores=False)
        key = (terms.bound_s, -(-skv // bkv), smem)
        if best is None or key < best_key:
            best, best_key = DecodeSchedule(bkv, terms, smem), key
    if best is None:
        raise ValueError(f"decode_attention: group {group} x head_dim {d} does not fit "
                         f"in {spec.smem_bytes} bytes of shared memory")
    return best


@dataclass(frozen=True)
class ScanSchedule:
    chunk: int
    terms: RooflineTerms
    smem_bytes: int


@functools.lru_cache(maxsize=4096)
def pom_scan_schedule(s: int, p: int, n: int, dtype_bytes: int = 2,
                      spec: HopperSpec = H100) -> ScanSchedule:
    """Chunk length for the chunked SSM scan: the POM split factor.

    Larger chunks raise arithmetic intensity (L^2 work on L inputs) but the
    L x L decay matrix and the (N, P) f32 carry must fit in one block's shared
    memory.  No port kernel takes this yet: the scan kernel is still to be
    ported."""
    model = HopperModel(spec)
    best: Optional[ScanSchedule] = None
    L = 64
    while L <= min(s, 1024):
        if s % L == 0:
            smem = (L * p + 2 * L * n) * dtype_bytes * 2 + L * L * 4 + n * p * 4
            if smem <= spec.smem_bytes:
                flops = 2.0 * s * (L * n + L * p + n * p)
                byts = s * (p + 2 * n + 1) * dtype_bytes + n * p * 4 * (s // L)
                terms = model.kernel_terms(flops, byts)
                cand = ScanSchedule(L, terms, smem)
                if best is None or cand.terms.bound_s < best.terms.bound_s:
                    best = cand
        L *= 2
    if best is None:
        raise ValueError(f"no scan chunk of s={s} fits in shared memory")
    return best
