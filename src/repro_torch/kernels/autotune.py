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

from repro_torch.core.cost_model import H100, HopperModel, HopperSpec, RooflineTerms

# block sizes compiled into csrc/flash_attention.cu and csrc/decode_attention.cu
FLASH_BQ = (32, 64)
FLASH_BKV = (32, 64, 128)
DECODE_BKV = (32, 64, 128, 256)
HEAD_DIMS = (32, 64, 128)
# tile heights compiled into csrc/grouped_matmul.cu; every tile is GMM_BN wide
GMM_BM = (8, 32, 64, 128)
GMM_BN = 64
# chunk lengths and P tiles compiled into csrc/ssm_scan.cu; N is streamed in
# tiles of SCAN_NT
SCAN_CHUNKS = (32, 64)
SCAN_PTILES = (16, 32, 64)
SCAN_NT = 32
# (bm, bn, bk) tiles compiled into csrc/matmul_pom.cu (those that compile
# without spilling registers), and the fixed tile of ``schedule="naive"``
MATMUL_TILES = ((64, 64, 32), (64, 128, 32), (128, 64, 32), (128, 128, 16))
MATMUL_NAIVE = (128, 128, 16)


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


def matmul_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one ``csrc/matmul_pom.cu`` block: the f32 x
    tile (bm rows of bk + 1, padded) and y tile (bk rows of bn)."""
    return 4 * (bm * (bk + 1) + bk * bn)


@functools.lru_cache(maxsize=4096)
def pom_matmul_schedule(m: int, n: int, k: int, dtype_bytes: int = 2,
                        spec: HopperSpec = H100) -> MatmulSchedule:
    """Tile (bm, bn, bk) of ``MATMUL_TILES`` for ``csrc/matmul_pom.cu``
    (one block per (bm, bn) tile of the output, a k loop of bk-deep steps).

    Device-memory traffic: reads = m*k*ceil(n/bn) + k*n*ceil(m/bm), write
    m*n.  The 2*m*n*k operations are charged at the f32 CUDA-core rate (the
    kernel computes there), scaled down when the grid of tiles does not
    fill the SMs.  Ties go to fewer bytes (larger tiles re-read less), then
    to the smaller shared-memory footprint."""
    model = HopperModel(spec)
    best, best_key = None, None
    for bm, bn, bk in MATMUL_TILES:
        smem = matmul_smem_bytes(bm, bn, bk)
        if smem > spec.smem_bytes:
            continue
        tiles = -(-m // bm) * -(-n // bn)
        reads = m * k * (-(-n // bn)) + k * n * (-(-m // bm))
        byts = (reads + m * n) * dtype_bytes
        fill = min(1.0, max(tiles, 1) / spec.num_sms)
        terms = model.kernel_terms(2.0 * m * n * k / fill, byts, tensor_cores=False)
        key = (terms.bound_s, byts, smem)
        if best is None or key < best_key:
            best, best_key = MatmulSchedule(bm, bn, bk, terms, smem), key
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
    p_tile: int
    terms: RooflineTerms
    smem_bytes: int


def scan_smem_bytes(chunk: int, p_tile: int, n: int) -> int:
    """Dynamic shared memory of one ``csrc/ssm_scan.cu`` block (f32): the
    carried h (N rounded up to ``SCAN_NT`` rows x the P tile), the chunk of
    X, the masked decay matrix (padded rows), the streamed B and C tiles
    (padded rows) and the per-step cumsum, exp(cum) and carry weights."""
    n_pad = -(-n // SCAN_NT) * SCAN_NT
    return 4 * (n_pad * p_tile + chunk * p_tile + chunk * (chunk + 1)
                + 2 * chunk * (SCAN_NT + 1) + 3 * chunk)


def _scan_cost(s: int, p: int, n: int, dtype_bytes: int, groups: int, chunk: int,
               p_tile: int, model: HopperModel) -> RooflineTerms:
    """The kernel's padded work and traffic: every (b, h, P tile) block
    recomputes C B^T per chunk and streams B and C once; x, a and y move
    once; the f32 CUDA-core rate is scaled down when the grid does not fill
    the card's SMs."""
    n_pad = -(-n // SCAN_NT) * SCAN_NT
    p_tiles, chunks = -(-p // p_tile), -(-s // chunk)
    blocks = groups * p_tiles
    per_chunk = chunk * chunk * n_pad + chunk * chunk * p_tile + 2 * chunk * n_pad * p_tile
    flops = 2.0 * blocks * chunks * per_chunk
    byts = groups * (2 * s * p * dtype_bytes + 4 * s + 8 * s * n * p_tiles + 4 * n * p)
    fill = min(1.0, blocks / model.spec.num_sms)
    return model.kernel_terms(flops / fill, byts, tensor_cores=False)


@functools.lru_cache(maxsize=4096)
def pom_scan_schedule(s: int, p: int, n: int, dtype_bytes: int = 2, groups: int = 1,
                      spec: HopperSpec = H100) -> ScanSchedule:
    """Chunk length L (the POM split factor) and P tile for ``csrc/ssm_scan.cu``.

    One block per (b * h, P tile) carries h (N x P tile, f32) in shared
    memory across the chunks, so the P tile is bounded by the 232,448 bytes
    a block may use (xlstm's N x P = 512 x 512 f32 carry is 1 MiB: it must
    be split over P).  A narrower P tile fills more SMs but recomputes the
    L x L matrix C B^T once more per tile; a longer chunk means fewer
    sequential steps but L^2 work per step.  Any S is accepted: the kernel
    pads the tail chunk with a = 1, b = 0, x = 0.  ``groups`` is B * H.
    Ties go to the longer chunk, then to the smaller footprint."""
    model = HopperModel(spec)
    best, best_key = None, None
    for chunk in SCAN_CHUNKS:
        for p_tile in SCAN_PTILES:
            smem = scan_smem_bytes(chunk, p_tile, n)
            if smem > spec.smem_bytes:
                continue
            terms = _scan_cost(s, p, n, dtype_bytes, groups, chunk, p_tile, model)
            key = (terms.bound_s, -chunk, smem)
            if best is None or key < best_key:
                best, best_key = ScanSchedule(chunk, p_tile, terms, smem), key
    if best is None:
        raise ValueError(f"ssm_scan: no (chunk, P tile) of state size N {n} fits in "
                         f"{spec.smem_bytes} bytes of shared memory")
    return best


@dataclass(frozen=True)
class GmmSchedule:
    bm: int
    terms: RooflineTerms


@functools.lru_cache(maxsize=4096)
def pom_gmm_schedule(e: int, cap: int, d: int, f: int, dtype_bytes: int = 2,
                     spec: HopperSpec = H100) -> GmmSchedule:
    """Tile height bm for ``csrc/grouped_matmul.cu`` ((bm, ``GMM_BN``) output
    tiles, one block per (expert, m tile, n tile)).

    The height follows the capacity: each tile computes bm rows whether or
    not cap fills them, so at decode (cap 8) a 128-row tile would do 16x the
    work, while there the bound is the bytes of the expert weights, read
    once per m tile.  Work is charged at the f32 CUDA-core rate (the kernel
    computes there), scaled down when the grid does not fill the SMs; ties
    go to fewer bytes (taller tiles re-read the weights less)."""
    model = HopperModel(spec)
    best, best_key = None, None
    n_tiles = -(-f // GMM_BN)
    for bm in GMM_BM:
        m_tiles = -(-cap // bm)
        flops = 2.0 * e * m_tiles * bm * n_tiles * GMM_BN * d
        byts = e * (cap * d * n_tiles + d * f * m_tiles + cap * f) * dtype_bytes
        fill = min(1.0, e * m_tiles * n_tiles / spec.num_sms)
        terms = model.kernel_terms(flops / fill, byts, tensor_cores=False)
        key = (terms.bound_s, byts)
        if best is None or key < best_key:
            best, best_key = GmmSchedule(bm, terms), key
    return best
