"""POM stage-2 DSE applied to the port's kernel schedules on the H100 model.

The same bottleneck-oriented search as the JAX package's autotuner (one
loop per block dimension, every candidate scored by the roofline model, the
one with the smallest bound kept), retargeted at Hopper: the resource
constraint is the shared-memory footprint of the port's own kernels (at
most 232,448 bytes a block), and the block sizes are the ones those kernels
are compiled for.  Each schedule's docstring says how it breaks ties in the
bound (fewer bytes or fewer sequential steps first, the smaller footprint
last).

The matmul, the grouped matmul and flash attention have two routes each,
and a pure function of the shape, the dtype and the operands' alignment
picks one before any tile is scored (``matmul_route``, ``gmm_route``,
``attention_route``): the tensor cores (TMA-fed stages and wgmma:
``csrc/hopper_gemm.cuh``, the tensor-core kernel of
``csrc/flash_attention.cu``) where TMA can describe the operands (bf16,
16-byte row strides, 16-byte aligned base pointers), the CUDA-core kernels
otherwise.  Each schedule takes the same ``aligned`` flag, so the tile it
returns always belongs to the route that will run.
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
# the two routes of the matmul and the grouped matmul
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
# (bm, bn, bk) tiles of the tensor-core route (csrc/hopper_gemm.cuh: bm/64
# consumer warpgroups, bk the 64-deep stage), as instantiated by the TILE(...)
# lines of csrc/matmul_pom.cu and csrc/grouped_matmul.cu, and the fixed tiles
# of ``schedule="naive"`` (the CUDA-core grouped matmul's is GMM_NAIVE_BM)
TC_BK = 64
MATMUL_TC_TILES = ((64, 128, 64), (128, 128, 64), (128, 256, 64))
MATMUL_TC_NAIVE = (128, 128, 64)
GMM_TC_TILES = ((64, 64, 64), (64, 128, 64), (128, 128, 64), (128, 256, 64))
GMM_TC_NAIVE = (128, 128, 64)
GMM_NAIVE_BM = 64
# the (bq, bkv) tile of flash attention's tensor-core route (two consumer
# warpgroups of 64 q rows, a two-stage ring of 64-key K/V tiles), as
# instantiated by the TILE(...) line of ``tc::dispatch`` in
# csrc/flash_attention.cu, the head dims it is compiled for (one or two
# 128-byte TMA boxes a row; D 32 runs on the CUDA cores) and its stages; and
# the CUDA-core route's fixed tile.  One tile: at D 64, the dim of every
# model, (128, 64) holds two blocks an SM, and (128, 128) with one took 22%
# longer at smollm's forward on an H100 (PERF.md)
FLASH_TC_TILES = ((128, 64),)
FLASH_TC_DIMS = (64, 128)
FLASH_TC_STAGES = 2
FLASH_TC_NAIVE = FLASH_TC_TILES[0]
FLASH_NAIVE = (64, 64)
SMEM_PER_SM = 233_472          # shared memory of one SM; 1 KB of it is reserved a block


def flash_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Dynamic shared memory of one flash-attention block (f32 tiles)."""
    return 4 * (bq * (d + 1) + bkv * (d + 1) + bkv * d + bq * (bkv + 1) + 3 * bq)


def flash_tc_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Dynamic shared memory of one tensor-core flash block
    (``tc::Tile::kSmem``): the bf16 Q tile, every stage of the K/V ring, a
    full and an empty barrier a stage and Q's, and 1 KB to align the
    swizzled tiles."""
    return 1024 + bq * d * 2 + FLASH_TC_STAGES * 2 * bkv * d * 2 + 8 * (2 * FLASH_TC_STAGES + 1)


def decode_smem_bytes(group: int, d: int, bkv: int) -> int:
    """Dynamic shared memory of one decode-attention block (f32): q, acc,
    p, the softmax state and the staged K (padded) and V tiles."""
    return 4 * (2 * group * d + group * bkv + 3 * group + bkv * (d + 1) + bkv * d)


def matmul_route(m: int, n: int, k: int, dtype_bytes: int, aligned: bool = True) -> str:
    """The route of an (m, k) @ (k, n) matmul: the tensor cores where TMA
    can describe both operands (bf16, every row stride a multiple of 16
    bytes: k and n multiples of 8, nothing empty, and both base pointers
    16-byte ``aligned``), the CUDA cores for every other shape or pointer and
    for f32 (TF32 would break its 1e-4 tolerance)."""
    if aligned and dtype_bytes == 2 and min(m, n, k) > 0 and k % 8 == 0 and n % 8 == 0:
        return TENSOR_CORES
    return CUDA_CORES


def gmm_route(e: int, cap: int, d: int, f: int, dtype_bytes: int, aligned: bool = True) -> str:
    """The route of an (e, cap, d) @ (e, d, f) grouped matmul, by the rule
    of ``matmul_route`` (d and f multiples of 8, x and w aligned)."""
    if e > 0 and matmul_route(cap, f, d, dtype_bytes, aligned) == TENSOR_CORES:
        return TENSOR_CORES
    return CUDA_CORES


def attention_route(sq: int, skv: int, d: int, dtype_bytes: int, aligned: bool = True) -> str:
    """The route of flash attention over (Sq, D) queries and (Skv, D) keys:
    the tensor cores for bf16 at a head dim of ``FLASH_TC_DIMS`` (rows of one
    or two 128-byte TMA boxes) with q, k and v 16-byte ``aligned``; the CUDA
    cores for f32, D 32 and any other shape or pointer."""
    if aligned and dtype_bytes == 2 and d in FLASH_TC_DIMS and min(sq, skv) > 0:
        return TENSOR_CORES
    return CUDA_CORES


def tc_stages(bm: int, bn: int, bk: int = TC_BK) -> int:
    """Stages of the TMA ring of a tensor-core tile (``hgemm::stages_for``):
    four, unless three let two blocks share an SM where four do not."""
    def two_fit(stages: int) -> bool:
        return 2 * (_tc_smem(bm, bn, bk, stages) + 1024) <= SMEM_PER_SM
    return 3 if not two_fit(4) and two_fit(3) else 4


def _tc_smem(bm: int, bn: int, bk: int, stages: int) -> int:
    return stages * (bm + bn) * bk * 2 + 1024 + 16 * stages


def tc_smem_bytes(bm: int, bn: int, bk: int = TC_BK) -> int:
    """Dynamic shared memory of one tensor-core block: every stage of the
    ring (a bm x bk tile of A and a bk x bn tile of B in bf16), 1 KB to
    align the swizzled tiles, and a full and an empty barrier a stage."""
    return _tc_smem(bm, bn, bk, tc_stages(bm, bn, bk))


def _terms(model: HopperModel, flops: float, byts: float, blocks: int,
           tensor_cores: bool) -> RooflineTerms:
    """Roofline terms of a grid of ``blocks``: a grid that leaves SMs idle
    gets their share of neither the peak rate nor the HBM rate."""
    fill = min(1.0, max(blocks, 1) / model.spec.num_sms)
    return model.kernel_terms(flops / fill, byts / fill, tensor_cores=tensor_cores)


@dataclass(frozen=True)
class MatmulSchedule:
    bm: int
    bn: int
    bk: int
    terms: RooflineTerms
    smem_bytes: int
    route: str = CUDA_CORES


def matmul_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one CUDA-core ``csrc/matmul_pom.cu`` block:
    the f32 x tile (bm rows of bk + 1, padded) and y tile (bk rows of bn)."""
    return 4 * (bm * (bk + 1) + bk * bn)


@functools.lru_cache(maxsize=4096)
def pom_matmul_schedule(m: int, n: int, k: int, dtype_bytes: int = 2,
                        spec: HopperSpec = H100, *, aligned: bool = True) -> MatmulSchedule:
    """Tile (bm, bn, bk) for ``csrc/matmul_pom.cu`` (one block per (bm, bn)
    tile of the output, a k loop of bk-deep steps), from the tiles of the
    route ``matmul_route`` picks (with ``aligned``): ``MATMUL_TC_TILES`` or
    ``MATMUL_TILES``.

    Device-memory traffic: reads = m*k*ceil(n/bn) + k*n*ceil(m/bm), write
    m*n.  The 2*m*n*k operations (padded to whole tiles on the tensor
    cores, which compute them) are charged at the route's rate: 989 TFLOP/s
    on the tensor cores, 67 on the f32 CUDA cores.  Both terms are scaled
    down when the grid of tiles does not fill the SMs.  Ties go to fewer
    bytes (larger tiles re-read less), then to less padding, then to the
    smaller shared-memory footprint (all the ring's stages on the tensor
    cores)."""
    model = HopperModel(spec)
    route = matmul_route(m, n, k, dtype_bytes, aligned)
    tc = route == TENSOR_CORES
    best, best_key = None, None
    for bm, bn, bk in MATMUL_TC_TILES if tc else MATMUL_TILES:
        smem = tc_smem_bytes(bm, bn, bk) if tc else matmul_smem_bytes(bm, bn, bk)
        if smem > spec.smem_bytes:
            continue
        mt, nt = -(-m // bm), -(-n // bn)
        reads = m * k * nt + k * n * mt
        byts = (reads + m * n) * dtype_bytes
        flops = 2.0 * (mt * bm * nt * bn * -(-k // bk) * bk if tc else m * n * k)
        terms = _terms(model, flops, byts, mt * nt, tc)
        key = (terms.bound_s, byts, flops, smem)
        if best is None or key < best_key:
            best, best_key = MatmulSchedule(bm, bn, bk, terms, smem, route), key
    assert best is not None
    return best


@dataclass(frozen=True)
class AttentionSchedule:
    bq: int
    bkv: int
    terms: RooflineTerms
    smem_bytes: int
    route: str = CUDA_CORES


@functools.lru_cache(maxsize=4096)
def pom_attention_schedule(sq: int, skv: int, d: int, dtype_bytes: int = 2,
                           causal: bool = True, spec: HopperSpec = H100, *,
                           aligned: bool = True) -> AttentionSchedule:
    """Flash-attention block sizes (bq, bkv) for ``csrc/flash_attention.cu``
    on the route ``attention_route`` picks (with ``aligned``): the
    tensor-core route's one tile ``FLASH_TC_NAIVE``, or the best of
    ``FLASH_BQ`` x ``FLASH_BKV`` on the CUDA cores.

    K and V are modelled as re-read once per q tile, so a larger bq moves
    fewer bytes; a larger bkv means fewer steps of the softmax recurrence
    (the POM split factor).  FLOPs are charged at the route's rate: on the
    tensor cores the kernel's own work (each q tile computes whole KV tiles
    up to its last row's last visible key) at the bf16 tensor-core rate, on
    the CUDA cores the causal fraction at the f32 rate.  Ties go to fewer
    sequential KV steps, then to the smaller footprint.  The CUDA-core
    kernel takes head_dim in ``HEAD_DIMS``; its wrapper rejects others."""
    model = HopperModel(spec)
    route = attention_route(sq, skv, d, dtype_bytes, aligned)
    tc = route == TENSOR_CORES
    frac = 0.5 if causal and sq == skv else 1.0
    if tc:
        tiles = FLASH_TC_TILES
    else:
        tiles = tuple((bq, bkv) for bq in FLASH_BQ for bkv in FLASH_BKV)
    best, best_key = None, None
    for bq, bkv in tiles:
        smem = flash_tc_smem_bytes(bq, bkv, d) if tc else flash_smem_bytes(bq, bkv, d)
        if smem > spec.smem_bytes:
            continue
        q_tiles = -(-sq // bq)
        if tc:
            keys = 0     # keys a q tile computes, summed over the q tiles
            for i in range(q_tiles):
                end = min(skv, max(0, min((i + 1) * bq, sq) + skv - sq)) if causal else skv
                keys += -(-end // bkv) * bkv
            flops = 4.0 * bq * keys * d
            byts = (2 * sq * d + 2 * keys * d) * dtype_bytes
        else:
            flops = 4.0 * sq * skv * d * frac
            byts = (2 * sq * d + 2 * skv * d * q_tiles * frac) * dtype_bytes
        terms = model.kernel_terms(flops, byts, tensor_cores=tc)
        key = (terms.bound_s, -(-skv // bkv), smem)
        if best is None or key < best_key:
            best, best_key = AttentionSchedule(bq, bkv, terms, smem, route), key
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


# the k step of each CUDA-core tile height of csrc/grouped_matmul.cu
GMM_CC_BK = {8: 32, 32: 32, 64: 16, 128: 16}


def gmm_smem_bytes(bm: int) -> int:
    """Static shared memory of one CUDA-core ``csrc/grouped_matmul.cu``
    block: the transposed x tile (bk rows of bm + 1) and the w tile (bk
    rows of ``GMM_BN``), f32."""
    bk = GMM_CC_BK[bm]
    return 4 * (bk * (bm + 1) + bk * GMM_BN)


@dataclass(frozen=True)
class GmmSchedule:
    bm: int
    terms: RooflineTerms
    bn: int = GMM_BN
    bk: int = 0
    route: str = CUDA_CORES
    smem_bytes: int = 0


@functools.lru_cache(maxsize=4096)
def pom_gmm_schedule(e: int, cap: int, d: int, f: int, dtype_bytes: int = 2,
                     spec: HopperSpec = H100, *, aligned: bool = True) -> GmmSchedule:
    """Tile for ``csrc/grouped_matmul.cu`` (one block per (expert, m tile,
    n tile)), from the tiles of the route ``gmm_route`` picks (with
    ``aligned``): (bm, bn, bk)
    of ``GMM_TC_TILES`` on the tensor cores, a height bm of ``GMM_BM``
    (``GMM_BN`` wide) on the CUDA cores.

    Each tile computes bm rows whether or not cap fills them; at decode
    (cap 8) the bound is the bytes of the expert weights, read once per m
    tile.  On the CUDA cores the height follows the capacity (a 128-row
    tile would do 16x the work at cap 8).  On the tensor cores every tile
    is at least 64 rows (the 56 padding rows at decode cost ~2 us at the
    tensor-core rate), so there the choice is the width: E x ceil(f / bn)
    blocks must fill the SMs to stream the weights at the HBM rate.  Work
    (padded to whole tiles) is charged at the route's rate; both terms are
    scaled down when the grid does not fill the SMs; ties go to fewer bytes
    (taller tiles re-read the weights less), then to fewer padding rows,
    then to the smaller shared-memory footprint."""
    model = HopperModel(spec)
    route = gmm_route(e, cap, d, f, dtype_bytes, aligned)
    tc = route == TENSOR_CORES
    if tc:
        tiles = GMM_TC_TILES
    else:
        tiles = tuple((bm, GMM_BN, GMM_CC_BK[bm]) for bm in GMM_BM)
    best, best_key = None, None
    for bm, bn, bk in tiles:
        smem = tc_smem_bytes(bm, bn, bk) if tc else gmm_smem_bytes(bm)
        if smem > spec.smem_bytes:
            continue
        m_tiles, n_tiles = -(-cap // bm), -(-f // bn)
        kk = -(-d // bk) * bk if tc else d
        flops = 2.0 * e * m_tiles * bm * n_tiles * bn * kk
        byts = e * (cap * d * n_tiles + d * f * m_tiles + cap * f) * dtype_bytes
        terms = _terms(model, flops, byts, e * m_tiles * n_tiles, tc)
        key = (terms.bound_s, byts, flops, smem)
        if best is None or key < best_key:
            best, best_key = GmmSchedule(bm, terms, bn, bk, route, smem), key
    assert best is not None
    return best
