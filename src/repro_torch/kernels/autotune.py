"""POM stage-2 DSE applied to the port's kernel schedules on the H100 model.

The same bottleneck-oriented search as the JAX package's autotuner (one
loop per block dimension, every candidate scored by the roofline model, the
one with the smallest bound kept), retargeted at Hopper: the resource
constraint is the shared-memory footprint of the port's own kernels (at
most 232,448 bytes a block), and the block sizes are the ones those kernels
are compiled for.  Each schedule's docstring says how it breaks ties in the
bound (fewer bytes or fewer sequential steps first, the smaller footprint
last).

The grouped matmul and flash attention have two routes each, the matmul
three, and a pure function of the shape, the dtype and the operands'
alignment picks one before any tile is scored (``matmul_route``,
``gmm_route``, ``attention_route``): the tensor cores (TMA-fed stages and
wgmma: ``csrc/hopper_gemm.cuh``, the tensor-core kernel of
``csrc/flash_attention.cu``) where TMA can describe the operands (bf16,
16-byte row strides, 16-byte aligned base pointers); for the f32 matmul the
contraction's shared-memory ring (``csrc/strided_gemm.cuh``) where its
16-byte copies can stage both operands; the CUDA-core kernels otherwise.
Each schedule takes the same ``aligned`` flag, so the tile it returns always
belongs to the route that will run.

Decode attention has no tile to choose: ``pom_decode_schedule`` picks how
many CTAs split each (batch, kv head)'s cache and how many query heads a
CTA serves.  The stencil's schedule is a rule read off the card's timings,
not a search (``pom_jacobi_schedule``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from repro_torch.core.cost_model import H100, HopperModel, HopperSpec, RooflineTerms

# block sizes compiled into csrc/flash_attention.cu; the head dims both
# attention kernels are compiled for
FLASH_BQ = (32, 64)
FLASH_BKV = (32, 64, 128)
HEAD_DIMS = (32, 64, 128)
# csrc/decode_attention.cu: threads a CTA, the most CTAs that split one
# (batch, kv head) (a cluster: 8 is the portable cluster size), the most
# query heads a CTA serves (a template parameter), and the row steps of a
# warp's pass for up to 3 heads (2 above)
DECODE_THREADS = 256
DECODE_MAX_SPLITS = 8
DECODE_MAX_HEADS = 8
DECODE_UNROLL = 4
# tile heights compiled into csrc/grouped_matmul.cu; every tile is GMM_BN wide
GMM_BM = (8, 32, 64, 128)
GMM_BN = 64
# the (chunk length, P tile) pairs compiled into csrc/ssm_scan.cu: those the
# paths' shapes select (the mLSTM normaliser's P = 1; zamba2's and xlstm's
# serve prefills and 170-token checks; their forwards; zamba2's gradient, whose
# role-swapped scans have P 64 and N 128); the K step of C B^T,
# the chunk states and the readout (N and the chunk streamed in steps of
# SCAN_KT); the N rows of a chunk-state tile (SCAN_NT); the side of a C B^T
# tile (SCAN_CT); every scan kernel runs SCAN_THREADS threads a block
SCAN_TILES = ((64, 8), (64, 64), (64, 128), (128, 128))
SCAN_NAIVE = (64, 128)
SCAN_KT = 32
SCAN_NT = 64
SCAN_CT = 32
SCAN_THREADS = 256
# the scan's routes, by x's dtype: every product on the tensor cores in
# split TF32 (three passes), the products with a bf16 x in two (exact in TF32)
SCAN_ROUTES = {4: "tf32x3", 2: "tf32x3, x exact"}
# csrc/stencil.cu: the single-sweep kernel's tile, the multi-sweep kernel's
# tiles (rows, columns), and the most sweeps a launch
JACOBI_TILE = (32, 32)
JACOBI_TILES = ((32, 128), (64, 128))
JACOBI_MAX_SWEEPS = 16
JACOBI_MAX_WIDTH = 256     # tile columns + 2 T, at most (kMaxWidth in csrc/stencil.cu)
# (bm, bn, bk) tiles compiled into csrc/matmul_pom.cu (those that compile
# without spilling registers), and the fixed tile of ``schedule="naive"``
MATMUL_TILES = ((64, 64, 32), (64, 128, 32), (128, 64, 32), (128, 128, 16))
MATMUL_NAIVE = (128, 128, 16)
# the routes of the matmul and the grouped matmul (the ring: the matmul's f32
# route on csrc/strided_gemm.cuh, with its one tile)
TENSOR_CORES, CUDA_CORES, RING = "tensor_cores", "cuda_cores", "ring"
MATMUL_RING_TILE = (128, 128, 16)
RING_STAGES = 4
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


# csrc/flash_attention_bwd.cu's CUDA-core route: head dim -> ((bq, bkv) of
# the dK/dV kernel, (bq, bkv) of the dQ kernel), its ``BwdTiles``.  D 128
# takes 32 query rows a dK/dV tile, so that a thread's dK, dV, S^T and dP^T
# stay in registers.
FLASH_BWD_TILES = {32: ((64, 64), (64, 64)), 64: ((64, 64), (64, 64)),
                   128: ((32, 64), (64, 64))}
# its tensor-core route (namespace ``tc``): the head dims it is compiled for
# (D 64, every model's training shape: one 128-byte TMA box a row; D 32 and
# 128 run on the CUDA cores), the rows of every tile (keys or queries), the
# consumer warpgroups of a dK/dV block (they take its steps in turn; a
# producer warpgroup feeds them) and the stages of the dK/dV kernel's Q/dO
# ring (two a consumer) and of the dQ kernel's K/V ring
FLASH_BWD_TC_DIMS = (64,)
FLASH_BWD_TC_ROWS = 64
FLASH_BWD_TC_CONSUMERS = 2
FLASH_BWD_TC_STAGES = (4, 2)


def flash_bwd_tc_smem_bytes(d: int) -> tuple:
    """Dynamic shared memory of one tensor-core dK/dV block and one dQ block
    (``tc::kKvSmem``, ``tc::kQSmem``): 1 KB to align the swizzled tiles;
    the dK/dV block's two buffers of K and V tiles, each stage's Q and dO
    tiles and its 64 lse and Delta values, the two consumer warpgroups'
    hand-over of dK and dV (a 64 x D f32 fragment each), a full and an empty
    barrier a K/V buffer and a stage;
    the dQ block's Q and dO tiles, each stage's K and V tiles, a full and an
    empty barrier a stage and the Q/dO one."""
    tile = FLASH_BWD_TC_ROWS * d * 2
    kv_stages, q_stages = FLASH_BWD_TC_STAGES
    xfer = FLASH_BWD_TC_CONSUMERS * (d // 2) * 128 * 4
    dkdv = (1024 + 2 * 2 * tile + kv_stages * 2 * tile + kv_stages * 2 * FLASH_BWD_TC_ROWS * 4
            + xfer + 8 * (4 + 2 * kv_stages))
    dq = 1024 + 2 * tile + q_stages * 2 * tile + 8 * (1 + 2 * q_stages)
    return dkdv, dq


def flash_bwd_smem_bytes(d: int) -> tuple:
    """Dynamic shared memory of one dK/dV block and one dQ block of the
    flash backward (f32 tiles; ``dkdv_smem_floats`` / ``dq_smem_floats``)."""
    (kbq, kbkv), (qbq, qbkv) = FLASH_BWD_TILES[d]
    dkdv = 2 * kbkv * (d + 1) + 2 * kbq * (d + 1) + 2 * kbkv * (kbq + 1) + 2 * kbq
    dq = 2 * qbq * (d + 1) + 2 * qbkv * (d + 1) + qbq * (qbkv + 1) + 2 * qbq
    return 4 * dkdv, 4 * dq


def decode_smem_bytes(heads: int, d: int) -> int:
    """Static shared memory of one decode-attention CTA serving ``heads``
    query heads (f32): each warp's partial acc, max and sum per head, and
    the CTA's merged max and sum per head (its merged acc reuses warp 0's)."""
    warps = DECODE_THREADS // 32
    return 4 * (warps * heads * d + 2 * warps * heads + 2 * heads)


def ring_smem_bytes() -> int:
    """Dynamic shared memory of one block of the f32 ring
    (``csrc/strided_gemm.cuh``): every stage's X and Y tile, 16 k rows of
    128 floats padded to 132."""
    bm, _, bk = MATMUL_RING_TILE
    return RING_STAGES * 2 * bk * (bm + 4) * 4


def matmul_route(m: int, n: int, k: int, dtype_bytes: int, aligned: bool = True) -> str:
    """The route of an (m, k) @ (k, n) matmul, nothing empty and both base
    pointers 16-byte ``aligned``: the tensor cores where TMA can describe
    both operands (bf16, every row stride a multiple of 16 bytes: k and n
    multiples of 8); the ring for f32 whose rows its 16-byte copies can
    stage (k and n multiples of 4); the CUDA cores for every other shape or
    pointer (TF32 would break the f32 tolerance of 1e-4, so f32 never takes
    the tensor cores)."""
    if aligned and min(m, n, k) > 0:
        if dtype_bytes == 2 and k % 8 == 0 and n % 8 == 0:
            return TENSOR_CORES
        if dtype_bytes == 4 and k % 4 == 0 and n % 4 == 0:
            return RING
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


def attention_bwd_route(sq: int, skv: int, d: int, dtype_bytes: int,
                        aligned: bool = True) -> str:
    """The route of the flash backward: the tensor cores for bf16 at a head
    dim of ``FLASH_BWD_TC_DIMS`` with q, k, v, o, dO and lse 16-byte
    ``aligned``; the CUDA cores for f32, D 32 and 128 and any other shape or
    pointer."""
    if aligned and dtype_bytes == 2 and d in FLASH_BWD_TC_DIMS and min(sq, skv) > 0:
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
    route ``matmul_route`` picks (with ``aligned``): ``MATMUL_TC_TILES``,
    the ring's one ``MATMUL_RING_TILE`` or ``MATMUL_TILES``.

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
    tiles = {TENSOR_CORES: MATMUL_TC_TILES, RING: (MATMUL_RING_TILE,)}.get(route, MATMUL_TILES)
    best, best_key = None, None
    for bm, bn, bk in tiles:
        smem = (tc_smem_bytes(bm, bn, bk) if tc else
                ring_smem_bytes() if route == RING else matmul_smem_bytes(bm, bn, bk))
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
    splits: int
    heads: int
    terms: RooflineTerms
    smem_bytes: int


def decode_heads_per_cta(group: int) -> int:
    """Query heads a decode CTA serves: the largest divisor of ``group`` up
    to ``DECODE_MAX_HEADS`` (the whole group for the models' groups 1-8; a
    group of 9 is served 3 heads at a time, each CTA reading its kv head's
    cache)."""
    return max(h for h in range(1, min(group, DECODE_MAX_HEADS) + 1) if group % h == 0)


def decode_rows_per_pass(d: int, dtype_bytes: int, heads: int) -> int:
    """Cache rows one decode CTA reads in one pass of its loop: every warp
    takes ``DECODE_UNROLL`` row steps (2 above 3 heads), and a row step of
    a warp covers 32 lanes x 16 bytes of rows."""
    unroll = DECODE_UNROLL if heads <= 3 else 2
    return DECODE_THREADS // 32 * (512 // (d * dtype_bytes)) * unroll


@functools.lru_cache(maxsize=4096)
def pom_decode_schedule(bh: int, s: int, group: int, d: int, dtype_bytes: int = 2,
                        spec: HopperSpec = H100) -> DecodeSchedule:
    """How ``csrc/decode_attention.cu`` splits the work of ``bh`` = B x Hkv
    kv heads with a cache of ``s`` positions and ``group`` query heads each.

    Each (batch, kv head, head chunk) gets ``splits`` CTAs, one cluster,
    that share its valid prefix.  Every CTA count moves the same bytes, so
    the choice is parallelism: the fewest splits that put a CTA on every SM
    (one wave), at most ``DECODE_MAX_SPLITS`` (the portable cluster size)
    and at most one split per pass of rows at full length (so every split
    has rows when the cache is full).  The grid depends on shapes only,
    never on the lengths."""
    heads = decode_heads_per_cta(group)
    chunks = group // heads
    units = bh * chunks
    useful = -(-s // decode_rows_per_pass(d, dtype_bytes, heads))
    want = -(-spec.num_sms // max(units, 1))
    splits = max(1, min(DECODE_MAX_SPLITS, useful, want))
    flops = 4.0 * bh * group * s * d
    byts = bh * (2 * s * d * chunks + 2 * group * d) * dtype_bytes
    terms = _terms(HopperModel(spec), flops, byts, units * splits, False)
    return DecodeSchedule(splits, heads, terms, decode_smem_bytes(heads, d))


@dataclass(frozen=True)
class ScanSchedule:
    chunk: int
    p_tile: int
    terms: RooflineTerms
    smem_bytes: int
    state_bytes: int = 0


def _pitch(c: int, r: int) -> int:
    """The smallest row pitch >= c that is r modulo 32 banks (``pitch`` in
    csrc/ssm_scan.cu)."""
    return c + ((r - c % 32) + 32) % 32


def scan_smem_bytes(chunk: int, p_tile: int) -> int:
    """Dynamic shared memory of the largest ``csrc/ssm_scan.cu`` kernel: the
    C B^T kernel (two stages of a C and a B tile, SCAN_CT x SCAN_KT), the
    chunk-state kernel (two stages of B w's two TF32 parts, SCAN_KT x
    SCAN_NT each, and the X tile, SCAN_KT x P tile, at most in f32; the
    weights) or the readout (two stages of the masked decay or scaled C
    tile's two TF32 parts, chunk x SCAN_KT each, and the X or state tile,
    SCAN_KT x P tile; cum and exp(cum)), f32 words with bank-spreading
    pitches.  N is streamed, so it does not enter."""
    cbt = 2 * 2 * SCAN_CT * _pitch(SCAN_KT, 4)
    states = 2 * (2 * SCAN_KT * _pitch(SCAN_NT, 8) + SCAN_KT * _pitch(p_tile, 8)) + chunk
    out = 2 * (2 * chunk * _pitch(SCAN_KT, 4) + SCAN_KT * _pitch(p_tile, 8)) + 2 * chunk
    return 4 * max(cbt, states, out)


def scan_state_bytes(s: int, p: int, n: int, groups: int, chunk: int) -> int:
    """Device scratch of one scan call: every chunk's N x P f32 state."""
    return 4 * groups * -(-s // chunk) * n * p


def _scan_cost(s: int, p: int, n: int, dtype_bytes: int, groups: int, bc_groups: int,
               chunk: int, p_tile: int, model: HopperModel) -> list:
    """Roofline terms of the four kernels: their padded tensor-core work at
    the TF32 rate (three passes a product, two for the products with a bf16
    x) and their device traffic, counting each block's reads (a narrower P
    tile reads the C B^T and C tiles again), each kernel's terms scaled down
    when its grid does not fill the SMs."""
    spec = model.spec
    nc = -(-s // chunk)
    n_kt, n_nt = -(-n // SCAN_KT) * SCAN_KT, -(-n // SCAN_NT) * SCAN_NT
    p_pad = -(-p // p_tile) * p_tile
    px = 2 if dtype_bytes == 2 else 3
    states = 4.0 * groups * nc * n * p
    ntp = p_pad // p_tile
    tt = chunk // SCAN_CT

    def terms(macs: float, byts: float, blocks: int) -> RooflineTerms:
        fill = min(1.0, max(blocks, 1) / spec.num_sms)
        return RooflineTerms(2.0 * macs / spec.peak_flops_tf32 / fill,
                             byts / spec.hbm_bw / fill)

    g_blocks = bc_groups * nc * tt * (tt + 1) // 2
    s_blocks = groups * nc * (n_nt // SCAN_NT) * ntp
    o_blocks = groups * nc * ntp
    cbt_k = terms(3.0 * g_blocks * SCAN_CT * SCAN_CT * n_kt,
                  g_blocks * (8.0 * SCAN_CT * n_kt + 4.0 * SCAN_CT * SCAN_CT), g_blocks)
    chunk_k = terms(px * s_blocks * SCAN_NT * p_tile * chunk,
                    s_blocks * chunk * (4.0 * SCAN_NT + p_tile * dtype_bytes) + states, s_blocks)
    pass_k = terms(0.0, 2.0 * states + 4.0 * groups * n * p,
                   groups * -(-n * p // (4 * SCAN_THREADS)))
    out_k = terms(px * o_blocks * chunk * chunk * p_tile
                  + 3.0 * groups * max(nc - 1, 0) * ntp * chunk * n_kt * p_tile,
                  o_blocks * (4.0 * chunk * chunk + 4.0 * chunk * n_kt
                              + chunk * p_tile * dtype_bytes * 2 + 4.0 * n_kt * p_tile),
                  o_blocks)
    return [cbt_k, chunk_k, pass_k, out_k]


@functools.lru_cache(maxsize=4096)
def pom_scan_schedule(s: int, p: int, n: int, dtype_bytes: int = 2, groups: int = 1,
                      spec: HopperSpec = H100, *, bc_groups: int = 0) -> ScanSchedule:
    """Chunk length L (the POM split factor) and P tile for ``csrc/ssm_scan.cu``.

    The scan runs in four kernels: C B^T once per (batch, B/C group,
    chunk), each chunk's N x P state, a pass over the chunk states
    (sequential only over the chunks) and the readout (parallel over (b * h,
    chunk, P tile)).  A longer chunk means
    fewer chunk states to write and pass over but L^2 work per chunk; a
    narrower P tile fills more SMs but pads P = 1 less only down to 8.  The
    footprint does not depend on N (it is streamed), so every pair fits; a
    state whose chunk scratch exceeds the card's memory at every chunk length
    raises.  ``groups`` is B * H; ``bc_groups`` the distinct (batch, B/C
    group) pairs (B where one group is broadcast over the heads; 0 means
    ``groups``).  The score is the sum of the four kernels' bounds; ties go
    to the longer chunk, then to the smaller footprint."""
    model = HopperModel(spec)
    bc_groups = bc_groups or groups
    best, best_key = None, None
    for chunk, p_tile in SCAN_TILES:
        state = scan_state_bytes(s, p, n, groups, chunk)
        smem = scan_smem_bytes(chunk, p_tile)
        if state > spec.hbm_bytes or smem > spec.smem_bytes:
            continue
        kernels = _scan_cost(s, p, n, dtype_bytes, groups, bc_groups, chunk, p_tile, model)
        terms = RooflineTerms(sum(t.compute_s for t in kernels),
                              sum(t.memory_s for t in kernels))
        key = (sum(t.bound_s for t in kernels), -chunk, smem)
        if best is None or key < best_key:
            best, best_key = ScanSchedule(chunk, p_tile, terms, smem, state), key
    if best is None:
        raise ValueError(f"ssm_scan: the chunk states of S {s}, N {n}, P {p} over {groups} "
                         f"(batch, head) pairs exceed the card's {spec.hbm_bytes} bytes at "
                         f"every (chunk, P tile) of {SCAN_TILES}")
    return best


@dataclass(frozen=True)
class JacobiSchedule:
    sweeps: int            # sweeps a launch (the last launch runs the rest)
    tile: tuple            # (rows, columns) of the multi-sweep kernel; JACOBI_TILE at 1
    launches: int
    smem_bytes: int


def jacobi_plan(steps: int, sweeps: int) -> list:
    """The sweeps of each launch of a ``steps``-sweep call that runs up to
    ``sweeps`` a launch: ceil(steps / sweeps) launches."""
    return [min(sweeps, steps - i) for i in range(0, steps, sweeps)]


def jacobi_smem_bytes(tile: tuple, sweeps: int) -> int:
    """Dynamic shared memory of one multi-sweep block running ``sweeps``
    sweeps: two f32 copies (read and written in turns) of its tile and a
    halo of ``sweeps`` cells."""
    return 2 * 4 * (tile[0] + 2 * sweeps) * (tile[1] + 2 * sweeps)


@functools.lru_cache(maxsize=4096)
def pom_jacobi_schedule(m: int, n: int, steps: int, dtype_bytes: int = 4,
                        spec: HopperSpec = H100) -> JacobiSchedule:
    """Sweeps a launch T and tile for ``csrc/stencil.cu``'s ``steps``-sweep call.

    A launch loads each block's tile and a halo of T cells once, sweeps T
    times in shared memory (the valid region shrinking by a cell a sweep) and
    writes the tile once, so a call makes ceil(steps / T) passes over the
    grid instead of ``steps``.  T is as many sweeps as the call has, up to
    ``JACOBI_MAX_SWEEPS``: on an H100, of every (T up to 10, tile) timed at
    1024^2 and 4096^2 x 10, this rule's was the fastest (PERF.md,
    ``tools/scan_bench.py --tiles``).  The tile is 64 x 128 where
    that grid fills the SMs, else 32 x 128 (1024^2 gives 128 blocks of 64 x
    128 for 132 SMs).  T = 1 is the single-sweep kernel.  ``dtype_bytes``
    does not enter: the kernel sweeps in f32 either way."""
    steps = max(steps, 1)
    sweeps = min(steps, JACOBI_MAX_SWEEPS)
    if sweeps == 1:
        return JacobiSchedule(1, JACOBI_TILE, steps, 0)
    wide = JACOBI_TILES[1]
    fills = -(-m // wide[0]) * -(-n // wide[1]) >= spec.num_sms
    tile = wide if fills else JACOBI_TILES[0]
    return JacobiSchedule(sweeps, tile, len(jacobi_plan(steps, sweeps)),
                          jacobi_smem_bytes(tile, sweeps))


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
                     spec: HopperSpec = H100, *, aligned: bool = True,
                     route: str | None = None) -> GmmSchedule:
    """Tile for ``csrc/grouped_matmul.cu`` (one block per (expert, m tile,
    n tile)), from the tiles of the route ``gmm_route`` picks (with
    ``aligned``; ``route`` names it instead, as ``gmm_bwd_schedules`` does
    for products whose operands lie transposed): (bm, bn, bk)
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
    if route is None:
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


def gmm_bwd_schedules(e: int, cap: int, d: int, f: int, dtype_bytes: int = 2,
                      spec: HopperSpec = H100, *, aligned: bool = True) -> tuple:
    """The (dX, dW) schedules of the grouped matmul's backward for a forward
    (e, cap, d) @ (e, d, f): dX = dY W^T, an (e, cap, f) @ (e, f, d)
    product, and dW = X^T dY, an (e, d, cap) @ (e, cap, f) one.  Both read
    x and w where they lie (W as a K-major operand, X as an MN-major one),
    so both take the forward's route, ``gmm_route(e, cap, d, f)``: TMA needs
    the contiguous dims d and f to be multiples of 8, and cap, dW's
    contraction, only counts rows of boxes."""
    route = gmm_route(e, cap, d, f, dtype_bytes, aligned)
    return (pom_gmm_schedule(e, cap, f, d, dtype_bytes, spec, aligned=aligned, route=route),
            pom_gmm_schedule(e, d, cap, f, dtype_bytes, spec, aligned=aligned, route=route))
