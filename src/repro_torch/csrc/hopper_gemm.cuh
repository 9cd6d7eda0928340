// The Hopper (sm_90a) GEMM mainloop shared by the bf16 routes of
// matmul_pom.cu and grouped_matmul.cu: out[z] = A[z] @ B[z] for a batch of
// z, A (M, K) and B (K, N) row-major bf16, out (M, N) bf16, f32 sums.
//
// It replaces, for bf16 operands whose rows TMA can describe, the CUDA-core
// kernels that stand in for the Pallas TPU kernels `_matmul_kernel`
// (src/repro/kernels/matmul_pom.py:26) and `_gmm_kernel`
// (src/repro/kernels/grouped_matmul.py:18).  Those compute bf16 products on
// the f32 CUDA cores (67 TFLOP/s), staging tiles through registers into
// shared memory behind a __syncthreads every k step: at 4096^3 they ran at
// 4% of the tensor cores' 989 TFLOP/s, and at granite_moe_1b's decode
// (cap 8) at a twentieth of the HBM rate the expert weights need.
//
// Bound: at the shapes the port calls it with, operations for the large
// products (4096^3, smollm's FFN, the grouped matmul at cap 640 is near the
// ridge) and bytes of the weights at decode (cap 8: 32 MiB a call).  The
// design feeds the tensor cores without a thread touching an element:
//   * one block computes a (BM, BN) tile of out for one batch entry
//     (blockIdx.z: the expert of the grouped matmul; 0 for the matmul);
//   * a producer warp (one elected thread) issues TMA loads
//     (cp.async.bulk.tensor.3d) of the A tile (BM x 64) and of the B tile
//     (64 x BN) into a ring of kStages shared-memory stages, each with a
//     full and an empty mbarrier; the 128-byte swizzle that TMA writes is
//     the one wgmma reads;
//   * BM/64 consumer warpgroups, 64 rows each, issue
//     wgmma.mma_async.m64nBNk16.f32.bf16.bf16 straight from shared memory,
//     keep one group of products in flight, and hand a stage back to the
//     producer as soon as the products reading it are done; the sums stay
//     in f32 registers;
//   * either operand is read as it lies in memory, K-major or MN-major
//     (gemm_kernel's template parameters; wgmma's transpose bits), so no
//     operand is transposed anywhere: the forward products read A K-major
//     and B MN-major, the grouped matmul's backward dX = dY W^T reads W
//     K-major and dW = X^T dY reads X MN-major;
//   * the epilogue rounds each sum once to bf16 and stores with masks;
//   * where the caller gives row counts (`rows`, one int a batch entry: the
//     grouped matmul's filled rows of each expert), the rows of out[z] at
//     or past rows[z] are zeros, whatever A holds there.  A block whose
//     first row is past the count stores its tile's zeros with 16-byte
//     stores and returns before any barrier, TMA load or wgmma; a block
//     across the count runs as the others and stores zeros past it.  With
//     dropless routing three quarters of the grouped matmul's slots are
//     empty, so three quarters of its tiles skip the mainloop.
// Ragged edges cost nothing in the mainloop: TMA fills the part of a box
// outside the tensor with zeros.  The descriptors are 3-D (inner dim, rows,
// batch), so a tile at a row or k tail of one expert reads zeros, never the
// next expert's rows (0 x Inf would be NaN in the k direction).
//
// What TMA needs decides the route (autotune.matmul_route / gmm_route):
// bf16, every row stride a multiple of 16 bytes (the contiguous dim of each
// operand, K and N for the forward products, a multiple of 8) and 16-byte
// aligned base pointers.  Other shapes and f32 run on the
// CUDA-core kernels of the two .cu files.
//
// The primitives (mbarriers, TMA, wgmma descriptors, fences and products,
// the tensor map) are hopper.cuh's, shared with flash attention.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// Everything here has internal linkage (the unnamed namespace): both
// libraries include this header, and a static local of a template with
// external linkage (the once-per-instantiation opt-in in launch()) would be
// one object for the whole process, so the second library to launch a tile
// would skip the opt-in for its own kernel.
namespace hgemm {
namespace {

using namespace hopper;

constexpr int kBK = 64;              // k depth of a stage: 64 bf16, one 128-byte swizzle row
constexpr int kBoxN = 64;            // columns of one B box (128 bytes)
constexpr int kSmemPerSM = 233472;   // shared memory of an SM (228 KB)

// Stages of the ring: four, unless three stages let two blocks share an SM
// where four do not (then three: one block's epilogue overlaps the other's
// loads).  autotune.tc_stages mirrors this rule.
constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * kBK * 2; }
constexpr int smem_bytes(int bm, int bn, int stages) {
  return stages * stage_bytes(bm, bn) + 1024 + 16 * stages;   // + alignment, barriers
}
constexpr bool two_fit(int bm, int bn, int stages) {
  return 2 * (smem_bytes(bm, bn, stages) + 1024) <= kSmemPerSM;   // 1 KB reserved a block
}
constexpr int stages_for(int bm, int bn) {
  return (!two_fit(bm, bn, 4) && two_fit(bm, bn, 3)) ? 3 : 4;
}

template <int BM, int BN>
struct Tile {
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BN <= 256, "tile shape");
  static constexpr int kConsumers = BM / 64;              // warpgroups, 64 rows each
  static constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp
  static constexpr int kStages = stages_for(BM, BN);
  static constexpr int kMinBlocks = two_fit(BM, BN, kStages) ? 2 : 1;   // for the registers
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kStageBytes = stage_bytes(BM, BN);
  static constexpr int kSmem = smem_bytes(BM, BN, kStages);
};

// The operands' layouts are template parameters (the defaults are the
// forward's, A K-major and B MN-major):
//   * A K-major (kAMnMajor false): A (M, K) row-major, one BM x 64 box of a
//     (K, M, batch) map a stage, BM rows of 128 bytes; A MN-major (true): A
//     stored as its transpose (K, M), BM/64 boxes of 64 m x 64 k from an
//     (M, K, batch) map, each 64 k rows of 128 bytes, read through the
//     transpose bit (tnspA = 1);
//   * B MN-major (kBKMajor false): B (K, N) row-major, BN/64 boxes of 64 n x
//     64 k from an (N, K, batch) map, through the transpose bit (tnspB = 1);
//     B K-major (true): B stored as its transpose (N, K), one 64 k x BN box
//     of a (K, N, batch) map, BN rows of 128 bytes (tnspB = 0).
// A stage holds BM x 64 of A and 64 x BN of B whichever the layout, and the
// descriptors of the PTX ISA's 128-byte-swizzle canonical layouts: K-major,
// 8-row groups 1024 bytes apart (stride byte offset) and a k16 step 32 bytes
// along the swizzled row (the leading byte offset unused); MN-major, 8-k-row
// groups 1024 bytes apart (stride) and 64-element boxes along m or n
// 64 * 128 bytes apart (leading), a k16 step 16 rows of 128 bytes.
template <int BM, int BN, bool kAMnMajor = false, bool kBKMajor = false>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, Tile<BM, BN>::kMinBlocks)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
            __nv_bfloat16* __restrict__ out, const int* __restrict__ rows, int M, int N, int K) {
  using T = Tile<BM, BN>;
  constexpr int S = T::kStages;
  constexpr int kBoxBytes = kBK * 128;                     // one 64 x 64 box
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  __nv_bfloat16* o = out + static_cast<size_t>(z) * M * N;
  // the rows of out[z] that hold products: M, or rows[z] where the caller
  // counts them; warp-uniform as ptxas sees it (a lane-0 shuffle), so that
  // no wgmma below sits under a branch it must treat as divergent
  int live = M;
  if (rows != nullptr) live = min(M, __ldg(rows + z));
  live = __shfl_sync(0xffffffffu, live, 0);
  if (m0 >= live) {                                        // a dead tile: zeros alone
    constexpr int kVecs = BN / 8;                          // 16-byte stores a row
    for (int i = tid; i < BM * kVecs; i += T::kThreads) {
      const int r = m0 + i / kVecs, col = n0 + (i % kVecs) * 8;
      if (r < M && col < N)                                // N % 8 == 0: all 8 columns
        *reinterpret_cast<uint4*>(o + static_cast<size_t>(r) * N + col) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  // stage s: the A tile at base + s * kStageBytes, then the B tile; every
  // box starts on a 1024-byte boundary, the period of the 128-byte swizzle.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + S * T::kStageBytes;
  const int k_tiles = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                          // full: the producer's arrival + bytes
      mbar_init(bars + 8 * (S + s), T::kConsumers);        // empty: one arrival a warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == T::kConsumers) {                               // the producer warp
    if (tid % 32 == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(bars + 8 * (S + s), ((kt / S) & 1) ^ 1);
        const uint32_t a = base + s * T::kStageBytes;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, T::kStageBytes);
        if constexpr (kAMnMajor) {
#pragma unroll
          for (int c = 0; c < BM / 64; ++c)
            tma_load(a + c * kBoxBytes, &tma_a, full, m0 + c * 64, kt * kBK, z);
        } else {
          tma_load(a, &tma_a, full, kt * kBK, m0, z);
        }
        if constexpr (kBKMajor) {
          tma_load(a + T::kABytes, &tma_b, full, kt * kBK, n0, z);
        } else {
#pragma unroll
          for (int c = 0; c < BN / kBoxN; ++c)
            tma_load(a + T::kABytes + c * (kBK * kBoxN * 2), &tma_b, full, n0 + c * kBoxN,
                     kt * kBK, z);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 ... + 63 of the tile (in either A
  // layout its 64 rows start wg * 64 * 128 bytes into the stage)
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % S;
    mbar_wait(bars + 8 * s, (kt / S) & 1);
    const uint32_t a = base + s * T::kStageBytes + wg * 64 * 128;
    const uint32_t b = base + s * T::kStageBytes + T::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = kAMnMajor ? desc(a + kk * 2048, kBoxBytes, 1024)
                                    : desc(a + kk * 32, 16, 1024);
      const uint64_t db = kBKMajor ? desc(b + kk * 32, 16, 1024)
                                   : desc(b + kk * 2048, kBK * kBoxN * 2, 1024);
      WgmmaSS<BN, kAMnMajor ? 1 : 0, kBKMajor ? 0 : 1>::mma(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();                   // the products of stage kt - 1 are done
    if (kt > 0 && tid % 128 == 0) mbar_arrive(bars + 8 * (S + (kt - 1) % S));
  }
  wgmma_wait<0>();

  // epilogue: the m64nBN fragment holds, for each 8-column group j, rows
  // r and r + 8 (r = warp * 16 + lane / 4) at columns 8 j + 2 (lane % 4) + {0, 1};
  // rows past the live count store zeros
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    if (col >= N) continue;            // N % 8 == 0: col + 1 < N as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const bool on = r < live;
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(r) * N + col) =
            __floats2bfloat162_rn(on ? acc[4 * j + 2 * h] : 0.f,
                                  on ? acc[4 * j + 2 * h + 1] : 0.f);
    }
  }
}

// out[z] = A[z] @ B[z] for z < batch: out (batch, m, n) contiguous bf16; a
// is A (batch, m, k), or with kAMnMajor its transpose (batch, k, m); b is B
// (batch, k, n), or with kBKMajor its transpose (batch, n, k); both
// contiguous bf16.  Needs the contiguous (inner) dim of a and b and n to be
// multiples of 8 and a, b and out 16-byte aligned (the callers' routes and
// allocations guarantee it; the dead tiles store 16 bytes at a time); k,
// and m or n as a row count, may be anything.  rows: nullptr (every
// row of out computed), or a device int array (batch,): the rows of out[z]
// at or past rows[z] are stored as zeros and their tiles skip the mainloop.
template <int BM, int BN, bool kAMnMajor = false, bool kBKMajor = false>
cudaError_t launch(const void* a, const void* b, void* out, int batch, int m, int n, int k,
                   cudaStream_t stream, const int* rows = nullptr) {
  using T = Tile<BM, BN>;
  const int a_inner = kAMnMajor ? m : k, b_inner = kBKMajor ? k : n;
  if (batch <= 0 || batch > 65535 || m <= 0 || n <= 0 || k <= 0 || a_inner % 8 != 0 ||
      b_inner % 8 != 0 || n % 8 != 0 || (m + BM - 1) / BM > 65535 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kern = gemm_kernel<BM, BN, kAMnMajor, kBKMajor>;
  static const cudaError_t attr =   // once per instantiation
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ta, tb;
  cudaError_t err = kAMnMajor ? make_map(&ta, a, m, k, batch, 64, kBK)
                              : make_map(&ta, a, k, m, batch, kBK, BM);
  if (err == cudaSuccess)
    err = kBKMajor ? make_map(&tb, b, k, n, batch, kBK, BN)
                   : make_map(&tb, b, n, k, batch, kBoxN, kBK);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(ta, tb, static_cast<__nv_bfloat16*>(out), rows,
                                                 m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hgemm
