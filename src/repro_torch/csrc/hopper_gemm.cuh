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
//     (cp.async.bulk.tensor.3d) of the A tile (BM x 64, K-major) and of
//     the B tile (64 x BN as BN/64 boxes of 64 x 64, MN-major) into a ring
//     of kStages shared-memory stages, each with a full and an empty
//     mbarrier; the 128-byte swizzle that TMA writes is the one wgmma reads;
//   * BM/64 consumer warpgroups, 64 rows each, issue
//     wgmma.mma_async.m64nBNk16.f32.bf16.bf16 straight from shared memory
//     (B through the instruction's transpose bit, so neither operand is
//     transposed anywhere), keep one group of products in flight, and hand a
//     stage back to the producer as soon as the products reading it are
//     done; the sums stay in f32 registers;
//   * the epilogue rounds each sum once to bf16 and stores with masks.
// Ragged edges cost nothing in the mainloop: TMA fills the part of a box
// outside the tensor with zeros.  The descriptors are 3-D (inner dim, rows,
// batch), so a tile at a row or k tail of one expert reads zeros, never the
// next expert's rows (0 x Inf would be NaN in the k direction).
//
// What TMA needs decides the route (autotune.matmul_route / gmm_route):
// bf16, every row stride a multiple of 16 bytes (K and N multiples of 8)
// and 16-byte aligned base pointers.  Other shapes and f32 run on the
// CUDA-core kernels of the two .cu files.
//
// The primitives (mbarriers, TMA, wgmma descriptors and fences, the tensor
// map) are hopper.cuh's, shared with the flash-attention forward.
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

// d (f32, the m64nN fragment) += A (64 x 16, K-major) B (16 x N, MN-major:
// the last immediate sets the transpose bit of B).  Written out for each N.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1)
        : "memory");
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, Tile<BM, BN>::kMinBlocks)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
            __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using T = Tile<BM, BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  // stage s: the A tile at base + s * kStageBytes, then BN/64 B boxes of
  // 64 k rows x 128 bytes; every tile starts on a 1024-byte boundary, the
  // period of the 128-byte swizzle.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + S * T::kStageBytes;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
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
        tma_load(a, &tma_a, full, kt * kBK, m0, z);
#pragma unroll
        for (int c = 0; c < BN / kBoxN; ++c)
          tma_load(a + T::kABytes + c * (kBK * kBoxN * 2), &tma_b, full, n0 + c * kBoxN,
                   kt * kBK, z);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 ... + 63 of the tile
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
    for (int kk = 0; kk < kBK / 16; ++kk)
      // A: 8-row groups 1024 bytes apart, a k16 step 32 bytes along the
      // swizzled row.  B: 8-k-row groups 1024 bytes apart (stride), 64-column
      // boxes kBK * 128 bytes apart (leading), a k16 step 16 rows of 128 bytes.
      Wgmma<BN>::mma(acc, desc(a + kk * 32, 16, 1024),
                     desc(b + kk * 2048, kBK * kBoxN * 2, 1024));
    wgmma_commit();
    wgmma_wait<1>();                   // the products of stage kt - 1 are done
    if (kt > 0 && tid % 128 == 0) mbar_arrive(bars + 8 * (S + (kt - 1) % S));
  }
  wgmma_wait<0>();

  // epilogue: the m64nBN fragment holds, for each 8-column group j, rows
  // r and r + 8 (r = warp * 16 + lane / 4) at columns 8 j + 2 (lane % 4) + {0, 1}
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  __nv_bfloat16* o = out + static_cast<size_t>(z) * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    if (col >= N) continue;            // N % 8 == 0: col + 1 < N as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(r) * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out[z] = a[z] @ b[z] for z < batch: a (batch, m, k), b (batch, k, n), out
// (batch, m, n), all contiguous bf16.  Needs k % 8 == 0, n % 8 == 0 and
// 16-byte aligned a and b (the callers' routes guarantee it).
template <int BM, int BN>
cudaError_t launch(const void* a, const void* b, void* out, int batch, int m, int n, int k,
                   cudaStream_t stream) {
  using T = Tile<BM, BN>;
  if (batch <= 0 || batch > 65535 || m <= 0 || n <= 0 || k <= 0 || k % 8 != 0 || n % 8 != 0 ||
      (m + BM - 1) / BM > 65535 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kern = gemm_kernel<BM, BN>;
  static const cudaError_t attr =   // once per instantiation
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ta, tb;
  cudaError_t err = make_map(&ta, a, k, m, batch, kBK, BM);
  if (err == cudaSuccess) err = make_map(&tb, b, n, k, batch, kBoxN, kBK);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(ta, tb, static_cast<__nv_bfloat16*>(out), m, n,
                                                 k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hgemm
