// POM-scheduled tiled matmul for Hopper (sm_90a): out = x @ y.
//
// Replaces the Pallas TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul_pom.py (:26, :39).  There the grid is
// (M/bm, N/bn, K/bk) with the k axis "arbitrary": an f32 accumulator in
// VMEM scratch is zeroed at the first k step and flushed (cast to the
// output dtype) at the last, and the wrapper copies zero-padded inputs so
// that every dim is a multiple of its block.  Here one block computes one
// (bm, bn) tile of out; the k axis is a loop inside the block with the f32
// sums in registers, and nothing is padded or copied.
//
// Bound: at the sizes it is called with (4096^3, smollm_360m's FFN
// up-projection 2048 x 960 x 2560, a ragged 1000 x 520 x 3000) operations:
// 2 M N K against M K + K N + M N elements moved.  Two routes, chosen by
// shape (autotune.matmul_route), each with its own tiles:
//
// * tensor cores (`matmul_pom_tc_launch`): bf16 with K and N multiples of
//   8, so that TMA can describe both operands.  The mainloop of
//   hopper_gemm.cuh: TMA loads into a ring of swizzled stages, wgmma with
//   f32 sums in registers, one rounding to bf16; the m, n and k tails are
//   zero-filled by TMA.  Its tiles, (bm, bn, 64), are
//   autotune.MATMUL_TC_TILES.
// * CUDA cores (`matmul_pom_launch`): f32 (TF32 would break its 1e-4
//   tolerance) and bf16 shapes TMA cannot describe (k = 70).  Every edge is
//   masked, so any shape runs.  Each of the 256 threads (a 16 x 16 grid)
//   owns a (bm/16) x (bn/16) block of sums in registers, read from
//   shared-memory tiles staged bk deep, so a k step costs bm/16 + bn/64
//   shared loads (x scalars, y as float4 in runs of 256 bytes a half-warp)
//   per (bm/16)(bn/16) fused multiply-adds, and the next step's x and y
//   elements are loaded from device memory into registers while the
//   current step computes.  The x tile is kept row-major with its k rows
//   padded by one, so both the coalesced stores (consecutive threads walk k
//   along a row of x) and the reads (two rows per warp) are free of bank
//   conflicts.  The tiles the schedule may pick are autotune.MATMUL_TILES;
//   the wrapper rejects any other.
//
// Layouts (all contiguous, row-major): x (M, K), y (K, N), out (M, N) in
// x's dtype (float32 or bfloat16; y of the same dtype).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

template <int BM, int BN, int BK>
constexpr int smem_bytes() {
  return 4 * (BM * (BK + 1) + BK * BN);
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, int M,
              int N, int K) {
  constexpr int TM = BM / 16, TN = BN / 16;                         // sums a thread owns
  constexpr int XL = BM * BK / kThreads, YL = BK * BN / kThreads;   // loads a thread makes
  static_assert(BN % 64 == 0 && XL * kThreads == BM * BK && YL * kThreads == BK * BN,
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  float (*xs)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(smem);            // xs[m][k]
  float (*ys)[BN] = reinterpret_cast<float (*)[BN]>(smem + BM * (BK + 1));    // ys[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // This thread's rows are ty * TM + i; its columns come in groups of four,
  // 64 apart, so that the 16 threads of a half-warp read (and write) 256
  // consecutive bytes of a y row: column j is col(j).
  auto col = [&](int j) { return (j / 4) * 64 + tx * 4 + j % 4; };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The prefetched elements stay in x's dtype until they are stored to
  // shared memory: converting them on arrival would make the warp wait for
  // the loads before the k step's multiply-adds.
  const T zero = from_f<T>(0.f);
  T xr[XL], yr[YL];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < XL; ++r) {   // consecutive threads walk k along a row of x
      const int e = tid + r * kThreads;
      const int gm = m0 + e / BK, gk = k0 + e % BK;
      xr[r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : zero;
    }
#pragma unroll
    for (int r = 0; r < YL; ++r) {   // consecutive threads walk n along a row of y
      const int e = tid + r * kThreads;
      const int gk = k0 + e / BN, gn = n0 + e % BN;
      yr[r] = (gk < K && gn < N) ? y[(size_t)gk * N + gn] : zero;
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int e = tid + r * kThreads;
      xs[e / BK][e % BK] = to_f(xr[r]);
    }
#pragma unroll
    for (int r = 0; r < YL; ++r) {
      const int e = tid + r * kThreads;
      ys[e / BN][e % BN] = to_f(yr[r]);
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty * TM + i][kk];
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&ys[kk][col(j)]);
        b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next step overwrites both tiles
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + col(j);
      if (gn < N) out[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch(const void* x, const void* y, void* out, int m, int n, int k,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM, BN, BK>();
  auto kern = matmul_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if ((m + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(y),
                                         static_cast<T*>(out), m, n, k);
  return cudaGetLastError();
}

// The tiles of autotune.MATMUL_TILES, (bm, bn, bk): those that compile
// without spilling (ptxas -v on sm_90a: 153-219 registers a thread).  The
// last four spill at 255 registers; they stay compiled only so that
// tools/matmul_tiles.py can measure them, and the wrapper refuses them.
template <typename T>
cudaError_t dispatch(const void* x, const void* y, void* out, int m, int n, int k, int bm,
                     int bn, int bk, cudaStream_t stream) {
#define TILE(BM, BN, BK)                                             \
  if (bm == BM && bn == BN && bk == BK)                              \
    return launch<T, BM, BN, BK>(x, y, out, m, n, k, stream);
  TILE(64, 64, 32)
  TILE(64, 128, 32)
  TILE(128, 64, 32)
  TILE(128, 128, 16)
  TILE(128, 128, 32)
  TILE(128, 256, 16)
  TILE(128, 256, 32)
  TILE(256, 128, 16)
#undef TILE
  return cudaErrorInvalidValue;
}

// The tensor-core tiles of autotune.MATMUL_TC_TILES, (bm, bn, bk): bk is
// the 64-deep stage of hopper_gemm.cuh.
cudaError_t dispatch_tc(const void* x, const void* y, void* out, int m, int n, int k, int bm,
                        int bn, int bk, cudaStream_t stream) {
#define TILE(BM, BN, BK)                                             \
  if (bm == BM && bn == BN && bk == BK)                              \
    return hgemm::launch<BM, BN>(x, y, out, 1, m, n, k, stream);
  TILE(64, 128, 64)
  TILE(128, 128, 64)
  TILE(128, 256, 64)
#undef TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for an unsupported shape or
// tile.
extern "C" int matmul_pom_launch(const void* x, const void* y, void* out, int m, int n, int k,
                                 int bm, int bn, int bk, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(x, y, out, m, n, k, bm, bn, bk, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(x, y, out, m, n, k, bm, bn, bk, st);
  return (int)cudaErrorInvalidValue;
}

// bf16 on the tensor cores: k % 8 == 0, n % 8 == 0, x and y 16-byte
// aligned.  Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for a shape, tile or pointer the route does not take.
extern "C" int matmul_pom_tc_launch(const void* x, const void* y, void* out, int m, int n, int k,
                                    int bm, int bn, int bk, void* stream) {
  return (int)dispatch_tc(x, y, out, m, n, k, bm, bn, bk, static_cast<cudaStream_t>(stream));
}
