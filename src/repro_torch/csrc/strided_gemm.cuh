// The f32 strided GEMM mainloop for Hopper (sm_90a), shared by
// contraction.cu (the compile path's affine GEMM statements, D = D + X Y)
// and matmul_pom.cu (the kernel library's f32 matmul, out = x @ y).
//
// Element (m, k) of X is x[x0 + m sxm + k], (k, n) of Y is y[y0 + k syk + n]
// and the output (m, n) is out[o0 + m som + n son]: X contiguous along K and
// Y along N, no offset tables.  Each CTA computes a 128 x 128 tile with 256
// threads, 8 x 8 sums a thread in registers.  X and Y tiles (16 deep) live
// in a ring of four shared-memory stages, one __syncthreads a k step.  Y's
// runs along N land in its tile by 16-byte cp.async copies; X's runs along K
// cannot land in a k-major tile 16 bytes at a time, so each thread loads two
// float4s of the next tile into registers before a step's products and
// stores them transposed after them.  Both tiles are stored k-major ([k][m],
// [k][n], rows padded to 132 floats), so the inner loop reads a thread's 8
// rows and 8 columns as float4s in two groups 64 apart, without bank
// conflicts.  Each output's products are summed in k order into one f32
// register (fmaf) from 0, as the contraction's generic and table kernels and
// the matmul's CUDA-core tiles do, so all of them give the same bits.
//
// Bound: operations.  2 M N K f32 FMAs at the H100's 67 TFLOP/s on the CUDA
// cores (TF32 stays off: the callers' tolerance is 1e-4); at 4096^3 that is
// 2.05 ms against ~0.2 ms to move the three arrays once.
//
// The epilogue is the template parameter: kAccumulate adds the sums to what
// `out` holds (the contraction), otherwise they are stored (the matmul).
//
// Everything here has internal linkage (the unnamed namespace): both
// libraries include this header, and a function-local static of a template
// with external linkage is one object process-wide (a GNU unique symbol),
// which made the second library skip its shared-memory opt-in.
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace sgemm {
namespace {

// Mirrors `contraction._G` in src/repro_torch/kernels/contraction.py.
struct StridedGemm {
  int64_t M, N, K;
  int64_t sxm, sxk, syk, syn, som, son;
  int64_t x0, y0, o0;
  int64_t bx, by, bo;          // batch strides (0: shared)
};

// 16-deep k steps in four stages (32-deep steps in three were slower at
// gemm n 4096 on an H100)
constexpr int kBM = 128, kBN = 128, kBK = 16, kStages = 4, kThreads = 256;
constexpr int kLd = 132;                     // floats a k row of a staged tile (128 + 4)
constexpr int kTile = kBK * kLd;             // floats of one staged X (or Y) tile
constexpr int kSmem = kStages * 2 * kTile * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes of which the first `bytes` are read, the rest zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Y's kBK x 128 tile at (k0, n0), element (k, n) = src[(k0 + k) syk + n0 + n],
// staged into dst[k][n] by 16-byte cp.async copies: thread tid copies four
// n at n = 4 (tid % 32) of the rows k = tid / 32 + 8 r.
struct YOperand {
  const float* p;
  int64_t syk, n_left;
  int ka, na;

  __device__ __forceinline__ YOperand(const float* src, int64_t syk_, int64_t n0, int64_t N,
                                      int tid)
      : syk(syk_), ka(tid / 32), na((tid % 32) * 4) {
    n_left = N - n0 - na;
    p = src + ka * syk + n0 + na;
  }

  // issues the copies of the tile at k0 (k_left = K - k0); zeros outside Y
  __device__ __forceinline__ void stage(uint32_t dst, int64_t k0, int64_t k_left) const {
    const float* q = p + k0 * syk;
    const int64_t kl = k_left - ka;
    const int bytes = n_left >= 4 ? 16 : (n_left > 0 ? 4 * static_cast<int>(n_left) : 0);
#pragma unroll
    for (int r = 0; r < kBK * 128 / 4 / kThreads; ++r) {
      const bool ok = 8 * r < kl && bytes > 0;
      cp_async16(dst + 4 * ((ka + 8 * r) * kLd + na), ok ? q + 8 * r * syk : p, ok ? bytes : 0);
    }
  }
};

// X's kBK x 128 tile at (k0, m0), element (k, m) = src[(m0 + m) sxm + k0 + k]:
// thread tid loads four k at k = 4 (tid % 4) of the rows m = tid / 4 + 64 r
// into registers and stores them transposed into dst[k][m].
struct XOperand {
  const float* p;
  int64_t sxm, m_left;
  int ka, ma;
  float4 held[2];                    // the next tile's elements

  __device__ __forceinline__ XOperand(const float* src, int64_t sxm_, int64_t m0, int64_t M,
                                      int tid)
      : sxm(sxm_), ka((tid % 4) * 4), ma(tid / 4) {
    m_left = M - m0 - ma;
    p = src + ka + (m0 + ma) * sxm;
  }

  // loads the tile at k0 into `held` (zeros outside X)
  __device__ __forceinline__ void load(int64_t k0, int64_t k_left) {
    const float* q = p + k0;
    const int64_t kl = k_left - ka;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row = q + 64 * r * sxm;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (64 * r < m_left) {
        if (kl >= 4) {
          v = *reinterpret_cast<const float4*>(row);
        } else {                       // the k tail
          if (kl > 0) v.x = row[0];
          if (kl > 1) v.y = row[1];
          if (kl > 2) v.z = row[2];
        }
      }
      held[r] = v;
    }
  }

  // stores `held` transposed into the k-major tile `dst`
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* d = dst + ka * kLd + ma + 64 * r;
      d[0] = held[r].x;
      d[kLd] = held[r].y;
      d[2 * kLd] = held[r].z;
      d[3 * kLd] = held[r].w;
    }
  }
};

template <bool kAccumulate>
__global__ void __launch_bounds__(kThreads, 2)
strided_gemm_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ out, const StridedGemm g) {
  extern __shared__ __align__(16) float ssm[];   // stage s: X tile, then Y tile
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int64_t b = blockIdx.z;
  XOperand xo(x + g.x0 + b * g.bx, g.sxm, m0, g.M, tid);
  const YOperand yo(y + g.y0 + b * g.by, g.syk, n0, g.N, tid);
  const uint32_t s0 = smem_addr(ssm);
  const int k_tiles = static_cast<int>((g.K + kBK - 1) / kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      const int64_t k0 = (int64_t)s * kBK;
      xo.load(k0, g.K - k0);
      xo.store(ssm + 2 * s * kTile);
      yo.stage(s0 + 4 * (2 * s + 1) * kTile, k0, g.K - k0);
    }
    cp_async_commit();
  }
  // this thread's rows are 4 ty + {0..3} and 64 + 4 ty + {0..3}, its
  // columns 4 tx + {0..3} and 64 + 4 tx + {0..3}; a warp is 4 ty x 8 tx, so
  // each of its float4 loads reads 64 (X) or 128 (Y) consecutive bytes: one
  // shared-memory wavefront
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8, ty = (warp / 2) * 4 + lane / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();      // the copies of step kt have landed (this thread's)
    __syncthreads();                   // ... everyone's; step kt - 1's stage is free
    const int nt = kt + kStages - 1;
    if (nt < k_tiles) {                // step nt: X into registers, Y copies issued
      const int64_t k0 = (int64_t)nt * kBK;
      xo.load(k0, g.K - k0);
      yo.stage(s0 + 4 * (2 * (nt % kStages) + 1) * kTile, k0, g.K - k0);
    }
    cp_async_commit();
    const float* as = ssm + 2 * (kt % kStages) * kTile;
    const float* bs = as + kTile;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kLd + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kLd + 64 + ty * 4);
      const float4 c0 = *reinterpret_cast<const float4*>(bs + kk * kLd + tx * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(bs + kk * kLd + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    // the held X tile goes to step nt's stage, free since this step's barrier
    if (nt < k_tiles) xo.store(ssm + 2 * (nt % kStages) * kTile);
  }
  cp_async_wait<0>();
  float* ob = out + g.o0 + b * g.bo;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (n < g.N) {
        float* o = ob + m * g.som + n * g.son;
        *o = kAccumulate ? *o + acc[i][j] : acc[i][j];
      }
    }
  }
}

// Launches the ring over `batch` lanes.  cudaErrorInvalidValue for a layout
// it does not stage: X must be contiguous along K and Y along N, with sxm,
// syk, x0, y0, bx, by multiples of 4 and x, y 16-byte aligned.
template <bool kAccumulate>
cudaError_t launch(const void* x, const void* y, void* out, const StridedGemm& g, int64_t batch,
                   cudaStream_t stream) {
  if (g.M < 0 || g.N < 0 || g.K < 0 || batch < 0 || batch > 65535 ||
      (g.M + kBM - 1) / kBM > 65535 || (g.N + kBN - 1) / kBN > 2147483647LL)
    return cudaErrorInvalidValue;
  if (g.sxk != 1 || g.syn != 1 || ((g.sxm | g.syk | g.x0 | g.y0 | g.bx | g.by) & 3) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  if (g.M == 0 || g.N == 0 || batch == 0) return cudaSuccess;
  static const cudaError_t attr =   // once per process (and library)
      cudaFuncSetAttribute(strided_gemm_kernel<kAccumulate>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)((g.N + kBN - 1) / kBN), (unsigned)((g.M + kBM - 1) / kBM),
                  (unsigned)batch);
  strided_gemm_kernel<kAccumulate><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out), g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sgemm
