// Jacobi-2D sweeps for Hopper (sm_90a): the interior of out is
// 0.2 * (N + S + W + E + C) of x, the boundary rows and columns are x's.
//
// Replaces the Pallas TPU kernel `_jacobi_kernel` / `jacobi2d_step` in
// src/repro/kernels/stencil.py (:19, :37).  There the grid walks blocks of
// bm whole rows, each given three row-block views of the input (the block
// above and below clamped at the edges) for its one-row halo, the grid
// axis is marked "arbitrary" though nothing crosses it, m must be a
// multiple of bm (asserted), and the wrapper launches once per sweep.
//
// Two kernels.  jacobi_kernel runs one sweep: each block owns a 32 x 32
// tile of out and loads it and its one-cell halo into shared memory through
// masked loads.  jacobi_sweeps_kernel runs T sweeps in one launch: each
// block loads its BM x BN tile and a halo of T cells once, sweeps T times in
// shared memory, the valid region shrinking by a cell a sweep (two f32
// copies, read and written in turns), and writes its tile once.  Nothing
// crosses blocks, so any M and N run; where M or N is below 3 every cell is
// boundary and a sweep copies x.
//
// Bound: bytes.  A sweep reads x once and writes out once (8 bytes a cell
// in f32) for 5 operations a cell, so one launch a sweep moves the grid
// `steps` times; T sweeps a launch move it ceil(steps / T) times, plus the
// halo, which the neighbouring block reads and sweeps again.  At 1024^2 the
// 4 MB grid sits in L2 and a launch is mostly its fixed cost; at 4096^2
// (64 MB) every pass goes to HBM.  In shared memory a thread walks a strip
// of rows down two adjacent columns (8-byte shared-memory accesses),
// keeping their north and centre values in registers.  The math is f32 and each sweep rounds once to x's dtype, as
// the TPU kernel does; the neighbours are summed in its order, N + S + W + E
// + C, so both kernels give the same bits as `steps` single sweeps.
//
// Layouts (contiguous, row-major): x and out (M, N), float32 or bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kTile = 32;           // a block's tile of out: 32 x 32 cells
constexpr int kMaxWidth = 256;      // the widest region (tile and halos) of jacobi_sweeps_kernel
constexpr int kRowsPerThread = 4;   // 32 x 8 threads, each 4 rows of one column
constexpr int kThreads = kTile * kTile / kRowsPerThread;

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const T* __restrict__ x, T* __restrict__ out, int m, int n) {
  __shared__ float t[kTile + 2][kTile + 2];   // the tile and its halo: t[r + 1][c + 1]
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < (kTile + 2) * (kTile + 2); i += kThreads) {
    const int lr = i / (kTile + 2), lc = i - lr * (kTile + 2);
    const int gr = r0 + lr - 1, gc = c0 + lc - 1;
    t[lr][lc] = (gr >= 0 && gr < m && gc >= 0 && gc < n) ? to_f(x[(size_t)gr * n + gc]) : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x, gc = c0 + c;
  if (gc >= n) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = threadIdx.y + k * (kTile / kRowsPerThread);
    const int gr = r0 + r;
    if (gr >= m) break;
    const float ctr = t[r + 1][c + 1];
    float v = ctr;
    if (gr > 0 && gr < m - 1 && gc > 0 && gc < n - 1)
      v = 0.2f * ((((t[r][c + 1] + t[r + 2][c + 1]) + t[r + 1][c]) + t[r + 1][c + 2]) + ctr);
    out[(size_t)gr * n + gc] = from_f<T>(v);
  }
}

// T sweeps of a BM x BN tile: the block loads rows [r0 - T, r0 + BM + T) and
// columns [c0 - T, c0 + BN + T) (zeros outside the grid, which no interior
// cell reads), and sweep k updates the cells k or more from that region's
// edge.  The region's pitch is W = BN + 2 T.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
jacobi_sweeps_kernel(const T* __restrict__ x, T* __restrict__ out, int m, int n, int sweeps) {
  extern __shared__ float buf[];
  const int rows = BM + 2 * sweeps, W = BN + 2 * sweeps;
  float* b0 = buf;
  float* b1 = buf + rows * W;
  const int r0 = blockIdx.y * BM - sweeps, c0 = blockIdx.x * BN - sweeps;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  constexpr int kStrips = kThreads / 32;
  // warp ty loads rows ty, ty + 8, ..., kRows of them at a time, a lane every
  // 32nd column: all kRows * kCols loads of a thread are issued before any store
  constexpr int kRows = 2, kCols = kMaxWidth / 32;
  for (int lr0 = ty; lr0 < rows; lr0 += kRows * kStrips) {
    float v[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = lr0 + i * kStrips, gr = r0 + lr;
      const bool row_in = lr < rows && gr >= 0 && gr < m;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int lc = tx + 32 * j, gc = c0 + lc;
        v[i][j] = row_in && lc < W && gc >= 0 && gc < n ? to_f(x[(size_t)gr * n + gc]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = lr0 + i * kStrips;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int lc = tx + 32 * j;
        if (lr < rows && lc < W) {
          b0[lr * W + lc] = v[i][j];
          b1[lr * W + lc] = v[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int k = 1; k <= sweeps; ++k) {
    const float* src = (k & 1) ? b0 : b1;
    float* dst = (k & 1) ? b1 : b0;
    // rows [k, rows - k) in kStrips strips, columns [k, W - k) across the lanes
    const int lo = k, hi = rows - k, per = (hi - lo + kStrips - 1) / kStrips;
    const int ra = lo + ty * per, rb = min(ra + per, hi);
    if (ra < rb) {
      // column pairs (c, c + 1), c even, cover [k, W - k) (W is even): a pair
      // may reach one column past either end, which no later sweep reads
      for (int c = (lo & ~1) + 2 * tx; c < W - k; c += 64) {
        const int gc = c0 + c;
        const bool in0 = gc > 0 && gc < n - 1, in1 = gc + 1 > 0 && gc + 1 < n - 1;
        float2 up = *reinterpret_cast<const float2*>(src + (ra - 1) * W + c);
        float2 ctr = *reinterpret_cast<const float2*>(src + ra * W + c);
        for (int lr = ra; lr < rb; ++lr) {
          const float2 dn = *reinterpret_cast<const float2*>(src + (lr + 1) * W + c);
          const float w = src[lr * W + c - 1], e = src[lr * W + c + 2];
          const int gr = r0 + lr;
          const bool row_in = gr > 0 && gr < m - 1;
          float2 v = ctr;   // N + S + W + E + C, in that order, for each column
          if (row_in && in0) v.x = to_f(from_f<T>(0.2f * ((((up.x + dn.x) + w) + ctr.y) + ctr.x)));
          if (row_in && in1) v.y = to_f(from_f<T>(0.2f * ((((up.y + dn.y) + ctr.x) + e) + ctr.y)));
          *reinterpret_cast<float2*>(dst + lr * W + c) = v;
          up = ctr;
          ctr = dn;
        }
      }
    }
    __syncthreads();
  }
  const float* fin = (sweeps & 1) ? b1 : b0;
  for (int lr = ty; lr < BM; lr += kStrips) {
    const int gr = r0 + sweeps + lr;
    if (gr >= m) break;
    for (int lc = tx; lc < BN; lc += 32) {
      const int gc = c0 + sweeps + lc;
      if (gc < n) out[(size_t)gr * n + gc] = from_f<T>(fin[(lr + sweeps) * W + lc + sweeps]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int m, int n, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  jacobi_kernel<T><<<grid, dim3(kTile, kTile / kRowsPerThread), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m, n);
  return cudaGetLastError();
}

// Raises `kernel`'s dynamic shared-memory limit to the card's opt-in maximum,
// once per device (`done` holds one bit per device).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int BM, int BN>
cudaError_t launch_sweeps(const void* x, void* out, int m, int n, int sweeps,
                          cudaStream_t stream) {
  const int smem = 2 * (BM + 2 * sweeps) * (BN + 2 * sweeps) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> opted{0};
    cudaError_t err = opt_in_smem(jacobi_sweeps_kernel<T, BM, BN>, opted);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  jacobi_sweeps_kernel<T, BM, BN><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m, n, sweeps);
  return cudaGetLastError();
}

// The tiles of autotune.JACOBI_TILES.
template <typename T>
cudaError_t dispatch_sweeps(const void* x, void* out, int m, int n, int sweeps, int bm, int bn,
                            cudaStream_t s) {
  if (bm == 32 && bn == 128) return launch_sweeps<T, 32, 128>(x, out, m, n, sweeps, s);
  if (bm == 64 && bn == 128) return launch_sweeps<T, 64, 128>(x, out, m, n, sweeps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One sweep of x into out (distinct buffers).  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch (0 on
// success); cudaErrorInvalidValue for an unsupported shape.
extern "C" int jacobi2d_launch(const void* x, void* out, int m, int n, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || (m + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, out, m, n, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, out, m, n, st);
  return (int)cudaErrorInvalidValue;
}

// `sweeps` sweeps of x into out (distinct buffers) in one launch of the
// multi-sweep kernel with a bm x bn tile.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for an unsupported shape or tile.
extern "C" int jacobi2d_sweeps_launch(const void* x, void* out, int m, int n, int sweeps, int bm,
                                      int bn, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || sweeps <= 0 || bm <= 0 || (m + bm - 1) / bm > 65535 ||
      bn + 2 * sweeps > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_sweeps<float>(x, out, m, n, sweeps, bm, bn, st);
  if (dtype == 1) return (int)dispatch_sweeps<__nv_bfloat16>(x, out, m, n, sweeps, bm, bn, st);
  return (int)cudaErrorInvalidValue;
}
