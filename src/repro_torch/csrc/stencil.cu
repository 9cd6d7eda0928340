// One Jacobi-2D sweep for Hopper (sm_90a): the interior of out is
// 0.2 * (N + S + W + E + C) of x, the boundary rows and columns are x's.
//
// Replaces the Pallas TPU kernel `_jacobi_kernel` / `jacobi2d_step` in
// src/repro/kernels/stencil.py (:19, :37).  There the grid walks blocks of
// bm whole rows, each given three row-block views of the input (the block
// above and below clamped at the edges) for its one-row halo, the grid
// axis is marked "arbitrary" though nothing crosses it, and m must be a
// multiple of bm (asserted).  Here each block owns a 32 x 32 tile of out,
// loads the tile and its one-cell halo into shared memory through masked
// loads, and nothing crosses blocks, so any M and N run; where M or N is
// below 3 every cell is boundary and the sweep copies x.
//
// Bound: bytes.  A sweep reads x once and writes out once (8 bytes a cell
// in f32) for 5 operations a cell.  The halo costs (34 x 34) / (32 x 32),
// 13%, more reads, mostly from L2.  The math is f32 and each sweep rounds
// once to x's dtype, as the TPU kernel does; the neighbours are summed in
// its order, N + S + W + E + C.
//
// Layouts (contiguous, row-major): x and out (M, N), float32 or bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kTile = 32;           // a block's tile of out: 32 x 32 cells
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

template <typename T>
cudaError_t launch(const void* x, void* out, int m, int n, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  jacobi_kernel<T><<<grid, dim3(kTile, kTile / kRowsPerThread), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m, n);
  return cudaGetLastError();
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
