// Grouped (per-expert) matmul for Hopper (sm_90a): out[e] = x[e] @ w[e].
//
// Replaces the Pallas TPU kernel `_gmm_kernel` / `grouped_matmul` in
// src/repro/kernels/grouped_matmul.py (:18, :32).  There the grid is
// (expert, m block, n block, k block) with the k axis "arbitrary": an f32
// accumulator in VMEM scratch is zeroed at the first k step and flushed at
// the last, and cap, f and d must be multiples of their blocks (asserted).
// Here the k axis is a loop inside the block with the f32 sums in
// registers, and any cap, d and f run.
//
// Bound: at the MoE decode shape (granite_moe_1b, batch 8: cap 8, E 32,
// d 1024, f 512) the bytes of the expert weights (32 MiB a call, read
// once) dominate; at the forward shape (4 x 512 tokens: cap 640) the
// bytes still edge out the 21.5 GFLOP of a call at the tensor-core rate.
// Two routes, chosen by shape (autotune.gmm_route), each with its tiles:
//
// * tensor cores (`grouped_matmul_tc_launch`): bf16 with d and f multiples
//   of 8, so that TMA can describe both operands (the contiguous dim of
//   each, whichever the layout, a multiple of 8).  The mainloop of
//   hopper_gemm.cuh with the expert in blockIdx.z and 3-D descriptors,
//   (d, cap, E) for x and (f, d, E) for w, so that a tile at a cap or d
//   tail reads TMA's zeros, never the next expert's rows.  At decode a
//   64-row tile computes 56 rows of zeros (2.1 GFLOP, ~2 us at the
//   tensor-core rate, under the ~10 us the weights take); what matters
//   there is that E x ceil(f / bn) blocks fill the 132 SMs with enough
//   stages in flight to stream the weights at the HBM rate
//   (autotune.pom_gmm_schedule).  Tiles: autotune.GMM_TC_TILES.
// * CUDA cores (`grouped_matmul_launch`): f32 (TF32 would break its 1e-4
//   tolerance) and bf16 shapes TMA cannot describe (d = 500).  Every edge is
//   masked.  The tile height follows cap (BM 8, 32, 64 or 128 rows,
//   autotune.GMM_BM): at decode an 8-row tile reads each weight element
//   once and computes no padding rows, while at the forward shape a 128-row
//   tile re-reads the weights only cap / 128 times.  Each block stages a
//   BM x BK tile of x (transposed) and a BK x BN tile of w in shared memory
//   per k step, and every thread keeps a TM x TN block of f32 sums in
//   registers.  Its rows and columns are interleaved (row ty + i * BM/TM,
//   column tx + j * BN/TN), so the reads of a warp from shared memory and
//   its stores to out are on consecutive addresses.
//
// The backward (kernels/grouped_matmul.py grouped_matmul_backward) runs on
// the same kernels: dX = dY W^T and dW = X^T dY.  It has no TPU
// counterpart: the reference lets XLA differentiate its pure-jnp grouped
// matmul.  Bound: at granite_moe_1b's training shape (E 32, cap 640, d 1024,
// f 512, bf16) the bytes of x, w, dy, dx and dw (0.0513 ms at 3.35 TB/s)
// edge out the two products' operations at the tensor-core rate.  Both
// products read the saved x and w where they lie (layouts 1 and 2 below):
// the tensor-core route reads w as a K-major B operand and x as an MN-major
// A operand through wgmma's transpose bits, the CUDA-core route by index.
// No operand is transposed into a copy: at that shape copies of W^T and X^T
// would move 150 MB more, nearly the products' own 172 MB.  On
// the tensor cores dW's contraction over cap is a row count of TMA boxes,
// so cap needs no multiple of 8: a cap tail reads zeros, as a d or f tail
// does.
//
// Layouts (all contiguous): x (E, cap, d), w (E, d, f), out (E, cap, f) in
// x's dtype (float32 or bfloat16; w of the same dtype); layout 1 takes w
// stored as its transpose (E, f, d), layout 2 x stored as its transpose
// (E, d, cap).
//
// Row counts: both routes take `rows`, nullptr or a device int32 array (E,)
// (the forward's filled rows of each expert, which the MoE dispatch knows
// on the card).  The rows of out[e] at or past rows[e] are then zeros,
// whatever x holds there: a block whose first row is past the count
// stores its tile's zeros and returns before its k loop, a block across it
// stores zeros past it.  The zeros are stored, not left: the gate reads
// both products' rows and dW of the third reads its input's, and garbage
// there would reach dW as 0 x NaN.  With dropless routing at granite's
// training shape (cap 32,768, ~8,192 filled) three quarters of the tiles
// skip their products.
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

constexpr int kBN = 64;  // every tile is 64 columns wide (autotune.GMM_BN)

// kTA: x is stored as its transpose, (E, d, cap) (element (m, k) at
// k * cap + m); kTB: w is stored as its transpose, (E, f, d).  The backward
// runs dW = X^T dY with kTA and dX = dY W^T with kTB on the saved x and w as
// they lie; each tile load walks the operand's contiguous dim with
// consecutive threads.
template <typename T, int BM, int BK, int TM, int TN, bool kTA, bool kTB>
__global__ void __launch_bounds__((BM / TM) * (kBN / TN))
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
           const int* __restrict__ rows, int cap, int d, int f) {
  constexpr int CX = kBN / TN;           // threads along n
  constexpr int NT = (BM / TM) * CX;     // threads in the block
  __shared__ float xs[BK][BM + 1];       // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][kBN];          // w tile: ws[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % CX, ty = tid / CX;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const T* xe = x + (size_t)e * cap * d;
  const T* we = w + (size_t)e * d * f;
  T* oe = out + (size_t)e * cap * f;
  const int live = rows == nullptr ? cap : min(cap, rows[e]);   // rows holding products
  if (m0 >= live) {                      // a dead tile: zeros alone
    for (int i = tid; i < BM * kBN; i += NT) {
      const int gm = m0 + i / kBN, gn = n0 + i % kBN;
      if (gm < cap && gn < f) oe[(size_t)gm * f + gn] = from_f<T>(0.f);
    }
    return;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      if constexpr (kTA) {   // consecutive threads walk m along a row of x^T
        const int k = i / BM, m = i - (i / BM) * BM;
        const int gm = m0 + m, gk = k0 + k;
        xs[k][m] = (gm < cap && gk < d) ? to_f(xe[(size_t)gk * cap + gm]) : 0.f;
      } else {               // consecutive threads walk k along a row of x
        const int m = i / BK, k = i - (i / BK) * BK;
        const int gm = m0 + m, gk = k0 + k;
        xs[k][m] = (gm < cap && gk < d) ? to_f(xe[(size_t)gm * d + gk]) : 0.f;
      }
    }
    for (int i = tid; i < BK * kBN; i += NT) {
      if constexpr (kTB) {   // consecutive threads walk k along a row of w^T
        const int n = i / BK, k = i - (i / BK) * BK;
        const int gk = k0 + k, gn = n0 + n;
        ws[k][n] = (gk < d && gn < f) ? to_f(we[(size_t)gn * d + gk]) : 0.f;
      } else {               // consecutive threads walk n along a row of w
        const int k = i / kBN, n = i - (i / kBN) * kBN;
        const int gk = k0 + k, gn = n0 + n;
        ws[k][n] = (gk < d && gn < f) ? to_f(we[(size_t)gk * f + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx + j * CX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();  // the next step overwrites both tiles
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= cap) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * CX;
      if (gn < f) oe[(size_t)gm * f + gn] = from_f<T>(gm < live ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, int BM, int BK, int TM, int TN, bool kTA, bool kTB>
cudaError_t launch(const void* x, const void* w, void* out, const int* rows, int e, int cap,
                   int d, int f, cudaStream_t stream) {
  constexpr int threads = (BM / TM) * (kBN / TN);
  const dim3 grid((f + kBN - 1) / kBN, (cap + BM - 1) / BM, e);
  gmm_kernel<T, BM, BK, TM, TN, kTA, kTB><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), rows, cap, d,
      f);
  return cudaGetLastError();
}

// The tile heights of autotune.GMM_BM, each with its k step and per-thread
// block: 8 rows (decode) 128 threads of 1 x 4; 32 rows 256 threads of 2 x 4;
// 64 rows 256 threads of 4 x 4; 128 rows 256 threads of 8 x 4.
template <typename T, bool kTA, bool kTB>
cudaError_t dispatch(const void* x, const void* w, void* out, const int* rows, int e, int cap,
                     int d, int f, int bm, cudaStream_t stream) {
  switch (bm) {
    case 8: return launch<T, 8, 32, 1, 4, kTA, kTB>(x, w, out, rows, e, cap, d, f, stream);
    case 32: return launch<T, 32, 32, 2, 4, kTA, kTB>(x, w, out, rows, e, cap, d, f, stream);
    case 64: return launch<T, 64, 16, 4, 4, kTA, kTB>(x, w, out, rows, e, cap, d, f, stream);
    case 128: return launch<T, 128, 16, 8, 4, kTA, kTB>(x, w, out, rows, e, cap, d, f, stream);
    default: return cudaErrorInvalidValue;
  }
}

// layout: 0 out = x @ w (the forward), 1 out = x @ w^T (w stored (E, f, d)),
// 2 out = x^T @ w (x stored (E, d, cap)).
template <typename T>
cudaError_t dispatch_layout(const void* x, const void* w, void* out, const int* rows, int e,
                            int cap, int d, int f, int bm, int layout, cudaStream_t stream) {
  if (layout == 0) return dispatch<T, false, false>(x, w, out, rows, e, cap, d, f, bm, stream);
  if (layout == 1) return dispatch<T, false, true>(x, w, out, rows, e, cap, d, f, bm, stream);
  if (layout == 2) return dispatch<T, true, false>(x, w, out, rows, e, cap, d, f, bm, stream);
  return cudaErrorInvalidValue;
}

// The tensor-core tiles of autotune.GMM_TC_TILES, (bm, bn, bk): bk is the
// 64-deep stage of hopper_gemm.cuh.  The layouts as dispatch_layout's: the
// forward reads x K-major and w MN-major; out = x @ w^T reads w K-major (B
// K-major), out = x^T @ w reads x MN-major (A MN-major), each in place.
template <bool kAMn, bool kBK>
cudaError_t dispatch_tc(const void* x, const void* w, void* out, const int* rows, int e,
                        int cap, int d, int f, int bm, int bn, int bk, cudaStream_t stream) {
#define TILE(BM, BN, BK)                                             \
  if (bm == BM && bn == BN && bk == BK)                              \
    return hgemm::launch<BM, BN, kAMn, kBK>(x, w, out, e, cap, f, d, stream, rows);
  TILE(64, 64, 64)
  TILE(64, 128, 64)
  TILE(128, 128, 64)
  TILE(128, 256, 64)
#undef TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// out (E, cap, f) = x @ w for x (E, cap, d) and w (E, d, f), or (layout 1)
// x @ w^T for w stored (E, f, d), or (layout 2) x^T @ w for x stored
// (E, d, cap); all contiguous.  rows: nullptr, or a device int32 array (E,)
// of row counts (the rows of out[e] at or past rows[e] are zeros).  dtype:
// 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch (0
// on success); cudaErrorInvalidValue for an unsupported shape or layout.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out, const int* rows,
                                     int e, int cap, int d, int f, int bm, int dtype, int layout,
                                     void* stream) {
  if (e <= 0 || e > 65535 || cap <= 0 || d <= 0 || f <= 0 || bm <= 0 ||
      (cap + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_layout<float>(x, w, out, rows, e, cap, d, f, bm, layout, st);
  if (dtype == 1)
    return (int)dispatch_layout<__nv_bfloat16>(x, w, out, rows, e, cap, d, f, bm, layout, st);
  return (int)cudaErrorInvalidValue;
}

// bf16 on the tensor cores, the layouts and row counts of
// grouped_matmul_launch: the contiguous dim of each operand (d and f for the
// forward; f for layout 1, d and f for layout 2) a multiple of 8, f a
// multiple of 8, x, w and out 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 on success); cudaErrorInvalidValue for a shape, tile,
// layout or pointer the route does not take.
extern "C" int grouped_matmul_tc_launch(const void* x, const void* w, void* out, const int* rows,
                                        int e, int cap, int d, int f, int bm, int bn, int bk,
                                        int layout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0)
    return (int)dispatch_tc<false, false>(x, w, out, rows, e, cap, d, f, bm, bn, bk, st);
  if (layout == 1)
    return (int)dispatch_tc<false, true>(x, w, out, rows, e, cap, d, f, bm, bn, bk, st);
  if (layout == 2)
    return (int)dispatch_tc<true, false>(x, w, out, rows, e, cap, d, f, bm, bn, bk, st);
  return (int)cudaErrorInvalidValue;
}
