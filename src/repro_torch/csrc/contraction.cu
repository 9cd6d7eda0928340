// One scheduled POM contraction statement, D = D + X * Y, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel` of
// src/repro/core/backend_pallas.py:286 (built in _lower_stmt_pallas_compute).
// There the statement's non-unrolled dims form the Pallas grid, its fully
// unrolled dims form the VMEM block, BlockSpec index maps cut X, Y and D, the
// reduction grid dims are "arbitrary" axes that carry the sum in the output
// block from one grid step to the next, and each step is one dot_general.
//
// Here the lowering (src/repro_torch/core/backend_cuda.py) linearises every
// access: for each statement dim d and each array, the offset coefficient is
// sum over array axes of (coefficient of d in the composed index) x (the
// axis's row-major stride), plus a constant offset that folds in the lower
// bounds.  Dims that appear in the store access are output dims; all others
// are reduction dims.  The kernel then computes, for every output point p,
//     D[o(p)] = D[o(p)] + sum over reduction points r of X[x(p, r)] * Y[y(p, r)]
// with the sum kept in f32 (f64 for f64 arrays) and the result cast to D's
// dtype once.  D arrives holding the statement's initial contents (the
// wrapper clones it), so points the statement does not store keep them.
//
// Three kernels.  GEMM-shaped statements (f32 or bf16, every output dim
// moves X or Y but not both, M and N of at least 128; gemm, 2mm, 3mm and
// the conv nests) re-block the output into 128 x 128 tiles, since the DSE's
// blocks (32 x 32 at most on the compile path) are too small for register
// tiling.  Those whose M, N and K groups each linearise to one stride, X
// contiguous along K and Y along N (the tiled gemm, 2mm and 3mm) take, in
// f32, contraction_strided_kernel: a multi-stage shared-memory ring, no
// offset tables.  The others (the conv nests' implicit im2col, other
// layouts, bf16) take contraction_gemm_kernel, which gathers X and Y
// through per-statement offset tables.  Every other statement (the
// matrix-vector shapes of bicg/gesummv, batched dims, f64) takes the
// generic contraction_kernel.
//
// Generic mapping: the output points are linearised as (batch, output grid
// dims, output block dims), the DSE's block dims innermost, and walked by
// CTAs of 256 threads (grid-stride).  A DSE block of 256 points or more spans whole
// CTAs; smaller blocks (an unscheduled statement has block 1: one thread per
// output element) share a CTA.  The reduction grid dims and reduction block
// dims are a loop inside the thread (an odometer over the reduction dims,
// innermost dim as a strided inner loop): the TPU's sequential "arbitrary"
// axis moved inside the program, so no two threads ever write one output.
//
// Bound: at the gemm size the path runs (n 4096, f32), operations: 2 n^3 =
// 137.4 GFLOP at the H100's 67 TFLOP/s f32 rate on CUDA cores is 2.05 ms,
// against ~0.08 ms to move the three arrays once.  TF32 stays off, as in the
// rest of the port, so the tensor cores do not apply to f32.  The generic
// kernel does nothing about that bound beyond keeping every product in a
// register FMA chain (it reads X and Y through L1/L2, coalesced along the
// innermost output dim); it ran gemm n 4096 at 1.2 TFLOP/s.  The GEMM-shaped
// kernels attack it the classic way: each X and Y element staged in shared
// memory feeds 128 FMAs and 64 accumulators per thread stay in registers,
// with two CTAs on each SM.  The table kernel prefetches the next 8-deep k
// step through registers (two __syncthreads a step, each element a scalar
// load through two int64 offsets); the strided kernel keeps three 16-deep
// steps in flight in a shared-memory ring (cp.async for Y, 16-byte loads
// of X one step ahead; one __syncthreads a step, no tables).  Warp specialisation and wgmma for bf16 are later work.
//
// All offsets are 64-bit, so arrays and batches past 2^31 elements work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxDims = 16;
constexpr int kThreads = 256;

}  // namespace

// Mirrors `ContractionDesc._C` in src/repro_torch/kernels/contraction.py.
struct ContractionDesc {
  int32_t n_out, n_red;
  int64_t out_trip[kMaxDims], out_x[kMaxDims], out_y[kMaxDims], out_o[kMaxDims];
  int64_t red_trip[kMaxDims], red_x[kMaxDims], red_y[kMaxDims];
  int64_t x0, y0, o0;
  int64_t batch, bx, by, bo;  // batch count, per-array batch strides (0: shared)
  int64_t points, red_points;  // products of the output / reduction trips
};

namespace {

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T, typename A> __device__ __forceinline__ T from_acc(A x);
template <> __device__ __forceinline__ float from_acc<float, float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ double from_acc<double, double>(double x) { return x; }

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
contraction_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                   const ContractionDesc d) {
  const int64_t total = d.batch * d.points;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int last = d.n_red - 1;
  for (int64_t lin = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; lin < total;
       lin += step) {
    int64_t b = lin / d.points;
    int64_t p = lin - b * d.points;
    int64_t xo = d.x0 + b * d.bx, yo = d.y0 + b * d.by, oo = d.o0 + b * d.bo;
    for (int i = d.n_out - 1; i >= 0; --i) {  // innermost output dim first
      const int64_t t = d.out_trip[i];
      const int64_t q = p / t;
      const int64_t r = p - q * t;
      p = q;
      xo += r * d.out_x[i];
      yo += r * d.out_y[i];
      oo += r * d.out_o[i];
    }
    A acc = 0;
    if (d.red_points > 0) {
      if (last < 0) {
        acc = to_acc(x[xo]) * to_acc(y[yo]);
      } else {
        int64_t idx[kMaxDims];
        for (int r = 0; r < last; ++r) idx[r] = 0;
        const int64_t tl = d.red_trip[last], sx = d.red_x[last], sy = d.red_y[last];
        for (;;) {
          int64_t xi = xo, yi = yo;
#pragma unroll 4
          for (int64_t t = 0; t < tl; ++t) {
            acc += to_acc(x[xi]) * to_acc(y[yi]);
            xi += sx;
            yi += sy;
          }
          int r = last - 1;
          for (; r >= 0; --r) {  // odometer carry over the outer reduction dims
            xo += d.red_x[r];
            yo += d.red_y[r];
            if (++idx[r] < d.red_trip[r]) break;
            xo -= d.red_x[r] * d.red_trip[r];
            yo -= d.red_y[r] * d.red_trip[r];
            idx[r] = 0;
          }
          if (r < 0) break;
        }
      }
    }
    out[oo] = from_acc<T, A>(to_acc(out[oo]) + acc);
  }
}

// GEMM-shaped descriptors: every output dim moves X or Y but not both.  The
// output dims then split into M dims (Y constant along them) and N dims
// (X constant along them), the reduction dims form K, and the statement is
//     D[mo[m] + no[n]] += sum_k X[mx[m] + kx[k]] * Y[ny[n] + ky[k]]
// with the six offset tables built by the wrapper (one int64 per index).
// Each CTA computes a 128 x 128 tile of (m, n) with 256 threads, 8 x 8
// outputs per thread in registers, staging 128 x 8 tiles of X and 8 x 128
// tiles of Y in shared memory per step of 8 k (gathered through the
// tables, so any affine layout works: gemm, the conv nests as an implicit
// im2col).  Each output's products are summed in k order into one f32
// register, the order of the generic kernel, so both give the same bits.
constexpr int kBM = 128, kBN = 128, kBK = 8, kGemmThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
contraction_gemm_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                        const int64_t* __restrict__ mx, const int64_t* __restrict__ mo,
                        const int64_t* __restrict__ ny, const int64_t* __restrict__ no,
                        const int64_t* __restrict__ kx, const int64_t* __restrict__ ky,
                        int64_t M, int64_t N, int64_t K, int64_t bx, int64_t by, int64_t bo) {
  constexpr int kLoads = (kBM * kBK) / kGemmThreads;  // X (and Y) elements per thread per step
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ int64_t smx[kBM], sny[kBN];
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int64_t b = blockIdx.z;
  x += b * bx;
  y += b * by;
  out += b * bo;
  if (tid < kBM) {
    const int64_t m = m0 + tid;
    smx[tid] = m < M ? mx[m] : 0;
  } else {
    const int64_t n = n0 + (tid - kBM);
    sny[tid - kBM] = n < N ? ny[n] : 0;
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;  // this thread's 8 x 8 outputs
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // The next step's X and Y elements are loaded into registers while the
  // current step computes from shared memory.  X: 8 threads walk k (rows
  // contiguous in k); Y: a warp walks n (rows contiguous in n).
  float xr[kLoads], yr[kLoads];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kGemmThreads;
      const int kk = e % kBK, mm = e / kBK;
      const int64_t k = k0 + kk;
      xr[r] = (k < K && m0 + mm < M) ? to_acc(x[smx[mm] + kx[k]]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kGemmThreads;
      const int nn = e % kBN, kk = e / kBN;
      const int64_t k = k0 + kk;
      yr[r] = (k < K && n0 + nn < N) ? to_acc(y[sny[nn] + ky[k]]) : 0.f;
    }
  };
  load(0);
  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kGemmThreads;
      As[e % kBK][e / kBK] = xr[r];
      Bs[e / kBN][e % kBN] = yr[r];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], c[8];
      const float4* ap = reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4* cp = reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 a0 = ap[0], a1 = ap[1], c0 = cp[0], c1 = cp[1];
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
      c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + ty * 8 + i;
    if (m >= M) continue;
    const int64_t om = mo[m];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + tx * 8 + j;
      if (n < N) {
        const int64_t o = om + no[n];
        out[o] = from_acc<T, float>(to_acc(out[o]) + acc[i][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_gemm(const void* x, const void* y, void* out, const int64_t* const* tab,
                        int64_t M, int64_t N, int64_t K, int64_t batch, int64_t bx,
                        int64_t by, int64_t bo, cudaStream_t st) {
  if (M == 0 || N == 0 || batch == 0) return cudaSuccess;
  dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM), (unsigned)batch);
  contraction_gemm_kernel<T><<<grid, kGemmThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), tab[0], tab[1],
      tab[2], tab[3], tab[4], tab[5], M, N, K, bx, by, bo);
  return cudaGetLastError();
}

template <typename T, typename A>
cudaError_t launch(const void* x, const void* y, void* out, const ContractionDesc& d,
                   cudaStream_t st) {
  const int64_t total = d.batch * d.points;
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride covers the rest
  contraction_kernel<T, A><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float64.  `out` holds D's initial contents.
extern "C" int contraction_launch(const void* x, const void* y, void* out,
                                  const ContractionDesc* desc, int dtype, void* stream) {
  const ContractionDesc& d = *desc;
  if (d.n_out < 0 || d.n_out > kMaxDims || d.n_red < 0 || d.n_red > kMaxDims ||
      d.batch < 0 || d.points < 0 || d.red_points < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < d.n_out; ++i)
    if (d.out_trip[i] <= 0 && d.points > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, float>(x, y, out, d, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16, float>(x, y, out, d, st);
  if (dtype == 2) return (int)launch<double, double>(x, y, out, d, st);
  return (int)cudaErrorInvalidValue;
}

// The GEMM-shaped variant (f32 and bf16 only).  `tables` holds six device
// pointers: mx, mo (M entries), ny, no (N entries), kx, ky (K entries).
extern "C" int contraction_gemm_launch(const void* x, const void* y, void* out,
                                       const int64_t* const* tables, int64_t M, int64_t N,
                                       int64_t K, int64_t batch, int64_t bx, int64_t by,
                                       int64_t bo, int dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0 || batch < 0 || batch > 65535 ||
      (M + kBM - 1) / kBM > 65535 || (N + kBN - 1) / kBN > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_gemm<float>(x, y, out, tables, M, N, K, batch, bx, by, bo, st);
  if (dtype == 1)
    return (int)launch_gemm<__nv_bfloat16>(x, y, out, tables, M, N, K, batch, bx, by, bo, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------------
// The strided (affine) GEMM-shaped path, f32.  When each of the M, N and K
// groups of dims linearises to one stride (contraction.gemm_strides) and the
// operands have the row-major layout of the compile path's tiled gemm, 2mm
// and 3mm (contraction.takes_strided: X contiguous along K, Y along N, every
// row and batch lane on a 16-byte boundary), element (m, k) of X is
// x[x0 + m sxm + k], (k, n) of Y is y[y0 + k syk + n] and the output (m, n)
// is out[o0 + m som + n son]: no offset tables.  Each CTA computes a
// 128 x 128 tile with 256 threads, 8 x 8 sums a thread in registers.  X and
// Y tiles (16 deep) live in a ring of four shared-memory stages, one
// __syncthreads a k step.  Y's runs along N land in its tile by 16-byte
// cp.async copies; X's runs along K cannot land in a k-major tile 16 bytes
// at a time, so each thread loads two float4s of the next tile into
// registers before a step's products and stores them transposed after them.
// Both tiles are stored k-major ([k][m], [k][n], rows padded to 132
// floats), so the inner loop reads a thread's 8 rows and 8 columns as
// float4s in two groups 64 apart, without bank conflicts.  Each output's
// products are summed in k order into one f32 register (fmaf), as the
// generic and the table kernels do, so all three give the same bits; any
// other layout takes the table kernel.
struct StridedGemm {
  int64_t M, N, K;
  int64_t sxm, sxk, syk, syn, som, son;
  int64_t x0, y0, o0;
  int64_t bx, by, bo;          // batch strides (0: shared)
};

namespace {

// 16-deep k steps in four stages (32-deep steps in three were slower at
// gemm n 4096 on an H100)
constexpr int kSBM = 128, kSBN = 128, kSBK = 16, kSStages = 4, kSThreads = 256;
constexpr int kSLd = 132;                    // floats a k row of a staged tile (128 + 4)
constexpr int kSTile = kSBK * kSLd;          // floats of one staged X (or Y) tile
constexpr int kSSmem = kSStages * 2 * kSTile * 4;

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

// Y's kSBK x 128 tile at (k0, n0), element (k, n) = src[(k0 + k) syk + n0 + n],
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
    for (int r = 0; r < kSBK * 128 / 4 / kSThreads; ++r) {
      const bool ok = 8 * r < kl && bytes > 0;
      cp_async16(dst + 4 * ((ka + 8 * r) * kSLd + na), ok ? q + 8 * r * syk : p, ok ? bytes : 0);
    }
  }
};

// X's kSBK x 128 tile at (k0, m0), element (k, m) = src[(m0 + m) sxm + k0 + k]:
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
      float* d = dst + ka * kSLd + ma + 64 * r;
      d[0] = held[r].x;
      d[kSLd] = held[r].y;
      d[2 * kSLd] = held[r].z;
      d[3 * kSLd] = held[r].w;
    }
  }
};

__global__ void __launch_bounds__(kSThreads, 2)
contraction_strided_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           float* __restrict__ out, const StridedGemm g) {
  extern __shared__ __align__(16) float ssm[];   // stage s: X tile, then Y tile
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.y * kSBM, n0 = (int64_t)blockIdx.x * kSBN;
  const int64_t b = blockIdx.z;
  XOperand xo(x + g.x0 + b * g.bx, g.sxm, m0, g.M, tid);
  const YOperand yo(y + g.y0 + b * g.by, g.syk, n0, g.N, tid);
  const uint32_t s0 = smem_addr(ssm);
  const int k_tiles = static_cast<int>((g.K + kSBK - 1) / kSBK);
#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < k_tiles) {
      const int64_t k0 = (int64_t)s * kSBK;
      xo.load(k0, g.K - k0);
      xo.store(ssm + 2 * s * kSTile);
      yo.stage(s0 + 4 * (2 * s + 1) * kSTile, k0, g.K - k0);
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
    cp_async_wait<kSStages - 2>();     // the copies of step kt have landed (this thread's)
    __syncthreads();                   // ... everyone's; step kt - 1's stage is free
    const int nt = kt + kSStages - 1;
    if (nt < k_tiles) {                // step nt: X into registers, Y copies issued
      const int64_t k0 = (int64_t)nt * kSBK;
      xo.load(k0, g.K - k0);
      yo.stage(s0 + 4 * (2 * (nt % kSStages) + 1) * kSTile, k0, g.K - k0);
    }
    cp_async_commit();
    const float* as = ssm + 2 * (kt % kSStages) * kSTile;
    const float* bs = as + kSTile;
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kSLd + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kSLd + 64 + ty * 4);
      const float4 c0 = *reinterpret_cast<const float4*>(bs + kk * kSLd + tx * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(bs + kk * kSLd + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    // the held X tile goes to step nt's stage, free since this step's barrier
    if (nt < k_tiles) xo.store(ssm + 2 * (nt % kSStages) * kSTile);
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
        *o = *o + acc[i][j];
      }
    }
  }
}

}  // namespace

// The strided GEMM-shaped variant (f32).  `out` holds D's initial contents.
// Returns cudaErrorInvalidValue for a layout the kernel does not stage (see
// contraction.takes_strided): X must be contiguous along K and Y along N,
// with sxm, syk, x0, y0, bx, by multiples of 4 and x, y 16-byte aligned.
extern "C" int contraction_strided_launch(const void* x, const void* y, void* out,
                                          const StridedGemm* desc, int64_t batch, void* stream) {
  const StridedGemm& g = *desc;
  if (g.M < 0 || g.N < 0 || g.K < 0 || batch < 0 || batch > 65535 ||
      (g.M + kSBM - 1) / kSBM > 65535 || (g.N + kSBN - 1) / kSBN > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (g.sxk != 1 || g.syn != 1 || ((g.sxm | g.syk | g.x0 | g.y0 | g.bx | g.by) & 3) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (g.M == 0 || g.N == 0 || batch == 0) return (int)cudaSuccess;
  static const cudaError_t attr =   // once per process
      cudaFuncSetAttribute(contraction_strided_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((g.N + kSBN - 1) / kSBN), (unsigned)((g.M + kSBM - 1) / kSBM),
                  (unsigned)batch);
  contraction_strided_kernel<<<grid, kSThreads, kSSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}
