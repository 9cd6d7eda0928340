// Device code shared by the selective scan's forward (ssm_scan.cu) and its
// backward (ssm_scan_bwd.cu): the split-TF32 warp products, the cp.async
// tile copies, programmatic dependent launch, the within-chunk cumulative
// log-decay and the chunk-state kernel (the forward's S_c and the
// backward's reverse chunk states R_c).  Everything is in an unnamed
// namespace: a function-local static of a template with external linkage
// would be one object across the two libraries of a process.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 32;     // the K step of C B^T and of the readout (autotune.SCAN_KT)
constexpr int kNT = 64;     // N rows of a chunk-state tile (autotune.SCAN_NT)
constexpr int kCT = 32;     // the side of a C B^T tile (autotune.SCAN_CT)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two adjacent values of y in one store (dst 2-element aligned)
__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// the smallest row pitch >= c that is r modulo 32 banks
__host__ __device__ constexpr int pitch(int c, int r) { return c + ((r - c % 32) + 32) % 32; }

// Element strides (batch, time, head) of the four inputs.  Mirrors the
// int64[12] array the wrapper passes.
struct Strides {
  long long x[3], a[3], b[3], c[3];
};

struct Dims {
  int B, H, S, P, N;
  int nc;     // chunks
  int hg;     // B/C groups a batch: 1 where b and c broadcast over the heads, else H
  int xunit;  // bytes x is copied in: 16 or 4 (aligned addresses and strides), or 2 (bf16 at
              // an odd one: element by element)
  int wide;   // copied in 16-byte units: 1 b, 2 c, 4 the chunk states (P a multiple of 4)
};

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

// ---------------------------------------------------------------------------
// split-TF32 warp products
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo in TF32; an operand exact in TF32 (a bf16 value) keeps hi = v
template <bool kSplit>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (kSplit) {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// How the warps of a block share an R x C output tile: WM x WN warps, each
// (16 MT) x (8 NT), at most 8 warps; WN is 4 (or C / 8 where smaller) unless
// kWN names it.
template <int R, int C, int kWN = 0>
struct WarpGrid {
  static constexpr int tm = R / 16, tn = C / 8;
  static constexpr int WN = kWN > 0 ? kWN : (tn >= 4 ? 4 : tn);
  static constexpr int WM = tm < 8 / WN ? tm : 8 / WN;
  static constexpr int MT = tm / WM, NT = tn / WN;
  static constexpr int kWarps = WM * WN;
  static_assert(R % 16 == 0 && C % 8 == 0 && tm % WM == 0 && tn % WN == 0, "tile shape");
};

template <int R, int C, int kWN = 0>
struct Acc {
  using G = WarpGrid<R, C, kWN>;
  float v[G::MT][G::NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][j][e] = 0.f;
  }

  // acc += A B over k in [0, K) (K a multiple of 8), with A(r, k) at
  // A[r * ar + k * ak] and B(k, c) at B[k * bk + c * bc] in shared memory
  // (f32, or bf16 widened exactly).  kSA / kSB: split that operand (f32) or
  // take it as exact in TF32; with Alo, A holds the high TF32 parts and Alo
  // (same layout) the low ones, split beforehand.  Products known to be zero
  // are skipped, a 16-row block at a time: with tri >= 0, A(r, k) is 0 where
  // tri + k > r (a causal mask whose column 0 is tri); with triu >= 0, A(r,
  // k) is 0 where triu + k < r (its transpose); with `lower`, only the output
  // entries (r, c) with c <= r are needed.
  template <bool kSA, bool kSB, int kUnroll = 2, typename TB, typename TA>
  __device__ __forceinline__ void mma(const TA* A, int ar, int ak, const TB* B, int bk,
                                      int bc, int K, int tri = -1, bool lower = false,
                                      const float* Alo = nullptr, int triu = -1) {
    const int warp = threadIdx.x >> 5;
    if (warp >= G::kWarps) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int r0 = (warp / G::WN) * 16 * G::MT, c0 = (warp % G::WN) * 8 * G::NT;
    if (tri > r0 + 16 * G::MT - 1 || (lower && c0 > r0 + 16 * G::MT - 1)) return;
    if (triu >= 0 && triu + K - 1 < r0) return;
    const int oa = (r0 + g) * ar + q * ak;
    const TB* pb = B + q * bk + (c0 + g) * bc;
#pragma unroll (kUnroll)
    for (int k = 0; k < K; k += 8) {
      uint32_t bh[G::NT][2], bl[G::NT][2];
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const TB* p = pb + k * bk + 8 * j * bc;
        split<kSB>(to_f(p[0]), bh[j][0], bl[j][0]);
        split<kSB>(to_f(p[4 * bk]), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < G::MT; ++i) {
        const int rlast = r0 + 16 * i + 15;
        if (tri >= 0 && tri + k > rlast) continue;
        if (triu >= 0 && triu + k + 7 < r0 + 16 * i) continue;
        uint32_t ah[4], al[4];
        const int o[4] = {oa + 16 * i * ar + k * ak, oa + (16 * i + 8) * ar + k * ak,
                          oa + 16 * i * ar + (k + 4) * ak, oa + (16 * i + 8) * ar + (k + 4) * ak};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kSA && Alo != nullptr) {
            ah[e] = __float_as_uint(to_f(A[o[e]]));
            al[e] = __float_as_uint(Alo[o[e]]);
          } else {
            split<kSA>(to_f(A[o[e]]), ah[e], al[e]);
          }
        }
        // consecutive products go to different accumulators where NT > 1
#pragma unroll
        for (int j = 0; j < G::NT; ++j)
          if (kSA && !(lower && c0 + 8 * j > rlast)) mma8(v[i][j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < G::NT; ++j)
          if (kSB && !(lower && c0 + 8 * j > rlast)) mma8(v[i][j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < G::NT; ++j)
          if (!(lower && c0 + 8 * j > rlast)) mma8(v[i][j], ah, bh[j]);
      }
    }
  }

  // f(row, col, value at col, value at col + 1) for every pair of adjacent
  // entries this thread holds (col is even)
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int warp = threadIdx.x >> 5;
    if (warp >= G::kWarps) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int r0 = (warp / G::WN) * 16 * G::MT + g, c0 = (warp % G::WN) * 8 * G::NT + 2 * q;
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int r = r0 + 16 * i, c = c0 + 8 * j;
        f(r, c, v[i][j][0], v[i][j][1]);
        f(r + 8, c, v[i][j][2], v[i][j][3]);
      }
  }

  // every entry of row r times w[r] (w in shared memory)
  __device__ __forceinline__ void scale_rows(const float* w) {
    const int warp = threadIdx.x >> 5;
    if (warp >= G::kWarps) return;
    const int r0 = (warp / G::WN) * 16 * G::MT + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int i = 0; i < G::MT; ++i) {
      const float w0 = w[r0 + 16 * i], w1 = w[r0 + 16 * i + 8];
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        v[i][j][0] *= w0;
        v[i][j][1] *= w0;
        v[i][j][2] *= w1;
        v[i][j][3] *= w1;
      }
    }
  }

  // out[r] = the sum over the tile's columns c of f(r, c, entry (r, c)), for
  // every row r < R, in a fixed order (a thread's columns, the four lanes of
  // a quad by two shuffles, then the WN warps of a row in turn), so the same
  // inputs give the same bits.  red: WN * R floats of shared memory, out: R.
  // Every thread of the block calls it; it ends with a barrier.
  template <typename F>
  __device__ __forceinline__ void row_sums(F f, float* red, float* out) const {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if (warp < G::kWarps) {
      const int r0 = (warp / G::WN) * 16 * G::MT + g, c0 = (warp % G::WN) * 8 * G::NT + 2 * q;
#pragma unroll
      for (int i = 0; i < G::MT; ++i) {
        float s0 = 0.f, s1 = 0.f;
        const int r = r0 + 16 * i;
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          const int c = c0 + 8 * j;
          s0 += f(r, c, v[i][j][0]) + f(r, c + 1, v[i][j][1]);
          s1 += f(r + 8, c, v[i][j][2]) + f(r + 8, c + 1, v[i][j][3]);
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if (q == 0) {
          red[(warp % G::WN) * R + r] = s0;
          red[(warp % G::WN) * R + r + 8] = s1;
        }
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < G::WN; ++w) s += red[w * R + r];
      out[r] = s;
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// asynchronous tile copies (cp.async): every load of a tile is in flight at
// once and holds no register
// ---------------------------------------------------------------------------
// 4 or 16 bytes to shared memory, `bytes` of them from src, the rest zero
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch: the four kernels of a call are launched so
// that each one's launch is prepared while the previous one runs.  Each
// kernel first waits until the previous grid has completed and its writes
// are visible (transitively, every earlier one).
__device__ __forceinline__ void follow_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Starts copying a ROWS x COLS tile of E (4 bytes or 2) into shared memory
// (row pitch ld elements, a 16-byte multiple), in units of kUnit bytes: row r
// starts at src + r * rstride; rows from `rows` on and columns from `cols` on
// are zero.  src and rstride must be multiples of the unit.
template <int kUnit, typename E, int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(E* dst, int ld, const E* src, long long rstride,
                                          int rows, int cols) {
  constexpr int kPer = kUnit / (int)sizeof(E);   // elements a unit
  constexpr int U = COLS / kPer;                  // units a row
  static_assert(COLS % kPer == 0, "tile width");
  for (int i = threadIdx.x; i < ROWS * U; i += kThreads) {
    const int r = i / U, c = (i - r * U) * kPer;
    const int left = r < rows ? cols - c : 0;
    const int bytes = left <= 0 ? 0 : (left >= kPer ? kUnit : left * (int)sizeof(E));
    const void* from = bytes ? static_cast<const void*>(src + r * rstride + c)
                             : static_cast<const void*>(src);
    if (kUnit == 16)
      cp16(dst + r * ld + c, from, bytes);
    else
      cp4(dst + r * ld + c, from, bytes);
  }
}

// copy_tile in 16-byte units where `wide`, else in 4-byte units.
template <typename E, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(E* dst, int ld, const E* src, long long rstride,
                                          int rows, int cols, bool wide) {
  if (wide)
    copy_tile<16, E, ROWS, COLS>(dst, ld, src, rstride, rows, cols);
  else
    copy_tile<4, E, ROWS, COLS>(dst, ld, src, rstride, rows, cols);
}

// The X tile: in x's unit (Dims::xunit), for a bf16 x at an odd address or
// stride element by element.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_x(T* dst, int ld, const T* src, long long rstride, int rows,
                                       int cols, int unit) {
  if (unit >= 4) {
    load_tile<T, ROWS, COLS>(dst, ld, src, rstride, rows, cols, unit == 16);
    return;
  }
  for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
    const int r = i / COLS, c = i - r * COLS;
    dst[r * ld + c] = r < rows && c < cols ? src[r * rstride + c] : from_f<T>(0.f);
  }
}

// cum[t] for the chunk starting at t0, by the warp whose lane is `lane`
// (every lane of that warp calls it): each lane sums L/32 consecutive steps,
// then a warp scan.  Steps at or beyond S count a = 1.  The chunk-state
// kernel stores it for the pass and the readout.
template <int L>
__device__ __forceinline__ void chunk_cum(const float* ab, long long sa, int t0, int S, float* cum,
                                          int lane) {
  constexpr int E = L / 32;
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int gt = t0 + lane * E + r;
    const float av = gt < S ? ab[(long long)gt * sa] : 1.f;
    run += logf(fmaxf(av, 1e-20f));
    v[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  const float excl = lane == 0 ? 0.f : prev;
#pragma unroll
  for (int r = 0; r < E; ++r) cum[lane * E + r] = v[r] + excl;
}

// X in shared memory: x's own dtype (a bf16 tile is widened exactly when a
// fragment is read), with a row pitch that keeps the fragment reads of a
// warp on distinct 4-byte words: 8 modulo 32 for f32, 16 modulo 64 for bf16.
template <typename T>
__host__ __device__ constexpr int x_pitch(int c) {
  return sizeof(T) == 4 ? pitch(c, 8) : c + ((16 - c % 64) + 64) % 64;
}

// Shared memory, in floats, of the kernels.  Must agree with
// repro_torch.kernels.autotune.scan_smem_bytes.
__host__ __device__ constexpr int cbt_smem_floats() {
  // two stages of a C and a B tile (kCT x kKT, pitch 4 mod 32)
  return 2 * 2 * kCT * pitch(kKT, 4);
}
__host__ __device__ constexpr int chunk_smem_floats(int L, int pt) {
  // two stages of B w's high and low TF32 parts (kKT x kNT, pitch 8) and X
  // (kKT x pt, at most f32 pitch 8); w (L)
  return 2 * (2 * kKT * pitch(kNT, 8) + kKT * pitch(pt, 8)) + L;
}
__host__ __device__ constexpr int out_smem_floats(int L, int pt) {
  // two stages of the A tile's high and low TF32 parts (L x kKT, pitch 4)
  // and the B tile (kKT x pt, X or the state, pitch 8), cum and exp(cum)
  return 2 * (2 * L * pitch(kKT, 4) + kKT * pitch(pt, 8)) + 2 * L;
}

// ---------------------------------------------------------------------------
// 2. the chunk states S_c = B^T diag(exp(cum_L - cum)) X, per (batch *
// head, chunk, N tile, P tile); the first N and P tile's block also stores the
// chunk's cum, which the pass (d_c = exp(cum_L)) and the readout read (where
// cums is not null).  With kRev, the backward's reverse chunk states R_c =
// C^T diag(exp(cum)) dY instead: the wrapper passes c as `bmat` and dy as `x`.
// ---------------------------------------------------------------------------
template <typename T, int L, int PT, bool kRev = false>
__global__ void __launch_bounds__(kThreads, 1)
ssm_scan_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ bmat, float* __restrict__ states,
                      float* __restrict__ cums, const Strides st, const Dims d) {
  constexpr bool kXExact = sizeof(T) == 2;   // bf16 x is exact in TF32
  extern __shared__ float smem[];
  follow_previous_grid();
  const int tid = threadIdx.x;
  int id = blockIdx.x;
  const int ntp = (d.P + PT - 1) / PT, ntn = (d.N + kNT - 1) / kNT;
  const int pt = id % ntp;
  id /= ntp;
  const int nt = id % ntn;
  id /= ntn;
  const int ci = id % d.nc, bh = id / d.nc;
  const int bi = bh / d.H, hi = bh - bi * d.H;
  const int t0 = ci * L, n0 = nt * kNT, p0 = pt * PT;
  const int S = d.S, N = d.N, P = d.P;
  constexpr int LDB = pitch(kNT, 8), LDX = x_pitch<T>(PT);
  // a stage: B[t][n] (then the high TF32 parts of B[t][n] w[t]), their low
  // parts, X[t][p], for kKT steps t
  constexpr int kStage = 2 * kKT * LDB + kKT * pitch(PT, 8);
  float* w = smem + 2 * kStage;        // [L]: cum, then exp(cum_L - cum) (kRev: exp(cum))
  const long long sb = st.b[1], sx = st.x[1];
  const int xunit = d.xunit;
  const bool wb = d.wide & 1;
  const float* bsrc = bmat + bi * st.b[0] + hi * st.b[2] + (long long)t0 * sb + n0;
  const T* xsrc = x + bi * st.x[0] + hi * st.x[2] + (long long)t0 * sx + p0;
  auto issue = [&](int k) {
    float* bw = smem + (k & 1) * kStage;
    const int r0 = k * kKT;
    load_tile<float, kKT, kNT>(bw, LDB, bsrc + (long long)r0 * sb, sb, S - t0 - r0, N - n0,
                               wb);
    load_x<T, kKT, PT>(reinterpret_cast<T*>(bw + 2 * kKT * LDB), LDX, xsrc + (long long)r0 * sx,
                       sx, S - t0 - r0, P - p0, xunit);
    cp_commit();
  };
  Acc<kNT, PT> acc;
  acc.zero();
  constexpr int kSteps = L / kKT;
  // step k + 1's copies go out before step k's products (one call site, so
  // `issue` is inlined); warp 0 makes w while step 0's are in flight
  for (int k = -1; k < kSteps; ++k) {
    if (k + 1 < kSteps) issue(k + 1);
    if (k < 0) {
      if (tid < 32) {
        chunk_cum<L>(a + bi * st.a[0] + hi * st.a[2], st.a[1], t0, S, w, tid);
        __syncwarp();
        const float last = w[L - 1];
        if (cums != nullptr && nt == 0 && pt == 0)
          for (int t = tid; t < L; t += 32) cums[((size_t)bh * d.nc + ci) * L + t] = w[t];
        __syncwarp();   // every lane has read w before it is overwritten
        for (int t = tid; t < L; t += 32) w[t] = kRev ? expf(w[t]) : expf(last - w[t]);
      }
      continue;
    }
    if (k + 1 < kSteps)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();   // step k's tiles (and w) are in
    float* bw = smem + (k & 1) * kStage;
    float* blo = bw + kKT * LDB;
    for (int i = tid; i < kKT * kNT; i += kThreads) {
      const int t = i / kNT, c = i - t * kNT;
      uint32_t h, l;
      split<true>(bw[t * LDB + c] * w[k * kKT + t], h, l);
      bw[t * LDB + c] = __uint_as_float(h);
      blo[t * LDB + c] = __uint_as_float(l);
    }
    __syncthreads();
    acc.template mma<true, !kXExact>(bw, 1, LDB, reinterpret_cast<const T*>(blo + kKT * LDB),
                                     LDX, 1, kKT, -1, false, blo);
    __syncthreads();   // stage k % 2 is free for step k + 2
  }
  // pairs of adjacent columns leave as one 8-byte store where P is even
  float* sout = states + ((size_t)bh * d.nc + ci) * N * P + (size_t)n0 * P + p0;
  const bool pairs = P % 2 == 0;
  acc.each([&](int r, int c, float v0, float v1) {
    if (n0 + r >= N || p0 + c >= P) return;
    float* out = sout + (size_t)r * P + c;
    if (pairs) {
      *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    } else {
      out[0] = v0;
      if (p0 + c + 1 < P) out[1] = v1;
    }
  });
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, std::atomic<unsigned long long>& opted) {
  return smem > 48 * 1024 ? opt_in_smem(kernel, opted) : cudaSuccess;
}

// Launches `kernel` on `blocks` blocks with programmatic stream
// serialization (see follow_previous_grid).
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), unsigned blocks, int smem,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
