// Chunked selective scan (Mamba2 / SSD form, scalar decay per head) for
// Hopper (sm_90a):
//     h_t = a_t h_{t-1} + b_t (x) x_t,    y_t = c_t . h_t
// per (batch, head), with x (P wide), b and c (N wide) and h (N x P).
//
// Replaces the Pallas TPU kernel `_ssm_kernel` / `ssm_scan` in
// src/repro/kernels/ssm_scan.py (:28, :73).  There the grid is (b * h,
// chunk) with the chunk axis "arbitrary" (:110): h is carried in VMEM from
// one chunk to the next.  Here the chunk axis is the SSD decomposition, four
// kernels a call, of which only the third walks the chunks in order.  Per
// chunk of L steps (cum = inclusive cumsum of log max(a, 1e-20) over the
// chunk, cum_L its last entry):
//   1. ssm_scan_cbt_kernel, every (batch, B/C group, chunk, 32 x 32 tile on
//      or below the diagonal):  G = C B^T  (L x L, once per group)
//   2. ssm_scan_chunk_kernel, every (batch * head, chunk, 64-row N tile, P
//      tile):  S_c = B^T diag(exp(cum_L - cum)) X  (N x P), and cum
//   3. ssm_scan_pass_kernel, every (batch * head, 4 entries of N x P):
//        h_0 = 0,  h_{c+1} = exp(cum_L) h_c + S_c  (h_c overwrites S_c; the last h out)
//   4. ssm_scan_out_kernel, every (batch * head, chunk, P tile):
//        y = (G * tril(exp(cum_t - cum_s))) X + (C * exp(cum)) h_c
// C B^T depends on the B/C group, not on the head: where b and c have a
// head stride of 0 (zamba2 broadcasts one group over 32 heads) it is made
// once per (batch, chunk) and every head applies its own decay mask to it.
// The tail chunk is padded with a = 1, b = c = 0, x = 0, so any S runs.
//
// Bound: the products, on the tensor cores, and the chunk states' traffic.
// The products run as mma.sync m16n8k8 TF32 fed from shared memory by each
// warp (wgmma's TF32 form takes only K-major shared-memory operands, which X
// and the state are not in two of the four products).  TF32 keeps 11 bits,
// too few for the models (a 1e-3 change moves zamba2's and xlstm's logits by
// 21% and 74%), so every f32 operand is split into two TF32 parts, hi =
// tf32(v) and lo = tf32(v - hi), and a product takes three passes, lo*hi +
// hi*lo + hi*hi, with f32 sums: within a few ulp of f32.  A bf16 x is exact
// in TF32, so the products with X take two.  Tiles stream through shared
// memory in K steps of 32 with cp.async (16-byte units where addresses and
// strides allow), two stages deep, so the copy of step k + 1 is in flight
// while step k's products run; the masked decay, the scaled C and B w are
// split once, when they are made, not by every warp that reads them.  Row
// pitches keep every fragment load of a warp on distinct banks, and products
// known to be zero (above the causal diagonal) are skipped.  The four
// kernels go out with programmatic dependent launch, so each one's launch is
// prepared while the one before runs.
//
// Layouts: x (B, S, H, P) and b, c (B, S, H, N) with their last dim
// contiguous and any batch, time and head strides; a (B, S, H) with any
// strides.  a, b, c are float32; x is float32 or bfloat16.  h starts at 0;
// the final h is (B, H, N, P) f32, contiguous; y is (B, S, H, P) in x's
// dtype, contiguous.  Scratch (f32, from the wrapper): G (B * groups *
// chunks, L, L), the chunk states (B * H, chunks, N, P) and cum (B * H,
// chunks, L).
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
// (16 MT) x (8 NT), at most 8 warps.
template <int R, int C>
struct WarpGrid {
  static constexpr int tm = R / 16, tn = C / 8;
  static constexpr int WN = tn >= 4 ? 4 : tn;
  static constexpr int WM = tm < 8 / WN ? tm : 8 / WN;
  static constexpr int MT = tm / WM, NT = tn / WN;
  static constexpr int kWarps = WM * WN;
  static_assert(R % 16 == 0 && C % 8 == 0 && tm % WM == 0 && tn % WN == 0, "tile shape");
};

template <int R, int C>
struct Acc {
  using G = WarpGrid<R, C>;
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
  // A[r * ar + k * ak] (f32) and B(k, c) at B[k * bk + c * bc] (f32, or bf16
  // widened exactly) in shared memory.  kSA / kSB: split that operand (f32)
  // or take it as exact in TF32; with Alo, A holds the high TF32 parts and
  // Alo (same layout) the low ones, split beforehand.  Products known to be
  // zero are skipped, a 16-row block at a time: with tri >= 0, A(r, k) is 0
  // where tri + k > r (a causal mask whose column 0 is tri); with `lower`,
  // only the output entries (r, c) with c <= r are needed.
  template <bool kSA, bool kSB, int kUnroll = 2, typename TB>
  __device__ __forceinline__ void mma(const float* A, int ar, int ak, const TB* B, int bk,
                                      int bc, int K, int tri = -1, bool lower = false,
                                      const float* Alo = nullptr) {
    const int warp = threadIdx.x >> 5;
    if (warp >= G::kWarps) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int r0 = (warp / G::WN) * 16 * G::MT, c0 = (warp % G::WN) * 8 * G::NT;
    if (tri > r0 + 16 * G::MT - 1 || (lower && c0 > r0 + 16 * G::MT - 1)) return;
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
        uint32_t ah[4], al[4];
        const int o[4] = {oa + 16 * i * ar + k * ak, oa + (16 * i + 8) * ar + k * ak,
                          oa + 16 * i * ar + (k + 4) * ak, oa + (16 * i + 8) * ar + (k + 4) * ak};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kSA && Alo != nullptr) {
            ah[e] = __float_as_uint(A[o[e]]);
            al[e] = __float_as_uint(Alo[o[e]]);
          } else {
            split<kSA>(A[o[e]], ah[e], al[e]);
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
// 1. C B^T per (batch, B/C group, chunk), in kCT x kCT tiles on and below
// the diagonal (the readout uses G[t][s] for s <= t only)
// ---------------------------------------------------------------------------
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
ssm_scan_cbt_kernel(const float* __restrict__ bmat, const float* __restrict__ cmat,
                    float* __restrict__ gmat, const Strides st, const Dims d) {
  constexpr int TT = L / kCT, kTiles = TT * (TT + 1) / 2;
  constexpr int LD = pitch(kKT, 4);
  constexpr int kStage = 2 * kCT * LD;
  extern __shared__ float smem[];
  follow_previous_grid();
  int id = blockIdx.x;
  const int tile = id % kTiles;
  id /= kTiles;
  const int ci = id % d.nc, bg = id / d.nc;
  const int bi = bg / d.hg, hi = bg - bi * d.hg;
  int tr = 0;   // the tile's (row, column) among the lower tiles: 0 (0, 0), 1 (1, 0), 2 (1, 1), ...
  while ((tr + 1) * (tr + 2) / 2 <= tile) ++tr;
  const int tc = tile - tr * (tr + 1) / 2;
  const int t0 = ci * L, r0 = tr * kCT, s0 = tc * kCT, S = d.S, N = d.N;
  const long long sb = st.b[1], sc = st.c[1];
  const bool wb = d.wide & 1, wc = d.wide & 2;
  const float* cb = cmat + bi * st.c[0] + hi * st.c[2] + (long long)(t0 + r0) * sc;
  const float* bb = bmat + bi * st.b[0] + hi * st.b[2] + (long long)(t0 + s0) * sb;
  const int steps = (N + kKT - 1) / kKT;
  auto issue = [&](int k) {   // C[t][n] and B[s][n] of step k into stage k % 2
    float* cs = smem + (k & 1) * kStage;
    const int n0 = k * kKT;
    load_tile<float, kCT, kKT>(cs, LD, cb + n0, sc, S - t0 - r0, N - n0, wc);
    load_tile<float, kCT, kKT>(cs + kCT * LD, LD, bb + n0, sb, S - t0 - s0, N - n0, wb);
    cp_commit();
  };
  Acc<kCT, kCT> acc;
  acc.zero();
  // step k + 1's copies go out before step k's products (one call site, so
  // `issue` is inlined)
  for (int k = -1; k < steps; ++k) {
    if (k + 1 < steps) issue(k + 1);
    if (k < 0) continue;
    if (k + 1 < steps)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    const float* cs = smem + (k & 1) * kStage;
    acc.template mma<true, true>(cs, LD, 1, cs + kCT * LD, 1, LD, kKT, -1, tr == tc);
    __syncthreads();
  }
  float* gout = gmat + ((size_t)bg * d.nc + ci) * L * L + (size_t)r0 * L + s0;
  acc.each([&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(gout + r * L + c) = make_float2(v0, v1);
  });
}

// ---------------------------------------------------------------------------
// 2. the chunk states S_c = B^T diag(exp(cum_L - cum)) X, per (batch *
// head, chunk, N tile, P tile); the first N and P tile's block also stores the
// chunk's cum, which the pass (d_c = exp(cum_L)) and the readout read
// ---------------------------------------------------------------------------
template <typename T, int L, int PT>
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
  float* w = smem + 2 * kStage;                         // [L]: cum, then exp(cum_L - cum)
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
        if (nt == 0 && pt == 0)
          for (int t = tid; t < L; t += 32) cums[((size_t)bh * d.nc + ci) * L + t] = w[t];
        __syncwarp();   // every lane has read w before it is overwritten
        for (int t = tid; t < L; t += 32) w[t] = expf(last - w[t]);
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

// ---------------------------------------------------------------------------
// 3. the pass over the chunks: h_c = state entering chunk c
// ---------------------------------------------------------------------------
// (chunk 0 starts from h = 0, which the readout skips, so it is not stored)
template <int V>
__global__ void __launch_bounds__(kThreads)
ssm_scan_pass_kernel(float* __restrict__ states, const float* __restrict__ cums,
                     float* __restrict__ hout, int nc, int L, long long np, int tiles) {
  follow_previous_grid();
  const int bh = blockIdx.x / tiles, tile = blockIdx.x - bh * tiles;
  const long long e = ((long long)tile * kThreads + threadIdx.x) * V;
  if (e >= np) return;
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = 0.f;
  float* s = states + (size_t)bh * nc * np + e;
  const float* cl = cums + (size_t)bh * nc * L + L - 1;   // cum_L of each chunk
  constexpr int kAhead = 4;   // chunks whose loads are in flight together
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float sv[kAhead][V], dv[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j >= nc) break;
      const float* sj = s + (size_t)(c0 + j) * np;
      if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(sj);
        sv[j][0] = t.x; sv[j][1] = t.y; sv[j][2] = t.z; sv[j][3] = t.w;
      } else {
        sv[j][0] = sj[0];
      }
      dv[j] = expf(cl[(size_t)(c0 + j) * L]);
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int ci = c0 + j;
      if (ci >= nc) break;
      float* sj = s + (size_t)ci * np;
      if (ci > 0) {
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(sj) = make_float4(h[0], h[1], h[2], h[3]);
        } else {
          sj[0] = h[0];
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = dv[j] * h[v] + sv[j][v];
    }
  }
  float* ho = hout + (size_t)bh * np + e;
#pragma unroll
  for (int v = 0; v < V; ++v) ho[v] = h[v];
}

// ---------------------------------------------------------------------------
// 4. the readout: y = (G * decay mask) X + (C * exp(cum)) h_c
// ---------------------------------------------------------------------------
// The K steps (L / kKT tiles of G and X, then N / kKT tiles of C and h_c
// where the chunk has a carried state) run through two stages: the copy of
// step k + 1 is in flight while step k's products run.
// (two blocks an SM for a bf16 x: at most 128 registers; an f32 x's third
// pass needs more)
template <typename T, int L, int PT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
ssm_scan_out_kernel(const T* __restrict__ x, const float* __restrict__ cums,
                    const float* __restrict__ cmat, const float* __restrict__ gmat,
                    const float* __restrict__ states, T* __restrict__ y, const Strides st,
                    const Dims d) {
  constexpr bool kXExact = sizeof(T) == 2;
  constexpr int LDA = pitch(kKT, 4), LDB = pitch(PT, 8), LDX = x_pitch<T>(PT);
  constexpr int kStage = 2 * L * LDA + kKT * LDB;   // A (high parts), B, A's low parts
  extern __shared__ float smem[];
  follow_previous_grid();
  float* cum = smem + 2 * kStage;  // [L]
  float* ecum = cum + L;           // [L]
  const int tid = threadIdx.x;
  const int ntp = (d.P + PT - 1) / PT;
  const int pt = blockIdx.x % ntp, rest = blockIdx.x / ntp;
  const int ci = rest % d.nc, bh = rest / d.nc;
  const int bi = bh / d.H, hi = bh - bi * d.H;
  const int gi = d.hg == 1 ? 0 : hi;
  const int t0 = ci * L, p0 = pt * PT;
  const int S = d.S, N = d.N, P = d.P, H = d.H;
  const long long sx = st.x[1], sc = st.c[1];
  const int xunit = d.xunit;
  const bool wc = d.wide & 2, wh = d.wide & 4;
  const T* xb = x + bi * st.x[0] + hi * st.x[2] + (long long)t0 * sx + p0;
  const float* gb = gmat + ((size_t)(bi * d.hg + gi) * d.nc + ci) * L * L;
  const float* cb = cmat + bi * st.c[0] + hi * st.c[2] + (long long)t0 * sc;
  const float* hb = states + ((size_t)bh * d.nc + ci) * N * P + p0;
  constexpr int kIntra = L / kKT;
  const int steps = kIntra + (ci > 0 ? (N + kKT - 1) / kKT : 0);
  // step k's copies into stage k % 2
  auto issue = [&](int k) {
    float* as = smem + (k & 1) * kStage;
    float* bs = as + 2 * L * LDA;
    if (k < kIntra) {
      const int s0 = k * kKT;
      load_tile<float, L, kKT>(as, LDA, gb + s0, L, L, kKT, true);
      load_x<T, kKT, PT>(reinterpret_cast<T*>(bs), LDX, xb + (long long)s0 * sx, sx,
                         S - t0 - s0, P - p0, xunit);
    } else {
      const int n0 = (k - kIntra) * kKT;
      load_tile<float, L, kKT>(as, LDA, cb + n0, sc, S - t0, N - n0, wc);
      load_tile<float, kKT, PT>(bs, LDB, hb + (size_t)n0 * P, P, N - n0, P - p0, wh);
    }
    cp_commit();
  };
  Acc<L, PT> acc;
  acc.zero();
  // step k + 1's copies go out before step k's products (one call site, so
  // `issue` is inlined); cum comes in while step 0's are in flight
  for (int k = -1; k < steps; ++k) {
    if (k + 1 < steps) issue(k + 1);
    if (k < 0) {
      for (int t = tid; t < L; t += kThreads) {
        const float c = cums[((size_t)bh * d.nc + ci) * L + t];
        cum[t] = c;
        ecum[t] = expf(c);
      }
      continue;
    }
    if (k + 1 < steps)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();   // step k's tiles (and cum) are in
    float* as = smem + (k & 1) * kStage;
    float* alo = as + L * LDA;
    float* bs = alo + L * LDA;
    // A in place (the decay mask, G[t][s] exp(cum_t - cum_s) for s <= t and
    // 0 above, or C[t][n] exp(cum_t)), split into its TF32 parts once for
    // every warp that reads it
    const int s0 = k * kKT;
    for (int i = tid; i < L * kKT; i += kThreads) {
      const int t = i / kKT, c = i - t * kKT;
      float* e = as + t * LDA + c;
      const float v = k < kIntra ? (s0 + c <= t ? *e * __expf(cum[t] - cum[s0 + c]) : 0.f)
                                 : *e * ecum[t];
      uint32_t hi, lo;
      split<true>(v, hi, lo);
      *e = __uint_as_float(hi);
      alo[t * LDA + c] = __uint_as_float(lo);
    }
    __syncthreads();
    if (k < kIntra)
      acc.template mma<true, !kXExact, 1>(as, LDA, 1, reinterpret_cast<const T*>(bs), LDX, 1,
                                          kKT, s0, false, alo);
    else
      acc.template mma<true, true, 1>(as, LDA, 1, bs, LDB, 1, kKT, -1, false, alo);
    __syncthreads();   // stage k % 2 is free for step k + 2
  }
  // pairs of adjacent columns leave as one store where P is even
  T* const yb = y + (size_t)bi * S * H * P + (size_t)hi * P + p0;
  const bool pairs = P % 2 == 0;
  acc.each([&](int r, int c, float v0, float v1) {
    if (t0 + r >= S || p0 + c >= P) return;
    T* out = yb + (size_t)(t0 + r) * H * P + c;
    if (pairs) {
      store2(out, v0, v1);
    } else {
      out[0] = from_f<T>(v0);
      if (p0 + c + 1 < P) out[1] = from_f<T>(v1);
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

template <typename T, int L, int PT>
cudaError_t launch(const void* x, const float* a, const float* b, const float* c, void* y,
                   float* hout, float* gmat, float* states, float* cums, const Strides& st,
                   const Dims& d, cudaStream_t stream) {
  cudaError_t err;
  const long long np = (long long)d.N * d.P;
  const long long ntp = (d.P + PT - 1) / PT, ntn = (d.N + kNT - 1) / kNT;
  constexpr int TT = L / kCT;
  const long long g_blocks = (long long)d.B * d.hg * d.nc * (TT * (TT + 1) / 2);
  const long long s_blocks = (long long)d.B * d.H * d.nc * ntn * ntp;
  const long long o_blocks = (long long)d.B * d.H * d.nc * ntp;
  const bool v4 = np % 4 == 0;
  const long long per = (long long)kThreads * (v4 ? 4 : 1);
  const long long tiles = (np + per - 1) / per;
  if (g_blocks > 2147483647LL || s_blocks > 2147483647LL || o_blocks > 2147483647LL ||
      tiles * d.B * d.H > 2147483647LL)
    return cudaErrorInvalidValue;
  if (d.nc > 0) {
    const int smem0 = cbt_smem_floats() * (int)sizeof(float);
    static std::atomic<unsigned long long> opted0{0};
    if ((err = prepare(ssm_scan_cbt_kernel<L>, smem0, opted0)) != cudaSuccess) return err;
    if ((err = launch_after(ssm_scan_cbt_kernel<L>, (unsigned)g_blocks, smem0, stream, b, c,
                            gmat, st, d)) != cudaSuccess)
      return err;
    const int smem1 = chunk_smem_floats(L, PT) * (int)sizeof(float);
    static std::atomic<unsigned long long> opted1{0};
    if ((err = prepare(ssm_scan_chunk_kernel<T, L, PT>, smem1, opted1)) != cudaSuccess) return err;
    if ((err = launch_after(ssm_scan_chunk_kernel<T, L, PT>, (unsigned)s_blocks, smem1, stream,
                            static_cast<const T*>(x), a, b, states, cums, st, d)) != cudaSuccess)
      return err;
  }
  const unsigned pass_blocks = (unsigned)(tiles * d.B * d.H);
  err = v4 ? launch_after(ssm_scan_pass_kernel<4>, pass_blocks, 0, stream, states,
                          static_cast<const float*>(cums), hout, d.nc, L, np, (int)tiles)
           : launch_after(ssm_scan_pass_kernel<1>, pass_blocks, 0, stream, states,
                          static_cast<const float*>(cums), hout, d.nc, L, np, (int)tiles);
  if (err != cudaSuccess) return err;
  if (d.nc > 0) {
    const int smem3 = out_smem_floats(L, PT) * (int)sizeof(float);
    static std::atomic<unsigned long long> opted3{0};
    if ((err = prepare(ssm_scan_out_kernel<T, L, PT>, smem3, opted3)) != cudaSuccess) return err;
    if ((err = launch_after(ssm_scan_out_kernel<T, L, PT>, (unsigned)o_blocks, smem3, stream,
                            static_cast<const T*>(x), static_cast<const float*>(cums), c,
                            static_cast<const float*>(gmat), static_cast<const float*>(states),
                            static_cast<T*>(y), st, d)) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

// The (chunk, P tile) pairs of autotune.SCAN_TILES.
template <typename T>
cudaError_t dispatch(const void* x, const float* a, const float* b, const float* c, void* y,
                     float* hout, float* gmat, float* states, float* cums, const Strides& st,
                     const Dims& d, int L, int pt, cudaStream_t s) {
#define SSM_CASE(LL, PP)                                                                     \
  if (L == LL && pt == PP)                                                                   \
    return launch<T, LL, PP>(x, a, b, c, y, hout, gmat, states, cums, st, d, s);
  SSM_CASE(64, 8) SSM_CASE(64, 128) SSM_CASE(128, 128)
#undef SSM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: int64[12], the (batch, time, head) element strides of x, a, b, c.
// groups: the B/C groups a batch (1 where b and c have a head stride of 0,
// else H).  gmat: B * groups * ceil(S / chunk) * chunk^2 floats; states:
// B * H * ceil(S / chunk) * N * P floats; cums: B * H * ceil(S / chunk) *
// chunk floats.  dtype (of x and y): 0 = float32, 1 = bfloat16.  Runs the
// four kernels on `stream`; returns the first launch error (0 on success),
// cudaErrorInvalidValue for an unsupported shape.
extern "C" int ssm_scan_launch(const void* x, const void* a, const void* b, const void* c,
                               void* y, void* hout, void* gmat, void* states, void* cums,
                               const long long* strides, int B, int H, int S, int P, int N,
                               int groups, int chunk, int p_tile, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || P <= 0 || N <= 0 || chunk <= 0 ||
      (groups != 1 && groups != H))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.a[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
  }
  // whether a tensor's rows can be copied in units of `unit` bytes: its base
  // address and its (batch, time, head) strides are multiples of the unit
  auto fits = [&](const void* ptr, int first, int elem, int unit) {
    const int per = unit / elem;
    return (uintptr_t)ptr % unit == 0 && strides[first] % per == 0 &&
           strides[first + 1] % per == 0 && strides[first + 2] % per == 0;
  };
  const int xe = dtype == 0 ? 4 : 2;
  const int xunit = fits(x, 0, xe, 16) ? 16 : (fits(x, 0, xe, 4) ? 4 : 2);
  const int wide = (fits(b, 6, 4, 16) ? 1 : 0) | (fits(c, 9, 4, 16) ? 2 : 0) | (P % 4 == 0 ? 4 : 0);
  const Dims d{B, H, S, P, N, (S + chunk - 1) / chunk, groups, xunit, wide};
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* ho = static_cast<float*>(hout);
  float* gm = static_cast<float*>(gmat);
  float* sm = static_cast<float*>(states);
  float* cs = static_cast<float*>(cums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(x, af, bf, cf, y, ho, gm, sm, cs, st, d, chunk, p_tile, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, af, bf, cf, y, ho, gm, sm, cs, st, d, chunk, p_tile,
                                        s);
  return (int)cudaErrorInvalidValue;
}
