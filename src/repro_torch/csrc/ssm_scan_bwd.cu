// The selective scan's backward (the forward is csrc/ssm_scan.cu) for
// Hopper (sm_90a): for the output gradients dY (B, S, H, P) and dh_final
// (B, H, N, P) or none, the gradients dX, da, dB and dC.
//
// No TPU counterpart: the reference differentiates its pure-jnp scan with
// XLA (src/repro/configs/base.py:54 use_pallas False).  The Pallas scan
// `_ssm_kernel` (src/repro/kernels/ssm_scan.py:28) has no backward.
//
// In the forward's notation, per (batch, head) and chunk c of L steps: cum
// the inclusive cumsum of log max(a, 1e-20) within the chunk, cL its last
// entry, M_ts = exp(cum_t - cum_s) for t >= s (0 above), G = C B^T, h_c the
// state entering chunk c.  Lambda_c, the gradient of the state leaving chunk
// c, runs backwards: Lambda_last = dh_final (or 0), Lambda_{c-1} =
// exp(cL_c) Lambda_c + R_c with R_c = (C * exp(cum))^T dY.  With D = dY X^T
// (L x L, made once and used twice):
//     dX = (G * M)^T dY + diag(exp(cL - cum)) B Lambda_c
//     dB = (D * M)^T C  + diag(exp(cL - cum)) X Lambda_c^T
//     dC = (D * M) B    + diag(exp(cum)) dY h_c^T
//     d log a_t = sum_{u >= t} (c_u . dc_u - b_u . db_u) + <dh_final, h_final>,
//     da_t = d log a_t / a_t, 0 where a_t < 1e-20
// (the identity for d log a is proved in kernels/ssm_scan.py).  G, h_c and
// cum are the forward's scratch, which SsmScan keeps for the backward.  One
// call of ssm_scan_bwd_launch runs up to five kernels, in order, each
// waiting for the one before (programmatic dependent launch, as the
// forward):
//   1. ssm_scan_chunk_kernel<.., kRev> (ssm_scan.cuh), every (batch * head,
//      chunk, N tile, P tile): R_c, into the Lambda buffer;
//   2. ssm_scan_bwd_pass_kernel, every (batch * head, 1024 entries of N x P;
//      256 where N P is not a multiple of 4):
//      the reverse pass over the chunks (Lambda_c overwrites R_c), and each
//      block's part of <dh_final, h_final>;
//   3. ssm_scan_bwd_dd_kernel, every (batch * head, chunk): D on and below
//      the diagonal;
//   4. ssm_scan_bwd_dx_kernel, every (batch * head, chunk, P tile): dX (not
//      launched where x needs no gradient, as the mLSTM normaliser's x = 1);
//   5. ssm_scan_bwd_dbc_kernel, every (batch * head, chunk, N tile):
//      dC, then dB, and in each one's epilogue the tile's part of the dots
//      c_u . dc_u and b_u . db_u;
// and where da is asked for, one call of ssm_scan_da_launch:
//   6. ssm_scan_da_sum_kernel, a block a (batch, head): the dots' parts in a
//      fixed order and the reverse cumulative sum in f64 (over S terms that
//      nearly cancel, f32 would lose their difference), then da.
// No atomics: partial sums meet in a fixed order, so a second call gives the
// same bits.
//
// Bound: the products on the tensor cores (R_c, D, and two halves each of
// dX, dB and dC: about twice the forward's) and the bytes of x, a, b, c, dy
// and the four gradients.  As in the forward, the products run as mma.sync
// TF32 with every f32 operand split into two TF32 parts (three passes; two
// against a bf16 x or dy, which are exact in TF32; one for D of a bf16 x),
// tiles stream through shared memory by cp.async two stages deep, the
// masked decay is made and split once per tile, and products known to be
// zero (across the causal diagonal) are skipped.  The inputs are read in
// place, in their own dtypes and strides (a b or c that broadcasts one group
// has a head stride of 0).  The diagonal factors scale the accumulator's
// rows between the two halves of a product instead of weighting X or dY,
// which would make a bf16 operand inexact.
//
// Layouts: x, dy (B, S, H, P) in x's dtype (f32 or bf16), b, c (B, S, H, N)
// f32, last dims contiguous, any batch, time and head strides; a (B, S, H)
// f32, any strides; the forward's G (B * groups, chunks, L, L), chunk states
// (B * H, chunks, N, P; h_c for c >= 1) and cum (B * H, chunks, L), h_final
// and dh_final (B, H, N, P), f32, contiguous.  Out: dX (B, S, H, P) in x's
// dtype, dB and dC (B, S, H, N) f32 (per head), contiguous.  Scratch: Lambda
// (as the chunk states), D (B * H, chunks, L, L), the dots' parts (B * H, S,
// dB/dC N tiles) and <dh_final, h_final>'s (B * H, pass blocks).
#include "ssm_scan.cuh"

namespace {

constexpr float kFloor = 1e-20f;   // log max(a, kFloor) in the forward

// Element strides (batch, time, head) of x, a, b, c and dy.  Mirrors the
// int64[15] array the wrapper passes.
struct BwdStrides {
  long long x[3], a[3], b[3], c[3], dy[3];
};

struct BwdDims {
  int B, H, S, P, N;
  int nc;              // chunks
  int hg;              // groups of the forward's G a batch: 1 (b and c broadcast) or H
  int xunit, dyunit;   // bytes x and dy are copied in: 16, 4, or 2 (bf16 element by element)
  int wide;            // 16-byte copies: 1 b, 2 c, 4 the N x P states (P a multiple of 4)
  int has_dh;          // Lambda of the last chunk is dh_final (else 0: its products are skipped)
};

struct BwdPtrs {
  const void* x;
  const float *a, *b, *c;
  const void* dy;
  const float *gmat, *states, *cums, *hfin, *dh;
  float *lam, *dd;
  void* dx;
  float *db, *dc, *gpart, *biasp;   // db, dc, gpart, biasp may be null
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The N tile of the dB/dC kernel at chunk length L (and so the decay
// gradient's parts a step, ceil(N / tile)).
__host__ __device__ constexpr int bwd_nt(int L) { return L == 64 ? 128 : 64; }

// The reverse pass's blocks a (batch, head): kThreads threads of V entries of
// N x P each (V 4 where N * P is a multiple of 4), each block writing one
// part of <dh_final, h_final>.
inline long long pass_tiles(long long np) {
  const long long per = kThreads * (np % 4 == 0 ? 4 : 1);
  return (np + per - 1) / per;
}

// Row pitch (elements) of an R x kKT tile of T that a product reads along
// its rows as A, so a warp's fragment loads fall on distinct banks: 4
// modulo 32 words for f32, 8 modulo 64 elements for bf16.
template <typename T>
__host__ __device__ constexpr int a_pitch(int c) {
  return sizeof(T) == 4 ? pitch(c, 4) : c + ((8 - c % 64) + 64) % 64;
}

// Shared memory of the kernels (the chunk kernel's is chunk_smem_floats).
template <typename T>
__host__ __device__ constexpr int dd_smem_bytes(int L) {
  // two stages of a dY and an X tile (L x kKT each, in T)
  return 2 * 2 * L * a_pitch<T>(kKT) * (int)sizeof(T);
}
__host__ __device__ constexpr int bwd_a_floats(int L) {
  // one TF32 part of an A tile: L x kKT (pitch 4; also an L x kKT tile of x
  // or dy in either dtype) or kKT x L read transposed (pitch 8 modulo 32)
  return cmax(L * pitch(kKT, 4), kKT * pitch(L, 8));
}
__host__ __device__ constexpr int dx_smem_floats(int L, int pt) {
  // two stages of the A tile's two parts and the B tile (Lambda_c or dY,
  // kKT x pt, at most f32 pitch 8); cum and exp(cL - cum)
  return 2 * (2 * bwd_a_floats(L) + kKT * pitch(pt, 8)) + 2 * L;
}
__host__ __device__ constexpr int dbc_b_floats(int nt) {
  // h_c or Lambda_c (nt x kKT, pitch 4) or B or C (kKT x nt, pitch 8)
  return cmax(nt * pitch(kKT, 4), kKT * pitch(nt, 8));
}
template <int L, int NT>
__host__ __device__ constexpr int dbc_smem_floats() {
  // two stages; cum, exp(cum), exp(cL - cum); the row sums' scratch (a row
  // of L for each of the NT / 16 warps along N) and the two dots (L each)
  return 2 * (2 * bwd_a_floats(L) + dbc_b_floats(NT)) + 3 * L + NT / 16 * L + 2 * L;
}

// The rows of the chunk starting at t0 of a (B, S, H, ...) operand with
// element strides s (batch, time, head): computed where a kernel needs
// them, so no pointer per operand stays live across the K loop.
template <typename E>
__device__ __forceinline__ const E* chunk_rows(const void* base, const long long (&s)[3], int bi,
                                               int hi, int t0) {
  return static_cast<const E*>(base) + bi * s[0] + hi * s[2] + (long long)t0 * s[1];
}

// ---------------------------------------------------------------------------
// 2. the reverse pass over the chunks, every (batch * head, kThreads * V
// entries of N x P): Lambda_c overwrites R_c; with biasp, the block's part of
// <dh_final, h_final>
// ---------------------------------------------------------------------------
template <int V>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_pass_kernel(float* __restrict__ lam, const float* __restrict__ cums,
                         const float* __restrict__ dh, const float* __restrict__ hfin,
                         float* __restrict__ biasp, int nc, int L, long long np, int tiles) {
  __shared__ float warp_sums[kThreads / 32];
  follow_previous_grid();
  const int bh = blockIdx.x / tiles, tile = blockIdx.x - bh * tiles;
  const long long e = ((long long)tile * kThreads + threadIdx.x) * V;
  float l[V], dot = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) l[v] = 0.f;
  if (e < np) {
    if (dh != nullptr) {
      const float* d0 = dh + (size_t)bh * np + e;
      const float* h0 = hfin + (size_t)bh * np + e;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        l[v] = d0[v];
        if (biasp != nullptr) dot += l[v] * h0[v];
      }
    }
    float* s = lam + (size_t)bh * nc * np + e;
    const float* cl = cums + (size_t)bh * nc * L + L - 1;   // cL of each chunk
    constexpr int kAhead = 4;   // chunks whose loads are in flight together
    for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
      float rv[kAhead][V], dv[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (c0 - j < 0) break;
        const float* sj = s + (size_t)(c0 - j) * np;
        if constexpr (V == 4) {
          const float4 t = *reinterpret_cast<const float4*>(sj);
          rv[j][0] = t.x; rv[j][1] = t.y; rv[j][2] = t.z; rv[j][3] = t.w;
        } else {
          rv[j][0] = sj[0];
        }
        dv[j] = expf(cl[(size_t)(c0 - j) * L]);
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int ci = c0 - j;
        if (ci < 0) break;
        float* sj = s + (size_t)ci * np;
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(sj) = make_float4(l[0], l[1], l[2], l[3]);
        } else {
          sj[0] = l[0];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) l[v] = dv[j] * l[v] + rv[j][v];
      }
    }
  }
  if (biasp == nullptr) return;
  // the block's sum in a fixed order: the warp by shuffles, then the warps in turn
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = dot;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sums[w];
    biasp[(size_t)bh * tiles + tile] = t;
  }
}

// ---------------------------------------------------------------------------
// 3. D = dY X^T, a block a (batch * head, chunk): the L x L products on and
// below the diagonal (dB and dC read D[t][s] for s <= t only), over P in
// K steps
// ---------------------------------------------------------------------------
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
ssm_scan_bwd_dd_kernel(const BwdPtrs p, const BwdStrides st, const BwdDims d) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 products are exact: one pass
  constexpr int LD = a_pitch<T>(kKT);
  constexpr int kStage = 2 * L * LD;        // elements of T: a dY and an X tile
  extern __shared__ float smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  follow_previous_grid();
  const int ci = blockIdx.x % d.nc, bh = blockIdx.x / d.nc;
  const int bi = bh / d.H, hi = bh - bi * d.H;
  const int t0 = ci * L;
  const int steps = (d.P + kKT - 1) / kKT;
  auto issue = [&](int k) {   // dY[t][p] and X[s][p] of step k into stage k % 2
    T* ys = sm + (k & 1) * kStage;
    const int p0 = k * kKT;
    load_x<T, L, kKT>(ys, LD, chunk_rows<T>(p.dy, st.dy, bi, hi, t0) + p0, st.dy[1], d.S - t0,
                      d.P - p0, d.dyunit);
    load_x<T, L, kKT>(ys + L * LD, LD, chunk_rows<T>(p.x, st.x, bi, hi, t0) + p0, st.x[1],
                      d.S - t0, d.P - p0, d.xunit);
    cp_commit();
  };
  Acc<L, L> acc;
  acc.zero();
  for (int k = -1; k < steps; ++k) {
    if (k + 1 < steps) issue(k + 1);
    if (k < 0) continue;
    if (k + 1 < steps)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    const T* ys = sm + (k & 1) * kStage;
    acc.template mma<!kExact, !kExact, 1>(ys, LD, 1, ys + L * LD, 1, LD, kKT, -1, true);
    __syncthreads();
  }
  // the pairs that hold an entry on or below the diagonal (the readers mask
  // the rest by selection, so it may hold anything)
  float* out = p.dd + ((size_t)bh * d.nc + ci) * L * L;
  acc.each([&](int r, int c, float v0, float v1) {
    if (c <= r) *reinterpret_cast<float2*>(out + r * L + c) = make_float2(v0, v1);
  });
}

// ---------------------------------------------------------------------------
// 4. dX = diag(exp(cL - cum)) B Lambda_c + (G * M)^T dY, per (batch * head,
// chunk, P tile): the N steps of B Lambda_c (none where Lambda_c is 0), the
// rows scaled, then the L steps of (G * M)^T dY
// ---------------------------------------------------------------------------
template <typename T, int L, int PT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
ssm_scan_bwd_dx_kernel(const BwdPtrs p, const BwdStrides st, const BwdDims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int LDA = pitch(kKT, 4);    // B: L x kKT (rows t, columns n)
  constexpr int LDG = pitch(L, 8);      // G: kKT x L (rows t, columns s), read transposed
  constexpr int LDL = pitch(PT, 8);     // Lambda_c: kKT x PT (rows n, columns p)
  constexpr int LDY = x_pitch<T>(PT);   // dY: kKT x PT (rows t, columns p)
  constexpr int kA = bwd_a_floats(L);
  constexpr int kStage = 2 * kA + kKT * LDL;   // A's two TF32 parts, the B operand
  extern __shared__ float smem[];
  follow_previous_grid();
  float* cum = smem + 2 * kStage;   // [L]
  float* wrev = cum + L;            // [L]: exp(cL - cum)
  const int tid = threadIdx.x;
  const int ntp = (d.P + PT - 1) / PT;
  const int pt = blockIdx.x % ntp, rest = blockIdx.x / ntp;
  const int ci = rest % d.nc, bh = rest / d.nc;
  const int bi = bh / d.H, hi = bh - bi * d.H;
  const int gi = d.hg == 1 ? 0 : hi;
  const int t0 = ci * L, p0 = pt * PT;
  const int S = d.S, N = d.N, P = d.P, H = d.H;
  const long long sb = st.b[1], sy = st.dy[1];
  const bool wb = d.wide & 1, wl = d.wide & 4;
  const float* bb = p.b + bi * st.b[0] + hi * st.b[2] + (long long)t0 * sb;
  const float* lb = p.lam + ((size_t)bh * d.nc + ci) * N * P + p0;
  const float* gb = p.gmat + ((size_t)(bi * d.hg + gi) * d.nc + ci) * L * L;
  const T* yb = static_cast<const T*>(p.dy) + bi * st.dy[0] + hi * st.dy[2] +
                (long long)t0 * sy + p0;
  const float* cg = p.cums + ((size_t)bh * d.nc + ci) * L;
  const int k1 = (ci + 1 < d.nc || d.has_dh) ? (N + kKT - 1) / kKT : 0;
  const int steps = k1 + L / kKT;
  auto issue = [&](int k) {   // step k's copies into stage k % 2
    float* as = smem + (k & 1) * kStage;
    float* bs = as + 2 * kA;
    if (k < k1) {
      const int n0 = k * kKT;
      load_tile<float, L, kKT>(as, LDA, bb + n0, sb, S - t0, N - n0, wb);
      load_tile<float, kKT, PT>(bs, LDL, lb + (size_t)n0 * P, P, N - n0, P - p0, wl);
    } else {
      const int r0 = (k - k1) * kKT;   // rows t of G (whole rows: the upper tiles are masked)
      load_tile<float, kKT, L>(as, LDG, gb + (size_t)r0 * L, L, kKT, L, true);
      load_x<T, kKT, PT>(reinterpret_cast<T*>(bs), LDY, yb + (long long)r0 * sy, sy,
                         S - t0 - r0, P - p0, d.dyunit);
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
      const float last = cg[L - 1];
      for (int t = tid; t < L; t += kThreads) {
        const float c = cg[t];
        cum[t] = c;
        wrev[t] = expf(last - c);
      }
      continue;
    }
    if (k + 1 < steps)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();   // step k's tiles (and cum) are in
    if (k == k1 && k1 > 0) acc.scale_rows(wrev);
    float* as = smem + (k & 1) * kStage;
    float* alo = as + kA;
    const float* bs = as + 2 * kA;
    if (k < k1) {
      for (int i = tid; i < L * kKT; i += kThreads) {
        const int t = i / kKT, c = i - t * kKT;
        uint32_t h, l;
        split<true>(as[t * LDA + c], h, l);
        as[t * LDA + c] = __uint_as_float(h);
        alo[t * LDA + c] = __uint_as_float(l);
      }
      __syncthreads();
      acc.template mma<true, true, 1>(as, LDA, 1, bs, LDL, 1, kKT, -1, false, alo);
    } else {
      // A(s, t) = G[t][s] exp(cum_t - cum_s) for t >= s, else 0, split once
      const int r0 = (k - k1) * kKT;
      for (int i = tid; i < kKT * L; i += kThreads) {
        const int t = i / L, s = i - t * L;
        float* e = as + t * LDG + s;
        const float v = s <= r0 + t ? *e * __expf(cum[r0 + t] - cum[s]) : 0.f;
        uint32_t h, l;
        split<true>(v, h, l);
        *e = __uint_as_float(h);
        alo[t * LDG + s] = __uint_as_float(l);
      }
      __syncthreads();
      acc.template mma<true, !kExact, 1>(as, 1, LDG, reinterpret_cast<const T*>(bs), LDY, 1, kKT,
                                         -1, false, alo, r0);
    }
    __syncthreads();   // stage k % 2 is free for step k + 2
  }
  T* const xb = static_cast<T*>(p.dx) + (size_t)bi * S * H * P + (size_t)hi * P + p0;
  const bool pairs = P % 2 == 0;
  acc.each([&](int r, int c, float v0, float v1) {
    if (t0 + r >= S || p0 + c >= P) return;
    T* out = xb + (size_t)(t0 + r) * H * P + c;
    if (pairs) {
      store2(out, v0, v1);
    } else {
      out[0] = from_f<T>(v0);
      if (p0 + c + 1 < P) out[1] = from_f<T>(v1);
    }
  });
}

// ---------------------------------------------------------------------------
// 5. dC, then dB, per (batch * head, chunk, NT-wide N tile), in one stream
// of K steps: the P steps of dY h_c^T (none in chunk 0, where h_c = 0), the
// rows scaled by exp(cum), the L steps of (D * M) B; then the P steps of
// X Lambda_c^T (none where Lambda_c = 0), the rows scaled by exp(cL - cum),
// the L steps of (D * M)^T C.  Each gradient's epilogue stores it and sums
// its dot with c (or b) over the tile's N entries of each step.  NT is 64
// at L 128 and 128 at L 64 (the accumulator holds L * NT / 256 floats a
// thread either way, and each warp 4 x 2 fragments).
// ---------------------------------------------------------------------------
template <typename T, int L, int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssm_scan_bwd_dbc_kernel(const BwdPtrs p, const BwdStrides st, const BwdDims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int LDX = a_pitch<T>(kKT);   // dY or X: L x kKT (rows t, columns p), in T
  constexpr int LDH = pitch(kKT, 4);     // h_c or Lambda_c: NT x kKT (rows n, columns p)
  constexpr int LDD = pitch(kKT, 4);     // D for dC: L x kKT (rows t, columns s)
  constexpr int LDT = pitch(L, 8);       // D for dB: kKT x L (rows t, columns s), read transposed
  constexpr int LDN = pitch(NT, 8);      // B or C: kKT x NT (rows t, columns n)
  constexpr int kA = bwd_a_floats(L);
  constexpr int kStage = 2 * kA + dbc_b_floats(NT);
  extern __shared__ float smem[];
  follow_previous_grid();
  float* cum = smem + 2 * kStage;   // [L]
  float* ecum = cum + L;            // [L]: exp(cum)
  float* wrev = ecum + L;           // [L]: exp(cL - cum)
  float* red = wrev + L;            // [NT / 16 * L]: row_sums' scratch
  float* dotc = red + NT / 16 * L;   // [L]: c . dc over the tile
  float* dotb = dotc + L;                        // [L]: b . db over the tile
  const int tid = threadIdx.x;
  const int ntn = (d.N + NT - 1) / NT;
  const int nt = blockIdx.x % ntn, rest = blockIdx.x / ntn;
  const int ci = rest % d.nc, bh = rest / d.nc;
  const int bi = bh / d.H, hi = bh - bi * d.H;
  const int t0 = ci * L, n0 = nt * NT;
  const int kp = (d.P + kKT - 1) / kKT, kl = L / kKT;
  const int c1 = ci > 0 ? kp : 0;                                  // dY h_c^T
  const int c2 = c1 + kl;                                          // (D * M) B
  const int b1 = c2 + ((ci + 1 < d.nc || d.has_dh) ? kp : 0);      // X Lambda_c^T
  const int steps = b1 + kl;                                       // (D * M)^T C
  auto issue = [&](int k) {   // step k's copies into stage k % 2
    float* as = smem + (k & 1) * kStage;
    float* bs = as + 2 * kA;
    if (k < c1 || (k >= c2 && k < b1)) {
      const bool grad_c = k < c1;
      const int p0 = (grad_c ? k : k - c2) * kKT;
      const T* src = grad_c ? chunk_rows<T>(p.dy, st.dy, bi, hi, t0)
                            : chunk_rows<T>(p.x, st.x, bi, hi, t0);
      load_x<T, L, kKT>(reinterpret_cast<T*>(as), LDX, src + p0, grad_c ? st.dy[1] : st.x[1],
                        d.S - t0, d.P - p0, grad_c ? d.dyunit : d.xunit);
      const float* hl = (grad_c ? p.states : p.lam) +
                        ((size_t)bh * d.nc + ci) * d.N * d.P + (size_t)n0 * d.P;
      load_tile<float, NT, kKT>(bs, LDH, hl + p0, d.P, d.N - n0, d.P - p0, d.wide & 4);
    } else {
      const bool grad_c = k < c2;
      const int o = (grad_c ? k - c1 : k - b1) * kKT;
      const float* dd = p.dd + ((size_t)bh * d.nc + ci) * L * L;
      if (grad_c)
        load_tile<float, L, kKT>(as, LDD, dd + o, L, L, kKT, true);
      else
        load_tile<float, kKT, L>(as, LDT, dd + (size_t)o * L, L, kKT, L, true);
      const long long sn = grad_c ? st.b[1] : st.c[1];
      const float* bc = grad_c ? chunk_rows<float>(p.b, st.b, bi, hi, t0)
                               : chunk_rows<float>(p.c, st.c, bi, hi, t0);
      load_tile<float, kKT, NT>(bs, LDN, bc + n0 + (long long)o * sn, sn, d.S - t0 - o, d.N - n0,
                                d.wide & (grad_c ? 1 : 2));
    }
    cp_commit();
  };
  // 8 warps of (16 x 4) x (8 x 2) entries each: NT / 16 along N
  Acc<L, NT, NT / 16> acc;
  acc.zero();
  // step k + 1's copies go out before step k's products; at k = c2 and k =
  // steps (past the last step) an epilogue stores dC or dB and sums its dot
  // (each lambda has one call site, so none keeps its captures on the stack)
  for (int k = -1; k <= steps; ++k) {
    if (k + 1 < steps) issue(k + 1);
    if (k < 0) {
      const float* cg = p.cums + ((size_t)bh * d.nc + ci) * L;
      const float last = cg[L - 1];
      for (int t = tid; t < L; t += kThreads) {
        const float c = cg[t];
        cum[t] = c;
        ecum[t] = expf(c);
        wrev[t] = expf(last - c);
      }
      continue;
    }
    if (k + 1 < steps)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();   // step k's tiles (and cum) are in
    if (k == c1 && c1 > 0) acc.scale_rows(ecum);
    if (k == c2 || k == steps) {   // dC (at c2) or dB (at the end) is complete
      const bool grad_c = k == c2;
      float* g = grad_c ? p.dc : p.db;
      const int S = d.S, N = d.N, H = d.H;
      if (g != nullptr) {
        float* gb = g + ((size_t)bi * S + t0) * H * N + (size_t)hi * N + n0;
        const bool pairs = N % 2 == 0;
        acc.each([&](int r, int c, float v0, float v1) {
          if (t0 + r >= S || n0 + c >= N) return;
          float* out = gb + (size_t)r * H * N + c;
          if (pairs) {
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else {
            out[0] = v0;
            if (n0 + c + 1 < N) out[1] = v1;
          }
        });
      }
      // c (or b) rows of the tile
      const float* m = (grad_c ? chunk_rows<float>(p.c, st.c, bi, hi, t0)
                               : chunk_rows<float>(p.b, st.b, bi, hi, t0)) + n0;
      const long long sm = grad_c ? st.c[1] : st.b[1];
      if (p.gpart != nullptr)
        acc.row_sums([&](int r, int c, float v) {
          return t0 + r < S && n0 + c < N ? m[(long long)r * sm + c] * v : 0.f;
        }, red, grad_c ? dotc : dotb);
      if (k == steps) break;
      acc.zero();
    }
    if (k == b1 && b1 > c2) acc.scale_rows(wrev);
    float* as = smem + (k & 1) * kStage;
    float* alo = as + kA;
    const float* bs = as + 2 * kA;
    if (k < c1 || (k >= c2 && k < b1)) {
      acc.template mma<!kExact, true, 1>(reinterpret_cast<const T*>(as), LDX, 1, bs, 1, LDH, kKT);
    } else {
      // the masked D, split once: A(t, s) = D[t][s] exp(cum_t - cum_s) for
      // dC, its transpose A(s, t) for dB, 0 where s > t
      const bool grad_c = k < c2;
      const int o = (grad_c ? k - c1 : k - b1) * kKT;
      if (grad_c) {
        for (int i = tid; i < L * kKT; i += kThreads) {
          const int t = i / kKT, c = i - t * kKT;
          float* e = as + t * LDD + c;
          const float v = o + c <= t ? *e * __expf(cum[t] - cum[o + c]) : 0.f;
          uint32_t h, l;
          split<true>(v, h, l);
          *e = __uint_as_float(h);
          alo[t * LDD + c] = __uint_as_float(l);
        }
      } else {
        for (int i = tid; i < kKT * L; i += kThreads) {
          const int t = i / L, s = i - t * L;
          float* e = as + t * LDT + s;
          const float v = s <= o + t ? *e * __expf(cum[o + t] - cum[s]) : 0.f;
          uint32_t h, l;
          split<true>(v, h, l);
          *e = __uint_as_float(h);
          alo[t * LDT + s] = __uint_as_float(l);
        }
      }
      __syncthreads();
      if (grad_c)
        acc.template mma<true, true, 1>(as, LDD, 1, bs, LDN, 1, kKT, o, false, alo);
      else
        acc.template mma<true, true, 1>(as, 1, LDT, bs, LDN, 1, kKT, -1, false, alo, o);
    }
    __syncthreads();   // stage k % 2 is free for step k + 2
  }
  if (p.gpart != nullptr)
    for (int r = tid; r < L; r += kThreads)
      if (t0 + r < d.S) p.gpart[((size_t)bh * d.S + t0 + r) * ntn + nt] = dotc[r] - dotb[r];
}

// ---------------------------------------------------------------------------
// 6. da from the dots' parts g (B * H, S, K) and <dh_final, h_final>'s parts
// (B * H, Kb) or none, one block a (batch, head): each thread sums a segment
// of steps in f64 (a step's K parts in order), a block-wide suffix scan of
// the segment sums, then each thread walks its segment back, writing da
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssm_scan_da_sum_kernel(const float* __restrict__ g, const float* __restrict__ a,
                       const float* __restrict__ bias, float* __restrict__ da, long long sa0,
                       long long sa1, long long sa2, int H, int S, int K, int Kb) {
  __shared__ double warp_sums[kThreads / 32];
  const int bh = blockIdx.x, bi = bh / H, hi = bh - bi * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seg = (S + kThreads - 1) / kThreads;
  const int t0 = tid * seg, t1 = min(S, t0 + seg);
  const float* gb = g + (size_t)bh * S * K;
  auto step = [&](int u) {
    double v = 0.0;
    for (int k = 0; k < K; ++k) v += (double)gb[(size_t)u * K + k];
    return v;
  };
  double mine = 0.0;
  for (int u = t0; u < t1; ++u) mine += step(u);
  // the sum over the segments after this thread's: a suffix scan in the
  // warp, then over the warps' totals
  double incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double w = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += w;
  }
  if (lane == 0) warp_sums[warp] = incl;
  __syncthreads();
  double run = incl - mine;
  if (bias != nullptr)
    for (int k = 0; k < Kb; ++k) run += (double)bias[(size_t)bh * Kb + k];
  for (int w = warp + 1; w < kThreads / 32; ++w) run += warp_sums[w];
  const float* ab = a + bi * sa0 + hi * sa2;
  float* db = da + (size_t)bi * S * H + hi;   // step u at db[u * H]
  for (int u = t1 - 1; u >= t0; --u) {
    run += step(u);
    const float av = ab[(long long)u * sa1];
    db[(size_t)u * H] = av >= kFloor ? (float)(run / (double)av) : 0.f;
  }
}

// the P tile of R_c: a (chunk, P tile) the forward compiles (autotune.SCAN_TILES)
int r_tile(int L, int P) { return L == 128 || P > 64 ? 128 : (P > 8 ? 64 : 8); }

template <typename T, int L, int NT>
cudaError_t launch_bwd(const BwdPtrs& p, const BwdStrides& st, const BwdDims& d,
                       cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const bool need_dbc = p.db != nullptr || p.dc != nullptr || p.gpart != nullptr;
  const long long np = (long long)d.N * d.P, bhc = (long long)d.B * d.H * d.nc;
  const int ntn = (d.N + NT - 1) / NT;
  const bool v4 = np % 4 == 0;
  const long long tiles = pass_tiles(np);
  const int rpt = r_tile(L, d.P), xpt = d.P > 64 ? 128 : 64;
  const long long r_blocks = bhc * ((d.N + kNT - 1) / kNT) * ((d.P + rpt - 1) / rpt);
  const long long dx_blocks = bhc * ((d.P + xpt - 1) / xpt);
  if (r_blocks > 2147483647LL || dx_blocks > 2147483647LL ||
      tiles * d.B * d.H > 2147483647LL || bhc * ntn > 2147483647LL)
    return cudaErrorInvalidValue;
  {
    // 1. R_c: the forward's chunk kernel with c in b's place and dy in x's
    Strides fs;
    for (int i = 0; i < 3; ++i) {
      fs.x[i] = st.dy[i];
      fs.a[i] = st.a[i];
      fs.b[i] = fs.c[i] = st.c[i];
    }
    const Dims fd{d.B, d.H, d.S, d.P, d.N, d.nc, d.hg, d.dyunit, (d.wide & 2) ? 1 : 0};
    const T* dy = static_cast<const T*>(p.dy);
#define SSM_BWD_R(PP)                                                                          \
  if constexpr (L == 64 || PP == 128) {   /* r_tile's tiles at this chunk */                   \
    if (rpt == PP) {                                                                           \
      const int smem = chunk_smem_floats(L, PP) * (int)sizeof(float);                          \
      static std::atomic<unsigned long long> opted{0};                                         \
      if ((err = prepare(ssm_scan_chunk_kernel<T, L, PP, true>, smem, opted)) != cudaSuccess)  \
        return err;                                                                            \
      err = launch_after(ssm_scan_chunk_kernel<T, L, PP, true>, (unsigned)r_blocks, smem,      \
                         stream, dy, p.a, p.c, p.lam, static_cast<float*>(nullptr), fs, fd);   \
    }                                                                                          \
  }
    SSM_BWD_R(8) SSM_BWD_R(64) SSM_BWD_R(128)
#undef SSM_BWD_R
    if (err != cudaSuccess) return err;
    // 2. the reverse pass
    const unsigned pass_blocks = (unsigned)(tiles * d.B * d.H);
    err = v4 ? launch_after(ssm_scan_bwd_pass_kernel<4>, pass_blocks, 0, stream, p.lam, p.cums,
                            p.dh, p.hfin, p.biasp, d.nc, L, np, (int)tiles)
             : launch_after(ssm_scan_bwd_pass_kernel<1>, pass_blocks, 0, stream, p.lam, p.cums,
                            p.dh, p.hfin, p.biasp, d.nc, L, np, (int)tiles);
    if (err != cudaSuccess) return err;
  }
  if (need_dbc) {   // 3. D
    const int smem = dd_smem_bytes<T>(L);
    static std::atomic<unsigned long long> opted{0};
    if ((err = prepare(ssm_scan_bwd_dd_kernel<T, L>, smem, opted)) != cudaSuccess) return err;
    if ((err = launch_after(ssm_scan_bwd_dd_kernel<T, L>, (unsigned)bhc, smem, stream, p, st,
                            d)) != cudaSuccess)
      return err;
  }
  if (p.dx != nullptr) {   // 4. dX
#define SSM_BWD_DX(PP)                                                                         \
  if (xpt == PP) {                                                                             \
    const int smem = dx_smem_floats(L, PP) * (int)sizeof(float);                               \
    static std::atomic<unsigned long long> opted{0};                                           \
    if ((err = prepare(ssm_scan_bwd_dx_kernel<T, L, PP>, smem, opted)) != cudaSuccess)         \
      return err;                                                                              \
    err = launch_after(ssm_scan_bwd_dx_kernel<T, L, PP>, (unsigned)dx_blocks, smem, stream, p, \
                       st, d);                                                                 \
  }
    SSM_BWD_DX(64) SSM_BWD_DX(128)
#undef SSM_BWD_DX
    if (err != cudaSuccess) return err;
  }
  if (need_dbc) {   // 5. dC and dB
    const int smem = dbc_smem_floats<L, NT>() * (int)sizeof(float);
    static std::atomic<unsigned long long> opted{0};
    if ((err = prepare(ssm_scan_bwd_dbc_kernel<T, L, NT>, smem, opted)) != cudaSuccess)
      return err;
    if ((err = launch_after(ssm_scan_bwd_dbc_kernel<T, L, NT>, (unsigned)(bhc * ntn), smem,
                            stream, p, st, d)) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const BwdPtrs& p, const BwdStrides& st, const BwdDims& d, int L,
                     cudaStream_t s) {
  if (L == 64) return launch_bwd<T, 64, bwd_nt(64)>(p, st, d, s);
  if (L == 128) return launch_bwd<T, 128, bwd_nt(128)>(p, st, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: int64[15], the (batch, time, head) element strides of x, a, b,
// c, dy.  gmat, states, cums: the forward call's scratch at this chunk
// length and B/C groups; hfin: its final h.  dh (and so biasp) may be null;
// dx (and dx's kernel), db, dc and gpart (and the dots) are null where not
// asked for.  lam: as the states; dd: B * H * ceil(S / chunk) * chunk^2
// floats; gpart: (B * H, S, Kg); biasp: (B * H, Kb), with Kg and Kb as
// ssm_scan_bwd_parts gives them.  dtype (of x, dy and dx): 0 = float32, 1 =
// bfloat16.  Runs the kernels on `stream`; returns the first launch error (0
// on success), cudaErrorInvalidValue for an unsupported shape.
extern "C" int ssm_scan_bwd_launch(const void* x, const void* a, const void* b, const void* c,
                                   const void* dy, const void* gmat, const void* states,
                                   const void* cums, const void* hfin, const void* dh, void* lam,
                                   void* dd, void* dx, void* db, void* dc, void* gpart,
                                   void* biasp, const long long* strides, int B, int H, int S,
                                   int P, int N, int groups, int chunk, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || P <= 0 || N <= 0 || (groups != 1 && groups != H) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  BwdStrides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.a[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
    st.dy[i] = strides[12 + i];
  }
  // whether a tensor's rows can be copied in units of `unit` bytes: its base
  // address and its (batch, time, head) strides are multiples of the unit
  auto fits = [&](const void* ptr, int first, int elem, int unit) {
    const int per = unit / elem;
    return (uintptr_t)ptr % unit == 0 && strides[first] % per == 0 &&
           strides[first + 1] % per == 0 && strides[first + 2] % per == 0;
  };
  const int xe = dtype == 0 ? 4 : 2;
  auto unit = [&](const void* ptr, int first) {
    return fits(ptr, first, xe, 16) ? 16 : (fits(ptr, first, xe, 4) ? 4 : 2);
  };
  const int wide = (fits(b, 6, 4, 16) ? 1 : 0) | (fits(c, 9, 4, 16) ? 2 : 0) | (P % 4 == 0 ? 4 : 0);
  const BwdDims d{B,          H,           S,    P,    N, (S + chunk - 1) / chunk, groups,
                  unit(x, 0), unit(dy, 12), wide, dh != nullptr};
  const BwdPtrs p{x,
                  static_cast<const float*>(a),
                  static_cast<const float*>(b),
                  static_cast<const float*>(c),
                  dy,
                  static_cast<const float*>(gmat),
                  static_cast<const float*>(states),
                  static_cast<const float*>(cums),
                  static_cast<const float*>(hfin),
                  static_cast<const float*>(dh),
                  static_cast<float*>(lam),
                  static_cast<float*>(dd),
                  dx,
                  static_cast<float*>(db),
                  static_cast<float*>(dc),
                  static_cast<float*>(gpart),
                  static_cast<float*>(biasp)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, st, d, chunk, s);
  return (int)dispatch<__nv_bfloat16>(p, st, d, chunk, s);
}

// The decay gradient's parts that ssm_scan_bwd_launch writes at (N, P,
// chunk): *kg a step (gpart's last dim) and *kb a (batch, head) (biasp's).
// Returns cudaErrorInvalidValue for a chunk the backward does not take.
extern "C" int ssm_scan_bwd_parts(int N, int P, int chunk, int* kg, int* kb) {
  if (N <= 0 || P <= 0 || (chunk != 64 && chunk != 128)) return (int)cudaErrorInvalidValue;
  *kg = (N + bwd_nt(chunk) - 1) / bwd_nt(chunk);
  *kb = (int)pass_tiles((long long)N * P);
  return 0;
}

// g: (B * H, S, K) f32, the decay gradient's per-step parts (summed in
// order); bias: (B * H, Kb) f32 or null; a: (B, S, H) f32 with the element
// strides a_strides (int64[3]); da: (B, S, H) f32, contiguous.  Returns the
// launch error (0 on success), cudaErrorInvalidValue for a bad shape.
extern "C" int ssm_scan_da_launch(const void* g, const void* a, const void* bias, void* da,
                                  const long long* a_strides, int B, int H, int S, int K, int Kb,
                                  void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || K <= 0 || Kb < 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  ssm_scan_da_sum_kernel<<<(unsigned)(B * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(a),
      static_cast<const float*>(bias), static_cast<float*>(da), a_strides[0], a_strides[1],
      a_strides[2], H, S, K, Kb);
  return (int)cudaGetLastError();
}
