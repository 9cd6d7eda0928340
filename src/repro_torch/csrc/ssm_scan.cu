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
// chunks, L).  After the call the chunk states hold h_c, the state entering
// chunk c, for c >= 1; the backward (ssm_scan_bwd.cu) reads G, h_c and cum
// from this scratch.  The helpers and the chunk-state kernel are in
// ssm_scan.cuh, which the backward includes too.
#include "ssm_scan.cuh"

namespace {

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
  SSM_CASE(64, 8) SSM_CASE(64, 64) SSM_CASE(64, 128) SSM_CASE(128, 128)
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
