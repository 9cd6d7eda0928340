// Chunked selective scan (Mamba2 / SSD form, scalar decay per head) for
// Hopper (sm_90a):
//     h_t = a_t h_{t-1} + b_t (x) x_t,    y_t = c_t . h_t
// per (batch, head), with x (P wide), b and c (N wide) and h (N x P).
//
// Replaces the Pallas TPU kernel `_ssm_kernel` / `ssm_scan` in
// src/repro/kernels/ssm_scan.py (:28, :73).  There the grid is (b * h,
// chunk) with the chunk axis "arbitrary" (:110): h (N x P, f32) is carried
// in VMEM scratch from one chunk to the next, and S must be a multiple of
// the chunk (asserted).  Here one block runs every chunk of its (b * h, P
// tile) in a loop and carries its N x P-tile slice of h in shared memory;
// the columns of h and y are independent across P, which is what allows the
// split over P.  Per chunk of L steps (cum = inclusive cumsum of
// log max(a, 1e-20)):
//     G = (C B^T) masked by tril(exp(cum_t - cum_s))
//     y = G X + (C * exp(cum)) h
//     h <- B^T diag(exp(cum_L - cum)) X + exp(cum_L) h
// The tail chunk is padded with a = 1, b = 0, x = 0, which leaves h
// unchanged, so any S runs.
//
// Bound: operations.  Per chunk a block does L^2 N (C B^T) + L^2 Pt (G X)
// + 2 L N Pt (readout and carry) multiply-adds on L (P + 2 N + 1) inputs, so
// at zamba2's (N 64, P 128) and xlstm's (N 512, P 512) shapes the f32 work
// on the CUDA cores outweighs the bytes (autotune.pom_scan_schedule scores
// both).  The design keeps every operand of the chunk in shared memory (h,
// X, the masked decay matrix, B and C), streams B and C over N in tiles of
// 32 (at xlstm's N 512 a whole 64 x 512 f32 chunk of each would be 128 KiB),
// and fuses the readout of the old h with the carry update tile by tile:
// the rows of h that a B/C tile touches are read for y first and then
// overwritten.  The 256 threads form a 16 x 16 grid; each keeps its L/16 x
// L/16 slice of C B^T and its L/16 x Pt/16 slice of y in registers, with
// rows and columns interleaved (ty + 16 i, tx + 16 j) so that a warp's
// shared-memory reads hit distinct banks or one broadcast.  Tensor cores
// (wgmma on the three products) are later work.
//
// Layouts: x (B, S, H, P) and b, c (B, S, H, N) with their last dim
// contiguous and any batch, time and head strides (a head stride of 0
// broadcasts one B/C group over every head, as zamba2 does); a (B, S, H)
// with any strides.  a, b, c are float32; x is float32 or bfloat16.  h
// starts at 0; the final h is (B, H, N, P) f32, contiguous; y is
// (B, S, H, P) in x's dtype, contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kNT = 32;  // N tile (autotune.SCAN_NT)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides (batch, time, head) of the four inputs.  Mirrors the
// int64[12] array the wrapper passes.
struct Strides {
  long long x[3], a[3], b[3], c[3];
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

// Shared memory, in floats: h[n_pad][Pt], X[L][Pt], G[L][L+1], B[L][NT+1],
// C[L][NT+1], cum[L], exp(cum)[L], exp(cum_L - cum)[L] (the +1 pads keep
// the rows a warp reads on distinct banks).  Must agree with
// repro_torch.kernels.autotune.scan_smem_bytes.
__host__ __device__ inline int smem_floats(int L, int pt, int n) {
  const int n_pad = (n + kNT - 1) / kNT * kNT;
  return n_pad * pt + L * pt + L * (L + 1) + 2 * L * (kNT + 1) + 3 * L;
}

template <typename T, int L, int PT>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bmat, const float* __restrict__ cmat,
                T* __restrict__ y, float* __restrict__ hout,
                const Strides st, int H, int S, int P, int N) {
  constexpr int RL = L / 16;   // rows (or columns) of an L-long axis per thread
  constexpr int RP = PT / 16;  // columns of the P tile per thread
  constexpr int RN = kNT / 16; // rows of an N tile per thread
  constexpr int LD = kNT + 1;
  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh - (bh / H) * H;
  const int p0 = blockIdx.y * PT;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_pad = (N + kNT - 1) / kNT * kNT;

  extern __shared__ float smem[];
  float* hs = smem;                 // [n_pad][PT]
  float* xs = hs + n_pad * PT;      // [L][PT]
  float* gs = xs + L * PT;          // [L][L + 1]
  float* bs = gs + L * (L + 1);     // [L][LD]
  float* cs = bs + L * LD;          // [L][LD]
  float* cum = cs + L * LD;         // [L]
  float* ecum = cum + L;            // exp(cum)
  float* win = ecum + L;            // exp(cum[L-1] - cum)

  const T* xb = x + bi * st.x[0] + hi * st.x[2];
  const float* ab = a + bi * st.a[0] + hi * st.a[2];
  const float* bb = bmat + bi * st.b[0] + hi * st.b[2];
  const float* cb = cmat + bi * st.c[0] + hi * st.c[2];

  for (int i = tid; i < n_pad * PT; i += kThreads) hs[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    // cum by one warp: each lane sums L/32 consecutive steps, then a warp scan
    if (tid < 32) {
      constexpr int E = L / 32;
      const int lane = tid;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int gt = t0 + lane * E + r;
        const float av = gt < S ? ab[(long long)gt * st.a[1]] : 1.f;
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
      const float last = __shfl_sync(0xffffffffu, v[E - 1] + excl, 31);
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const float c = v[r] + excl;
        const int t = lane * E + r;
        cum[t] = c;
        ecum[t] = expf(c);
        win[t] = expf(last - c);
      }
    }
    for (int i = tid; i < L * PT; i += kThreads) {
      const int t = i / PT, p = i - (i / PT) * PT;
      const int gt = t0 + t, gp = p0 + p;
      xs[i] = (gt < S && gp < P) ? to_f(xb[(long long)gt * st.x[1] + gp]) : 0.f;
    }
    __syncthreads();

    float g[RL][RL], yv[RL][RP];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
#pragma unroll
      for (int j = 0; j < RL; ++j) g[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < RP; ++j) yv[i][j] = 0.f;
    }
    const float decay = ecum[L - 1];

    for (int n0 = 0; n0 < N; n0 += kNT) {
      for (int i = tid; i < L * kNT; i += kThreads) {
        const int t = i / kNT, nn = i - (i / kNT) * kNT;
        const int gt = t0 + t, gn = n0 + nn;
        const bool ok = gt < S && gn < N;
        bs[t * LD + nn] = ok ? bb[(long long)gt * st.b[1] + gn] : 0.f;
        cs[t * LD + nn] = ok ? cb[(long long)gt * st.c[1] + gn] : 0.f;
      }
      __syncthreads();
      // C B^T and C h_old over this N tile
#pragma unroll 4
      for (int nn = 0; nn < kNT; ++nn) {
        float cv[RL], bv[RL], hv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = cs[(ty + 16 * i) * LD + nn];
#pragma unroll
        for (int j = 0; j < RL; ++j) bv[j] = bs[(tx + 16 * j) * LD + nn];
#pragma unroll
        for (int j = 0; j < RP; ++j) hv[j] = hs[(n0 + nn) * PT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
#pragma unroll
          for (int j = 0; j < RL; ++j) g[i][j] += cv[i] * bv[j];
#pragma unroll
          for (int j = 0; j < RP; ++j) yv[i][j] += cv[i] * hv[j];
        }
      }
      __syncthreads();  // every read of the old h rows of this tile is done
      // carry: h[n][p] = exp(cum_L) h[n][p] + sum_t B[t][n] exp(cum_L - cum_t) X[t][p]
      float hn[RN][RP];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) hn[i][j] = decay * hs[(n0 + ty + 16 * i) * PT + tx + 16 * j];
#pragma unroll 4
      for (int t = 0; t < L; ++t) {
        const float w = win[t];
        float bv[RN], xv[RP];
#pragma unroll
        for (int i = 0; i < RN; ++i) bv[i] = bs[t * LD + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < RP; ++j) xv[j] = xs[t * PT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) hn[i][j] += bv[i] * xv[j];
      }
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) hs[(n0 + ty + 16 * i) * PT + tx + 16 * j] = hn[i][j];
      __syncthreads();  // the next tile overwrites B and C
    }

    // the masked decay matrix, then y = G X + exp(cum) (C h_old)
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        const int s = tx + 16 * j;
        gs[t * (L + 1) + s] = s <= t ? g[i][j] * expf(cum[t] - cum[s]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const float e = ecum[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RP; ++j) yv[i][j] *= e;
    }
#pragma unroll 4
    for (int s = 0; s < L; ++s) {
      float gv[RL], xv[RP];
#pragma unroll
      for (int i = 0; i < RL; ++i) gv[i] = gs[(ty + 16 * i) * (L + 1) + s];
#pragma unroll
      for (int j = 0; j < RP; ++j) xv[j] = xs[s * PT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) yv[i][j] += gv[i] * xv[j];
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int gt = t0 + ty + 16 * i;
      if (gt >= S) continue;
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int gp = p0 + tx + 16 * j;
        if (gp < P) y[(((size_t)bi * S + gt) * H + hi) * P + gp] = from_f<T>(yv[i][j]);
      }
    }
    __syncthreads();  // the next chunk overwrites X, G and cum
  }

  for (int i = tid; i < N * PT; i += kThreads) {
    const int n = i / PT, p = i - (i / PT) * PT;
    if (p0 + p < P) hout[((size_t)bh * N + n) * P + p0 + p] = hs[i];
  }
}

template <typename T, int L, int PT>
cudaError_t launch(const void* x, const float* a, const float* b, const float* c, void* y,
                   float* hout, const Strides& st, int B, int H, int S, int P, int N,
                   cudaStream_t stream) {
  const int smem = smem_floats(L, PT, N) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> opted{0};
    cudaError_t err = opt_in_smem(ssm_scan_kernel<T, L, PT>, opted);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (P + PT - 1) / PT);
  ssm_scan_kernel<T, L, PT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, b, c, static_cast<T*>(y), hout, st, H, S, P, N);
  return cudaGetLastError();
}

// The (chunk, P tile) pairs of autotune.SCAN_CHUNKS x autotune.SCAN_PTILES.
template <typename T>
cudaError_t dispatch(const void* x, const float* a, const float* b, const float* c, void* y,
                     float* hout, const Strides& st, int B, int H, int S, int P, int N, int L,
                     int pt, cudaStream_t s) {
#define SSM_CASE(LL, PP)                                                            \
  if (L == LL && pt == PP) return launch<T, LL, PP>(x, a, b, c, y, hout, st, B, H, S, P, N, s);
  SSM_CASE(32, 16) SSM_CASE(32, 32) SSM_CASE(32, 64)
  SSM_CASE(64, 16) SSM_CASE(64, 32) SSM_CASE(64, 64)
#undef SSM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: int64[12], the (batch, time, head) element strides of x, a, b, c.
// dtype (of x and y): 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for an unsupported shape.
extern "C" int ssm_scan_launch(const void* x, const void* a, const void* b, const void* c,
                               void* y, void* hout, const long long* strides,
                               int B, int H, int S, int P, int N, int chunk, int p_tile,
                               int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || P <= 0 || N <= 0 || p_tile <= 0 ||
      (long long)B * H > 2147483647LL || (P + p_tile - 1) / p_tile > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.a[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
  }
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* ho = static_cast<float*>(hout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(x, af, bf, cf, y, ho, st, B, H, S, P, N, chunk, p_tile, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, af, bf, cf, y, ho, st, B, H, S, P, N, chunk, p_tile,
                                        s);
  return (int)cudaErrorInvalidValue;
}
