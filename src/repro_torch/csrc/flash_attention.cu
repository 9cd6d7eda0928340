// Flash attention (prefill) for Hopper (sm_90a), with native GQA, an
// optional causal mask for aligned suffixes, and ragged Sq / Skv.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py.  There the KV blocks are an
// "arbitrary" grid axis with (max, sum, acc) carried in VMEM scratch; here
// one block owns one (b * Hq + h, q tile) and walks the KV tiles in a loop,
// staging each K and V tile in shared memory and keeping the online-softmax
// state in f32 (m, l in shared memory, acc in registers).
//
// Bound: at the port's prefill shapes (smollm_360m: Hq 15, Hkv 5, D 64,
// bf16, S 512) the card's bound is its bytes: q, k, v read once and o
// written once take longer at 3.35 TB/s than the causal FLOPs at the bf16
// tensor-core rate.  This first version computes in f32 on the CUDA cores
// and re-reads each K/V tile once per q tile (from L2), so it runs well above
// that bound; wgmma and TMA are later work.  What the design does keep:
// causal KV tiles wholly above the diagonal are skipped, so the causal
// kernel does about half the work of the full one.
//
// Layouts (all contiguous): q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
// out (B, Hq, Sq, D) in q's dtype.  Query head hq uses kv head
// hq / (Hq / Hkv).  Causal: query i sees key j iff j <= i + (Skv - Sq).
// A query row that sees no key returns 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // 16 x 8 threads: ty picks rows, tx columns
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF (initial max)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Raises `kernel`'s dynamic shared-memory limit to the card's opt-in maximum,
// once per device (`done` holds one bit per device), so a launch past the
// default 48 KB does not pay a driver call every time.  Each launch still
// asks only for the shared memory it uses.
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

// Shared memory, in floats: Q[BQ][D+1], K[BKV][D+1], V[BKV][D],
// S[BQ][BKV+1], m[BQ], l[BQ], corr[BQ].  The +1 pads break bank conflicts.
// Must agree with repro_torch.kernels.autotune.flash_smem_bytes.
__host__ __device__ constexpr int smem_floats(int bq, int bkv, int d) {
  return bq * (d + 1) + bkv * (d + 1) + bkv * d + bq * (bkv + 1) + 3 * bq;
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int hq, int hkv, int sq, int skv, int causal,
             float scale) {
  constexpr int R = BQ / 16;    // rows per thread
  constexpr int CS = BKV / 8;   // score columns per thread
  constexpr int CD = D / 8;     // output columns per thread
  constexpr int LDQ = D + 1;
  constexpr int LDK = D + 1;
  constexpr int LDS = BKV + 1;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LDQ;
  float* vs = ks + BKV * LDK;
  float* ss = vs + BKV * D;
  float* m_s = ss + BQ * LDS;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int bh = blockIdx.y;  // b * hq + query head
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int group = hq / hkv;
  const int kvh = h / group;
  const int q0 = blockIdx.x * BQ;
  const int seq_off = skv - sq;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + ((size_t)b * hkv + kvh) * skv * D;
  const T* vb = v + ((size_t)b * hkv + kvh) * skv * D;
  T* ob = out + (size_t)bh * sq * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    qs[r * LDQ + d] = (q0 + r < sq) ? to_f(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[R][CD];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;

  // KV tiles past the last visible key of the tile's last row are skipped
  int kv_end = skv;
  if (causal) kv_end = min(skv, max(0, min(q0 + BQ, sq) + seq_off));
  __syncthreads();

  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    for (int i = tid; i < BKV * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int j = j0 + r;
      const bool ok = j < skv;
      ks[r * LDK + d] = ok ? to_f(kb[(size_t)j * D + d]) : 0.f;
      vs[r * D + d] = ok ? to_f(vb[(size_t)j * D + d]) : 0.f;
    }
    __syncthreads();

    // S = scale * Q K^T on this tile; masked entries become -inf
    float sacc[R][CS];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CS; ++c) sacc[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[R];
      float kv[CS];
#pragma unroll
      for (int r = 0; r < R; ++r) qv[r] = qs[(ty * R + r) * LDQ + d];
#pragma unroll
      for (int c = 0; c < CS; ++c) kv[c] = ks[(tx + 8 * c) * LDK + d];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CS; ++c) sacc[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty * R + r;
      const int qpos = q0 + i + seq_off;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int j = tx + 8 * c;
        const int kpos = j0 + j;
        const bool ok = kpos < skv && q0 + i < sq && (!causal || kpos <= qpos);
        ss[i * LDS + j] = ok ? sacc[r][c] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row; masked entries give p = 0 exactly
    for (int i = warp; i < BQ; i += kThreads / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < BKV; j += 32) mx = fmaxf(mx, ss[i * LDS + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BKV; j += 32) {
        const float sv = ss[i * LDS + j];
        const float p = (sv == -INFINITY) ? 0.f : expf(sv - m_new);
        ss[i * LDS + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[i] = m_new;
        l_s[i] = l_s[i] * corr + sum;
        c_s[i] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float corr = c_s[ty * R + r];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= corr;
    }
    for (int j = 0; j < BKV; ++j) {
      float p[R];
      float vv[CD];
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = ss[(ty * R + r) * LDS + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = vs[j * D + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] += p[r] * vv[c];
    }
    __syncthreads();  // the next tile overwrites K, V and S
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty * R + r;
    if (q0 + i < sq) {
      const float l = l_s[i];
#pragma unroll
      for (int c = 0; c < CD; ++c)
        ob[(size_t)(q0 + i) * D + tx + 8 * c] = from_f<T>(l == 0.f ? 0.f : acc[r][c] / l);
    }
  }
}

template <typename T, int D, int BQ, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b,
                   int hq, int hkv, int sq, int skv, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats(BQ, BKV, D) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> opted{0};
    cudaError_t err = opt_in_smem(flash_kernel<T, D, BQ, BKV>, opted);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_kernel<T, D, BQ, BKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, sq, skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D, int BQ>
cudaError_t dispatch_bkv(int bkv, const void* q, const void* k, const void* v, void* out,
                         int b, int hq, int hkv, int sq, int skv, int causal,
                         float scale, cudaStream_t st) {
  switch (bkv) {
    case 32: return launch<T, D, BQ, 32>(q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    case 64: return launch<T, D, BQ, 64>(q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    case 128: return launch<T, D, BQ, 128>(q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t dispatch_bq(int bq, int bkv, const void* q, const void* k, const void* v,
                        void* out, int b, int hq, int hkv, int sq, int skv, int causal,
                        float scale, cudaStream_t st) {
  switch (bq) {
    case 32: return dispatch_bkv<T, D, 32>(bkv, q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    case 64: return dispatch_bkv<T, D, 64>(bkv, q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int d, int bq, int bkv, const void* q, const void* k, const void* v,
                       void* out, int b, int hq, int hkv, int sq, int skv, int causal,
                       float scale, cudaStream_t st) {
  switch (d) {
    case 32: return dispatch_bq<T, 32>(bq, bkv, q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    case 64: return dispatch_bq<T, 64>(bq, bkv, q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    case 128: return dispatch_bq<T, 128>(bq, bkv, q, k, v, out, b, hq, hkv, sq, skv, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for an unsupported shape or
// block size.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int b, int hq, int hkv, int sq, int skv,
                                      int d, int bq, int bkv, int causal, float scale,
                                      int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, bq, bkv, q, k, v, out, b, hq, hkv, sq, skv, causal,
                                  scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(d, bq, bkv, q, k, v, out, b, hq, hkv, sq, skv,
                                          causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
