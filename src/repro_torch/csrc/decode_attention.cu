// Flash-decode attention for Hopper (sm_90a): one new query token per
// (batch, query head) against a KV cache with a per-row valid length.
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// src/repro/kernels/decode_attention.py.  There the KV walk is an
// "arbitrary" grid axis with (max, sum, acc) carried in VMEM scratch; here
// it is a loop inside one block, which stops at length[b] (the TPU kernel
// walks the whole cache and masks the tail).
//
// Bound: bytes.  Per (b, kv head) the kernel must read the valid K and V
// prefix once (2 * length * D elements) and does 4 * group * length * D
// FLOPs on them: about group FLOPs per byte, far below the ~295 FLOP/byte
// at which an H100 stops being memory-bound.  The design therefore reads each
// KV row once: one block per (b, kv head) serves all `group` query heads of
// that kv head (GQA), so K and V are not re-read per query head.  Each KV
// tile is staged in shared memory by all threads with independent,
// coalesced loads (a warp walking rows one load at a time was bound by
// memory latency), then scored one thread per (head, row).  The dot products
// and the softmax run in f32 on the CUDA cores; tensor cores would not move
// a bytes-bound kernel.  At batch 8 the grid has only 40 blocks for 132 SMs;
// a split-KV pass is the next step (ROADMAP Queue 2).
//
// Layouts (all contiguous): q (B, Hq, D), k/v (B, Hkv, S, D), length (B,)
// int32, out (B, Hq, D) in q's dtype.  Query head h uses kv head
// h / (Hq / Hkv).  Positions at or past length[b] contribute nothing; a row
// with length 0 has no valid key and returns 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

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

// Shared memory, in floats: q[group][D], acc[group][D], p[group][bkv],
// m[group], l[group], corr[group], K[bkv][D+1], V[bkv][D] (the +1 pad keeps
// threads that read different K rows on different banks).  Must agree with
// repro_torch.kernels.autotune.decode_smem_bytes.
__host__ __device__ inline int smem_floats(int group, int d, int bkv) {
  return 2 * group * d + group * bkv + 3 * group + bkv * (d + 1) + bkv * d;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              T* __restrict__ out, int hq, int hkv, int s, int bkv, float scale) {
  constexpr int LDK = D + 1;
  const int group = hq / hkv;
  const int bh = blockIdx.x;  // b * hkv + kv head
  const int b = bh / hkv;
  const int kvh = bh % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;
  float* acc = qs + group * D;
  float* ps = acc + group * D;
  float* m_s = ps + group * bkv;
  float* l_s = m_s + group;
  float* c_s = l_s + group;
  float* ks = c_s + group;
  float* vs = ks + bkv * LDK;

  const int len = min(max(length[b], 0), s);
  // the group query heads of this kv head are contiguous in q and out
  const size_t qoff = ((size_t)b * hq + (size_t)kvh * group) * D;
  for (int i = tid; i < group * D; i += kThreads) {
    qs[i] = to_f(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const T* kb = k + (size_t)bh * s * D;
  const T* vb = v + (size_t)bh * s * D;
  for (int j0 = 0; j0 < len; j0 += bkv) {
    const int n = min(bkv, len - j0);
    // stage the tile's valid rows: consecutive threads, consecutive elements
    const T* kt = kb + (size_t)j0 * D;
    const T* vt = vb + (size_t)j0 * D;
    for (int i = tid; i < n * D; i += kThreads) {
      const int r = i / D;
      ks[r * LDK + i - r * D] = to_f(kt[i]);
      vs[i] = to_f(vt[i]);
    }
    __syncthreads();
    // scores: one thread per (head, row)
    for (int i = tid; i < group * n; i += kThreads) {
      const int g = i / n;
      const int r = i - g * n;
      const float* qr = qs + g * D;
      const float* kr = ks + r * LDK;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      ps[g * bkv + r] = dot * scale;
    }
    __syncthreads();
    // online softmax over the tile: one warp per query head
    for (int g = warp; g < group; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ps[g * bkv + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(ps[g * bkv + r] - m_new);
        ps[g * bkv + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // acc[g][d] = acc * corr + sum_r p[g][r] * V[r][d]
    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* p = ps + g * bkv;
      float a = acc[i] * c_s[g];
      for (int r = 0; r < n; ++r) a += p[r] * vs[r * D + d];
      acc[i] = a;
    }
    __syncthreads();  // the next tile overwrites K, V and p
  }
  __syncthreads();

  for (int i = tid; i < group * D; i += kThreads) {
    const float l = l_s[i / D];
    out[qoff + i] = from_f<T>(l == 0.f ? 0.f : acc[i] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* length,
                   void* out, int b, int hq, int hkv, int s, int bkv, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats(hq / hkv, D, bkv) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> opted{0};
    cudaError_t err = opt_in_smem(decode_kernel<T, D>, opted);
    if (err != cudaSuccess) return err;
  }
  decode_kernel<T, D><<<b * hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(length), static_cast<T*>(out), hq, hkv, s, bkv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* length,
                       void* out, int b, int hq, int hkv, int s, int d, int bkv,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, length, out, b, hq, hkv, s, bkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, length, out, b, hq, hkv, s, bkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, length, out, b, hq, hkv, s, bkv, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for an unsupported shape.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* length, void* out, int b, int hq,
                                       int hkv, int s, int d, int bkv, float scale,
                                       int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || bkv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, length, out, b, hq, hkv, s, d, bkv, scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, length, out, b, hq, hkv, s, d, bkv,
                                          scale, st);
  return (int)cudaErrorInvalidValue;
}
