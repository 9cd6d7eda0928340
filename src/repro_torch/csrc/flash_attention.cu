// Flash attention (prefill) for Hopper (sm_90a), with native GQA, an
// optional causal mask for aligned suffixes, and ragged Sq / Skv.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py.  There the KV blocks are an
// "arbitrary" grid axis with (max, sum, acc) carried in VMEM scratch; here
// one block owns one (b * Hq + h, q tile) and walks the KV tiles in a loop,
// keeping the online-softmax state in f32.
//
// Bound: at the port's prefill shapes (smollm_360m: Hq 15, Hkv 5, D 64,
// bf16, S 512) the card's bound is its bytes: q, k, v read once and o
// written once take longer at 3.35 TB/s than the causal FLOPs at the bf16
// tensor-core rate.  Two routes, chosen by autotune.attention_route:
//
// * tensor cores (`flash_attention_tc_launch`, flash_kernel_tc): bf16 with
//   D 64 or 128 and 16-byte aligned q, k, v (what TMA needs).  One block of
//   two consumer warpgroups (64 q rows each) and one producer warp per
//   (b * Hq + h, 128-row q tile).  The producer loads the Q tile once and
//   the K and V tiles (64 x D) through a two-stage ring, all by TMA (3-D
//   maps over (D, S, B * H), 128-byte swizzle), with a full and an empty
//   mbarrier a stage.  Each warpgroup computes S = Q K^T with
//   wgmma.m64n64k16 (both operands K-major in shared memory, nothing
//   transposed), runs the online softmax on the accumulator fragment in
//   registers (a row spread over a quad of threads: quad shuffles for the
//   max, exp2f with scale * log2 e folded in, the row sums kept per thread
//   and reduced once at the end), rounds P to bf16 in registers -- the S
//   fragment's consecutive pairs are exactly wgmma's register A operand --
//   and adds P V with wgmma.m64nDk16 from registers, V read through the
//   transpose bit.  O stays in f32 registers and is rounded once.  K and V
//   are read once per q tile of 128 rows; causal q tiles launch heaviest
//   first; KV tiles wholly above a warpgroup's diagonal are skipped and only
//   edge tiles are masked.  TMA fills a box past Sq or Skv with zeros of
//   the same head (never the next head's rows); a zero K row scores 0, so
//   keys at or past Skv are masked to -inf like the causal ones.
// * CUDA cores (`flash_attention_launch`, flash_kernel): f32 and every
//   other shape, computing in f32 with each K and V tile staged in shared
//   memory (m, l in shared memory, acc in registers) and re-read once per q
//   tile of at most 64 rows.
//
// Both routes write, where the caller passes an `lse` buffer (B, Hq, Sq) f32,
// each row's log-sum-exp of its scaled scores in natural-log units (the
// training backward, csrc/flash_attention_bwd.cu, recomputes P from it); a
// null pointer writes nothing.  A row that sees no key gets -inf.
//
// Layouts (all contiguous): q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
// out (B, Hq, Sq, D) in q's dtype.  Query head hq uses kv head
// hq / (Hq / Hkv).  Causal: query i sees key j iff j <= i + (Skv - Sq).
// A query row that sees no key returns 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>

#include "hopper.cuh"

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
             T* __restrict__ out, float* __restrict__ lse, int hq, int hkv, int sq, int skv,
             int causal, float scale) {
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
      // m is in natural-log units here
      if (lse != nullptr && tx == 0)
        lse[(size_t)bh * sq + q0 + i] = l == 0.f ? -INFINITY : m_s[i] + logf(l);
    }
  }
}

template <typename T, int D, int BQ, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
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
      static_cast<T*>(out), lse, hq, hkv, sq, skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D, int BQ>
cudaError_t dispatch_bkv(int bkv, const void* q, const void* k, const void* v, void* out,
                         float* lse, int b, int hq, int hkv, int sq, int skv, int causal,
                         float scale, cudaStream_t st) {
  switch (bkv) {
    case 32: return launch<T, D, BQ, 32>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    case 64: return launch<T, D, BQ, 64>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    case 128: return launch<T, D, BQ, 128>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t dispatch_bq(int bq, int bkv, const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int hq, int hkv, int sq, int skv, int causal,
                        float scale, cudaStream_t st) {
  switch (bq) {
    case 32: return dispatch_bkv<T, D, 32>(bkv, q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    case 64: return dispatch_bkv<T, D, 64>(bkv, q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int d, int bq, int bkv, const void* q, const void* k, const void* v,
                       void* out, float* lse, int b, int hq, int hkv, int sq, int skv, int causal,
                       float scale, cudaStream_t st) {
  switch (d) {
    case 32: return dispatch_bq<T, 32>(bq, bkv, q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    case 64: return dispatch_bq<T, 64>(bq, bkv, q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    case 128: return dispatch_bq<T, 128>(bq, bkv, q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ the tensor-core route (bf16)
namespace tc {

using namespace hopper;

constexpr int kBQ = 128;                      // q rows of a block: two warpgroups of 64
constexpr int kConsumers = kBQ / 64;
constexpr int kThreads = kConsumers * 128 + 32;   // + the producer warp
constexpr int kStages = 2;                    // stages of the K/V ring
constexpr int kBKV = 64;                      // keys of a K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: the Q tile (D / 64 boxes of 128 rows x 128 bytes), then
// kStages stages of a K and a V tile (D / 64 boxes of kBKV rows x 128 bytes
// each), then a full and an empty barrier a stage and the Q barrier; 1 KB
// to align every tile to the 1024-byte period of the 128-byte swizzle.
// Must agree with repro_torch.kernels.autotune.flash_tc_smem_bytes.
template <int D>
struct Tile {
  static_assert(D == 64 || D == 128, "head dim");
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBKV * D * 2;      // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * (2 * kStages + 1);
  // two blocks an SM at D 64, where the registers allow it (the S and O
  // fragments: ~100 a thread)
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
};

// The products are hopper.cuh's: S = Q K^T on WgmmaSS (both operands
// K-major), O += P V on WgmmaRS (P from registers, V MN-major).

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
flash_kernel_tc(const __grid_constant__ CUtensorMap tma_q, const __grid_constant__ CUtensorMap tma_k,
                const __grid_constant__ CUtensorMap tma_v, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int hq, int hkv, int sq, int skv, int causal, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = qs + T::kQBytes;
  const uint32_t bars = ring + kStages * T::kStageBytes;   // full[s], empty[s], then Q's
  const uint32_t qbar = bars + 16 * kStages;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                     // b * hq + query head
  const int kvz = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // causal q tiles in reverse: the ones with the most keys launch first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const int seq_off = skv - sq;
  // the KV tiles up to the last key the block's last row sees
  const int kv_end = causal ? min(skv, max(0, min(q0 + kBQ, sq) + seq_off)) : skv;
  const int n_tiles = (kv_end + kBKV - 1) / kBKV;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                       // full: the producer's arrival + bytes
      mbar_init(bars + 8 * (kStages + s), kConsumers);  // empty: one arrival a warpgroup
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == kConsumers) {                        // the producer warp
    if (tid % 32 == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kBoxes; ++c) tma_load(qs + c * kBQ * 128, &tma_q, qbar, c * 64, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bars + 8 * (kStages + s), ((t / kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t ks = ring + s * T::kStageBytes;
        mbar_expect_tx(full, T::kStageBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c) {
          tma_load(ks + c * kBKV * 128, &tma_k, full, c * 64, t * kBKV, kvz);
          tma_load(ks + T::kKVBytes + c * kBKV * 128, &tma_v, full, c * 64, t * kBKV, kvz);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: q rows q_wg ... q_wg + 63.  The m64 fragments
  // hold, for each 8-column group j, rows r and r + 8 (r = warp * 16 +
  // lane / 4) at columns 8 j + 2 (lane % 4) + {0, 1}.
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int q_wg = q0 + wg * 64;
  const int row = q_wg + warp * 16 + lane / 4;   // and row + 8
  const int wg_end = causal ? min(kv_end, max(0, min(q_wg + 64, sq) + seq_off))
                            : (q_wg < sq ? skv : 0);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};           // running max (log2 units), rows r, r + 8
  float l[2] = {0.f, 0.f};                       // this thread's part of the row sums
  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int j0 = t * kBKV;
    mbar_wait(bars + 8 * s, (t / kStages) & 1);
    if (j0 < wg_end) {                           // else wholly above this warpgroup's diagonal
      const uint32_t ks = ring + s * T::kStageBytes;
      const uint32_t vs = ks + T::kKVBytes;
      float sc[kBKV / 2];
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // a k16 step is 32 bytes along a swizzled 128-byte row of box kk / 4
        const uint32_t step = (kk % 4) * 32;
        WgmmaSS<kBKV, 0, 0>::mma(
            sc, desc(qs + (kk / 4) * kBQ * 128 + wg * 64 * 128 + step, 16, 1024),
            desc(ks + (kk / 4) * kBKV * 128 + step, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();

      // scale (log2 units); mask the keys past Skv and, on the diagonal, the
      // causal ones
      const bool edge = j0 + kBKV > skv || (causal && j0 + kBKV - 1 > q_wg + seq_off);
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int key = j0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int r = row + 8 * (e >> 1);
            if (key >= skv || (causal && key > r + seq_off)) v = -INFINITY;
          }
          sc[4 * j + e] = v;
        }
      // online softmax on the fragment: a row lives in the quad of lanes
      // sharing lane / 4
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
        const float corr = exp2f(m[h] - base);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * h + e] - base);
            sc[4 * j + 2 * h + e] = p;
            sum += p;
          }
        l[h] = l[h] * corr + sum;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * h] *= corr;
          o[4 * j + 2 * h + 1] *= corr;
        }
      }
      // P in bf16: the S fragment's consecutive pairs are wgmma's A
      // fragment of the k16 step kk (registers 4 kk ... 4 kk + 3)
      uint32_t pa[kBKV / 4];
#pragma unroll
      for (int i = 0; i < kBKV / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
        // V: 16 key rows of 128 bytes a k16 step, 8-row groups 1024 bytes
        // apart (stride), 64-column boxes kBKV * 128 bytes apart (leading)
        WgmmaRS<D>::mma(o, pa + 4 * kk, desc(vs + kk * 2048, kBKV * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
    }
    if (tid % 128 == 0) mbar_arrive(bars + 8 * (kStages + s));   // stage s is free again
  }

  // epilogue: the quad's row sums, one rounding to bf16, masked rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __nv_bfloat16* ob = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= sq) continue;
    const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
    // m is in log2 units (scale * log2 e folded in): lse = (m + log2 l) ln 2
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<size_t>(bh) * sq + r] =
          l[h] == 0.f ? -INFINITY : (m[h] + log2f(l[h])) * kLn2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r) * D + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int hq, int hkv, int sq, int skv, int causal, float scale,
                   cudaStream_t stream) {
  using T = Tile<D>;
  const int q_tiles = (sq + kBQ - 1) / kBQ;
  if (q_tiles > 65535 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kern = flash_kernel_tc<D>;
  static const cudaError_t attr =   // once per instantiation
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, D, sq, static_cast<uint64_t>(b) * hq, 64, kBQ);
  if (err == cudaSuccess) err = make_map(&mk, k, D, skv, static_cast<uint64_t>(b) * hkv, 64, kBKV);
  if (err == cudaSuccess) err = make_map(&mv, v, D, skv, static_cast<uint64_t>(b) * hkv, 64, kBKV);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, q_tiles);
  kern<<<grid, kThreads, T::kSmem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse,
                                             hq, hkv, sq, skv, causal, scale * kLog2e);
  return cudaGetLastError();
}

// The tile of autotune.FLASH_TC_TILES, (bq, bkv) = (kBQ, kBKV), at the head
// dims of autotune.FLASH_TC_DIMS.
cudaError_t dispatch(int d, int bq, int bkv, const void* q, const void* k, const void* v,
                     void* out, float* lse, int b, int hq, int hkv, int sq, int skv, int causal,
                     float scale, cudaStream_t st) {
  if (bq != kBQ || bkv != kBKV) return cudaErrorInvalidValue;
  if (d == 64) return launch<64>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
  if (d == 128) return launch<128>(q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `lse`: null, or (B, Hq, Sq) f32 for
// each row's log-sum-exp.  Returns cudaGetLastError() after the launch (0 on
// success); cudaErrorInvalidValue for an unsupported shape or block size.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, float* lse, int b, int hq, int hkv, int sq, int skv,
                                      int d, int bq, int bkv, int causal, float scale,
                                      int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, bq, bkv, q, k, v, out, lse, b, hq, hkv, sq, skv, causal,
                                  scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(d, bq, bkv, q, k, v, out, lse, b, hq, hkv, sq, skv,
                                          causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// bf16 on the tensor cores: D 64 or 128, bq 128, bkv 64, q, k and v
// 16-byte aligned.  Returns cudaGetLastError() after the launch (0 on
// success); cudaErrorInvalidValue for a shape, tile or pointer the route
// does not take.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int b, int hq, int hkv, int sq, int skv, int d, int bq,
                                         int bkv, int causal, float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)tc::dispatch(d, bq, bkv, q, k, v, out, lse, b, hq, hkv, sq, skv, causal, scale,
                           static_cast<cudaStream_t>(stream));
}
