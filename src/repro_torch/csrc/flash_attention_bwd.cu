// The backward of flash attention for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(scale * Q K^T) V with native GQA, an optional causal mask for
// aligned suffixes, and ragged Sq / Skv.
//
// No TPU counterpart: the reference trains on its pure-jnp attention path
// (src/repro/configs/base.py, use_pallas False) and XLA differentiates it;
// it has no custom_vjp and no backward Pallas kernel.  On the card the
// port's training step runs the flash forward (csrc/flash_attention.cu), so
// it needs that forward's gradient, computed here without ever storing the
// Sq x Skv score matrix.  With lse the forward's log-sum-exp of each row:
//   P = exp(scale * Q K^T - lse)           (recomputed, masked entries 0)
//   dV = sum over the group of P^T dO      dP = dO V^T
//   Delta = rowsum(dO o O)                 dS = P o (dP - Delta)
//   dQ = scale * dS K                      dK = scale * sum over the group of dS^T Q
// A row that sees no key (lse = -inf) has every entry masked, so its P and
// its gradient are 0, never NaN.
//
// Bound: at the port's training shape (smollm_360m: B 8, Hq 15, Hkv 5,
// S 256, D 64, bf16, causal) reading q, k, v, o, dO, lse and writing dq, dk,
// dv take longer at 3.35 TB/s than the five causal products at the bf16
// tensor-core rate, so the bound is bytes (0.0063 ms on an H100 SXM).  At
// that size what holds a kernel above the bound is latency: loads that do
// not overlap products, few and uneven dK/dV work items (B * Hkv * Skv / 64
// of them, 160 at that shape, whose causal key tile 0 walks the group's 12
// query tiles where tile 3 walks 3), and a fixed cost an item.  The
// tensor-core route answers with TMA rings fed by a producer, the longest
// walks first and split over two warpgroups, and a persistent dK/dV grid.
//
// Design (deterministic, no atomics), on either of two routes (the tensor
// cores for bf16 at D 64 with 16-byte aligned operands,
// `flash_attention_bwd_tc_launch`; the CUDA cores for the rest -- f32, D
// 32 and 128, misaligned operands -- `flash_attention_bwd_launch`), chosen
// by autotune.attention_bwd_route:
// * the CUDA cores, three kernels: flash_bwd_delta_kernel, Delta (B, Hq, Sq)
//   in f32, one warp a row; flash_bwd_dkdv_kernel, one block per
//   (b * Hkv + kv head, key tile of BKV), K and V in shared memory, walking
//   the group's query heads and, causal, only the query tiles on or below
//   the diagonal, recomputing S^T and dP^T for each, with dK and dV in f32
//   registers (the group's sum happens in the block, so no two blocks write
//   one key); flash_bwd_dq_kernel, one block per (b * Hq + h, query tile of
//   BQ), walking the key tiles up to its last row's last visible key (as
//   the forward does), recomputing P and dP and keeping dQ in f32
//   registers.  Every product in f32 from operands staged in shared memory
//   (bf16 converted on load).
// * the tensor cores, two kernels on TMA and wgmma (namespace tc below):
//   dQ, which folds Delta into its prologue, then dK and dV, whose two
//   consumer warpgroups split each block's walk.
// The recompute of S and dP in both the dK/dV and the dQ kernel (seven
// products where a kernel with atomics on dQ needs five) is the price of
// determinism.
//
// Layouts (all contiguous): q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv
// (B, Hkv, Skv, D); lse, delta (B, Hq, Sq) f32.  Query head h uses kv head
// h / (Hq / Hkv).  Causal: query i sees key j iff j <= i + (Skv - Sq).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // 16 x 8 threads: ty picks rows, tx columns

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

// rows x D of src (rows from r0, zeros at or past n) into dst[rows][D + 1]
template <typename T, int ROWS, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * (D + 1) + d] = r0 + r < n ? to_f(src[static_cast<size_t>(r0 + r) * D + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + static_cast<size_t>(row) * d;
  const T* dp = dout + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f(op[c]) * to_f(dp[c]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// Shared memory, in floats: K[BKV][D+1], V[BKV][D+1], Q[BQ][D+1],
// dO[BQ][D+1], P^T[BKV][BQ+1], dS^T[BKV][BQ+1], lse[BQ], Delta[BQ].
template <int D, int BQ, int BKV>
__host__ __device__ constexpr int dkdv_smem_floats() {
  return 2 * BKV * (D + 1) + 2 * BQ * (D + 1) + 2 * BKV * (BQ + 1) + 2 * BQ;
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int hq, int hkv, int sq, int skv, int causal, float scale) {
  constexpr int R = BKV / 16;   // key rows a thread
  constexpr int CQ = BQ / 8;    // query columns a thread (of S^T, dP^T)
  constexpr int CD = D / 8;     // head-dim columns a thread (of dK, dV)
  constexpr int LD = D + 1;
  constexpr int LP = BQ + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BKV * LD;
  float* qs = vs + BKV * LD;
  float* dos = qs + BQ * LD;
  float* pt = dos + BQ * LD;
  float* dst = pt + BKV * LP;
  float* lse_s = dst + BKV * LP;
  float* dl_s = lse_s + BQ;

  const int bkh = blockIdx.y;   // b * hkv + kv head
  const int b = bkh / hkv;
  const int kvh = bkh - b * hkv;
  const int group = hq / hkv;
  const int j0 = blockIdx.x * BKV;
  const int seq_off = skv - sq;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;

  stage<T, BKV, D>(ks, k + static_cast<size_t>(bkh) * skv * D, j0, skv);
  stage<T, BKV, D>(vs, v + static_cast<size_t>(bkh) * skv * D, j0, skv);
  float dka[R][CD], dva[R][CD];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[r][c] = dva[r][c] = 0.f;

  // causal: the first query that sees key j0 is j0 - seq_off; the query
  // tiles above it are skipped
  const int i_first = causal ? max(0, j0 - seq_off) : 0;
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = static_cast<size_t>(b) * hq + kvh * group + hh;
    const T* qb = q + bh * sq * D;
    const T* dob = dout + bh * sq * D;
    for (int i0 = (i_first / BQ) * BQ; i0 < sq; i0 += BQ) {
      __syncthreads();   // the last tile's Q, dO, P^T and dS^T are consumed
      stage<T, BQ, D>(qs, qb, i0, sq);
      stage<T, BQ, D>(dos, dob, i0, sq);
      for (int i = tid; i < BQ; i += kThreads) {
        const bool in = i0 + i < sq;
        lse_s[i] = in ? lse[bh * sq + i0 + i] : 0.f;
        dl_s[i] = in ? delta[bh * sq + i0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on this tile
      float st[R][CQ], dpt[R][CQ];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c) st[r][c] = dpt[r][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kr[R], vr[R], qc[CQ], dc[CQ];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          kr[r] = ks[(ty * R + r) * LD + d];
          vr[r] = vs[(ty * R + r) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          qc[c] = qs[(tx + 8 * c) * LD + d];
          dc[c] = dos[(tx + 8 * c) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            st[r][c] += kr[r] * qc[c];
            dpt[r][c] += vr[r] * dc[c];
          }
      }
      // P^T and dS^T = P^T o (dP^T - Delta); masked entries are exactly 0
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = ty * R + r;
        const int kpos = j0 + j;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int i = tx + 8 * c;
          const int qpos = i0 + i;
          const bool ok = kpos < skv && qpos < sq && (!causal || kpos <= qpos + seq_off);
          const float p = ok ? expf(st[r][c] * scale - lse_s[i]) : 0.f;
          pt[j * LP + i] = p;
          dst[j * LP + i] = p * (dpt[r][c] - dl_s[i]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
      for (int i = 0; i < BQ; ++i) {
        float pr[R], sr[R], dc[CD], qc[CD];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          pr[r] = pt[(ty * R + r) * LP + i];
          sr[r] = dst[(ty * R + r) * LP + i];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dc[c] = dos[i * LD + tx + 8 * c];
          qc[c] = qs[i * LD + tx + 8 * c];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dva[r][c] += pr[r] * dc[c];
            dka[r][c] += sr[r] * qc[c];
          }
      }
    }
  }

  T* dkb = dk + static_cast<size_t>(bkh) * skv * D;
  T* dvb = dv + static_cast<size_t>(bkh) * skv * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + ty * R + r;
    if (j >= skv) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dkb[static_cast<size_t>(j) * D + tx + 8 * c] = from_f<T>(dka[r][c] * scale);
      dvb[static_cast<size_t>(j) * D + tx + 8 * c] = from_f<T>(dva[r][c]);
    }
  }
}

// Shared memory, in floats: Q[BQ][D+1], dO[BQ][D+1], K[BKV][D+1],
// V[BKV][D+1], dS[BQ][BKV+1], lse[BQ], Delta[BQ].
template <int D, int BQ, int BKV>
__host__ __device__ constexpr int dq_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BKV * (D + 1) + BQ * (BKV + 1) + 2 * BQ;
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int hq, int hkv,
                    int sq, int skv, int causal, float scale) {
  constexpr int R = BQ / 16;    // query rows a thread
  constexpr int CS = BKV / 8;   // key columns a thread (of S, dP)
  constexpr int CD = D / 8;     // head-dim columns a thread (of dQ)
  constexpr int LD = D + 1;
  constexpr int LS = BKV + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BKV * LD;
  float* ds = vs + BKV * LD;
  float* lse_s = ds + BQ * LS;
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.y;    // b * hq + query head
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int bkh = b * hkv + h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const int seq_off = skv - sq;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const T* kb = k + static_cast<size_t>(bkh) * skv * D;
  const T* vb = v + static_cast<size_t>(bkh) * skv * D;

  stage<T, BQ, D>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq);
  stage<T, BQ, D>(dos, dout + static_cast<size_t>(bh) * sq * D, q0, sq);
  for (int i = tid; i < BQ; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse[static_cast<size_t>(bh) * sq + q0 + i] : 0.f;
    dl_s[i] = in ? delta[static_cast<size_t>(bh) * sq + q0 + i] : 0.f;
  }
  float dqa[R][CD];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) dqa[r][c] = 0.f;

  // the key tiles up to the last key the block's last row sees
  const int kv_end = causal ? min(skv, max(0, min(q0 + BQ, sq) + seq_off)) : skv;
  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    __syncthreads();   // the last tile's K, V and dS are consumed (Q, dO staged)
    stage<T, BKV, D>(ks, kb, j0, skv);
    stage<T, BKV, D>(vs, vb, j0, skv);
    __syncthreads();

    float sa[R][CS], dpa[R][CS];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CS; ++c) sa[r][c] = dpa[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qr[R], dr[R], kc[CS], vc[CS];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        qr[r] = qs[(ty * R + r) * LD + d];
        dr[r] = dos[(ty * R + r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        kc[c] = ks[(tx + 8 * c) * LD + d];
        vc[c] = vs[(tx + 8 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          sa[r][c] += qr[r] * kc[c];
          dpa[r][c] += dr[r] * vc[c];
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty * R + r;
      const int qpos = q0 + i;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int j = tx + 8 * c;
        const int kpos = j0 + j;
        const bool ok = kpos < skv && qpos < sq && (!causal || kpos <= qpos + seq_off);
        const float p = ok ? expf(sa[r][c] * scale - lse_s[i]) : 0.f;
        ds[i * LS + j] = p * (dpa[r][c] - dl_s[i]);
      }
    }
    __syncthreads();

    // dQ += dS K
    for (int j = 0; j < BKV; ++j) {
      float sr[R], kc[CD];
#pragma unroll
      for (int r = 0; r < R; ++r) sr[r] = ds[(ty * R + r) * LS + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) kc[c] = ks[j * LD + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) dqa[r][c] += sr[r] * kc[c];
    }
  }

  T* dqb = dq + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty * R + r;
    if (i >= sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      dqb[static_cast<size_t>(i) * D + tx + 8 * c] = from_f<T>(dqa[r][c] * scale);
  }
}

// The tiles of a head dim: (BQ, BKV) of the dK/dV kernel, then of the dQ
// kernel.  D 128 takes 32 query rows a dK/dV tile, so that its dK, dV, S^T
// and dP^T registers (R x (2 D / 8 + 2 BQ / 8) = 192) stay under 255.
// Must agree with repro_torch.kernels.autotune.FLASH_BWD_TILES and
// flash_bwd_smem_bytes.
template <int D> struct BwdTiles {
  static constexpr int kKvBQ = D == 128 ? 32 : 64;
  static constexpr int kKvBKV = 64;
  static constexpr int kQBQ = 64;
  static constexpr int kQBKV = 64;
};

template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int hq,
                   int hkv, int sq, int skv, int causal, float scale, cudaStream_t st) {
  using Tl = BwdTiles<D>;
  constexpr int kv_smem =
      dkdv_smem_floats<D, Tl::kKvBQ, Tl::kKvBKV>() * static_cast<int>(sizeof(float));
  constexpr int q_smem = dq_smem_floats<D, Tl::kQBQ, Tl::kQBKV>() * static_cast<int>(sizeof(float));
  auto kv_kern = flash_bwd_dkdv_kernel<T, D, Tl::kKvBQ, Tl::kKvBKV>;
  auto q_kern = flash_bwd_dq_kernel<T, D, Tl::kQBQ, Tl::kQBKV>;
  static const cudaError_t attr = [&] {   // once per instantiation
    cudaError_t e = smem_opt_in(kv_kern, kv_smem);
    return e == cudaSuccess ? smem_opt_in(q_kern, q_smem) : e;
  }();
  if (attr != cudaSuccess) return attr;
  const int rows = b * hq * sq;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  flash_bwd_delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      static_cast<const T*>(o), tdo, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((skv + Tl::kKvBKV - 1) / Tl::kKvBKV, b * hkv);
  kv_kern<<<kv_grid, kThreads, kv_smem, st>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
                                              static_cast<T*>(dv), hq, hkv, sq, skv, causal,
                                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((sq + Tl::kQBQ - 1) / Tl::kQBQ, b * hq);
  q_kern<<<q_grid, kThreads, q_smem, st>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), hq,
                                           hkv, sq, skv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int b, int hq, int hkv, int sq, int skv, int causal, float scale,
                       cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq, skv,
                                  causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq, skv,
                                  causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq,
                                    skv, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------ the tensor-core route (bf16, D 64)
// bf16 at D 64 with 16-byte aligned q, k, v, o and dO: two kernels a call
// on TMA and wgmma, each with a producer warp that keeps a ring of the
// tiles its block walks and consumer warpgroups that run every product on
// wgmma.m64n64k16 with f32 sums (hopper.cuh).
//
// * flash_bwd_dq_tc_kernel, one block per (b * Hq + h, 64-row query tile),
//   causal tiles with the most keys first.  The producer loads the Q and dO
//   tiles once and the K and V tiles through a two-stage ring.  Its
//   prologue computes Delta = rowsum(dO o O) of its rows (a quad of lanes a
//   row, 16 columns each) and writes it out for the dK/dV kernel, which
//   runs after it.  Each key tile: S = Q K^T and dP = dO V^T (both operands
//   K-major in shared memory), P = exp2(S scale log2 e - lse log2 e) and
//   dS = P o (dP - Delta) on the accumulator fragments in registers, dS
//   rounded to bf16 -- the fragments' consecutive pairs are exactly wgmma's
//   register A operand -- and dQ += dS K with K MN-major (the transpose
//   bit).  Key tiles above the diagonal are never loaded; only edge tiles
//   are masked.
// * flash_bwd_dkdv_tc_kernel, persistent: one block an SM walks work items
//   of one (b * Hkv + kv head, 64-key tile) each, in key tile-major order
//   (causal tile 0, the longest walks, first) dealt snake-wise over the
//   blocks.  An item's steps are the group's query heads times its query
//   tiles on or below the diagonal.  A producer warp loads each item's K
//   and V (two buffers, so the next item's load overlaps this one's steps)
//   and streams each step's Q and dO (TMA) and lse and Delta (its 32 lanes'
//   cp.async copies) through a four-stage ring.  Two consumer warpgroups
//   take an item's steps in turn (the longest key tile walks half as many
//   steps as one warpgroup would), each computing S^T = K Q^T and dP^T = V
//   dO^T (K-major), P^T and dS^T in registers (P^T and dS^T rounded to
//   bf16, as the forward rounds P), then dV += P^T dO and dK += dS^T Q with
//   dO and Q MN-major.  At an item's end the two warpgroups' dK and dV are
//   summed through shared memory in a fixed order (dK = dK_0 + dK_1, dV =
//   dV_0 + dV_1): the call is deterministic.  A block a work item would pay
//   its launch, its K/V load and that sum once per 64 keys, which at a
//   group of 1 (zamba2: 1-4 steps an item) is most of the item.
// The dK/dV consumers hold four m64n64 f32 fragments (dK, dV, S^T, dP^T)
// at once: the producer's warpgroup hands its registers to them
// (setmaxnreg: 40 a producer thread, 232 a consumer thread).  Every stage
// is released by each consumer warp after its own reads (four arrivals).
// TMA fills a box past Sq or Skv with zeros of the same head, never the
// next head's rows; lse and Delta past a head's Sq are zeros, masked with
// the rows they belong to.
namespace tc {

using namespace hopper;

constexpr int kD = 64;                      // head dim: one 128-byte box a row
constexpr int kRows = 64;                   // rows of every tile (keys or queries)
constexpr int kTileBytes = kRows * kD * 2;  // one swizzled 64 x 64 bf16 tile
constexpr int kRowBytes = kRows * 4;        // 64 lse or Delta values
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV: two consumer warpgroups and a producer warpgroup (one warp of it
// works); four stages, two a consumer.  Shared memory: two K/V buffers,
// then each stage's Q and dO, then each stage's lse and Delta, then the
// warpgroups' hand-over of their sums, then full[p] and empty[p] a K/V
// buffer and full[s] and empty[s] a stage; 1 KB to align the tiles to the
// 1024-byte swizzle period.  Must agree with
// repro_torch.kernels.autotune.flash_bwd_tc_smem_bytes.
constexpr int kKvConsumers = 2;
constexpr int kKvThreads = kKvConsumers * 128 + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 128 x 40 + 256 x 232 <= 65536
constexpr int kKvStages = 4;
constexpr int kXferBytes = kKvConsumers * (kD / 2) * 128 * 4;   // dK of one, dV of the other
constexpr int kKvSmem = 1024 + 2 * 2 * kTileBytes + kKvStages * 2 * kTileBytes +
                        kKvStages * 2 * kRowBytes + kXferBytes + 8 * (4 + 2 * kKvStages);
// dQ: one consumer warpgroup and the producer warp; a two-stage K/V ring.
// Shared memory: Q and dO, then each stage's K and V, then full[s],
// empty[s] and the Q/dO barrier; 1 KB to align.
constexpr int kQThreads = 128 + 32;
constexpr int kQStages = 2;
constexpr int kQSmem = 1024 + 2 * kTileBytes + kQStages * 2 * kTileBytes + 8 * (1 + 2 * kQStages);

// All 256 consumer threads of a dK/dV block (barrier 1; the producer
// warpgroup does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kKvConsumers * 128) : "memory");
}

// 4 bytes from global to shared memory, asynchronously (zeros where `in` is
// false: no byte is read), and an arrival on `bar` once every such copy of
// this thread has landed (counted as one of the barrier's arrivals).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// 2^x in one MUFU.EX2 (ftz: a result below 2^-126, far below a bf16 P's
// resolution, is 0), so that a masked entry is a select, not a branch
// around exp2f's range checks.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// threadIdx.x / n, warp-uniform as the compiler sees it (a lane-0 shuffle):
// a branch on it is not divergent, so ptxas keeps the wgmma pipeline (a
// wgmma under a branch it must treat as divergent is serialised, C7520).
__device__ __forceinline__ int uniform_div(int n) {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / n, 0);
}

// A warpgroup's register budget a thread (all its 128 threads execute it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// rows (row0 + lane / 4 and + 8, those below n) of an m64n64 fragment,
// times `mul`, as bf16 pairs into dst (kD wide)
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&acc)[kD / 2], int row0,
                                      int n, float mul, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + lane / 4 + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r) * kD + 8 * j +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

__global__ void __launch_bounds__(kQThreads, 2)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_do,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v,
                       const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int hq, int hkv, int sq, int skv,
                       int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + kTileBytes;
  const uint32_t ring = dos + kTileBytes;                   // stage s: K, then V
  const uint32_t bars = ring + kQStages * 2 * kTileBytes;   // full[s], empty[s], then Q/dO's
  const uint32_t qbar = bars + 16 * kQStages;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                                // b * hq + query head
  const int kvz = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // causal query tiles in reverse: the ones with the most keys launch first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int seq_off = skv - sq;
  // the key tiles up to the last key the tile's last row sees
  const int kv_end = causal ? min(skv, max(0, min(q0 + kRows, sq) + seq_off)) : skv;
  const int n_tiles = (kv_end + kRows - 1) / kRows;
  if (tid == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(bars + 8 * s, 1);                 // full: the producer's arrival + bytes
      mbar_init(bars + 8 * (kQStages + s), 4);    // empty: one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = uniform_div(32), lane = tid % 32;
  if (warp == 4) {                                // the producer warp
    if (tid == 128 && n_tiles > 0) {
      mbar_expect_tx(qbar, 2 * kTileBytes);
      tma_load(qs, &tma_q, qbar, 0, q0, bh);
      tma_load(dos, &tma_do, qbar, 0, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kQStages;
        if (t >= kQStages) mbar_wait(bars + 8 * (kQStages + s), ((t / kQStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t ks = ring + s * 2 * kTileBytes;
        mbar_expect_tx(full, 2 * kTileBytes);
        tma_load(ks, &tma_k, full, 0, t * kRows, kvz);
        tma_load(ks + kTileBytes, &tma_v, full, 0, t * kRows, kvz);
      }
    }
    return;
  }

  // the consumer warpgroup: the m64n64 fragments hold, for each 8-column
  // group j, rows r and r + 8 (r = warp * 16 + lane / 4) at columns
  // 8 j + 2 (lane % 4) + {0, 1}
  const int row = q0 + warp * 16 + lane / 4;      // and row + 8
  // Delta of rows row and row + 8: the quad's lanes take 16 columns each
  float dl[2], ls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const bool in = r < sq;
    // a row past Sq reads the tile's first row (in bounds) and counts 0
    const size_t at = static_cast<size_t>(bh) * sq + (in ? r : q0);
    const size_t off = at * kD + (lane % 4) * 16;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 ov = reinterpret_cast<const uint4*>(o + off)[c];
      const uint4 dv = reinterpret_cast<const uint4*>(dout + off)[c];
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]), g = __bfloat1622float2(d2[i]);
        acc += a.x * g.x + a.y * g.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[h] = in ? acc : 0.f;
    ls[h] = in ? lse[at] * kLog2e : 0.f;
    if (in && lane % 4 == 0) delta[at] = acc;
  }

  const float scale_log2 = scale * kLog2e;
  float dqa[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dqa[i] = 0.f;
  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kQStages;
    const int j0 = t * kRows;
    mbar_wait(bars + 8 * s, (t / kQStages) & 1);
    const uint32_t ks = ring + s * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    float sc[kRows / 2], dp[kRows / 2];
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)   // a k16 step is 32 bytes along a swizzled row
      WgmmaSS<kRows, 0, 0>::mma(sc, desc(qs + kk * 32, 16, 1024), desc(ks + kk * 32, 16, 1024));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      WgmmaSS<kRows, 0, 0>::mma(dp, desc(dos + kk * 32, 16, 1024), desc(vs + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();                   // S is done, dP still in flight

    // P; masked entries (keys past Skv, rows past Sq, causal keys past the
    // row's diagonal) are exactly 0
    const bool edge = j0 + kRows > skv || q0 + kRows > sq ||
                      (causal && j0 + kRows - 1 > q0 + seq_off);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const int r = row + 8 * (e >> 1);
        const bool ok = !edge | ((key < skv) & (r < sq) & (!causal | (key <= r + seq_off)));
        const float p = ex2(sc[4 * j + e] * scale_log2 - ls[e >> 1]);
        sc[4 * j + e] = ok ? p : 0.f;
      }
    wgmma_wait<0>();
    // dS = P o (dP - Delta), in bf16
    uint32_t da[kRows / 4];
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i)
      da[i] = pack_bf16(sc[2 * i] * (dp[2 * i] - dl[i % 2]),       // rows row + 8 (i % 2)
                        sc[2 * i + 1] * (dp[2 * i + 1] - dl[i % 2]));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      // K MN-major: 16 key rows of 128 bytes a k16 step, 8-row groups 1024
      // bytes apart
      WgmmaRS<kD>::mma(dqa, da + 4 * kk, desc(ks + kk * 2048, kTileBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(bars + 8 * (kQStages + s));  // stage s is free again
  }
  store(dq + static_cast<size_t>(bh) * sq * kD, dqa, q0 + warp * 16, sq, scale, lane);
}

// A dK/dV work item: one (b * Hkv + kv head, 64-key tile) and its walk,
// the group's query heads times the query tiles from the first that sees
// the tile (causal) to the last.
struct Item {
  int bkh, j0, qt0, n_qt, n_steps;
};

__device__ __forceinline__ Item item_at(int i, int nkv, int hq, int hkv, int sq, int skv,
                                        int causal) {
  Item it;
  it.bkh = i % nkv;                       // key tile-major: causal tile 0, the
  it.j0 = (i / nkv) * kRows;              // longest walks, come first
  it.qt0 = causal ? max(0, it.j0 - (skv - sq)) / kRows : 0;
  it.n_qt = (sq + kRows - 1) / kRows - it.qt0;
  it.n_steps = (hq / hkv) * it.n_qt;
  return it;
}

// The item of this block's round r, or -1 past the last: rounds go snake-
// wise over the blocks (an odd round in reverse), so the block that took
// one of the longest walks takes one of the shortest next.
__device__ __forceinline__ int item_index(int r, int n_items) {
  const int i = r * gridDim.x + (r % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return i < n_items ? i : -1;
}

__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tma_q,
                         const __grid_constant__ CUtensorMap tma_k,
                         const __grid_constant__ CUtensorMap tma_v,
                         const __grid_constant__ CUtensorMap tma_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int hq,
                         int hkv, int sq, int skv, int causal, float scale, int nkv,
                         int n_items) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t kv = (raw + 1023) & ~1023u;                    // buffer p: K, then V
  const uint32_t ring = kv + 2 * 2 * kTileBytes;                // stage s: Q, then dO
  const uint32_t rows = ring + kKvStages * 2 * kTileBytes;      // stage s: lse, then Delta
  const uint32_t xfer = rows + kKvStages * 2 * kRowBytes;       // the warpgroups' sums
  const uint32_t bars = xfer + kXferBytes;   // kv full[p], kv empty[p], full[s], empty[s]
  const uint32_t kv_full = bars, kv_empty = bars + 16;
  const uint32_t full = bars + 32, empty = full + 8 * kKvStages;
  const int tid = threadIdx.x;
  const int group = hq / hkv, seq_off = skv - sq;
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbar_init(kv_full + 8 * p, 1);                    // the TMA bytes
      mbar_init(kv_empty + 8 * p, 4 * kKvConsumers);    // one arrival a consumer warp
    }
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);                  // the TMA bytes, 32 lanes' copies
      mbar_init(empty + 8 * s, 4);                      // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Consumer warpgroup w takes the odd or even steps of every item, and only
  // stages w and w + 2: its m-th step (counted over the items) lands in
  // stage w + 2 (m % 2), phase m / 2, so a stage's phases are consumed in
  // order by one warpgroup.
  const int wg = uniform_div(128), warp = uniform_div(32) % 4, lane = tid % 32;
  if (wg == kKvConsumers) {                                     // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0) {                                            // its first warp
      int m0 = 0, m1 = 0;                                       // each consumer's steps
      for (int r = 0;; ++r) {
        const int i = item_index(r, n_items);
        if (i < 0) break;
        const Item it = item_at(i, nkv, hq, hkv, sq, skv, causal);
        const int p = r % 2;
        if (r >= 2) mbar_wait(kv_empty + 8 * p, ((r / 2) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(kv_full + 8 * p, 2 * kTileBytes);
          tma_load(kv + p * 2 * kTileBytes, &tma_k, kv_full + 8 * p, 0, it.j0, it.bkh);
          tma_load(kv + p * 2 * kTileBytes + kTileBytes, &tma_v, kv_full + 8 * p, 0, it.j0,
                   it.bkh);
        }
        for (int t = 0; t < it.n_steps; ++t) {
          const int w = t % kKvConsumers, mw = w ? m1 : m0;
          const int s = w + kKvConsumers * (mw % 2);
          m0 += w == 0;
          m1 += w == 1;
          if (mw >= 2) mbar_wait(empty + 8 * s, ((mw / 2) & 1) ^ 1);
          const int i0 = (it.qt0 + t % it.n_qt) * kRows;
          const int bh = (it.bkh / hkv) * hq + (it.bkh % hkv) * group + t / it.n_qt;
          if (lane == 0) {
            const uint32_t qs = ring + s * 2 * kTileBytes;
            mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
            tma_load(qs, &tma_q, full + 8 * s, 0, i0, bh);
            tma_load(qs + kTileBytes, &tma_do, full + 8 * s, 0, i0, bh);
          }
          // the step's lse and Delta, zeros past Sq, copied asynchronously:
          // each lane's copies land, then count as its arrival on `full`
          const uint32_t dst = rows + s * 2 * kRowBytes;
          for (int j = lane; j < kRows; j += 32) {
            const bool in = i0 + j < sq;
            const size_t at = in ? static_cast<size_t>(bh) * sq + i0 + j : 0;
            cp_async_4(dst + 4 * j, lse + at, in);
            cp_async_4(dst + kRowBytes + 4 * j, delta + at, in);
          }
          cp_async_arrive(full + 8 * s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const float* row_vals = reinterpret_cast<const float*>(smem_raw + (rows - raw));
  float* sums = reinterpret_cast<float*>(smem_raw + (xfer - raw));
  const float scale_log2 = scale * kLog2e;
  const int i_t = tid % 128;
  int m = 0;                                                    // this warpgroup's steps so far
  for (int r = 0;; ++r) {
    const int i = item_index(r, n_items);
    if (i < 0) break;
    const Item it = item_at(i, nkv, hq, hkv, sq, skv, causal);
    const int p = r % 2;
    const uint32_t ks = kv + p * 2 * kTileBytes, vs = ks + kTileBytes;
    // the m64n64 fragments of S^T and dP^T hold keys (rows) key and key + 8
    // at query columns 8 j + 2 (lane % 4) + {0, 1}
    const int key = it.j0 + warp * 16 + lane / 4;               // and key + 8
    float dka[kD / 2], dva[kD / 2];
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) dka[j] = dva[j] = 0.f;
    mbar_wait(kv_full + 8 * p, (r / 2) & 1);
    for (int t = wg; t < it.n_steps; t += kKvConsumers, ++m) {
      const int s = wg + kKvConsumers * (m % 2);
      const int i0 = (it.qt0 + t % it.n_qt) * kRows;
      mbar_wait(full + 8 * s, (m / 2) & 1);
      const uint32_t qs = ring + s * 2 * kTileBytes;
      const uint32_t dos = qs + kTileBytes;
      const float* lse_s = row_vals + s * 2 * kRows;
      const float* dl_s = lse_s + kRows;
      float st[kRows / 2], dpt[kRows / 2];
#pragma unroll
      for (int j = 0; j < kRows / 2; ++j) st[j] = dpt[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        WgmmaSS<kRows, 0, 0>::mma(st, desc(ks + kk * 32, 16, 1024),
                                  desc(qs + kk * 32, 16, 1024));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        WgmmaSS<kRows, 0, 0>::mma(dpt, desc(vs + kk * 32, 16, 1024),
                                  desc(dos + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();                 // S^T is done, dP^T still in flight

      // P^T; masked entries are exactly 0.  dV += P^T dO starts while dS^T
      // is computed
      const bool edge = it.j0 + kRows > skv || i0 + kRows > sq ||
                        (causal && it.j0 + kRows - 1 > i0 + seq_off);
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * (lane % 4) + (e & 1);
          const int kpos = key + 8 * (e >> 1);
          const bool ok = !edge | ((kpos < skv) & (i0 + qi < sq) &
                                   (!causal | (kpos <= i0 + qi + seq_off)));
          const float pr = ex2(st[4 * j + e] * scale_log2 - lse_s[qi] * kLog2e);
          st[4 * j + e] = ok ? pr : 0.f;
        }
      uint32_t pa[kRows / 4], sa[kRows / 4];
#pragma unroll
      for (int j = 0; j < kRows / 4; ++j) pa[j] = pack_bf16(st[2 * j], st[2 * j + 1]);
      wgmma_wait<0>();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)   // dO and Q MN-major, as K in the dQ kernel
        WgmmaRS<kD>::mma(dva, pa + 4 * kk, desc(dos + kk * 2048, kTileBytes, 1024));
      wgmma_commit();
      // dS^T = P^T o (dP^T - Delta), in bf16
#pragma unroll
      for (int j = 0; j < kRows / 4; ++j) {
        const int qi = 8 * (j / 2) + 2 * (lane % 4);
        sa[j] = pack_bf16(st[2 * j] * (dpt[2 * j] - dl_s[qi]),
                          st[2 * j + 1] * (dpt[2 * j + 1] - dl_s[qi + 1]));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        WgmmaRS<kD>::mma(dka, sa + 4 * kk, desc(qs + kk * 2048, kTileBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * s);                // stage s is free again
    }
    if (lane == 0) mbar_arrive(kv_empty + 8 * p);               // so are K and V

    // the two warpgroups' sums in a fixed order: warpgroup 1 hands over its
    // dK, warpgroup 0 its dV
    consumers_sync();                 // the last item's sums are read
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) {
      if (wg == 1) sums[j * 128 + i_t] = dka[j];
      else sums[(kD / 2 + j) * 128 + i_t] = dva[j];
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < kD / 2; ++j) dka[j] += sums[j * 128 + i_t];
      store(dk + static_cast<size_t>(it.bkh) * skv * kD, dka, it.j0 + warp * 16, skv, scale,
            lane);
    } else {
#pragma unroll
      for (int j = 0; j < kD / 2; ++j) dva[j] = sums[(kD / 2 + j) * 128 + i_t] + dva[j];
      store(dv + static_cast<size_t>(it.bkh) * skv * kD, dva, it.j0 + warp * 16, skv, 1.f,
            lane);
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int hq,
                   int hkv, int sq, int skv, int causal, float scale, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = [] {   // once per process
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmem);
    return e == cudaSuccess ? cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   kKvSmem)
                            : e;
  }();
  if (attr != cudaSuccess) return attr;
  const uint64_t nq = static_cast<uint64_t>(b) * hq, nkv = static_cast<uint64_t>(b) * hkv;
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err = make_map(&mq, q, kD, sq, nq, kD, kRows);
  if (err == cudaSuccess) err = make_map(&mdo, dout, kD, sq, nq, kD, kRows);
  if (err == cudaSuccess) err = make_map(&mk, k, kD, skv, nkv, kD, kRows);
  if (err == cudaSuccess) err = make_map(&mv, v, kD, skv, nkv, kD, kRows);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  flash_bwd_dq_tc_kernel<<<dim3(nq, (sq + kRows - 1) / kRows), kQThreads, kQSmem, st>>>(
      mq, mdo, mk, mv, static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), hq, hkv, sq, skv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // persistent: a block an SM (one fits by registers), each walking items
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_items = static_cast<int>(nkv) * ((skv + kRows - 1) / kRows);
  flash_bwd_dkdv_tc_kernel<<<n_items < sms ? n_items : sms, kKvThreads, kKvSmem, st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, sq, skv,
      causal, scale, static_cast<int>(nkv), n_items);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}.  `delta` is
// (B, Hq, Sq) f32 scratch the call fills.  Launches three kernels in order on
// `stream`; returns cudaGetLastError() after them (0 on success),
// cudaErrorInvalidValue for an unsupported shape or dtype.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int b,
                                          int hq, int hkv, int sq, int skv, int d, int causal,
                                          float scale, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 || b * hkv > 65535 ||
      b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_d<float>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                                              hkv, sq, skv, causal, scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_d<__nv_bfloat16>(d, q, k, v, o, dout, lse, delta, dq, dk,
                                                      dv, b, hq, hkv, sq, skv, causal, scale,
                                                      st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 on the tensor cores: d 64, q, k, v, o and dout 16-byte aligned.  The
// same work and arguments as flash_attention_bwd_launch (without a dtype),
// in two kernels (dQ with Delta, then dK and dV); cudaErrorInvalidValue for
// a shape or pointer the route does not take.
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const float* lse,
                                             float* delta, void* dq, void* dk, void* dv, int b,
                                             int hq, int hkv, int sq, int skv, int d, int causal,
                                             float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 || d != tc::kD ||
      (sq + tc::kRows - 1) / tc::kRows > 65535 || (skv + tc::kRows - 1) / tc::kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::launch(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq,
                                     skv, causal, scale, static_cast<cudaStream_t>(stream)));
}
