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
// tensor-core rate, so the bound is bytes.
//
// Design (deterministic, no atomics), three kernels a call on either of two
// routes (the tensor cores for bf16 at D 64 / 128 with 16-byte aligned
// operands, `flash_attention_bwd_tc_launch`; the CUDA cores for the rest,
// `flash_attention_bwd_launch`), chosen as the forward's are:
// * flash_bwd_delta_kernel: Delta (B, Hq, Sq) in f32, one warp a row;
// * flash_bwd_dkdv_kernel: one block per (b * Hkv + kv head, key tile of
//   BKV).  K and V stay in shared memory; the block walks the group's query
//   heads and, causal, only the query tiles on or below the diagonal,
//   recomputing S^T and dP^T for each, and keeps dK and dV in f32 registers;
//   the group's sum happens in the block, so no two blocks write one key;
// * flash_bwd_dq_kernel: one block per (b * Hq + h, query tile of BQ),
//   walking the key tiles up to its last row's last visible key (as the
//   forward does), recomputing P and dP and keeping dQ in f32 registers.
// On the CUDA cores every product runs in f32 from operands staged in
// shared memory (bf16 converted on load); on the tensor cores on
// mma.sync with f32 sums, P and dS rounded to bf16 as the forward rounds P
// (namespace tc below).  The recompute of S and dP in both the dK/dV and
// the dQ kernel (seven products where a kernel with atomics on dQ needs
// five) is the price of determinism.
//
// Layouts (all contiguous): q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv
// (B, Hkv, Skv, D); lse, delta (B, Hq, Sq) f32.  Query head h uses kv head
// h / (Hq / Hkv).  Causal: query i sees key j iff j <= i + (Skv - Sq).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

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

// ------------------------------------------------ the tensor-core route (bf16)
// bf16 with D 64 or 128 and 16-byte aligned q, k, v, dO: the same three
// kernels' work with every product on mma.sync.m16n8k16 (bf16 in, f32
// sums).  A block is four warps, each owning 16 rows of the block's 64-row
// tile (keys in dK/dV, queries in dQ).  Tiles are staged in shared memory
// 16 bytes a thread, rows padded by 16 bytes so that ldmatrix reads 8 rows
// without bank conflicts.  S^T = K Q^T and dP^T = V dO^T (dK/dV), or S = Q
// K^T and dP = dO V^T (dQ), come out as the m16n8 accumulator fragments;
// P and dS are rounded to bf16 in registers, where those fragments are
// exactly the next product's A operand, and dV += P^T dO, dK += dS^T Q
// (dQ += dS K) read dO, Q (K) through ldmatrix's transpose.
namespace tc {

constexpr int kRows = 64;        // rows of a block's tile, and of each step's tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: four bf16 tiles of kRows x (D + 8), then lse (log2 units)
// and Delta, kRows floats each.  Must agree with
// repro_torch.kernels.autotune.flash_bwd_tc_smem_bytes.
template <int D>
struct Tiles {
  static_assert(D == 64 || D == 128, "head dim");
  static constexpr int kPitch = D + 8;
  static constexpr int kTile = kRows * kPitch;
  static constexpr int kSmem = 4 * kTile * 2 + 2 * kRows * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// kRows rows x D of src (rows from r0, zeros at or past n) into dst (pitch
// D + 8), 16 bytes a thread a step
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                      int r0, int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + 8 * c) = x;
  }
}

// acc (16 x 64: eight m16n8 fragments) = rows row0 ... row0 + 15 of a times
// the transpose of all kRows rows of b, both D wide: A B^T over D.  Both
// operands are K-major in shared memory, so ldmatrix reads them as they are.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const __nv_bfloat16* a, int row0,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, smem_u32(a + (row0 + lane % 16) * P + 16 * kk + 8 * (lane / 16)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, smem_u32(b + (16 * np + lane % 8 + 8 * (lane / 16)) * P + 16 * kk +
                           8 * ((lane / 8) % 2)));
      mma(acc[2 * np], fa, fb[0], fb[1]);
      mma(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x D: D / 8 m16n8 fragments) += p (16 x 64 in registers, the
// fragments of mma_abt, rounded to bf16) times all kRows rows of b (D wide):
// b is read through ldmatrix's transpose.
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[8][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    // the m16n8 fragments 2 kk and 2 kk + 1 are the A fragment of k step kk
    const uint32_t fa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, smem_u32(b + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * P +
                                 16 * nd + 8 * (lane / 16)));
      mma(acc[2 * nd], fa, fb[0], fb[1]);
      mma(acc[2 * nd + 1], fa, fb[2], fb[3]);
    }
  }
}

// rows of a block's tile (row0 + lane / 4 and + 8) and D columns of acc,
// times `mul`, as bf16 pairs into dst (rows past n dropped)
template <int D>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&acc)[D / 8][4], int row0,
                                      int n, float mul, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + lane / 4 + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r) * D + 8 * j +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int hq,
                         int hkv, int sq, int skv, int causal, float scale) {
  using Tl = Tiles<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + Tl::kTile;
  __nv_bfloat16* qs = vs + Tl::kTile;
  __nv_bfloat16* dos = qs + Tl::kTile;
  float* lse_s = reinterpret_cast<float*>(dos + Tl::kTile);
  float* dl_s = lse_s + kRows;

  const int bkh = blockIdx.y;   // b * hkv + kv head
  const int b = bkh / hkv;
  const int kvh = bkh - b * hkv;
  const int group = hq / hkv;
  const int j0 = blockIdx.x * kRows;
  const int seq_off = skv - sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key_lo = j0 + 16 * warp + lane / 4;   // and key_lo + 8
  const float scale_log2 = scale * kLog2e;

  stage<D>(ks, k + static_cast<size_t>(bkh) * skv * D, j0, skv);
  stage<D>(vs, v + static_cast<size_t>(bkh) * skv * D, j0, skv);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int i_first = causal ? max(0, j0 - seq_off) : 0;
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = static_cast<size_t>(b) * hq + kvh * group + hh;
    for (int i0 = (i_first / kRows) * kRows; i0 < sq; i0 += kRows) {
      __syncthreads();   // the last tile's Q and dO are consumed
      stage<D>(qs, q + bh * sq * D, i0, sq);
      stage<D>(dos, dout + bh * sq * D, i0, sq);
      for (int i = threadIdx.x; i < kRows; i += kThreads) {
        const bool in = i0 + i < sq;
        lse_s[i] = in ? lse[bh * sq + i0 + i] * kLog2e : 0.f;
        dl_s[i] = in ? delta[bh * sq + i0 + i] : 0.f;
      }
      __syncthreads();

      float st[8][4], dpt[8][4];
      mma_abt<D>(st, ks, 16 * warp, qs, lane);    // S^T = K Q^T
      mma_abt<D>(dpt, vs, 16 * warp, dos, lane);  // dP^T = V dO^T
      // P^T and dS^T; masked entries are exactly 0
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + 8 * (e >> 1);
          const int qi = 8 * n + 2 * (lane % 4) + (e & 1);
          const int qpos = i0 + qi;
          const bool ok = key < skv && qpos < sq && (!causal || key <= qpos + seq_off);
          const float p = ok ? exp2f(st[n][e] * scale_log2 - lse_s[qi]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl_s[qi]);
        }
      mma_pb<D>(dva, st, dos, lane);    // dV += P^T dO
      mma_pb<D>(dka, dpt, qs, lane);    // dK += dS^T Q
    }
  }
  store<D>(dk + static_cast<size_t>(bkh) * skv * D, dka, j0 + 16 * warp, skv, scale, lane);
  store<D>(dv + static_cast<size_t>(bkh) * skv * D, dva, j0 + 16 * warp, skv, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int hq, int hkv, int sq, int skv,
                       int causal, float scale) {
  using Tl = Tiles<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + Tl::kTile;
  __nv_bfloat16* ks = dos + Tl::kTile;
  __nv_bfloat16* vs = ks + Tl::kTile;
  float* lse_s = reinterpret_cast<float*>(vs + Tl::kTile);
  float* dl_s = lse_s + kRows;

  const int bh = blockIdx.y;    // b * hq + query head
  const int b = bh / hq;
  const int bkh = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = blockIdx.x * kRows;
  const int seq_off = skv - sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale_log2 = scale * kLog2e;

  stage<D>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq);
  stage<D>(dos, dout + static_cast<size_t>(bh) * sq * D, q0, sq);
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse[static_cast<size_t>(bh) * sq + q0 + i] * kLog2e : 0.f;
    dl_s[i] = in ? delta[static_cast<size_t>(bh) * sq + q0 + i] : 0.f;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  const int kv_end = causal ? min(skv, max(0, min(q0 + kRows, sq) + seq_off)) : skv;
  for (int j0 = 0; j0 < kv_end; j0 += kRows) {
    __syncthreads();   // the last tile's K and V are consumed (Q, dO staged)
    stage<D>(ks, k + static_cast<size_t>(bkh) * skv * D, j0, skv);
    stage<D>(vs, v + static_cast<size_t>(bkh) * skv * D, j0, skv);
    __syncthreads();

    float sa[8][4], dpa[8][4];
    mma_abt<D>(sa, qs, 16 * warp, ks, lane);    // S = Q K^T
    mma_abt<D>(dpa, dos, 16 * warp, vs, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 16 * warp + lane / 4 + 8 * (e >> 1);
        const int qpos = q0 + qi;
        const int key = j0 + 8 * n + 2 * (lane % 4) + (e & 1);
        const bool ok = key < skv && qpos < sq && (!causal || key <= qpos + seq_off);
        const float p = ok ? exp2f(sa[n][e] * scale_log2 - lse_s[qi]) : 0.f;
        sa[n][e] = p * (dpa[n][e] - dl_s[qi]);   // dS
      }
    mma_pb<D>(dqa, sa, ks, lane);     // dQ += dS K
  }
  store<D>(dq + static_cast<size_t>(bh) * sq * D, dqa, q0 + 16 * warp, sq, scale, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int hq,
                   int hkv, int sq, int skv, int causal, float scale, cudaStream_t st) {
  using Tl = Tiles<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kv_kern = flash_bwd_dkdv_tc_kernel<D>;
  auto q_kern = flash_bwd_dq_tc_kernel<D>;
  static const cudaError_t attr = [&] {   // once per instantiation
    cudaError_t e = smem_opt_in(kv_kern, Tl::kSmem);
    return e == cudaSuccess ? smem_opt_in(q_kern, Tl::kSmem) : e;
  }();
  if (attr != cudaSuccess) return attr;
  using T = __nv_bfloat16;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int rows = b * hq * sq;
  flash_bwd_delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      static_cast<const T*>(o), tdo, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3((skv + kRows - 1) / kRows, b * hkv), kThreads, Tl::kSmem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, sq, skv,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((sq + kRows - 1) / kRows, b * hq), kThreads, Tl::kSmem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), hq, hkv, sq, skv, causal, scale);
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

// bf16 on the tensor cores: d 64 or 128, q, k, v and dout 16-byte aligned.
// The same work and arguments as flash_attention_bwd_launch (without a
// dtype); cudaErrorInvalidValue for a shape or pointer the route does not
// take.
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const float* lse,
                                             float* delta, void* dq, void* dk, void* dv, int b,
                                             int hq, int hkv, int sq, int skv, int d, int causal,
                                             float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0 || b * hkv > 65535 ||
      b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return static_cast<int>(tc::launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv,
                                           sq, skv, causal, scale, st));
  if (d == 128)
    return static_cast<int>(tc::launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv,
                                            sq, skv, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
