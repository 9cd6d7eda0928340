// Split-KV flash-decode attention for Hopper (sm_90a): one new query token
// per (batch, query head) against a KV cache with a per-row valid length.
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// src/repro/kernels/decode_attention.py.  There the KV walk is an
// "arbitrary" grid axis with (max, sum, acc) carried in VMEM scratch, and
// the distributed layer splits the cache across chips and merges the
// per-chip (max, sum, acc); here the same split runs across the CTAs of one
// thread-block cluster and the merge through distributed shared memory.
//
// Bound: bytes.  Per (b, kv head) the kernel must read the valid K and V
// prefix once (2 * length * D elements) and does 4 * group * length * D
// FLOPs on them: about group FLOPs per byte, far below the ~295 FLOP/byte
// at which an H100 stops being memory-bound, so the tensor cores would not
// help.  What the design does about the bound:
//
// * Enough CTAs.  B * Hkv (40 at smollm's batch 8) leaves most of the 132
//   SMs idle, so each (b, kv head, head chunk) gets `splits` CTAs, one
//   cluster (autotune.pom_decode_schedule: 1 to 8), each taking a
//   contiguous slice of the valid prefix [0, length[b]): CTA r of n takes
//   [r c, min((r + 1) c, length)) with c = ceil(length / n).  A CTA whose
//   slice is empty reads nothing and contributes m = -inf, l = 0.  The grid
//   depends on shapes only, so the host never reads `length`.
// * Each KV row read once, 16 bytes a lane, straight into registers.  A
//   CTA serves HG query heads of one kv head (the whole GQA group for the
//   models' groups 1-8), whose q rows sit in registers, pre-scaled by
//   scale * log2(e).  A row of D elements is spread over D / E lanes (E = 8
//   bf16 or 4 f32: 16 bytes), so a warp step covers 32 / (D / E) rows; a
//   pass is U steps of every warp, and a warp issues the next pass's K and V
//   loads before it computes the current one (two passes in flight).
//   A row's dot product is reduced over its lanes with __shfl_xor_sync; the
//   lanes of a row group run the online softmax (exp2) and the accumulator
//   in f32 registers.
// * Merges in a fixed order.  The row groups of a warp merge by shuffles,
//   the warps of a CTA through shared memory in warp order, and the CTAs of
//   the cluster through distributed shared memory in split order: each CTA
//   finalises a slice of the HG x D outputs, reading every CTA's (m, l,
//   acc) in rank order.  No atomics, no workspace, one launch a call, and
//   the output is the same bits from run to run.
//
// Layouts (all contiguous, 16-byte aligned): q (B, Hq, D), k/v (B, Hkv, S,
// D), length (B,) int32, out (B, Hq, D) in q's dtype, and where asked lse
// (B, Hq) f32: each row's log-sum-exp of its scaled scores over the valid
// keys, in natural-log units (the partial (o, lse) that a sequence-parallel
// decode merges across ranks).  Query head h uses kv head h / (Hq / Hkv).
// Positions at or past length[b] contribute nothing; a row with length 0
// has no valid key and returns o = 0, lse = -inf.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kMaxHeads = 8;
constexpr float kLn2 = 0.69314718055994530942f;

// 16 bytes of a row as E floats
template <typename T> struct Row;
template <> struct Row<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void to_f(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Row<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void to_f(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // a bf16 is the top half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x for x <= 0 (the hardware's approximation, 2 ulp; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp2(m - mx), 0 for an empty partial (m = -inf), never NaN
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : ex2(m - mx);
}

// Up to 4 heads a CTA, at most 128 registers a thread, so that two CTAs
// share an SM: above 128 an SM holds one, and smollm's grid of 160 CTAs at
// S 8192 then ran in two waves on an H100.  4 heads take 2 warp steps a
// pass, not 4, to stay in 128 registers without spilling.
template <typename T, int D, int HG>
__global__ void __launch_bounds__(kThreads, HG <= 4 ? 2 : 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ length, T* __restrict__ out, float* __restrict__ lse,
              int hq, int hkv, int s, int splits, float qscale) {
  constexpr int E = Row<T>::E;            // elements a lane holds of a row
  constexpr int LPR = D / E;              // lanes a row
  constexpr int RPW = 32 / LPR;           // rows a warp step
  constexpr int U = HG <= 3 ? 4 : 2;      // warp steps a pass (autotune.DECODE_UNROLL)
  constexpr int kPass = U * kWarps * RPW; // rows a pass of the CTA
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "head dim");
  __shared__ __align__(16) float part[kWarps][HG][D];   // warp partials; then the CTA's
  __shared__ float pm[kWarps][HG], pl[kWarps][HG];
  __shared__ float cm[HG], cl[HG];                      // the CTA's max and sum

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / splits;                   // b * hkv + kv head
  const int b = bh / hkv, kvh = bh % hkv;
  const int h0 = kvh * (hq / hkv) + blockIdx.y * HG;    // this CTA's first query head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPR, rg = lane / LPR;

  const int len = min(max(length[b], 0), s);
  const int chunk = (len + splits - 1) / splits;
  const int lo = min(rank * chunk, len), hi = min(lo + chunk, len);

  float qf[HG][E];
  const T* qb = q + ((size_t)b * hq + h0) * D + sub * E;
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    Row<T>::to_f(__ldg(reinterpret_cast<const uint4*>(qb + g * D)), qf[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) qf[g][e] *= qscale;
  }
  float m[HG], l[HG], acc[HG][E];
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + (size_t)bh * s * D + sub * E;
  const T* vb = v + (size_t)bh * s * D + sub * E;
  // this lane's rows of the pass at `base`: U warp steps, loaded into
  // registers (zeros past the slice)
  auto load = [&](int base, uint4 (&kr)[U], uint4 (&vr)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + (u * kWarps + warp) * RPW + rg;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (row < hi) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)row * D));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)row * D));
      }
    }
  };
  uint4 kr[U], vr[U];
  if (lo < hi) load(lo, kr, vr);
  for (int base = lo; base < hi; base += kPass) {     // uniform across the CTA
    // the next pass's loads go out before this pass computes: two passes a
    // warp in flight
    uint4 kn[U], vn[U];
    if (base + kPass < hi) load(base + kPass, kn, vn);
    float sc[U][HG];                     // log2-scaled scores, -inf past the slice
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = base + (u * kWarps + warp) * RPW + rg < hi;
      float kf[E];
      Row<T>::to_f(kr[u], kf);
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[u][g] = ok ? dot : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -INFINITY) continue;    // nothing valid yet in this row group
      const float c = ex2(m[g] - mx);    // 0 while m is -inf
      l[g] *= c;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= c;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      Row<T>::to_f(vr[u], vf);
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        if (m[g] == -INFINITY) continue;
        const float p = ex2(sc[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // the warp's row groups, by shuffles (lane sub of row group 0 ends with the
  // warp's partial of its E dims)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], m2);
      const float w1 = weight(m[g], mx), w2 = weight(m2, mx);
      l[g] = l[g] * w1 + l2 * w2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * w1 + a2 * w2;
      }
      m[g] = mx;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < HG; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) part[warp][g][sub * E + e] = acc[g][e];
      if (lane == 0) {
        pm[warp][g] = m[g];
        pl[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // the CTA's warps, in warp order: its partial goes to part[0], cm and cl
  for (int i = tid; i < HG * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, pm[w][g]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = weight(pm[w][g], mx);
      a += part[w][g][d] * wt;
      sum += pl[w][g] * wt;
    }
    part[0][g][d] = a;                  // only this thread reads or writes (g, d)
    if (d == 0) {
      cm[g] = mx;
      cl[g] = sum;
    }
  }
  cluster.sync();                       // every CTA's partial is ready

  // the cluster's CTAs, in split order: CTA `rank` finalises its slice of
  // the HG x D outputs
  const int per = (HG * D + splits - 1) / splits;
  const int end = min(HG * D, (rank + 1) * per);
  for (int i = rank * per + tid; i < end; i += kThreads) {
    const int g = i / D, d = i % D;
    float rm[kMaxSplits];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      rm[r] = r < splits ? *cluster.map_shared_rank(&cm[g], r) : -INFINITY;
      mx = fmaxf(mx, rm[r]);
    }
    float o = 0.f, lg = -INFINITY;
    if (mx != -INFINITY) {              // length 0: no valid key, the output is 0
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < splits) {
          const float wt = weight(rm[r], mx);
          a += *cluster.map_shared_rank(&part[0][g][d], r) * wt;
          sum += *cluster.map_shared_rank(&cl[g], r) * wt;
        }
      }
      o = a / sum;
      // the running max is in base 2 (scores pre-scaled by log2(e)): back to
      // natural-log units once, here
      lg = (mx + log2f(sum)) * kLn2;
    }
    out[((size_t)b * hq + h0 + g) * D + d] = from_f<T>(o);
    if (lse != nullptr && d == 0) lse[(size_t)b * hq + h0 + g] = lg;
  }
  cluster.sync();                       // no CTA leaves while its partial is read
}

template <typename T, int D>
const void* pick_heads(int heads) {
  switch (heads) {
    case 1: return reinterpret_cast<const void*>(&decode_kernel<T, D, 1>);
    case 2: return reinterpret_cast<const void*>(&decode_kernel<T, D, 2>);
    case 3: return reinterpret_cast<const void*>(&decode_kernel<T, D, 3>);
    case 4: return reinterpret_cast<const void*>(&decode_kernel<T, D, 4>);
    case 5: return reinterpret_cast<const void*>(&decode_kernel<T, D, 5>);
    case 6: return reinterpret_cast<const void*>(&decode_kernel<T, D, 6>);
    case 7: return reinterpret_cast<const void*>(&decode_kernel<T, D, 7>);
    case 8: return reinterpret_cast<const void*>(&decode_kernel<T, D, 8>);
    default: return nullptr;
  }
}

template <typename T>
const void* pick_dim(int d, int heads) {
  switch (d) {
    case 32: return pick_heads<T, 32>(heads);
    case 64: return pick_heads<T, 64>(heads);
    case 128: return pick_heads<T, 128>(heads);
    default: return nullptr;
  }
}

// The kernel for (dtype, d, heads), or nullptr where none is compiled.
const void* pick(int dtype, int d, int heads) {
  if (dtype == 0) return pick_dim<float>(d, heads);
  if (dtype == 1) return pick_dim<__nv_bfloat16>(d, heads);
  return nullptr;
}

// A launch of `fn` as clusters of `splits` CTAs along x.
struct Launch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  Launch(dim3 grid, int splits, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `heads` query heads a CTA (a divisor of
// hq / hkv, at most 8), `splits` CTAs a cluster (1 to 8), qscale = scale *
// log2(e).  `lse` (B, Hq) f32, or null where the caller does not ask for it.
// Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for a shape, split or pointer the kernel does not
// take.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* length, void* out, void* lse, int b,
                                       int hq, int hkv, int s, int d, int heads, int splits,
                                       float qscale, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || heads < 1 || heads > kMaxHeads ||
      (hq / hkv) % heads != 0 || splits < 1 || splits > kMaxSplits ||
      (long long)b * hkv * splits > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* fn = pick(dtype, d, heads);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Launch l(dim3(b * hkv * splits, hq / hkv / heads), splits, static_cast<cudaStream_t>(stream));
  void* args[] = {&q, &k, &v, &length, &out, &lse, &hq, &hkv, &s, &splits, &qscale};
  const cudaError_t err = cudaLaunchKernelExC(&l.cfg, fn, args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of `splits` CTAs of the (dtype, d, heads) kernel the
// card can hold at once (cudaOccupancyMaxActiveClusters), into *clusters.
// Returns the CUDA error (0 on success).
extern "C" int decode_attention_max_clusters(int d, int heads, int splits, int dtype,
                                             int* clusters) {
  const void* fn = pick(dtype, d, heads);
  if (fn == nullptr || splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  Launch l(dim3(splits), splits, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &l.cfg);
}
