// The decay's gradient of the selective scan (csrc/ssm_scan.cu) for Hopper
// (sm_90a).  With the gradients dc and db of the readout and the input
// projection (each a run of the forward scan kernels, see
// repro_torch/kernels/ssm_scan.py scan_backward), per (batch, head):
//     g_u = c_u . dc_u - b_u . db_u                      (dots over N)
//     d log a_t = sum_{u >= t} g_u + bias                 (bias: the dh_final term)
//     da_t = d log a_t / a_t,  0 where a_t < 1e-20       (the forward's floor)
//
// No TPU counterpart: the reference differentiates its pure-jnp scan with
// XLA (src/repro/configs/base.py:54 use_pallas False).  The Pallas scan
// `_ssm_kernel` (src/repro/kernels/ssm_scan.py:28) has no backward.
//
// Bound: the bytes of c, dc, b and db, each read once (xlstm at 8 x 256:
// 67 MB, 20 us at 3.35 TB/s); the cumulative sum is S numbers a (batch,
// head).  Two kernels a call:
//   1. ssm_scan_da_dots_kernel, a warp a time step, 8 steps a block: the
//      dots over N (16-byte loads where every row allows them), g_u written
//      into da;
//   2. ssm_scan_da_sum_kernel, a block a (batch, head): each thread sums a
//      segment of g in f64, a block-wide suffix scan of the segment sums,
//      then each thread walks its segment back, writing da.  The cumulative
//      sum runs in f64: over S terms that nearly cancel (the two dots of a
//      step are large and close), f32 would lose their difference.
//
// Layouts: c, dc, b, db (B, S, H, N) f32 with the last dim contiguous and
// any batch, time and head strides (a head stride of 0 broadcasts one
// group); a (B, S, H) f32, any strides; bias (B, H) f32 contiguous or null;
// da (B, S, H) f32 contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // time steps a block of the dots kernel
constexpr float kFloor = 1e-20f;        // log max(a, kFloor) in csrc/ssm_scan.cu

// Element strides (batch, time, head) of c, dc, b, db and a.  Mirrors the
// int64[15] array the wrapper passes.
struct Strides {
  long long c[3], dc[3], b[3], db[3], a[3];
};

__device__ __forceinline__ const float* row(const float* base, const long long (&s)[3], int bi,
                                            int u, int hi) {
  return base + bi * s[0] + (long long)u * s[1] + hi * s[2];
}

// u . v over n entries by one warp (every lane gets the sum)
template <bool kVec>
__device__ __forceinline__ float warp_dot(const float* __restrict__ u,
                                          const float* __restrict__ v, int n, int lane) {
  float s = 0.f;
  if (kVec) {
#pragma unroll 4
    for (int i = lane * 4; i < n; i += 128) {
      const float4 p = *reinterpret_cast<const float4*>(u + i);
      const float4 q = *reinterpret_cast<const float4*>(v + i);
      s += p.x * q.x + p.y * q.y + p.z * q.z + p.w * q.w;
    }
  } else {
    for (int i = lane; i < n; i += 32) s += u[i] * v[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssm_scan_da_dots_kernel(const float* __restrict__ c, const float* __restrict__ dc,
                        const float* __restrict__ b, const float* __restrict__ db,
                        float* __restrict__ g, const Strides st, int H, int S, int N) {
  const int tiles = (S + kWarps - 1) / kWarps;
  const int bh = blockIdx.x / tiles, tile = blockIdx.x - bh * tiles;
  const int bi = bh / H, hi = bh - bi * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = tile * kWarps + warp;
  if (u >= S) return;
  const float v = warp_dot<kVec>(row(c, st.c, bi, u, hi), row(dc, st.dc, bi, u, hi), N, lane) -
                  warp_dot<kVec>(row(b, st.b, bi, u, hi), row(db, st.db, bi, u, hi), N, lane);
  if (lane == 0) g[((long long)bi * S + u) * H + hi] = v;
}

// g (in da) -> da, in place, one block a (batch, head)
__global__ void __launch_bounds__(kThreads)
ssm_scan_da_sum_kernel(float* __restrict__ da, const float* __restrict__ a,
                       const float* __restrict__ bias, const Strides st, int H, int S) {
  __shared__ double warp_sums[kWarps];
  const int bh = blockIdx.x, bi = bh / H, hi = bh - bi * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seg = (S + kThreads - 1) / kThreads;
  const int t0 = tid * seg, t1 = min(S, t0 + seg);
  float* gd = da + (long long)bi * S * H + hi;   // step u at gd[u * H]
  double mine = 0.0;
  for (int u = t0; u < t1; ++u) mine += (double)gd[(long long)u * H];
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
  double run = incl - mine + (bias != nullptr ? (double)bias[bh] : 0.0);
  for (int w = warp + 1; w < kWarps; ++w) run += warp_sums[w];
  const float* ab = a + bi * st.a[0] + hi * st.a[2];
  for (int u = t1 - 1; u >= t0; --u) {
    run += (double)gd[(long long)u * H];
    const float av = ab[(long long)u * st.a[1]];
    gd[(long long)u * H] = av >= kFloor ? (float)(run / (double)av) : 0.f;
  }
}

}  // namespace

// strides: int64[15], the (batch, time, head) element strides of c, dc, b,
// db, a.  bias may be null.  Runs the two kernels on `stream`; returns the
// first launch error (0 on success), cudaErrorInvalidValue for an
// unsupported shape.
extern "C" int ssm_scan_da_launch(const void* c, const void* dc, const void* b, const void* db,
                                  const void* a, const void* bias, void* da,
                                  const long long* strides, int B, int H, int S, int N,
                                  void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.c[i] = strides[i];
    st.dc[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.db[i] = strides[9 + i];
    st.a[i] = strides[12 + i];
  }
  // 16-byte loads where every row of the four starts on a 16-byte boundary
  bool vec = N % 4 == 0;
  const void* rows[4] = {c, dc, b, db};
  for (int k = 0; k < 4; ++k) {
    vec = vec && (uintptr_t)rows[k] % 16 == 0;
    for (int i = 0; i < 3; ++i) vec = vec && strides[3 * k + i] % 4 == 0;
  }
  const long long blocks = (long long)B * H * ((S + kWarps - 1) / kWarps);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *cf = static_cast<const float*>(c), *dcf = static_cast<const float*>(dc),
              *bf = static_cast<const float*>(b), *dbf = static_cast<const float*>(db);
  float* out = static_cast<float*>(da);
  if (vec)
    ssm_scan_da_dots_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(cf, dcf, bf, dbf, out, st,
                                                                       H, S, N);
  else
    ssm_scan_da_dots_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(cf, dcf, bf, dbf, out, st,
                                                                        H, S, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssm_scan_da_sum_kernel<<<(unsigned)(B * H), kThreads, 0, s>>>(
      out, static_cast<const float*>(a), static_cast<const float*>(bias), st, H, S);
  return (int)cudaGetLastError();
}
