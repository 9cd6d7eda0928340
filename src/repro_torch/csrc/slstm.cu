// The sLSTM recurrence of the xLSTM family on Hopper (sm_90a): a forward
// kernel sequential in time and its reverse-time backward.
//
// No TPU counterpart: the reference runs the recurrence as a jax.lax.scan
// (src/repro/models/xlstm.py:132-146, slstm_apply), which its jitted train,
// prefill and serve steps compile into one loop on the device.  With c = 0
// and n = 0 before the first step,
//
//   c_t = f_t c_{t-1} + i_t z_t,   n_t = f_t n_{t-1} + i_t,
//   y_t = o_t c_t / max(n_t, 1),
//
// z (B, S, H, hd) f32 (any strides over batch, step and head; the lanes
// contiguous), the gates i, f, o (B, S, H) f32 (any strides), shared by a
// head's hd lanes; y, and the saved c (B, S, H, hd) and n (B, S, H),
// contiguous.
//
// Bound on the H100: bytes at 3.35 TB/s (z read and y written; c and n
// written too where a gradient is asked for; the backward reads z, c and dy
// and writes dz).  But the recurrence is sequential in S and parallel only
// over the B*H*hd lanes (4,096 at xlstm_1_3b's 2 x 512 forward, 16,384 at
// its 8 x 256 train step), so the latency of each lane's loads and of its
// chain of dependent operations, not the bytes, sets the time.
//
// Forward: one thread a (batch, head, lane), sequential in t.  A warp never
// spans two heads, so its 32 lanes load the gates of 32 steps at once (lane
// u those of step t0 + u) and hand them round by shuffles, and z of the next
// 32 steps is loaded while the current 32 are computed.  The arithmetic is
// the plain loop's (ref.slstm_scan), in its order, with __fmul_rn /
// __fadd_rn / __fdiv_rn, so that nothing is contracted into a fused
// multiply-add: y is bit-equal to the plain version on the card.
//
// Backward (ref.slstm_scan_backward's recursion; m_t = max(n_t, 1), sums
// over the hd lanes, dC_S = dN_S = 0):
//
//   dC_t = dy_t o_t / m_t + f_{t+1} dC_{t+1},   dz_t = i_t dC_t,
//   do_t = sum dy_t c_t / m_t,
//   dN_t = [n_t >= 1] (-o_t sum dy_t c_t / m_t^2) + f_{t+1} dN_{t+1},
//   di_t = sum dC_t z_t + dN_t,   df_t = sum dC_t c_{t-1} + dN_t n_{t-1}.
//
// One block a (batch, head), a thread a lane, in reverse t over the
// forward's saved c and n, in chunks of kBwdChunk steps whose loads are all
// issued before the chunk's arithmetic.  Each step's three lane sums are
// reduced by warp shuffles and written to shared memory a warp each; at the
// end of a chunk warp 0 sums them over the warps in warp order and runs the
// scalar dN chain, while the other warps go on to the next chunk (the
// partial sums are double-buffered).  No atomics: two runs give the same
// bits.
#include <cuda_runtime.h>

namespace {

constexpr int kFwdChunk = 32;      // steps whose gates a warp's lanes hold at once
constexpr int kFwdThreads = 128;   // a forward block's lanes, at most
constexpr int kBwdChunk = 16;      // steps a backward chunk
constexpr int kMaxLanes = 512;     // hd: a backward block has a thread a lane
constexpr int kMaxWarps = kMaxLanes / 32;
constexpr unsigned kAll = 0xffffffffu;

// strides, in elements, over (batch, step, head) of z, i, f, o and dy
struct Strides {
  long long z[3], i[3], f[3], o[3], dy[3];
};

__device__ __forceinline__ float clamp1(float n) {
  return n < 1.0f ? 1.0f : n;      // torch.clamp(n, min=1): a NaN stays NaN
}

__global__ void __launch_bounds__(kFwdThreads, 1)
slstm_fwd_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                 const float* __restrict__ gf, const float* __restrict__ go, Strides st,
                 float* __restrict__ y, float* __restrict__ c_out, float* __restrict__ n_out,
                 int S, int H, int hd) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;     // the lane within the head
  const int u = threadIdx.x & 31;
  const bool live = j < hd;
  const float* zp = z + b * st.z[0] + h * st.z[2] + (live ? j : 0);
  const float* ip = gi + b * st.i[0] + h * st.i[2];
  const float* fp = gf + b * st.f[0] + h * st.f[2];
  const float* op = go + b * st.o[0] + h * st.o[2];
  const long long row = (long long)H * hd;                 // y's and c's step stride
  const long long base = ((long long)b * S * H + h) * hd + j;
  float* yp = y + base;
  float* cp = c_out != nullptr ? c_out + base : nullptr;
  float* np = (n_out != nullptr && blockIdx.y == 0 && threadIdx.x == 0)
                  ? n_out + (long long)b * S * H + h : nullptr;

  float zc[kFwdChunk], zn[kFwdChunk] = {};
  float ic = 0.f, fc = 0.f, oc = 0.f, inx = 0.f, fnx = 0.f, onx = 0.f;
#pragma unroll
  for (int k = 0; k < kFwdChunk; ++k) zc[k] = (live && k < S) ? zp[k * st.z[1]] : 0.f;
  if (u < S) {
    ic = ip[u * st.i[1]];
    fc = fp[u * st.f[1]];
    oc = op[u * st.o[1]];
  }
  float c = 0.f, n = 0.f;
  for (int t0 = 0; t0 < S; t0 += kFwdChunk) {
    const int t1 = t0 + kFwdChunk;
    if (t1 < S) {                  // the next chunk's loads, ahead of this one's work
#pragma unroll
      for (int k = 0; k < kFwdChunk; ++k) {
        const long long t = t1 + k;
        zn[k] = (live && t < S) ? zp[t * st.z[1]] : 0.f;
      }
      const long long t = t1 + u;
      if (t < S) {
        inx = ip[t * st.i[1]];
        fnx = fp[t * st.f[1]];
        onx = op[t * st.o[1]];
      }
    }
#pragma unroll
    for (int k = 0; k < kFwdChunk; ++k) {
      const float it = __shfl_sync(kAll, ic, k);
      const float ft = __shfl_sync(kAll, fc, k);
      const float ot = __shfl_sync(kAll, oc, k);
      const long long t = t0 + k;
      if (t < S) {                 // the same for every lane
        c = __fadd_rn(__fmul_rn(ft, c), __fmul_rn(it, zc[k]));
        n = __fadd_rn(__fmul_rn(ft, n), it);
        const float yt = __fdiv_rn(__fmul_rn(ot, c), clamp1(n));
        if (live) {
          yp[t * row] = yt;
          if (cp != nullptr) cp[t * row] = c;
        }
        if (np != nullptr) np[t * H] = n;
      }
    }
#pragma unroll
    for (int k = 0; k < kFwdChunk; ++k) zc[k] = zn[k];
    ic = inx;
    fc = fnx;
    oc = onx;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(kAll, v, off));
  return v;                        // in lane 0, in a fixed order
}

__global__ void __launch_bounds__(kMaxLanes, 1)
slstm_bwd_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                 const float* __restrict__ gf, const float* __restrict__ go,
                 const float* __restrict__ dy, const float* __restrict__ c_sv,
                 const float* __restrict__ n_sv, Strides st, float* __restrict__ dz,
                 float* __restrict__ di, float* __restrict__ df, float* __restrict__ d_o,
                 int S, int H, int hd) {
  // each step's three lane sums a warp: sum dC z, sum dC c_{t-1}, sum dy c
  __shared__ float part[2][kBwdChunk][kMaxWarps][3];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x, u = j & 31, w = j >> 5, nw = blockDim.x >> 5;
  const bool live = j < hd;
  const float* zp = z + b * st.z[0] + h * st.z[2] + (live ? j : 0);
  const float* dyp = dy + b * st.dy[0] + h * st.dy[2] + (live ? j : 0);
  const float* ip = gi + b * st.i[0] + h * st.i[2];
  const float* fp = gf + b * st.f[0] + h * st.f[2];
  const float* op = go + b * st.o[0] + h * st.o[2];
  const long long row = (long long)H * hd;
  const long long base = ((long long)b * S * H + h) * hd + (live ? j : 0);
  const float* cp = c_sv + base;
  float* dzp = dz != nullptr ? dz + base : nullptr;
  const long long sbase = (long long)b * S * H + h;        // di, df, do, n: (B, S, H)
  const float* np = n_sv + sbase;

  float dC = 0.f;                  // every lane's carry
  float dN = 0.f;                  // warp 0's (each of its lanes holds it)
  float c_hi = live ? cp[(long long)(S - 1) * row] : 0.f;  // c at the chunk's last step
  for (int k = (S - 1) / kBwdChunk; k >= 0; --k) {
    const int t0 = k * kBwdChunk;
    const int len = min(kBwdChunk, S - t0);
    float(*pk)[kMaxWarps][3] = part[k & 1];
    // lane s < len holds step t0 + s's gates: i, f_{t+1}, o, n, m and n_{t-1}
    float gi_s = 0.f, gfn_s = 0.f, go_s = 0.f, gn_s = 0.f, gm_s = 1.f, gnp_s = 0.f;
    if (u < len) {
      const long long t = t0 + u;
      gi_s = ip[t * st.i[1]];
      gfn_s = t + 1 < S ? fp[(t + 1) * st.f[1]] : 0.f;
      go_s = op[t * st.o[1]];
      gn_s = np[t * H];
      gm_s = clamp1(gn_s);
      gnp_s = t > 0 ? np[(t - 1) * H] : 0.f;
    }
    float zr[kBwdChunk], dyr[kBwdChunk], cr[kBwdChunk];    // cr[s] = c_{t0+s-1}
#pragma unroll
    for (int s = 0; s < kBwdChunk; ++s) {
      const long long t = t0 + s;
      const bool ok = live && s < len;
      zr[s] = ok ? zp[t * st.z[1]] : 0.f;
      dyr[s] = ok ? dyp[t * st.dy[1]] : 0.f;
      cr[s] = (ok && t > 0) ? cp[(t - 1) * row] : 0.f;
    }
    float c_t = c_hi;
#pragma unroll
    for (int s = kBwdChunk - 1; s >= 0; --s) {
      const float it = __shfl_sync(kAll, gi_s, s);
      const float fnt = __shfl_sync(kAll, gfn_s, s);
      const float ot = __shfl_sync(kAll, go_s, s);
      const float mt = __shfl_sync(kAll, gm_s, s);
      float p0 = 0.f, p1 = 0.f, p2 = 0.f;
      if (s < len) {               // the same for every lane
        dC = __fadd_rn(__fdiv_rn(__fmul_rn(dyr[s], ot), mt), __fmul_rn(fnt, dC));
        if (live && dzp != nullptr) dzp[(long long)(t0 + s) * row] = __fmul_rn(it, dC);
        p0 = __fmul_rn(dC, zr[s]);
        p1 = __fmul_rn(dC, cr[s]);
        p2 = __fmul_rn(dyr[s], c_t);
        c_t = cr[s];
      }
      p0 = warp_sum(p0);
      p1 = warp_sum(p1);
      p2 = warp_sum(p2);
      if (u == 0 && s < len) {
        pk[s][w][0] = p0;
        pk[s][w][1] = p1;
        pk[s][w][2] = p2;
      }
    }
    c_hi = c_t;                    // c_{t0-1}
    __syncthreads();
    if (w == 0) {
      // lane s: step t0 + s's sums over the warps, in warp order
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      if (u < len) {
        for (int q = 0; q < nw; ++q) {
          s0 = __fadd_rn(s0, pk[u][q][0]);
          s1 = __fadd_rn(s1, pk[u][q][1]);
          s2 = __fadd_rn(s2, pk[u][q][2]);
        }
      }
      const float direct = (u < len && gn_s >= 1.f)
                               ? __fdiv_rn(-__fmul_rn(go_s, s2), __fmul_rn(gm_s, gm_s)) : 0.f;
      float mine = 0.f;            // dN at this lane's step
#pragma unroll
      for (int s = kBwdChunk - 1; s >= 0; --s) {
        const float d = __shfl_sync(kAll, direct, s);
        const float f1 = __shfl_sync(kAll, gfn_s, s);
        if (s < len) {
          dN = __fadd_rn(d, __fmul_rn(f1, dN));
          if (u == s) mine = dN;
        }
      }
      if (u < len) {
        const long long at = sbase + (long long)(t0 + u) * H;
        if (d_o != nullptr) d_o[at] = __fdiv_rn(s2, gm_s);
        if (di != nullptr) di[at] = __fadd_rn(s0, mine);
        if (df != nullptr) df[at] = __fadd_rn(s1, __fmul_rn(mine, gnp_s));
      }
    }
  }
}

Strides read_strides(const long long* s, int tensors) {
  Strides st = {};
  long long* dst[5] = {st.z, st.i, st.f, st.o, st.dy};
  for (int k = 0; k < tensors; ++k)
    for (int d = 0; d < 3; ++d) dst[k][d] = s[3 * k + d];
  return st;
}

int round_up32(int v) { return (v + 31) / 32 * 32; }

}  // namespace

// The forward: y (and, where c and n are not null, the saved c and n).
// strides: (batch, step, head) of z, i, f, o, 12 values.  Returns a
// cudaError_t.
extern "C" int slstm_fwd_launch(const void* z, const void* i, const void* f, const void* o,
                                const long long* strides, void* y, void* c, void* n, int B,
                                int S, int H, int hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > kMaxLanes || (c == nullptr) != (n == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = round_up32(hd) < kFwdThreads ? round_up32(hd) : kFwdThreads;
  const dim3 grid(B * H, (hd + threads - 1) / threads);
  slstm_fwd_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(i), static_cast<const float*>(f),
      static_cast<const float*>(o), read_strides(strides, 4), static_cast<float*>(y),
      static_cast<float*>(c), static_cast<float*>(n), S, H, hd);
  return (int)cudaGetLastError();
}

// The backward on the forward's saved c and n: dz, di, df, do, each skipped
// where its pointer is null.  strides: (batch, step, head) of z, i, f, o and
// dy, 15 values.  Returns a cudaError_t.
extern "C" int slstm_bwd_launch(const void* z, const void* i, const void* f, const void* o,
                                const void* dy, const void* c, const void* n,
                                const long long* strides, void* dz, void* di, void* df,
                                void* d_o, int B, int S, int H, int hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > kMaxLanes) return (int)cudaErrorInvalidValue;
  slstm_bwd_kernel<<<B * H, round_up32(hd), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(i), static_cast<const float*>(f),
      static_cast<const float*>(o), static_cast<const float*>(dy), static_cast<const float*>(c),
      static_cast<const float*>(n), read_strides(strides, 5), static_cast<float*>(dz),
      static_cast<float*>(di), static_cast<float*>(df), static_cast<float*>(d_o), S, H, hd);
  return (int)cudaGetLastError();
}
