// The sLSTM recurrence of the xLSTM family on Hopper (sm_90a): an exact
// carry pass sequential in time beside passes parallel over (t, lane), for
// the forward and for its reverse-time backward.
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
// head's hd lanes; y, c (B, S, H, hd) and n (B, S, H), contiguous.
//
// Bound on the H100: bytes at 3.35 TB/s (z read and y written; c and n
// written too where a gradient is asked for; the backward reads z, c and dy
// and writes dz).  Only the multiply and add of c and n (of dC and dN in
// the backward) depend on the step before; y's division and store and
// every sum over the lanes do not.  So each direction runs an exact carry
// pass of that chain, sequential in t and parallel over the B*H*hd lanes
// only (a warp a block, so 2 x 512's 4,096 lanes take 128 SMs), and the
// rest in passes parallel over (b, t, h) or (b, t, h, lane).
//
// Forward (two kernels, y bit-equal to the plain loop, ref.slstm_scan):
//   slstm_carry_kernel    one warp a block, 32 lanes of a (batch, head),
//                         sequential in t: c = f c + i z and, in the head's
//                         first block, n = f n + i, written to c and n (the
//                         saved states, or scratch).  z and the gates i, f
//                         of the next chunks of kChunk steps stream into a
//                         ring of kStages chunks in shared memory by
//                         cp.async (z 16 bytes a copy where aligned); a
//                         step reads its gates there by broadcast, and a
//                         chunk's stores follow its chain.
//   slstm_readout_kernel  a warp a (b, t, h) row: y = o c / max(n, 1).
// The arithmetic is the plain loop's, in its order, with __fmul_rn /
// __fadd_rn / __fdiv_rn, so that nothing is contracted into a fused
// multiply-add.  Above the bound: c and n written and read back.
//
// Backward (ref.slstm_scan_backward's recursion; m_t = max(n_t, 1), sums
// over the hd lanes, dC_S = dN_S = 0):
//
//   dC_t = dy_t o_t / m_t + f_{t+1} dC_{t+1},   dz_t = i_t dC_t,
//   do_t = sum dy_t c_t / m_t,
//   dN_t = [n_t >= 1] (-o_t sum dy_t c_t / m_t^2) + f_{t+1} dN_{t+1},
//   di_t = sum dC_t z_t + dN_t,   df_t = sum dC_t c_{t-1} + dN_t n_{t-1}.
//
// on the forward's saved c and n, in three kernels:
//   slstm_bwd_chain_kernel  (b) the carry pass in reverse t, a block of 32
//                           lanes: its chain warp runs dC alone, in the
//                           recursion's order of operations, and writes dz =
//                           i dC, while four helper warps stream dy, z and c
//                           through a ring of chunks, divide dy o / m ahead
//                           of the chain and sum each step's dC z, dC c_{t-1}
//                           and dy c over the block's lanes (a thread a step,
//                           in lane order) into a scratch row of warp sums.
//   slstm_bwd_rows_kernel   (a) a thread a (b, t, h): the warp sums added in
//                           warp order, do and dN's direct term.
//   slstm_bwd_dn_kernel     (c) a warp a (batch, head), reverse in t: the
//                           scalar dN chain, then di and df.
// (The lane sums of the plain passes (a) and (c) ride on (b), which reads
// dy, z and c once: no dC goes through device memory.)  No atomics: a
// second call gives the same bits.  Above the bound: the warp sums and the
// rows pass's output, 3 (ceil(hd / 32) + 1) floats a row written and read,
// and c's row before each chunk.  The kernels after a call's first follow
// it by programmatic dependent launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChunk = 32;         // steps a staged chunk of the carry passes
constexpr int kStages = 8;         // chunks in the ring: kStages - 1 in flight
constexpr int kMaxLanes = 512;     // hd at most (the wrapper's MAX_LANES: xlstm's 512)
constexpr int kRows = 8;           // rows a block of the readout, a warp each

// strides, in elements, over (batch, step, head) of z, i, f, o and dy
struct Strides {
  long long z[3], i[3], f[3], o[3], dy[3];
};

__device__ __forceinline__ float clamp1(float n) {
  return n < 1.0f ? 1.0f : n;      // torch.clamp(n, min=1): a NaN stays NaN
}

// 4 bytes to shared memory: `bytes` (4 or 0) of them from src, the rest zero
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
// 16 bytes to shared memory: `bytes` (16 or 0) of them from src, the rest zero
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v[s] to p + s * stride for the steps s < len of a chunk, after its chain.
__device__ __forceinline__ void store_steps(float* p, long long stride, const float (&v)[kChunk],
                                            int len) {
  if (len == kChunk) {
#pragma unroll
    for (int s = 0; s < kChunk; ++s, p += stride) *p = v[s];
  } else {
#pragma unroll
    for (int s = 0; s < kChunk; ++s, p += stride)
      if (s < len) *p = v[s];
  }
}

// Programmatic dependent launch: a kernel launched after another of its
// call waits here until that grid has completed and its writes are visible
// (a no-op for a kernel launched without the attribute).
__device__ __forceinline__ void follow_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
struct CarryRing {
  float z[kStages][kChunk][32];    // [slot][step][lane]
  float g[kStages][2][kChunk];     // [slot][i, f][step]
};

// Starts copying chunk k (steps t0 .. t0 + kChunk - 1) into its slot: z of
// the block's `lanes` live lanes (zb: lane 0 at step 0) and the gates i, f;
// steps from S on and dead lanes are zero.  kWide: 16 bytes a copy (four
// lanes of a step), else a lane's steps a thread.
template <bool kWide>
__device__ __forceinline__ void carry_stage(CarryRing& r, int k, const float* zb,
                                            const float* ip, const float* fp,
                                            const Strides& st, int lanes, int S) {
  const int u = threadIdx.x, slot = k % kStages, t0 = k * kChunk;
  if (kWide) {
    const int q = 4 * (u & 7), s0 = u >> 3;                // lanes q .. q + 3 of steps s0 + 4 v
#pragma unroll
    for (int v = 0; v < kChunk / 4; ++v) {
      const int s = s0 + 4 * v;
      const bool in = q < lanes && t0 + s < S;
      cp16(&r.z[slot][s][q], in ? zb + (long long)(t0 + s) * st.z[1] + q : zb, in ? 16 : 0);
    }
  } else {
    const float* zp = zb + (u < lanes ? u : 0);
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const bool in = u < lanes && t0 + s < S;
      cp4(&r.z[slot][s][u], in ? zp + (long long)(t0 + s) * st.z[1] : zp, in ? 4 : 0);
    }
  }
  const bool in = t0 + u < S;
  cp4(&r.g[slot][0][u], in ? ip + (long long)(t0 + u) * st.i[1] : ip, in ? 4 : 0);
  cp4(&r.g[slot][1][u], in ? fp + (long long)(t0 + u) * st.f[1] : fp, in ? 4 : 0);
}

// c's chain over a staged chunk, and n's beside it where kN (the two chains
// interleave): cs[s] = c after step s, nk = n after step u.  Steps from S on
// hold zeros, so a chunk runs without a branch (c and n past S are never
// stored) and its loads issue ahead of the chain.
template <bool kN>
__device__ __forceinline__ void carry_chunk(const CarryRing& r, int slot, float& c, float& n,
                                            float (&cs)[kChunk], float& nk) {
  const int u = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const float it = r.g[slot][0][s], ft = r.g[slot][1][s];
    c = __fadd_rn(__fmul_rn(ft, c), __fmul_rn(it, r.z[slot][s][u]));
    cs[s] = c;
    if (kN) {
      n = __fadd_rn(__fmul_rn(ft, n), it);
      nk = u == s ? n : nk;
    }
  }
}

// grid (B*H, ceil(hd / 32)), 32 threads: lane j = 32 blockIdx.y + u of head
// (b, h) = blockIdx.x; the head's first block also runs n's chain.  kWide:
// z is copied 16 bytes at a time (z 16-byte aligned, its strides and hd
// multiples of 4).
template <bool kWide>
__global__ void __launch_bounds__(32)
slstm_carry_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                   const float* __restrict__ gf, Strides st, float* __restrict__ c_out,
                   float* __restrict__ n_out, int S, int H, int hd) {
  __shared__ __align__(16) CarryRing ring;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int u = threadIdx.x, j = blockIdx.y * 32 + u;
  const bool live = j < hd, head0 = blockIdx.y == 0;
  const int lanes = min(32, hd - 32 * (int)blockIdx.y);
  const float* zb = z + b * st.z[0] + h * st.z[2] + 32 * blockIdx.y;
  const float* ip = gi + b * st.i[0] + h * st.i[2];
  const float* fp = gf + b * st.f[0] + h * st.f[2];
  const long long row = (long long)H * hd;                 // c's step stride
  float* cp = c_out + ((long long)b * S * H + h) * hd + (live ? j : 0);
  float* np = n_out + (long long)b * S * H + h;
  const int chunks = (S + kChunk - 1) / kChunk;

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < chunks) carry_stage<kWide>(ring, k, zb, ip, fp, st, lanes, S);
    cp_commit();
  }
  float c = 0.f, n = 0.f;
  for (int k = 0; k < chunks; ++k) {
    cp_wait<kStages - 2>();        // chunk k has landed (this thread's copies)
    __syncwarp();                  // ... and every lane's; slot k - 1 is free
    if (k + kStages - 1 < chunks)
      carry_stage<kWide>(ring, k + kStages - 1, zb, ip, fp, st, lanes, S);
    cp_commit();
    const int slot = k % kStages, t0 = k * kChunk, len = min(kChunk, S - t0);
    float cs[kChunk], nk = 0.f;
    if (head0)
      carry_chunk<true>(ring, slot, c, n, cs, nk);
    else
      carry_chunk<false>(ring, slot, c, n, cs, nk);
    if (live) store_steps(cp + (long long)t0 * row, row, cs, len);
    if (head0 && u < len) np[(long long)(t0 + u) * H] = nk;
  }
}

// rows (b, t, h) = kRows blockIdx.x + warp, 32 kRows threads: y = o c /
// max(n, 1), four lanes a thread where kVec.
template <bool kVec>
__global__ void __launch_bounds__(32 * kRows)
slstm_readout_kernel(const float* __restrict__ c, const float* __restrict__ n,
                     const float* __restrict__ go, Strides st, float* __restrict__ y, int S,
                     int H, int hd, int rows) {
  follow_previous_grid();
  const int r = blockIdx.x * kRows + (threadIdx.x >> 5), u = threadIdx.x & 31;
  if (r >= rows) return;
  const int h = r % H, bt = r / H, t = bt % S, b = bt / S;
  const float o = go[b * st.o[0] + t * st.o[1] + h * st.o[2]];
  const float m = clamp1(n[r]);
  const float* cr = c + (long long)r * hd;
  float* yr = y + (long long)r * hd;
  if (kVec) {
    for (int j = 4 * u; j < hd; j += 128) {
      const float4 cv = *reinterpret_cast<const float4*>(cr + j);
      *reinterpret_cast<float4*>(yr + j) =
          make_float4(__fdiv_rn(__fmul_rn(o, cv.x), m), __fdiv_rn(__fmul_rn(o, cv.y), m),
                      __fdiv_rn(__fmul_rn(o, cv.z), m), __fdiv_rn(__fmul_rn(o, cv.w), m));
    }
  } else {
    for (int j = u; j < hd; j += 32) yr[j] = __fdiv_rn(__fmul_rn(o, cr[j]), m);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
constexpr int kChainStages = 4;    // the chain pass's ring of chunks: two in flight
constexpr int kHelpers = 4;        // helper warps a chain block, beside its chain warp
constexpr int kPerHelper = kChunk / kHelpers;              // steps a helper copies, divides
constexpr int kPitch = 33;         // a row of 32 lanes, padded: a thread a step reads
                                   // its row without bank conflicts

struct ChainRing {
  float dy[kChainStages][kChunk][kPitch];      // [slot][step][lane]: dy, dy o / m, dC
  float z[kChainStages][kChunk][kPitch];
  float c[kChainStages][kChunk + 1][kPitch];   // row s: c at step t0 + s - 1
  float g[kChainStages][4][kChunk];            // [slot][i, f_{t+1}, o, n][step]
};
constexpr int kChainSmem = (int)sizeof(ChainRing);        // dynamic: above 48 KB

// a chain block's view of its (batch, head) and lanes
struct ChainArgs {
  const float *dy, *z, *c, *i, *f, *o, *n;  // at step 0 and the lane (n at the head's row 0)
  float* part;                              // the block's sums
  long long dy_t, z_t, i_t, f_t, o_t;       // step strides
  long long row, rows;                      // c's and dz's step stride; B*S*H
  int S, H, sbase;                          // sbase: the head's row at step 0
  bool live, sums;
};

__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kHelpers) : "memory");
}

// Helpers: start copying the q-th chunk of the reverse order, steps t0 ..
// t0 + kChunk - 1 with t0 = kChunk (chunks - 1 - q), into its slot: dy (and,
// for the lane sums, z and c from step t0 - 1) of the block's lanes, and
// the gates i, f_{t+1}, o and n; steps out of [0, S) and dead lanes are zero.
__device__ __forceinline__ void chain_load(ChainRing& r, int q, int chunks, const ChainArgs& a) {
  const int w = (threadIdx.x >> 5) - 1, u = threadIdx.x & 31;
  const int slot = q % kChainStages, t0 = (chunks - 1 - q) * kChunk;
#pragma unroll
  for (int v = 0; v < kPerHelper; ++v) {
    const int s = w + kHelpers * v;
    const bool in = a.live && t0 + s < a.S;
    cp4(&r.dy[slot][s][u], in ? a.dy + (long long)(t0 + s) * a.dy_t : a.dy, in ? 4 : 0);
  }
  if (a.sums) {
#pragma unroll
    for (int v = 0; v < kPerHelper; ++v) {
      const int s = w + kHelpers * v;
      const bool in = a.live && t0 + s < a.S;
      cp4(&r.z[slot][s][u], in ? a.z + (long long)(t0 + s) * a.z_t : a.z, in ? 4 : 0);
    }
#pragma unroll
    for (int v = 0; v <= kPerHelper; ++v) {
      const int s = w + kHelpers * v, t = t0 + s - 1;
      const bool in = a.live && t >= 0 && t < a.S;
      if (s <= kChunk) cp4(&r.c[slot][s][u], in ? a.c + (long long)t * a.row : a.c, in ? 4 : 0);
    }
  }
  // the gates: helper w copies row w of g
  const long long t = t0 + u;
  if (w == 0) {
    cp4(&r.g[slot][0][u], t < a.S ? a.i + t * a.i_t : a.i, t < a.S ? 4 : 0);
  } else if (w == 1) {
    cp4(&r.g[slot][1][u], t + 1 < a.S ? a.f + (t + 1) * a.f_t : a.f, t + 1 < a.S ? 4 : 0);
  } else if (w == 2) {
    cp4(&r.g[slot][2][u], t < a.S ? a.o + t * a.o_t : a.o, t < a.S ? 4 : 0);
  } else {
    cp4(&r.g[slot][3][u], t < a.S ? a.n + t * a.H : a.n, t < a.S ? 4 : 0);
  }
}

// Helper k < 3, thread u: the sum over the block's 32 lanes, in lane order,
// at step u of the q-th chunk, of dC z (k = 0), dC c_{t-1} (k = 1) or dy c_t
// (k = 2), into part[k rows + row].
__device__ __forceinline__ void chain_sum(ChainRing& r, int q, int chunks, int k,
                                          const ChainArgs& a) {
  const int u = threadIdx.x & 31;
  const int slot = q % kChainStages, t0 = (chunks - 1 - q) * kChunk;
  const float* x = k == 2 ? &r.c[slot][u + 1][0] : &r.dy[slot][u][0];
  const float* y = k == 0 ? &r.z[slot][u][0] : k == 1 ? &r.c[slot][u][0] : &r.dy[slot][u][0];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], y[j]));
  if (t0 + u < a.S) a.part[k * a.rows + a.sbase + (long long)(t0 + u) * a.H] = acc;
}

// Helper w: dy o / m in place of dy at steps kPerHelper w .. of the q-th
// chunk.
__device__ __forceinline__ void chain_divide(ChainRing& r, int q) {
  const int w = (threadIdx.x >> 5) - 1, u = threadIdx.x & 31, slot = q % kChainStages;
#pragma unroll
  for (int v = 0; v < kPerHelper; ++v) {
    const int s = kPerHelper * w + v;
    r.dy[slot][s][u] = __fdiv_rn(__fmul_rn(r.dy[slot][s][u], r.g[slot][2][s]),
                                 clamp1(r.g[slot][3][s]));
  }
}

// (b) grid (B*H, ceil(hd / 32)), 32 (1 + kHelpers) threads: lanes j = 32
// blockIdx.y + u of head (b, h) = blockIdx.x, sequential in reverse t.  Warp
// 0 runs dC's chain alone, in the plain recursion's order of operations,
// on dy o / m that the helper warps divided ahead of it, and writes dz = i
// dC where dz is not null.  While it runs chunk k, the helpers sum chunk k -
// 1's dC z and dC c_{t-1} and chunk k + 1's dy c_t over the lanes, a thread
// a step, start the copies of chunk k + kChainStages - 1 and divide chunk k
// + 1 (two chunks in flight a block).  Where part is not null, the sums go
// to part[(3 y + k) rows + row] (y = blockIdx.y).  Steps from S on hold
// zeros (dy o / m = 0 and f_{t+1} = 0 there), so dC enters step S - 1 as 0.
__global__ void __launch_bounds__(32 * (1 + kHelpers))
slstm_bwd_chain_kernel(const float* __restrict__ dy, const float* __restrict__ z,
                       const float* __restrict__ c, const float* __restrict__ gi,
                       const float* __restrict__ gf, const float* __restrict__ go,
                       const float* __restrict__ n, Strides st, float* __restrict__ dz,
                       float* __restrict__ part, int S, int H, int hd) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  ChainRing& ring = *reinterpret_cast<ChainRing*>(chain_smem);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int u = threadIdx.x & 31, j = blockIdx.y * 32 + u, w = (threadIdx.x >> 5) - 1;
  ChainArgs a;
  a.live = j < hd;
  a.sums = part != nullptr;
  a.S = S;
  a.H = H;
  a.sbase = b * S * H + h;
  a.row = (long long)H * hd;
  a.rows = (long long)gridDim.x * S;                       // B*S*H
  const long long lane = a.live ? j : 0;
  a.dy = dy + b * st.dy[0] + h * st.dy[2] + lane;
  a.z = z + b * st.z[0] + h * st.z[2] + lane;
  a.c = c + (long long)a.sbase * hd + lane;
  a.part = a.sums ? part + 3LL * blockIdx.y * a.rows : nullptr;
  a.i = gi + b * st.i[0] + h * st.i[2];
  a.f = gf + b * st.f[0] + h * st.f[2];
  a.o = go + b * st.o[0] + h * st.o[2];
  a.n = n + a.sbase;
  a.dy_t = st.dy[1];
  a.z_t = st.z[1];
  a.i_t = st.i[1];
  a.f_t = st.f[1];
  a.o_t = st.o[1];
  float* dzp = dz != nullptr && a.live ? dz + (long long)a.sbase * hd + lane : nullptr;
  const int chunks = (S + kChunk - 1) / kChunk;

  if (w >= 0) {
    for (int q = 0; q < kChainStages - 1; ++q) {
      if (q < chunks) chain_load(ring, q, chunks, a);
      cp_commit();
    }
    cp_wait<kChainStages - 2>();   // chunk 0 has landed (this thread's copies)
    helpers_sync();                // ... and every helper's
    if (a.sums && w == 2) chain_sum(ring, 0, chunks, 2, a);
    helpers_sync();
    chain_divide(ring, 0);
  }
  __syncthreads();
  float dc = 0.f;
  for (int k = 0; k < chunks; ++k) {
    if (w < 0) {                   // the chain warp
      const int slot = k % kChainStages, t0 = (chunks - 1 - k) * kChunk;
      float ds[kChunk];
#pragma unroll
      for (int s = kChunk - 1; s >= 0; --s) {
        dc = __fadd_rn(ring.dy[slot][s][u], __fmul_rn(ring.g[slot][1][s], dc));
        ds[s] = dc;
        ring.dy[slot][s][u] = dc;
      }
      if (dzp != nullptr) {
#pragma unroll
        for (int s = 0; s < kChunk; ++s) ds[s] = __fmul_rn(ring.g[slot][0][s], ds[s]);
        store_steps(dzp + (long long)t0 * a.row, a.row, ds, min(kChunk, S - t0));
      }
    } else {
      // chunks 0 .. k + 2 were committed, so at most one pending means
      // chunk k + 1 has landed (this thread's copies; every helper's after
      // the barrier)
      cp_wait<kChainStages - 3>();
      helpers_sync();
      if (a.sums) {
        if (w < 2 && k > 0) chain_sum(ring, k - 1, chunks, w, a);
        if (w == 2 && k + 1 < chunks) chain_sum(ring, k + 1, chunks, 2, a);
      }
      helpers_sync();              // chunk k - 1's slot is free
      if (k + kChainStages - 1 < chunks) chain_load(ring, k + kChainStages - 1, chunks, a);
      cp_commit();
      if (k + 1 < chunks) chain_divide(ring, k + 1);
    }
    __syncthreads();
  }
  if (a.sums && (w == 0 || w == 1)) chain_sum(ring, chunks - 1, chunks, w, a);
}

// (a) a thread a row r = (b, t, h): the sums over the hd lanes, the chain
// pass's warp sums added in warp order (blocks = ceil(hd / 32) of them);
// do = sum dy c / m where d_o is not null, and where out is not null, for
// the dN pass: out[r] = sum dC z, out[rows + r] = sum dC c_{t-1} and
// out[2 rows + r] = dN's direct term [n >= 1] (-o sum dy c / m^2).
__global__ void __launch_bounds__(256)
slstm_bwd_rows_kernel(const float* __restrict__ part, const float* __restrict__ n,
                      const float* __restrict__ go, Strides st, float* __restrict__ d_o,
                      float* __restrict__ out, int S, int H, int blocks, int rows) {
  follow_previous_grid();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int y = 0; y < blocks; ++y) {
    const float* py = part + 3LL * y * rows + r;
    s0 = __fadd_rn(s0, py[0]);
    s1 = __fadd_rn(s1, py[rows]);
    s2 = __fadd_rn(s2, py[2LL * rows]);
  }
  const float nt = n[r], m = clamp1(nt);
  if (d_o != nullptr) d_o[r] = __fdiv_rn(s2, m);
  if (out != nullptr) {
    const int h = r % H, bt = r / H, t = bt % S, b = bt / S;
    const float o = go[b * st.o[0] + t * st.o[1] + h * st.o[2]];
    out[r] = s0;
    out[rows + r] = s1;
    out[2LL * rows + r] = nt >= 1.f ? __fdiv_rn(-__fmul_rn(o, s2), __fmul_rn(m, m)) : 0.f;
  }
}

// (c) a warp a (batch, head) = blockIdx.x, in reverse t: the scalar chain
// dN_t = direct_t + f_{t+1} dN_{t+1}, then di = sum dC z + dN and df = sum dC
// c_{t-1} + dN n_{t-1} (each skipped where its pointer is null).  A round
// of kRound steps is loaded at once, lane u holding steps t0 + 32 v + u;
// every lane runs the chain, reading direct and f_{t+1} from shared memory
// by broadcast, and keeps dN at its own steps.
constexpr int kSeg = 8;
constexpr int kRound = 32 * kSeg;
__global__ void __launch_bounds__(32)
slstm_bwd_dn_kernel(const float* __restrict__ sums, const float* __restrict__ gf,
                    const float* __restrict__ n, Strides st, float* __restrict__ di,
                    float* __restrict__ df, int S, int H, int rows) {
  __shared__ __align__(16) float sd[kRound], sf[kRound];
  follow_previous_grid();
  const int bh = blockIdx.x, b = bh / H, h = bh % H, u = threadIdx.x;
  const long long sbase = (long long)b * S * H + h;
  const float* fp = gf + b * st.f[0] + h * st.f[2];
  float dn = 0.f;
  for (int t0 = (S - 1) / kRound * kRound; t0 >= 0; t0 -= kRound) {
    float s0[kSeg], s1[kSeg], np[kSeg], mine[kSeg];
#pragma unroll
    for (int v = 0; v < kSeg; ++v) {
      const long long t = t0 + 32 * v + u, r = sbase + t * H;
      const bool in = t < S;
      sd[32 * v + u] = in ? sums[2LL * rows + r] : 0.f;
      sf[32 * v + u] = t + 1 < S ? fp[(t + 1) * st.f[1]] : 0.f;
      s0[v] = in ? sums[r] : 0.f;
      s1[v] = in ? sums[rows + r] : 0.f;
      np[v] = in && t > 0 ? n[r - H] : 0.f;
      mine[v] = 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int s = kRound - 1; s >= 0; --s) {
      dn = __fadd_rn(sd[s], __fmul_rn(sf[s], dn));
      mine[s / 32] = u == s % 32 ? dn : mine[s / 32];
    }
    __syncwarp();                  // sd and sf are free again
#pragma unroll
    for (int v = 0; v < kSeg; ++v) {
      const long long t = t0 + 32 * v + u, r = sbase + t * H;
      if (t < S) {
        if (di != nullptr) di[r] = __fadd_rn(s0[v], mine[v]);
        if (df != nullptr) df[r] = __fadd_rn(s1[v], __fmul_rn(mine[v], np[v]));
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

// Launches `kernel` on `grid` x `threads` with `smem` bytes of dynamic
// shared memory; where `after`, with programmatic stream serialization (see
// follow_previous_grid).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads, int smem, bool after,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Raises the chain kernel's dynamic shared memory limit to kChainSmem, once
// a device (`done` holds a bit a device).
cudaError_t chain_opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(slstm_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kChainSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

bool bad_dims(int B, int S, int H, int hd) {
  return B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > kMaxLanes ||
         (long long)B * S * H > 0x7fffffffLL - kRows;
}

}  // namespace

// The forward: c and n (the saved states, or scratch), then y.  strides:
// (batch, step, head) of z, i, f, o, 12 values.  Returns a cudaError_t.
extern "C" int slstm_fwd_launch(const void* z, const void* i, const void* f, const void* o,
                                const long long* strides, void* y, void* c, void* n, int B,
                                int S, int H, int hd, void* stream) {
  if (bad_dims(B, S, H, hd) || c == nullptr || n == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = read_strides(strides, 4);
  const int rows = B * S * H;
  float *yf = static_cast<float*>(y), *cf = static_cast<float*>(c), *nf = static_cast<float*>(n);
  const bool wide = hd % 4 == 0 && (uintptr_t)z % 16 == 0 &&
                    (st.z[0] | st.z[1] | st.z[2]) % 4 == 0;
  const dim3 heads(B * H, (hd + 31) / 32);
  const float *zf = static_cast<const float*>(z), *fi = static_cast<const float*>(i),
              *ff = static_cast<const float*>(f);
  cudaError_t err = wide ? launch(slstm_carry_kernel<true>, heads, 32, 0, false, s, zf, fi, ff,
                                  st, cf, nf, S, H, hd)
                         : launch(slstm_carry_kernel<false>, heads, 32, 0, false, s, zf, fi, ff,
                                  st, cf, nf, S, H, hd);
  if (err != cudaSuccess) return (int)err;
  const bool vec = hd % 4 == 0 && ((uintptr_t)c | (uintptr_t)y) % 16 == 0;
  const dim3 grid((rows + kRows - 1) / kRows);
  err = vec ? launch(slstm_readout_kernel<true>, grid, 32 * kRows, 0, true, s,
                     static_cast<const float*>(cf), static_cast<const float*>(nf),
                     static_cast<const float*>(o), st, yf, S, H, hd, rows)
            : launch(slstm_readout_kernel<false>, grid, 32 * kRows, 0, true, s,
                     static_cast<const float*>(cf), static_cast<const float*>(nf),
                     static_cast<const float*>(o), st, yf, S, H, hd, rows);
  return (int)err;
}

// floats of the backward's scratch: the chain pass's warp sums (3 a row and
// warp of lanes) and the rows pass's output (3 a row).
extern "C" long long slstm_bwd_scratch_floats(int B, int S, int H, int hd) {
  return (3LL * ((hd + 31) / 32) + 3) * B * S * H;
}

// The backward on the forward's saved c and n: dz, di, df, do, each skipped
// where its pointer is null.  scratch: slstm_bwd_scratch_floats of them,
// needed where di, df or do is asked for.  strides: (batch, step, head) of z,
// i, f, o and dy, 15 values.  Returns a cudaError_t.
extern "C" int slstm_bwd_launch(const void* z, const void* i, const void* f, const void* o,
                                const void* dy, const void* c, const void* n,
                                const long long* strides, void* dz, void* di, void* df,
                                void* d_o, void* scratch, int B, int S, int H, int hd,
                                void* stream) {
  const bool gates = di != nullptr || df != nullptr, sums = gates || d_o != nullptr;
  if (bad_dims(B, S, H, hd) || (sums && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = read_strides(strides, 5);
  const int rows = B * S * H, blocks = (hd + 31) / 32;
  float* part = sums ? static_cast<float*>(scratch) : nullptr;
  float* out = gates ? part + 3LL * blocks * rows : nullptr;
  const float *fp = static_cast<const float*>(f), *nf = static_cast<const float*>(n),
              *of = static_cast<const float*>(o);
  if (dz == nullptr && !sums) return (int)cudaSuccess;
  cudaError_t err = chain_opt_in();
  if (err != cudaSuccess) return (int)err;
  err = launch(slstm_bwd_chain_kernel, dim3(B * H, blocks), 32 * (1 + kHelpers), kChainSmem,
               false, s, static_cast<const float*>(dy), static_cast<const float*>(z),
               static_cast<const float*>(c), static_cast<const float*>(i), fp, of, nf, st,
               static_cast<float*>(dz), part, S, H, hd);
  if (err != cudaSuccess || !sums) return (int)err;
  err = launch(slstm_bwd_rows_kernel, dim3((rows + 255) / 256), 256, 0, true, s,
               static_cast<const float*>(part), nf, of, st, static_cast<float*>(d_o), out, S, H,
               blocks, rows);
  if (err != cudaSuccess || !gates) return (int)err;
  return (int)launch(slstm_bwd_dn_kernel, dim3(B * H), 32, 0, true, s,
                     static_cast<const float*>(out), fp, nf, st, static_cast<float*>(di),
                     static_cast<float*>(df), S, H, rows);
}
