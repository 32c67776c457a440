// Per-pattern tree log likelihoods and branch-length gradient rows over the
// paired-slot tape, for trees past the on-chip grad body's limit: a bounded
// number of shared-memory rows a pattern, the rest recomputed.
//
// Replaces, for those trees, bito_tpu/treelike/pallas_paired.py::
// _grad_kernel as paired_grad.cu did, and computes the same numbers as
// paired_grad_onchip.cu, op for op.  That body keeps a shared-memory row
// an op, since the outside pass reads every postorder partial: at 500
// taxa 32 KB a pattern, so past about 144 taxa too few warps fit and
// paired_grad.cu took the tree.  That body is bound by device memory: one
// thread a (tree, pattern) runs the whole tape over slots in device memory
// (about 59 GB a call at rbcL 500's shape), at 255 registers and a spill.
// The FLOPs are not the limit (the least time is about 3.5% of its time).
//
// This body trades FLOPs for rows.  treelike/paired.py ckpt_schedule cuts
// each tree at its largest clades of at most CKPT_OPS ops; the ops above
// the cuts and the clades' roots are checkpoints, whose partials go to a
// tier in device memory.  One schedule a tree: the postorder over every op
// (a clade's ops together, in on-chip rows), then the outside pass over
// the ops above the cuts in reverse, each cut clade's partials recomputed
// from its tips right after the op above it, then the clade's own outside
// pass.  Each entry names its operands and destinations: an on-chip row, a
// tier slot, a tip, all ones or pi (the root's outside value); the kernel
// interprets it and decides nothing.  A pattern's rows are the largest
// clade's and three more (18 at CKPT_OPS = 16: paired.ckpt_plan gives a
// block 16 warps), whatever the tree's size.
//
// The layout is the on-chip body's (csrc/onchip.cuh): a block takes one
// tree and a tile of patterns, a category a lane (G lanes a pattern), a
// float4 of 4 states a lane, a thread's rows its own slices of shared
// memory; power-of-two rescales, shuffles for the max and the sums over
// categories; no float atomics (the caller sums the gradient rows over
// patterns).  Each warp runs the schedule on its own: its own ring of two
// buffers of one entry's P (and dP), filled by its lanes one entry ahead
// by cp.async, and __syncwarp in place of block barriers (a ring a block,
// with two barriers an entry, took 32.1 ms a call at rbcL 500's shape
// against 26.7 for a ring a warp, at 32 ops a clade).  An entry's tier
// and tip operands are loaded one entry ahead, while the entry before it
// runs: the schedule never has an entry read a tier slot that the entry
// just before it writes (such a value is also written to a forwarding
// row).  The tier is float4 [B, slots, Sp, G], a lane's 16 bytes beside
// its neighbours' for coalesced loads; every thread of the grid owns its
// slices (Sp is the grid's patterns), so threads past the last pattern,
// which compute a copy of it for the shuffles, store only into their own.
// A recomputed partial is the first pass's bit for bit: the same code on
// the same operands.
//
// What bounds it, on the H100 (PERF.md): the latency of a warp's entry.
// At 128 registers a block holds 16 warps, one block an SM, and an entry
// takes a warp about 1 us whatever the warps, so time goes as 1 / warps;
// with the tier's traffic or the staging taken out (each alone, results
// wrong) the time moved under 1%, and with every operand fetch taken out
// 2.5%.  At rbcL 500's shape it takes about half paired_grad.cu's time.
//
// Instantiations: C = 1..8, one a category count (G = Lanes<C>::G), the
// ring only.
#include <climits>

#include "onchip.cuh"

namespace {

using onchip::A;

// Codes of treelike/paired.py: an operand is a row (0 <= code < kTier), a
// tier slot (code - kTier), a tip (-1 - t), all ones (kOnes) or pi (kPi);
// a destination a row, a tier slot, or negative (not stored).
constexpr int kTier = 1 << 24;
constexpr int kPi = INT_MIN + 1;
constexpr int kPost = 1, kRoot = 2, kOut = 3;  // entry kinds (0: padding)

// One entry: kind, e0 | e1 << 16, a0, a1, a2, d0, d1, src0 | src1 << 16,
// each 16-bit half unsigned (read with an unsigned shift: an edge or row
// of 32768 or more sets the packed int's sign bit).
struct Entry {
  int kind, e01, a0, a1, a2, d0, d1, src01;
};

__device__ __forceinline__ Entry entry_at(const int4* __restrict__ sched,
                                          int i) {
  const int4 lo = __ldg(sched + 2 * i), hi = __ldg(sched + 2 * i + 1);
  return Entry{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
}

__device__ __forceinline__ bool is_row(int code) {
  return code >= 0 && code < kTier;
}

// An operand that is not a row, loaded ahead: a tier slot, pi, a tip or
// all ones (a row code reads as ones here; the row is read at the entry).
__device__ __forceinline__ float4 fetch(int code, const float4* tier_t,
                                        int stride, float4 pi4, int T, int S,
                                        const float* tips_s) {
  if (code >= kTier) return tier_t[(code - kTier) * stride];
  if (code == kPi) return pi4;
  return onchip::leaf_value(code, T, S, tips_s);
}

__device__ __forceinline__ void put(int code, float4 v, float4* my,
                                    int threads, float4* tier_t, int stride) {
  if (code >= kTier)
    tier_t[(code - kTier) * stride] = v;
  else if (code >= 0)
    my[code * threads] = v;
}

// A lane's share of staging one entry's matrices into the warp's ring:
// the 16-byte rows i = lane, lane + 32, ... of P (both children, k = 0, 1)
// and dP (k = 2, 3), row i = (k, category c, row a).  The offsets are the
// lane's alone, so they are formed once.
template <int G, int C>
struct Stager {
  static constexpr int kPer = C * A;              // a matrix's rows
  static constexpr int kCopies = (4 * kPer + 31) / 32;
  int src[kCopies];  // c * 16 + a * 4 within edge e's [C, 4, 4] block
  int dst[kCopies];  // (k * A + a) * G + c within a buffer
  int k[kCopies];

  __device__ __forceinline__ explicit Stager(int lane) {
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int i = lane + 32 * j, r = i % kPer;
      const int c = r / A, a = r % A;
      k[j] = i / kPer;
      src[j] = (c * A + a) * A;
      dst[j] = (k[j] * A + a) * G + c;
    }
  }

  // Stage entry `e`'s P (and, for an outside entry, dP) into buffer
  // `half` of `ring` by cp.async.  The caller commits.
  __device__ __forceinline__ void stage(float4* ring, int half, int kind,
                                        int e01, const float* P_b,
                                        const float* dP_b) const {
    const int n = kind == kOut ? 4 : 2;  // an outside entry: dP too
    const int edge[2] = {(e01 & 0xffff) * kPer * A,
                         static_cast<int>(static_cast<unsigned>(e01) >> 16) *
                             kPer * A};
    float4* const buf = ring + half * 4 * A * G;
#pragma unroll
    for (int j = 0; j < kCopies; ++j)
      if (k[j] < n)
        onchip::cp_async16(buf + dst[j],
                           (k[j] < 2 ? P_b : dP_b) + edge[k[j] & 1] + src[j]);
  }
};

template <int C>
__global__ void __launch_bounds__(onchip::kMaxThreads)
paired_grad_ckpt_kernel(const int* __restrict__ sched,   // [B, L, 8]
                        const float* __restrict__ P,     // [B, N1, C, 4, 4]
                        const float* __restrict__ dP,    // [B, N1, C, 4, 4]
                        const float* __restrict__ tips,  // [T, 4, S]
                        const float* __restrict__ pi,    // [4]
                        const float* __restrict__ props,    // [C]
                        const float* __restrict__ weights,  // [S]
                        float4* tier,  // [B, slots, Sp, G]
                        float* __restrict__ ll_rows,    // [B, S]
                        float* __restrict__ grad_rows,  // [B, N1, S]
                        int L, int T, int N1, int S, int slots, int rows) {
  using namespace onchip;
  constexpr int G = Lanes<C>::G;
  extern __shared__ float4 smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int b = blockIdx.y;
  const int s_raw = blockIdx.x * (threads / G) + tid / G;
  const int s = min(s_raw, S - 1);
  const float* const tips_s = tips + s;
  const bool writer = g == 0 && s_raw < S;
  const int lane = tid % 32;
  float4* const my = smem + tid;  // row r at my[r * threads]
  float4* const mats = smem + static_cast<size_t>(rows) * threads;
  // this warp's ring: two buffers of one entry's P and dP [4][A][G]
  float4* const ring = mats + (tid / 32) * 8 * A * G;
  const int Sp = gridDim.x * (threads / G);
  const int stride = Sp * G;  // a tier slot's float4s
  float4* const tier_t =
      tier + (static_cast<size_t>(b) * slots * Sp + s_raw) * G + g;
  const Stager<G, C> stager(lane);
  const int4* const sched_b =
      reinterpret_cast<const int4*>(sched) + static_cast<size_t>(b) * L * 2;
  const size_t tree_mats = static_cast<size_t>(b) * N1 * C * A * A;
  const float* const P_b = P + tree_mats;
  const float* const dP_b = dP + tree_mats;

  zero_idle<G>(mats, 8 * (threads / 32), C);
  __syncthreads();  // the one barrier: warps run the schedule on their own
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float prop = g < C ? __ldg(props + g) : 0.f;
  const float w = __ldg(weights + s);
  float* const grad_b = grad_rows + static_cast<size_t>(b) * N1 * S + s_raw;

  Entry cur = entry_at(sched_b, 0);
  stager.stage(ring, 0, cur.kind, cur.e01, P_b, dP_b);
  cp_async_commit();
  float4 q0 = fetch(cur.a0, tier_t, stride, pi4, T, S, tips_s);
  float4 q1 = fetch(cur.a1, tier_t, stride, pi4, T, S, tips_s);
  float4 q2 = fetch(cur.a2, tier_t, stride, pi4, T, S, tips_s);
  Entry nx = entry_at(sched_b, min(1, L - 1));
  int lsc = 0;  // the running log scale, in powers of two
  for (int i = 0; i < L; ++i) {
    if (i + 1 < L) stager.stage(ring, (i + 1) & 1, nx.kind, nx.e01, P_b, dP_b);
    cp_async_commit();
    // The next entry's tier and tip operands, and the entry after it,
    // before this entry's stores: their latency overlaps its work.
    const float4 n0 = fetch(nx.a0, tier_t, stride, pi4, T, S, tips_s);
    const float4 n1 = fetch(nx.a1, tier_t, stride, pi4, T, S, tips_s);
    const float4 n2 = fetch(nx.a2, tier_t, stride, pi4, T, S, tips_s);
    const Entry nn = entry_at(sched_b, min(i + 2, L - 1));
    cp_async_wait<1>();  // entry i's matrices have landed
    __syncwarp();
    const float4* const M0 = lane_rows<G>(ring, 4 * (i & 1), g);
    const float4* const M1 = M0 + A * G;
    const float4 p0 = is_row(cur.a0) ? my[cur.a0 * threads] : q0;
    const float4 p1 = is_row(cur.a1) ? my[cur.a1 * threads] : q1;
    if (cur.kind == kPost || cur.kind == kRoot) {
      const float4 prod = mul(evolve<G>(M0, p0), evolve<G>(M1, p1));
      const int ex = scale_exponent(group_max<G>(max4(prod)));
      const float4 scaled = scale(prod, pow2_neg(ex));
      lsc += ex;
      if (cur.kind == kRoot) {
        const float site = group_sum<G>(prop * dot(pi4, scaled));
        if (writer)
          ll_rows[static_cast<size_t>(b) * S + s_raw] = logf(site) + lsc * kLn2;
      } else {
        put(cur.d0, scaled, my, threads, tier_t, stride);
        put(cur.d1, scaled, my, threads, tier_t, stride);
      }
    } else if (cur.kind == kOut) {
      const float4* const dM0 = M1 + A * G;
      const float4* const dM1 = dM0 + A * G;
      const float4 up = is_row(cur.a2) ? my[cur.a2 * threads] : q2;
      const float4 ev0 = evolve<G>(M0, p0), ev1 = evolve<G>(M1, p1);
      float4 o0 = mul(up, ev1), o1 = mul(up, ev0);
      const float inv = pow2_neg(
          scale_exponent(group_max<G>(fmaxf(max4(o0), max4(o1)))));
      o0 = scale(o0, inv);
      o1 = scale(o1, inv);
      const float n0s = group_sum<G>(prop * dot(o0, evolve<G>(dM0, p0)));
      const float n1s = group_sum<G>(prop * dot(o1, evolve<G>(dM1, p1)));
      float d0 = group_sum<G>(prop * dot(o0, ev0));
      float d1 = group_sum<G>(prop * dot(o1, ev1));
      if (writer) {
        d0 = d0 > 0.f ? d0 : 1.f;
        d1 = d1 > 0.f ? d1 : 1.f;
        grad_b[static_cast<size_t>(cur.src01 & 0xffff) * S] =
            w * __fdividef(n0s, d0);
        grad_b[static_cast<size_t>(static_cast<unsigned>(cur.src01) >> 16) *
               S] =
            w * __fdividef(n1s, d1);
      }
      // Each child's outside value, where the child's own outside entry
      // reads it (over its partial, which this entry was the last to read).
      if (cur.d0 >= 0) put(cur.d0, evolve_t<G>(M0, o0), my, threads, tier_t,
                           stride);
      if (cur.d1 >= 0) put(cur.d1, evolve_t<G>(M1, o1), my, threads, tier_t,
                           stride);
    }
    __syncwarp();  // entry i's buffer is refilled for entry i + 2
    cur = nx;
    nx = nn;
    q0 = n0;
    q1 = n1;
    q2 = n2;
  }
}

template <int C>
cudaError_t launch(const int* sched, const float* P, const float* dP,
                   const float* tips, const float* pi, const float* props,
                   const float* weights, float* tier, float* ll_rows,
                   float* grad_rows, int B, int L, int T, int N1, int S,
                   int slots, int rows, int cols, cudaStream_t st) {
  constexpr int G = onchip::Lanes<C>::G;
  const int threads = cols * G;
  if (cols < 1 || threads % 32 || threads > onchip::kMaxThreads)
    return cudaErrorInvalidValue;
  // rows, then each warp's ring of one entry's P and dP; no tape in
  // shared memory
  const size_t smem = static_cast<size_t>(rows) * threads * 16 +
                      static_cast<size_t>(threads / 32) * 8 * A * G * 16;
  if (smem > onchip::kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      paired_grad_ckpt_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      onchip::kSmemMax);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + cols - 1) / cols, B);
  paired_grad_ckpt_kernel<C><<<grid, threads, smem, st>>>(
      sched, P, dP, tips, pi, props, weights,
      reinterpret_cast<float4*>(tier), ll_rows, grad_rows, L, T, N1, S,
      slots, rows);
  return cudaGetLastError();
}

}  // namespace

// `sched` [B, L, 8] int32 (16-byte aligned); `tier` float4 [B, slots, Sp,
// G] with Sp = S rounded up to `cols`; `rows` the rows a pattern the
// schedule names; `cols` patterns per block (a whole number of warps).
// Gradient rows that no entry writes are left as they are.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bito_paired_grad_ckpt(
    const int* sched, const float* P, const float* dP, const float* tips,
    const float* pi, const float* props, const float* weights, float* tier,
    float* ll_rows, float* grad_rows, int B, int L, int T, int N1, int C,
    int S, int slots, int rows, int cols, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || L <= 0 || slots < 1 || rows < 1 ||
      N1 > 65536)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CKPT_LAUNCH(CV)                                                      \
  case CV:                                                                   \
    return static_cast<int>(launch<CV>(sched, P, dP, tips, pi, props,        \
                                       weights, tier, ll_rows, grad_rows, B, \
                                       L, T, N1, S, slots, rows, cols, st))
  switch (C) {
    CKPT_LAUNCH(1);
    CKPT_LAUNCH(2);
    CKPT_LAUNCH(3);
    CKPT_LAUNCH(4);
    CKPT_LAUNCH(5);
    CKPT_LAUNCH(6);
    CKPT_LAUNCH(7);
    CKPT_LAUNCH(8);
    default:
      return cudaErrorInvalidValue;
  }
#undef CKPT_LAUNCH
}
