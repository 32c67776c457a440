// Per-pattern tree log likelihoods and branch-length gradient rows over the
// paired-slot tape, with every partial on chip.
//
// Replaces bito_tpu/treelike/pallas_paired.py::_grad_kernel (the Pallas TPU
// kernel behind paired_ll_and_gradients), as paired_grad.cu does, and
// computes the same numbers: the postorder and root log likelihood of
// paired_ll_onchip.cu, then the outside pass in reverse tape order.  Op m
// takes its outside value (pi at the root op), forms both children's
// outside vectors o0 = up * ev1 and o1 = up * ev0, rescales them, and
// writes for each child the weighted gradient row
//     w * sum_ca prop*o*(dP p) / sum_ca prop*o*(P p)
// to row post_src[m, j], then the child's up value P^T o where the child's
// own op reads it.  Summing the rows over patterns is left to the caller:
// no float atomics, the same result on every run.
//
// The rows: op m's output lives in shared-memory row m of its pattern
// (indexed by the op that produced it, through the child tape of
// treelike/paired.py child_tape), and the outside pass writes op m's
// outside value over it in place, once the consumer of m has read the
// partial: the paired layout's own trick, indexed by producer op.  A
// thread owns its lane's slice of every row, so the read and the overwrite
// are ordered by its own program order.  Tips are read in place from
// tips[t, :, s] (L2-resident), prefetched into registers one op ahead; no
// up value is stored for a tip, which no op reads.
//
// What bounds paired_grad.cu on the H100, and what this body does about
// it (csrc/onchip.cuh has the layout):
//   - its partials live in device memory and the outside pass reads three
//     64-byte columns and writes two per op; at 255 registers and a spill,
//     2 blocks of 128 threads fit an SM, and each warp waits on device
//     memory.  Here every row is in shared memory: M rows of C*16 bytes a
//     pattern.
//   - a rate category is a lane (G lanes a pattern), so a thread holds 4
//     states of a few vectors; __shfl_xor_sync takes the rescale max, the
//     gradient's sums over categories and the root LL.
//   - an op rescales by a power of two, 4 exact multiplies a lane and no
//     divide; the outside pass needs no log scale (each gradient row is a
//     ratio), the postorder only a running integer sum of exponents.
//   - P and dP: staged in shared memory once per block (ring = false) or
//     double-buffered one op ahead (ring = true), by cp.async; paired.py's
//     onchip_plan picks.
// What bounds it now, on the H100: instruction issue at an occupancy set
// by shared memory (one block of 15 warps an SM at the flagship, 100
// registers, no spill).  Beside the f32 FMAs, a warp issues the tape's and
// the tips' loads and their address arithmetic, the matrix rows' shared-
// memory loads and the shuffles; it runs at about a tenth of the FMA
// bound (PERF.md, chip runs).  Larger trees hold more rows a pattern and
// fewer warps an SM; below three warps paired_grad.cu is the faster, and
// paired.py's onchip_plan hands the tree to it (about 150 taxa at C=4).
//
// Instantiations: <C, ring> for C = 1..8, and for 9..32 categories one a
// lane count (G = 16 or 32) and staging, with the count read at run time.
// At G = 32 a pattern is a whole warp, and at G >= 16 the tree's P and dP
// staged at once take 64 G bytes a matrix (about 104 KB at the flagship
// and G = 16), so the plan takes the ring sooner.  Past 32 categories one
// a K = ceil(C / 32) of 2..4 (C = 33..128), on 32 lanes and the ring: lane
// g holds categories g + 32 k as K float4s in registers, a row is K float4s
// a thread, and an op takes one pass over the places.  The postorder keeps
// the K products in registers for the rescale's max and stores them
// scaled, once; the outside pass forms each place's o0 and o1 once, keeps
// them in registers, sums the gradient's terms as it goes, and after the
// warp's max writes the scaled o's P^T o.  Its row is K times longer, so
// fewer warps fit (at the flagship 7, 4 and 3 at K = 2, 3, 4).  This
// body also takes the chunked tape (walked one grid op at a time) and the
// per-node ops turned into a paired tape, for the chunked and per-node
// grad kernels where their own on-chip bodies get no plan (chunked.py,
// pernode.py), with gradient rows by node id through post_src.
#include "onchip.cuh"

namespace {

using onchip::A;

// The postorder's product of op m at place k: P p of both children, where
// place k of a child op's output is row c * K + k.
template <int GK, int K>
__device__ __forceinline__ float4 product(const float4* my, int threads,
                                          const onchip::Op& op, float4 l0,
                                          float4 l1, const float4* M0,
                                          const float4* M1, int k) {
  using namespace onchip;
  const float4 p0 = op.c0 >= 0 ? my[(op.c0 * K + k) * threads] : l0;
  const float4 p1 = op.c1 >= 0 ? my[(op.c1 * K + k) * threads] : l1;
  return mul(evolve<GK>(M0 + 32 * k, p0), evolve<GK>(M1 + 32 * k, p1));
}

// G lanes a pattern; CF the category count where it is fixed at compile
// time (1..8), else 0 and the run-time count C_run (G / 2 < C_run <= G, or
// past 32 G (K - 1) < C_run <= G K); K the categories a lane (1, or 2..4
// at G = 32 on the ring).
template <int G, int CF, bool kRing, int K>
__global__ void __launch_bounds__(K == 1 ? onchip::kMaxThreads
                                         : onchip::kMaxThreadsK)
paired_grad_onchip_kernel(const int* __restrict__ post_dst,   // [B, M]
                          const int* __restrict__ child,      // [B, M, 2]
                          const int* __restrict__ post_src,   // [B, M, 2]
                          const int* __restrict__ post_e,     // [B, M, 2]
                          const float* __restrict__ P,   // [B, N1, C, 4, 4]
                          const float* __restrict__ dP,  // [B, N1, C, 4, 4]
                          const float* __restrict__ tips,     // [T, 4, S]
                          const float* __restrict__ pi,       // [4]
                          const float* __restrict__ props,    // [C]
                          const float* __restrict__ weights,  // [S]
                          float* __restrict__ ll_rows,        // [B, S]
                          float* __restrict__ grad_rows,      // [B, N1, S]
                          int M, int T, int N1, int S, int rows,
                          int C_run) {
  using namespace onchip;
  static_assert(K == 1 || (G == 32 && kRing && CF == 0),
                "K categories a lane take 32 lanes and the ring");
  constexpr int GK = G * K;  // a matrix row's float4s: every category
  const int C = CF > 0 ? CF : C_run;
  extern __shared__ float4 smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int b = blockIdx.y;
  const int s_raw = blockIdx.x * (threads / G) + tid / G;
  // A thread past the last pattern computes a copy of it and stores
  // nothing: every lane of the warp takes part in the shuffles.
  const int s = min(s_raw, S - 1);
  const float* const tips_s = tips + s;
  const bool writer = g == 0 && s_raw < S;
  float4* const my = smem + tid;  // place k of row r at my[(r K + k) threads]
  float4* const mats = smem + static_cast<size_t>(rows) * K * threads;
  const int nslots = kRing ? 8 : 2 * N1;
  int* const t_dst = reinterpret_cast<int*>(mats + nslots * GK * A);
  int* const t_child = t_dst + M;
  int* const t_e = t_child + 2 * M;
  int* const t_src = t_e + 2 * M;
  const size_t tree_mats = static_cast<size_t>(b) * N1 * C * A * A;
  const float* const P_b = P + tree_mats;
  const float* const dP_b = dP + tree_mats;

  for (int i = tid; i < M; i += threads)
    t_dst[i] = post_dst[static_cast<size_t>(b) * M + i];
  for (int i = tid; i < 2 * M; i += threads) {
    const size_t k = static_cast<size_t>(b) * 2 * M + i;
    t_child[i] = child[k];
    t_e[i] = post_e[k];
    t_src[i] = post_src[k];
  }
  zero_idle<GK>(mats, nslots, C);
  if (!kRing) stage_all<GK>(mats, P_b, dP_b, N1, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int root = 2 * M, trash = 2 * M + 1;
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  float prop[K];  // place k's proportion, 0 where it is idle
#pragma unroll
  for (int k = 0; k < K; ++k)
    prop[k] = g + 32 * k < C ? __ldg(props + g + 32 * k) : 0.f;

  // -- postorder: op m's output to row m ------------------------------------
  int lsc = 0;  // the running log scale, in powers of two
  if (kRing) {
    stage_op<GK>(mats, 0, t_e[0], t_e[1], P_b, nullptr, C);
    cp_async_commit();
  }
  // Op m's tape and leaves are read one op ahead, before op m - 1's
  // stores, so their latency overlaps its work.
  Op op = op_at(t_dst, t_child, t_e, 0);
  float4 l0 = leaf_value(op.c0, T, S, tips_s);
  float4 l1 = leaf_value(op.c1, T, S, tips_s);
  for (int m = 0; m < M; ++m) {
    const int mn = min(m + 1, M - 1);
    const Op nx = op_at(t_dst, t_child, t_e, mn);
    const float4 n0 = leaf_value(nx.c0, T, S, tips_s);
    const float4 n1 = leaf_value(nx.c1, T, S, tips_s);
    const float4* M0;
    const float4* M1;
    if (kRing) {
      if (m + 1 < M) stage_op<GK>(mats, 4 * (mn & 1), nx.e0, nx.e1, P_b,
                                  nullptr, C);
      cp_async_commit();
      cp_async_wait<1>();  // op m's matrices have landed
      __syncthreads();
      M0 = lane_rows<GK>(mats, 4 * (m & 1), g);
      M1 = lane_rows<GK>(mats, 4 * (m & 1) + 1, g);
    } else {
      M0 = lane_rows<GK>(mats, op.e0, g);
      M1 = lane_rows<GK>(mats, op.e1, g);
    }
    if (op.dst != trash) {
      // One pass over the lane's places: the K products in registers, the
      // largest entry over them, then the warp's.
      float4 prod[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        prod[k] = product<GK, K>(my, threads, op, l0, l1, M0, M1, k);
      float mx = max4(prod[0]);
#pragma unroll
      for (int k = 1; k < K; ++k) mx = fmaxf(mx, max4(prod[k]));
      const int ex = scale_exponent(group_max<G>(mx));
      const float sc = pow2_neg(ex);
      lsc += ex;
      if (op.dst == root) {
        float site = prop[0] * dot(pi4, scale(prod[0], sc));
#pragma unroll
        for (int k = 1; k < K; ++k)
          site += prop[k] * dot(pi4, scale(prod[k], sc));
        site = group_sum<G>(site);
        if (writer)
          ll_rows[static_cast<size_t>(b) * S + s_raw] = logf(site) + lsc * kLn2;
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k)
          my[(m * K + k) * threads] = scale(prod[k], sc);
      }
    }
    if (kRing) __syncthreads();  // op m's buffer is refilled for op m + 2
    op = nx;
    l0 = n0;
    l1 = n1;
  }

  // -- outside pass, in reverse: op m's outside value in row m --------------
  const float w = __ldg(weights + s);
  float* const grad_b = grad_rows + static_cast<size_t>(b) * N1 * S + s_raw;
  if (kRing) {
    stage_op<GK>(mats, 0, t_e[2 * M - 2], t_e[2 * M - 1], P_b, dP_b, C);
    cp_async_commit();
  }
  op = op_at(t_dst, t_child, t_e, M - 1);
  l0 = leaf_value(op.c0, T, S, tips_s);
  l1 = leaf_value(op.c1, T, S, tips_s);
  for (int m = M - 1, j = 0; m >= 0; --m, ++j) {
    const int mn = max(m - 1, 0);
    const Op nx = op_at(t_dst, t_child, t_e, mn);
    const float4 n0 = leaf_value(nx.c0, T, S, tips_s);
    const float4 n1 = leaf_value(nx.c1, T, S, tips_s);
    const int src0 = t_src[2 * m], src1 = t_src[2 * m + 1];
    const float4 *M0, *M1, *dM0, *dM1;
    if (kRing) {
      if (m > 0) stage_op<GK>(mats, 4 * ((j + 1) & 1), nx.e0, nx.e1, P_b,
                              dP_b, C);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      M0 = lane_rows<GK>(mats, 4 * (j & 1), g);
      M1 = lane_rows<GK>(mats, 4 * (j & 1) + 1, g);
      dM0 = lane_rows<GK>(mats, 4 * (j & 1) + 2, g);
      dM1 = lane_rows<GK>(mats, 4 * (j & 1) + 3, g);
    } else {
      M0 = lane_rows<GK>(mats, op.e0, g);
      M1 = lane_rows<GK>(mats, op.e1, g);
      dM0 = lane_rows<GK>(mats, N1 + op.e0, g);
      dM1 = lane_rows<GK>(mats, N1 + op.e1, g);
    }
    if (op.dst == trash) {
      // a padded op: nothing to do
    } else if constexpr (K == 1) {
      const float4 up = op.dst == root ? pi4 : my[m * threads];
      const float4 p0 = op.c0 >= 0 ? my[op.c0 * threads] : l0;
      const float4 p1 = op.c1 >= 0 ? my[op.c1 * threads] : l1;
      const float4 ev0 = evolve<G>(M0, p0), ev1 = evolve<G>(M1, p1);
      float4 o0 = mul(up, ev1), o1 = mul(up, ev0);
      const float inv = pow2_neg(
          scale_exponent(group_max<G>(fmaxf(max4(o0), max4(o1)))));
      o0 = scale(o0, inv);
      o1 = scale(o1, inv);
      const float n0s = group_sum<G>(prop[0] * dot(o0, evolve<G>(dM0, p0)));
      const float n1s = group_sum<G>(prop[0] * dot(o1, evolve<G>(dM1, p1)));
      float d0 = group_sum<G>(prop[0] * dot(o0, ev0));
      float d1 = group_sum<G>(prop[0] * dot(o1, ev1));
      if (writer) {
        d0 = d0 > 0.f ? d0 : 1.f;
        d1 = d1 > 0.f ? d1 : 1.f;
        grad_b[static_cast<size_t>(src0) * S] = w * __fdividef(n0s, d0);
        grad_b[static_cast<size_t>(src1) * S] = w * __fdividef(n1s, d1);
      }
      // Each child op's outside value, over its partial, which this op was
      // the last to read.
      if (op.c0 >= 0) my[op.c0 * threads] = evolve_t<G>(M0, o0);
      if (op.c1 >= 0) my[op.c1 * threads] = evolve_t<G>(M1, o1);
    } else {
      // One pass over the lane's places: each place's o0 = up ev1 and o1 =
      // up ev0 formed once and kept in registers, with the gradient's sums
      // over them taken before the rescale.  The rescale is a power of two,
      // so scaling the sums after them is exact (as the K = 1 body's
      // scaling before them is), and the ratio does not depend on it.
      float4 o0[K], o1[K];
      float mx = 0.f, n0s = 0.f, n1s = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 up = op.dst == root ? pi4 : my[(m * K + k) * threads];
        const float4 p0 = op.c0 >= 0 ? my[(op.c0 * K + k) * threads] : l0;
        const float4 p1 = op.c1 >= 0 ? my[(op.c1 * K + k) * threads] : l1;
        const float4 ev0 = evolve<GK>(M0 + 32 * k, p0);
        const float4 ev1 = evolve<GK>(M1 + 32 * k, p1);
        o0[k] = mul(up, ev1);
        o1[k] = mul(up, ev0);
        mx = fmaxf(mx, fmaxf(max4(o0[k]), max4(o1[k])));
        n0s += prop[k] * dot(o0[k], evolve<GK>(dM0 + 32 * k, p0));
        n1s += prop[k] * dot(o1[k], evolve<GK>(dM1 + 32 * k, p1));
        d0 += prop[k] * dot(o0[k], ev0);
        d1 += prop[k] * dot(o1[k], ev1);
      }
      const float inv = pow2_neg(scale_exponent(group_max<G>(mx)));
      n0s = group_sum<G>(n0s * inv);
      n1s = group_sum<G>(n1s * inv);
      d0 = group_sum<G>(d0 * inv);
      d1 = group_sum<G>(d1 * inv);
      if (writer) {
        d0 = d0 > 0.f ? d0 : 1.f;
        d1 = d1 > 0.f ? d1 : 1.f;
        grad_b[static_cast<size_t>(src0) * S] = w * __fdividef(n0s, d0);
        grad_b[static_cast<size_t>(src1) * S] = w * __fdividef(n1s, d1);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (op.c0 >= 0)
          my[(op.c0 * K + k) * threads] =
              evolve_t<GK>(M0 + 32 * k, scale(o0[k], inv));
        if (op.c1 >= 0)
          my[(op.c1 * K + k) * threads] =
              evolve_t<GK>(M1 + 32 * k, scale(o1[k], inv));
      }
    }
    if (kRing) __syncthreads();
    op = nx;
    l0 = n0;
    l1 = n1;
  }
}

template <int G, int CF, bool kRing, int K>
cudaError_t launch(const int* post_dst, const int* child, const int* post_src,
                   const int* post_e, const float* P, const float* dP,
                   const float* tips, const float* pi, const float* props,
                   const float* weights, float* ll_rows, float* grad_rows,
                   int B, int M, int T, int N1, int C, int S, int rows,
                   int cols, cudaStream_t st) {
  const int below = K == 1 ? G / 2 : G * (K - 1);  // the counts it takes
  if (CF == 0 && (C <= below || C > G * K)) return cudaErrorInvalidValue;
  const int threads = cols * G;
  if (cols < 1 || threads % 32 ||
      threads > (K == 1 ? onchip::kMaxThreads : onchip::kMaxThreadsK))
    return cudaErrorInvalidValue;
  const size_t smem =
      onchip::smem_bytes(rows, threads, G, N1, 4, kRing, 7 * M, K);
  if (smem > onchip::kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      paired_grad_onchip_kernel<G, CF, kRing, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, onchip::kSmemMax);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + cols - 1) / cols, B);
  paired_grad_onchip_kernel<G, CF, kRing, K><<<grid, threads, smem, st>>>(
      post_dst, child, post_src, post_e, P, dP, tips, pi, props, weights,
      ll_rows, grad_rows, M, T, N1, S, rows, C);
  return cudaGetLastError();
}

}  // namespace

// `rows` is one more than the last op that stores a row (paired.py
// grad_rows_needed); `cols` patterns per block (a whole number of warps);
// `ring` the staging (past 32 categories the ring only).  Gradient rows
// that no op writes (the root's, the trash row) are left as they are.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bito_paired_grad_onchip(
    const int* post_dst, const int* child, const int* post_src,
    const int* post_e, const float* P, const float* dP, const float* tips,
    const float* pi, const float* props, const float* weights,
    float* ll_rows, float* grad_rows, int B, int M, int T, int N1, int C,
    int S, int rows, int cols, int ring, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || M <= 0 || rows < 1 || rows > M)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ONCHIP_LAUNCH_GRAD_AT(GV, CV, RV, KV)                                \
  return static_cast<int>(launch<GV, CV, RV, KV>(                            \
      post_dst, child, post_src, post_e, P, dP, tips, pi, props, weights,    \
      ll_rows, grad_rows, B, M, T, N1, C, S, rows, cols, st))
#define ONCHIP_LAUNCH_GRAD(CV, RV) \
  ONCHIP_LAUNCH_GRAD_AT(onchip::Lanes<CV>::G, CV, RV, 1)
#define ONCHIP_LAUNCH_GRAD_WIDE(GV, RV) ONCHIP_LAUNCH_GRAD_AT(GV, 0, RV, 1)
#define ONCHIP_LAUNCH_GRAD_K(KV) ONCHIP_LAUNCH_GRAD_AT(32, 0, true, KV)
  if (C > 32) {
    ONCHIP_DISPATCH_K(C, ring != 0, ONCHIP_LAUNCH_GRAD_K)
  }
  if (C > 8) {
    ONCHIP_DISPATCH_WIDE(C, ring != 0, ONCHIP_LAUNCH_GRAD_WIDE)
  }
  ONCHIP_DISPATCH(C, ring != 0, ONCHIP_LAUNCH_GRAD)
#undef ONCHIP_LAUNCH_GRAD_K
#undef ONCHIP_LAUNCH_GRAD_WIDE
#undef ONCHIP_LAUNCH_GRAD
#undef ONCHIP_LAUNCH_GRAD_AT
  return cudaErrorInvalidValue;
}
