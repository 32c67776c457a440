// The on-chip LL body: per-pattern tree log likelihoods over a tape of the
// paired-slot layout, with every partial on chip.  A template, instantiated
// by paired_ll_onchip.cu (the shipping body: `launch` <C, kRing, 0, 0> for
// C = 1..8, `launch_wide` <G, kRing> for 9..32 categories on G = 16 or 32
// lanes, `launch_k` <K> for 33..128 on 32 lanes of K categories each and
// the ring) and by the perf lab's chunk_variant.cu (the knobs below).  What the body computes,
// for which TPU kernels, and why it is laid out so, is in the header of
// paired_ll_onchip.cu.
//
// The chunk lab's knobs (scripts/perf_chunk_lab.py:29-111), as template
// parameters; with both 0 the body is the shipping one:
//   MU      the op walk's trip count, fixed at compile time and fully
//           unrolled (unroll); 0 for a loop over the run-time count M.
//   KNOBS   a mask of
//     kNoRescale  no rescale: the running log scale stays 0 (norescale);
//     kNoTips     each leaf reads as all ones instead of tips[t, :, s]
//                 (notips);
//     kFixStore   op m's output row is m % rows, and a child op c is read
//                 from row c % rows, instead of the tape's rows by liveness
//                 (fixstore: no row lookups); the caller passes a `rows`
//                 for which that keeps every live output apart;
//     kNoDot      the evolve is skipped, so that P = I in effect, and the
//                 matrices are not staged (nodot; not a likelihood).
#pragma once

#include "onchip.cuh"

namespace paired_ll_onchip {

using onchip::A;

constexpr int kNoRescale = 1;
constexpr int kNoTips = 2;
constexpr int kFixStore = 4;
constexpr int kNoDot = 8;

// Arguments every instantiation refuses.
inline bool bad_args(int B, int M, int S, int rows) {
  return B <= 0 || B > 65535 || S <= 0 || M <= 0 || rows < 1 || rows > M;
}

// The kernel and its launcher have internal linkage: each source that
// includes this header compiles its own instantiations.
namespace {

template <int KNOBS>
__device__ __forceinline__ float4 leaf(int code, int T, int S,
                                       const float* __restrict__ tips_s) {
  if constexpr (KNOBS & kNoTips) return make_float4(1.f, 1.f, 1.f, 1.f);
  return onchip::leaf_value(code, T, S, tips_s);
}

template <int KNOBS>
__device__ __forceinline__ int row_of(int op, const int* t_row, int rows) {
  if constexpr (KNOBS & kFixStore) return op % rows;
  return t_row[op];
}

// G lanes a pattern; CF the category count where it is fixed at compile
// time (1..8), else 0 and the run-time count C_run (G / 2 < C_run <= G, or
// past 32 G (K - 1) < C_run <= G K); K the categories a lane (1, or 2..4
// at G = 32 on the ring with no knob): place k of lane g is category
// g + 32 k, and an op's K products stay in registers for the rescale.
template <int G, int CF, bool kRing, int MU, int KNOBS, int K = 1>
__global__ void __launch_bounds__(onchip::kMaxThreads)
paired_ll_onchip_kernel(const int* __restrict__ post_dst,  // [B, M]
                        const int* __restrict__ child,     // [B, M, 2]
                        const int* __restrict__ live_row,  // [B, M]
                        const int* __restrict__ post_e,    // [B, M, 2]
                        const float* __restrict__ P,       // [B, N1, C, 4, 4]
                        const float* __restrict__ tips,    // [T, 4, S]
                        const float* __restrict__ pi,      // [4]
                        const float* __restrict__ props,   // [C]
                        float* __restrict__ ll_rows,       // [B, S]
                        int M_run, int T, int N1, int S, int rows,
                        int C_run) {
  using namespace onchip;
  static_assert(K == 1 || (G == 32 && kRing && CF == 0 && KNOBS == 0),
                "K categories a lane take 32 lanes, the ring and no knob");
  constexpr int GK = G * K;  // a matrix row's float4s: every category
  const int C = CF > 0 ? CF : C_run;
  constexpr bool kDot = !(KNOBS & kNoDot);
  const int M = MU > 0 ? MU : M_run;
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
  float4* const my = smem + tid;  // place k of row r at my[(r K + k) threads]
  float4* const mats = smem + static_cast<size_t>(rows) * K * threads;
  const int nslots = kRing ? 4 : N1;
  int* const t_dst = reinterpret_cast<int*>(mats + nslots * GK * A);
  int* const t_child = t_dst + M;
  int* const t_e = t_child + 2 * M;
  int* const t_row = t_e + 2 * M;
  const float* const P_b = P + static_cast<size_t>(b) * N1 * C * A * A;

  for (int i = tid; i < M; i += threads) {
    t_dst[i] = post_dst[static_cast<size_t>(b) * M + i];
    t_row[i] = live_row[static_cast<size_t>(b) * M + i];
  }
  for (int i = tid; i < 2 * M; i += threads) {
    t_child[i] = child[static_cast<size_t>(b) * 2 * M + i];
    t_e[i] = post_e[static_cast<size_t>(b) * 2 * M + i];
  }
  if constexpr (kDot) {
    zero_idle<GK>(mats, nslots, C);
    if (!kRing) stage_all<GK>(mats, P_b, nullptr, N1, C);
  }
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
  int lsc = 0;  // the running log scale, in powers of two
  if (kRing && kDot) {
    stage_op<GK>(mats, 0, t_e[0], t_e[1], P_b, nullptr, C);
    cp_async_commit();
  }
  // Op m's tape, its children's rows and its leaves are read one op
  // ahead, before op m - 1's stores, so their latency overlaps its work.
  Op op = op_at(t_dst, t_child, t_e, 0);
  float4 l0 = leaf<KNOBS>(op.c0, T, S, tips_s);
  float4 l1 = leaf<KNOBS>(op.c1, T, S, tips_s);
  int r0 = op.c0 >= 0 ? row_of<KNOBS>(op.c0, t_row, rows) : 0;
  int r1 = op.c1 >= 0 ? row_of<KNOBS>(op.c1, t_row, rows) : 0;
  // One op of the walk; the walk is a loop over the run-time count M,
  // or with MU, fully unrolled over MU ops.
  const auto step = [&](const int m) {
    const int mn = min(m + 1, M - 1);
    const Op nx = op_at(t_dst, t_child, t_e, mn);
    const float4 n0 = leaf<KNOBS>(nx.c0, T, S, tips_s);
    const float4 n1 = leaf<KNOBS>(nx.c1, T, S, tips_s);
    const int nr0 = nx.c0 >= 0 ? row_of<KNOBS>(nx.c0, t_row, rows) : 0;
    const int nr1 = nx.c1 >= 0 ? row_of<KNOBS>(nx.c1, t_row, rows) : 0;
    const int out = row_of<KNOBS>(m, t_row, rows);
    const float4* M0 = nullptr;
    const float4* M1 = nullptr;
    if constexpr (kDot) {
      if (kRing) {
        if (m + 1 < M) stage_op<GK>(mats, 2 * (mn & 1), nx.e0, nx.e1, P_b,
                                    nullptr, C);
        cp_async_commit();
        cp_async_wait<1>();  // op m's matrices have landed
        __syncthreads();
        M0 = lane_rows<GK>(mats, 2 * (m & 1), g);
        M1 = lane_rows<GK>(mats, 2 * (m & 1) + 1, g);
      } else {
        M0 = lane_rows<GK>(mats, op.e0, g);
        M1 = lane_rows<GK>(mats, op.e1, g);
      }
    }
    if (op.dst != trash) {
      // One pass over the lane's places: the K products in registers, the
      // largest entry over them, then the warp's.
      float4 prod[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 p0 = op.c0 >= 0 ? my[(r0 * K + k) * threads] : l0;
        const float4 p1 = op.c1 >= 0 ? my[(r1 * K + k) * threads] : l1;
        if constexpr (kDot) {
          prod[k] = mul(evolve<GK>(M0 + 32 * k, p0),
                        evolve<GK>(M1 + 32 * k, p1));
        } else {
          prod[k] = mul(p0, p1);
        }
      }
      if constexpr (!(KNOBS & kNoRescale)) {
        float mx = max4(prod[0]);
#pragma unroll
        for (int k = 1; k < K; ++k) mx = fmaxf(mx, max4(prod[k]));
        const int ex = scale_exponent(group_max<G>(mx));
#pragma unroll
        for (int k = 0; k < K; ++k) prod[k] = scale(prod[k], pow2_neg(ex));
        lsc += ex;
      }
      if (op.dst == root) {
        float site = prop[0] * dot(pi4, prod[0]);
#pragma unroll
        for (int k = 1; k < K; ++k) site += prop[k] * dot(pi4, prod[k]);
        site = group_sum<G>(site);
        if (g == 0 && s_raw < S)
          ll_rows[static_cast<size_t>(b) * S + s_raw] = logf(site) + lsc * kLn2;
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) my[(out * K + k) * threads] = prod[k];
      }
    }
    if (kRing && kDot) __syncthreads();  // op m's buffer is refilled for m + 2
    op = nx;
    l0 = n0;
    l1 = n1;
    r0 = nr0;
    r1 = nr1;
  };
  if constexpr (MU > 0) {
#pragma unroll
    for (int m = 0; m < MU; ++m) step(m);
  } else {
    for (int m = 0; m < M; ++m) step(m);
  }
}

template <int G, int CF, bool kRing, int MU, int KNOBS, int K = 1>
cudaError_t launch_body(const int* post_dst, const int* child,
                        const int* live_row, const int* post_e,
                        const float* P, const float* tips, const float* pi,
                        const float* props, float* ll_rows, int B, int M,
                        int T, int N1, int C, int S, int rows, int cols,
                        cudaStream_t st) {
  const int threads = cols * G;
  if (cols < 1 || threads > onchip::kMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  if (MU > 0 && M != MU) return cudaErrorInvalidValue;
  const size_t smem =
      onchip::smem_bytes(rows, threads, G, N1, 2, kRing, 6 * M, K);
  if (smem > onchip::kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      paired_ll_onchip_kernel<G, CF, kRing, MU, KNOBS, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, onchip::kSmemMax);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + cols - 1) / cols, B);
  paired_ll_onchip_kernel<G, CF, kRing, MU, KNOBS, K>
      <<<grid, threads, smem, st>>>(post_dst, child, live_row, post_e, P,
                                    tips, pi, props, ll_rows, M, T, N1, S,
                                    rows, C);
  return cudaGetLastError();
}

// C = 1..8 categories, fixed at compile time.
template <int C, bool kRing, int MU = 0, int KNOBS = 0>
cudaError_t launch(const int* post_dst, const int* child, const int* live_row,
                   const int* post_e, const float* P, const float* tips,
                   const float* pi, const float* props, float* ll_rows, int B,
                   int M, int T, int N1, int S, int rows, int cols,
                   cudaStream_t st) {
  return launch_body<onchip::Lanes<C>::G, C, kRing, MU, KNOBS>(
      post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows, B, M,
      T, N1, C, S, rows, cols, st);
}

// C = G / 2 + 1 .. G categories on G = 16 or 32 lanes, read at run time.
template <int G, bool kRing>
cudaError_t launch_wide(const int* post_dst, const int* child,
                        const int* live_row, const int* post_e,
                        const float* P, const float* tips, const float* pi,
                        const float* props, float* ll_rows, int B, int M,
                        int T, int N1, int C, int S, int rows, int cols,
                        cudaStream_t st) {
  static_assert(G == 16 || G == 32, "the wide instantiations take 16 or 32 "
                "lanes");
  if (C <= G / 2 || C > G) return cudaErrorInvalidValue;
  return launch_body<G, 0, kRing, 0, 0>(post_dst, child, live_row, post_e, P,
                                        tips, pi, props, ll_rows, B, M, T, N1,
                                        C, S, rows, cols, st);
}

// C = 32 (K - 1) + 1 .. 32 K categories on 32 lanes of K = 2..4 places
// each, read at run time, on the ring.
template <int K>
cudaError_t launch_k(const int* post_dst, const int* child,
                     const int* live_row, const int* post_e, const float* P,
                     const float* tips, const float* pi, const float* props,
                     float* ll_rows, int B, int M, int T, int N1, int C,
                     int S, int rows, int cols, cudaStream_t st) {
  static_assert(K >= 2 && K <= onchip::kMaxK, "K takes 2..kMaxK");
  if (C <= 32 * (K - 1) || C > 32 * K) return cudaErrorInvalidValue;
  return launch_body<32, 0, true, 0, 0, K>(post_dst, child, live_row, post_e,
                                           P, tips, pi, props, ll_rows, B, M,
                                           T, N1, C, S, rows, cols, st);
}

}  // namespace
}  // namespace paired_ll_onchip
