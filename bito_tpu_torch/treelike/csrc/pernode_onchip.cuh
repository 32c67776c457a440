// The per-node grad kernel's on-chip body: per-pattern tree log likelihoods
// and branch-length gradient rows over the scan tape's per-node ops, with
// every partial on chip.  A template, instantiated by pernode_grad_onchip.cu
// (the shipping body: launch<C> for C = 1..8, and launch_wide<G> for 9..32
// categories on G = 16 or 32 lanes with the count read at run time) and by
// the perf lab's variant_grad.cu (launch<C, knobs...>, the knobs below).
//
// Replaces bito_tpu/treelike/pallas_pruning.py::_grad_kernel, as
// pernode_grad.cu does, and computes the same numbers: the LL rows [B, S]
// and the weighted gradient rows [B, N1, S] by node,
//     w * sum_ca prop*o*(dP p) / sum_ca prop*o*(P p),
// which the caller sums over patterns and multiplies by the edge mask.  The
// rows of nodes without a branch (the root, the dummy, unused ids: the
// tape's `zero` list) are written 0.  No float atomics.
//
// The tape (treelike/pernode.py onchip_tape), derived on the host from the
// scan tape's post_ops and pre_ops.  Child codes: row r >= 0 for internal
// node T + r, -1 - t for tip t, anything below -T (INT_MIN) for the dummy,
// read as all ones through the identity edge.
//   post   [B, M, 5]   (dest row, c0, c1, e0, e1); dest row kPad: padded op
//   groups [B, NG, 4]  (parent row, three child codes): the pre_ops of one
//                      parent, which encode.py puts side by side; parent
//                      kRootUp for the root (up value pi), kPad for a
//                      padded group; a binary node's third child is the
//                      dummy.  Parents come in descending id, so a group's
//                      parent had its up value written by an earlier group.
//   zero   [B, Z]      node ids whose gradient rows no group writes (-1 pads)
//
// The rows.  Internal node v lives in shared-memory row v - T of its
// pattern: its partial after the postorder, then its up value.  p[c] is
// read only in the group of c's parent (as the destination of c's edge and
// as a sibling of c's siblings), so the group reads every child's partial
// first and then writes each child's up value P^T o over it: the up value
// of a child written right after that child's own op would be read as a
// sibling's partial.  A thread owns its lanes' slices, so its program order
// orders the reads and the writes; the root's row is its partial, read for
// the LL, and its up value is pi.
//
// A group of parent v: for each child c, ev_c = P[c] p[c] (ones for the
// dummy), then o_c = up[v] * prod_{c' != c} ev_c', the gradient row of c
// with dP[c] p[c], and P[c]^T o_c: three evolves an edge, where the Pallas
// kernel's per-op formulation takes five (both siblings, P p and dP p of
// the destination, P^T o).  The numbers are the same up to rounding.
//
// The layout, lanes, rescale and staging are the other on-chip bodies'
// (onchip.cuh): a block takes one tree and a tile of patterns, G lanes a
// pattern (one per rate category), rows as one float4 per lane, P and dP
// of the tree staged once by cp.async, the tape staged in shared memory,
// tips read in place, and an op's rescale by a power of two with an
// integer log scale (one logf a pattern, at the root).  The preorder needs
// no scale: each gradient row is a ratio.  No per-op ring of matrices: on
// the H100 its two barriers an op cost more than the warps it frees buy
// (PERF.md, the per-node hand-over).
//
// The perf lab's knobs (scripts/perf_lab.py:36-135), as template
// parameters:
//   MU, GU  the postorder's op count and the preorder's group count, fixed
//           at compile time and fully unrolled (unroll); 0 for loops over
//           the run-time counts M and NG.
//   RESK    with unrolled loops, post op m rescales only where m % RESK ==
//           RESK - 1, and group k's outside vectors only where k % RESK ==
//           RESK - 1 (resk); 1 rescales every op and group.
//   NODOT   the transition products are skipped, so that P = dP = I in
//           effect (nodot): ev = p, dP p = p and the up value is o; P and
//           dP are not staged.
#pragma once

#include "onchip.cuh"

namespace pernode_onchip {

using onchip::A;

constexpr int kPad = -2;        // a padded op's row, a padded group's parent
constexpr int kRootUp = -1;     // the root group's parent: up value pi
constexpr int kPostInts = 5;    // a post op's ints in the tape
constexpr int kGroupInts = 4;   // a group's ints

// Bytes of dynamic shared memory (treelike/pernode.py smem_bytes computes
// the same): rows, the tree's P and dP, the tape.
inline size_t smem_bytes(int rows, int threads, int G, int N1,
                         int tape_ints) {
  return static_cast<size_t>(rows) * threads * 16 +
         2 * static_cast<size_t>(N1) * G * A * 16 +
         (static_cast<size_t>(tape_ints) * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ bool is_child(int code, int T) { return code >= -T; }
__device__ __forceinline__ int node_of(int code, int T) {
  return code >= 0 ? T + code : -1 - code;
}

struct Group {
  int par, k0, k1, k2;
};

// Arguments every instantiation refuses.
inline bool bad_args(int B, int M, int NG, int Z, int S, int rows) {
  return B <= 0 || B > 65535 || S <= 0 || M <= 0 || NG <= 0 || Z < 0 ||
         rows < 1;
}

// The kernel and its launcher have internal linkage: each source that
// includes this header compiles its own instantiations.
namespace {

// G lanes a pattern; CF the category count where it is fixed at compile
// time (1..8), else 0 and the run-time count C_run (G / 2 < C_run <= G).
template <int G, int CF, int MU, int GU, int RESK, bool NODOT>
__global__ void __launch_bounds__(onchip::kMaxThreads)
pernode_grad_onchip_kernel(const int* __restrict__ post,     // [B, M, 5]
                           const int* __restrict__ groups,   // [B, NG, 4]
                           const int* __restrict__ zero,     // [B, Z]
                           const int* __restrict__ root,     // [B]
                           const float* __restrict__ P,   // [B, N1, C, 4, 4]
                           const float* __restrict__ dP,  // [B, N1, C, 4, 4]
                           const float* __restrict__ tips,     // [T, 4, S]
                           const float* __restrict__ pi,       // [4]
                           const float* __restrict__ props,    // [C]
                           const float* __restrict__ weights,  // [S]
                           float* __restrict__ ll_rows,        // [B, S]
                           float* __restrict__ grad_rows,      // [B, N1, S]
                           int M, int NG, int Z, int T, int N1, int S,
                           int rows, int C_run) {
  using namespace onchip;
  static_assert((MU > 0) == (GU > 0), "unroll both walks or neither");
  static_assert(MU > 0 || RESK == 1, "resk applies to unrolled walks only");
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
  float4* const my = smem + tid;  // row r at my[r * threads]
  float4* const mats = smem + static_cast<size_t>(rows) * threads;
  int* const t_post = reinterpret_cast<int*>(mats + 2 * N1 * G * A);
  int* const t_grp = t_post + kPostInts * M;
  int* const t_zero = t_grp + kGroupInts * NG;
  const size_t tree_mats = static_cast<size_t>(b) * N1 * C * A * A;
  const float* const P_b = P + tree_mats;
  const float* const dP_b = dP + tree_mats;

  for (int i = tid; i < kPostInts * M; i += threads)
    t_post[i] = post[static_cast<size_t>(b) * kPostInts * M + i];
  for (int i = tid; i < kGroupInts * NG; i += threads)
    t_grp[i] = groups[static_cast<size_t>(b) * kGroupInts * NG + i];
  for (int i = tid; i < Z; i += threads)
    t_zero[i] = zero[static_cast<size_t>(b) * Z + i];
  if constexpr (!NODOT) {
    zero_idle<G>(mats, 2 * N1, C);
    stage_all<G>(mats, P_b, dP_b, N1, C);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float4 ones = make_float4(1.f, 1.f, 1.f, 1.f);
  const float prop = g < C ? __ldg(props + g) : 0.f;

  // -- postorder: node v's partial to row v - T ------------------------------
  int lsc = 0;  // the running log scale, in powers of two
  auto post_at = [&](int m) {
    const int* o = t_post + kPostInts * m;
    return Op{o[0], o[1], o[2], o[3], o[4]};
  };
  // Op m's tape and leaves are read one op ahead, before op m - 1's
  // stores, so their latency overlaps its work.
  Op op = post_at(0);
  float4 l0 = leaf_value(op.c0, T, S, tips_s);
  float4 l1 = leaf_value(op.c1, T, S, tips_s);
  auto post_step = [&](int m, bool rescale) {
    const int mn = min(m + 1, M - 1);
    const Op nx = post_at(mn);
    const float4 n0 = leaf_value(nx.c0, T, S, tips_s);
    const float4 n1 = leaf_value(nx.c1, T, S, tips_s);
    if (op.dst != kPad) {
      const float4 p0 = op.c0 >= 0 ? my[op.c0 * threads] : l0;
      const float4 p1 = op.c1 >= 0 ? my[op.c1 * threads] : l1;
      float4 prod;
      if constexpr (NODOT) {
        prod = mul(p0, p1);
      } else {
        prod = mul(evolve<G>(lane_rows<G>(mats, op.e0, g), p0),
                   evolve<G>(lane_rows<G>(mats, op.e1, g), p1));
      }
      if (rescale) {
        const int ex = scale_exponent(group_max<G>(max4(prod)));
        prod = scale(prod, pow2_neg(ex));
        lsc += ex;
      }
      my[op.dst * threads] = prod;
    }
    op = nx;
    l0 = n0;
    l1 = n1;
  };
  if constexpr (MU > 0) {
#pragma unroll
    for (int m = 0; m < MU; ++m)
      post_step(m, RESK == 1 || m % RESK == RESK - 1);
  } else {
    for (int m = 0; m < M; ++m) post_step(m, true);
  }
  {
    const float site =
        group_sum<G>(prop * dot(pi4, my[(__ldg(root + b) - T) * threads]));
    if (writer)
      ll_rows[static_cast<size_t>(b) * S + s_raw] = logf(site) + lsc * kLn2;
  }

  // -- preorder, a parent group at a time -----------------------------------
  const float w = __ldg(weights + s);
  float* const grad_b = grad_rows + static_cast<size_t>(b) * N1 * S + s_raw;
  for (int z = 0; z < Z; ++z) {
    const int n = t_zero[z];
    if (writer && n >= 0) grad_b[static_cast<size_t>(n) * S] = 0.f;
  }
  auto group_at = [&](int k) {
    const int* o = t_grp + kGroupInts * k;
    return Group{o[0], o[1], o[2], o[3]};
  };
  Group gr = group_at(0);
  float4 q0 = leaf_value(gr.k0, T, S, tips_s);
  float4 q1 = leaf_value(gr.k1, T, S, tips_s);
  float4 q2 = leaf_value(gr.k2, T, S, tips_s);
  auto group_step = [&](int k, bool rescale) {
    const int kn = min(k + 1, NG - 1);
    const Group nx = group_at(kn);
    const float4 n0 = leaf_value(nx.k0, T, S, tips_s);
    const float4 n1 = leaf_value(nx.k1, T, S, tips_s);
    const float4 n2 = leaf_value(nx.k2, T, S, tips_s);
    if (gr.par != kPad) {
      const int kid[3] = {gr.k0, gr.k1, gr.k2};
      const float4 q[3] = {q0, q1, q2};
      const float4 up = gr.par == kRootUp ? pi4 : my[gr.par * threads];
      // Every child's partial is read before any up value is written.
      // The child's edge is its node; the dummy's matrices are never read.
      float4 p[3], ev[3];
      const float4* Mj[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        p[j] = kid[j] >= 0 ? my[kid[j] * threads] : q[j];
        Mj[j] = lane_rows<G>(mats, is_child(kid[j], T) ? node_of(kid[j], T)
                                                       : 0, g);
        if constexpr (NODOT) {
          ev[j] = p[j];
        } else {
          ev[j] = is_child(kid[j], T) ? evolve<G>(Mj[j], p[j]) : ones;
        }
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (!is_child(kid[j], T)) continue;
        float4 o = mul(up, mul(ev[(j + 1) % 3], ev[(j + 2) % 3]));
        if (rescale)
          o = scale(o, pow2_neg(scale_exponent(group_max<G>(max4(o)))));
        float4 dv;
        if constexpr (NODOT) {
          dv = p[j];
        } else {
          dv = evolve<G>(lane_rows<G>(mats, N1 + node_of(kid[j], T), g), p[j]);
        }
        const float num = group_sum<G>(prop * dot(o, dv));
        float den = group_sum<G>(prop * dot(o, ev[j]));
        if (writer) {
          den = den > 0.f ? den : 1.f;
          // Unrescaled vectors (resk) may leave den far from 1: divide in
          // full precision there.
          grad_b[static_cast<size_t>(node_of(kid[j], T)) * S] =
              w * (RESK == 1 ? __fdividef(num, den) : num / den);
        }
        if (kid[j] >= 0) {
          if constexpr (NODOT) {
            my[kid[j] * threads] = o;
          } else {
            my[kid[j] * threads] = evolve_t<G>(Mj[j], o);
          }
        }
      }
    }
    gr = nx;
    q0 = n0;
    q1 = n1;
    q2 = n2;
  };
  if constexpr (GU > 0) {
#pragma unroll
    for (int k = 0; k < GU; ++k)
      group_step(k, RESK == 1 || k % RESK == RESK - 1);
  } else {
    for (int k = 0; k < NG; ++k) group_step(k, true);
  }
}

template <int G, int CF, int MU, int GU, int RESK, bool NODOT>
cudaError_t launch_at(const int* post, const int* groups, const int* zero,
                      const int* root, const float* P, const float* dP,
                      const float* tips, const float* pi, const float* props,
                      const float* weights, float* ll_rows, float* grad_rows,
                      int B, int M, int NG, int Z, int T, int N1, int C,
                      int S, int rows, int cols, cudaStream_t st) {
  if (CF == 0 && (C <= G / 2 || C > G)) return cudaErrorInvalidValue;
  const int threads = cols * G;
  if (cols < 1 || threads > onchip::kMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(rows, threads, G, N1, kPostInts * M + kGroupInts * NG + Z);
  if (smem > onchip::kSmemMax) return cudaErrorInvalidValue;
  auto* kernel = pernode_grad_onchip_kernel<G, CF, MU, GU, RESK, NODOT>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, onchip::kSmemMax);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + cols - 1) / cols, B);
  kernel<<<grid, threads, smem, st>>>(post, groups, zero, root, P, dP, tips,
                                      pi, props, weights, ll_rows, grad_rows,
                                      M, NG, Z, T, N1, S, rows, C);
  return cudaGetLastError();
}

// C = 1..8 categories, fixed at compile time, with the knobs.
template <int C, int MU = 0, int GU = 0, int RESK = 1, bool NODOT = false>
cudaError_t launch(const int* post, const int* groups, const int* zero,
                   const int* root, const float* P, const float* dP,
                   const float* tips, const float* pi, const float* props,
                   const float* weights, float* ll_rows, float* grad_rows,
                   int B, int M, int NG, int Z, int T, int N1, int S, int rows,
                   int cols, cudaStream_t st) {
  return launch_at<onchip::Lanes<C>::G, C, MU, GU, RESK, NODOT>(
      post, groups, zero, root, P, dP, tips, pi, props, weights, ll_rows,
      grad_rows, B, M, NG, Z, T, N1, C, S, rows, cols, st);
}

// C = 9..32 categories on G = 16 or 32 lanes, the count read at run time.
template <int G>
cudaError_t launch_wide(const int* post, const int* groups, const int* zero,
                        const int* root, const float* P, const float* dP,
                        const float* tips, const float* pi,
                        const float* props, const float* weights,
                        float* ll_rows, float* grad_rows, int B, int M,
                        int NG, int Z, int T, int N1, int C, int S, int rows,
                        int cols, cudaStream_t st) {
  return launch_at<G, 0, 0, 0, 1, false>(
      post, groups, zero, root, P, dP, tips, pi, props, weights, ll_rows,
      grad_rows, B, M, NG, Z, T, N1, C, S, rows, cols, st);
}

}  // namespace
}  // namespace pernode_onchip
