// Per-pattern tree log likelihoods and branch-length gradient rows over the
// chunked level-synchronous tape, with every partial on chip.
//
// Replaces bito_tpu/treelike/pallas_chunked.py::_grad_kernel (the Pallas TPU
// kernel behind chunked_ll_and_gradients), as chunked_grad.cu does, and
// computes the same numbers: the LL rows [B, S] and the weighted gradient
// rows [B, 2MW+1, S] by grid position, rows 2g and 2g+1 for the two
// children of grid op g,
//     w * sum_ca prop*o*(dP p) / sum_ca prop*o*(P p),
// which the caller sums over patterns and maps to nodes through node_row.
// Row 2MW, which node_row gives the nodes without a branch, is written 0;
// the rows of padded positions are not written.  No float atomics: the same
// result on every run.
//
// The tape (treelike/chunked.py): grid op g = c*W + k of chunk c reads pair
// slots (2g, 2g+1) and writes slot post_dst[g] (2MW the root, 2MW+1 the
// trash slot of padded positions).  The child tape (treelike/paired.py
// child_tape, which applies to this tape as it is) names who wrote pair
// slot 2g+j: op g' >= 0, tip t as -1 - t, or nothing (INT_MIN: all ones).
//
// The rows: op g's output lives in shared-memory row g of its pattern, and
// the outside pass writes op g's outside value over it in place once g's
// consumer, the one op that reads it, has read the partial.  Padded
// positions and the root op store nothing; tips are read in place from
// tips[t, :, s] (L2-resident), one chunk ahead.
//
// The lanes.  A pattern has L op lanes x G category lanes (G the power of
// two at or above C, onchip.cuh), all in one warp: thread l of a warp is op
// lane k = l / (32 / L), pattern (l % (32 / L)) / G of the warp's, category
// lane l % G.  L is the plan's op_lanes (treelike/chunked.py onchip_plan):
// W at G <= 32 / W, else 32 / G (one at G = 32, where a pattern is a whole
// warp).  Op lane k runs grid ops k, k + L, k + 2L, ... in turn: the W / L
// ops of a chunk that fall to it one after another, the chunks in order.
// No op reads a slot that another op of its chunk writes (the schedule's
// guarantee), and every row is written in an earlier chunk than the one
// that reads it, so __syncwarp() after each op lane's step orders a
// pattern's rows: no block-wide barrier after the staging.  The 32 / L
// threads of an op lane run the same op of the same tree, so an op lane is
// the unit of divergence: a padded position's lane skips its op, and the
// shuffles over the G category lanes (the rescale max, the sums over
// categories, the root LL) name the op lane's threads only.  In shared
// memory a row's slice of a pattern is G float4 (16*G bytes); the 8
// threads of a quarter warp are one op lane's, so their 16-byte accesses
// hit one row of neighbouring patterns: no bank conflicts.
//
// Category counts: 1..8 compiled one count at a time; 9..32 on G = 16 (two
// op lanes) or 32 (one) with the count read at run time (onchip.cuh).  At
// G = 32 the tree's P and dP staged at once take 4 KB an edge, so
// chunked.py's onchip_plan hands larger trees to chunked_grad.cu sooner.
//
// The rescale, as in paired_grad_onchip.cu: an op scales by a power of two
// (exact, no divide), each op lane keeps the running sum of its ops'
// exponents, and the root's log likelihood adds the L lanes' sums: one log
// a pattern.  The outside pass needs no scale: each gradient row is a
// ratio.
//
// What bounded chunked_grad.cu on the H100 (PERF.md), and what this body
// does about it: its partials lived in device memory (buf [B, NS, C*4, S]
// and log scales ls [B, NS, S], 0.8 GB a call at the flagship) and each
// outside op loaded three columns and stored two; 190 registers left 8
// warps an SM waiting on them; 64 IEEE divides an op; tips copied into
// slots; a block-wide barrier per chunk; P and dP through the cache on
// every op.  Here the rows are on chip (at most MW rows of 16*G bytes a
// pattern), P and dP of the tree are staged once per block by cp.async
// (onchip.cuh stage_all), the block's tape is staged in shared memory, and
// treelike/chunked.py onchip_plan sizes the block before the launch (whole
// warps of patterns within 227 KB) or hands the tree to chunked_grad.cu.
#include "onchip.cuh"

namespace {

using onchip::A;

// Reductions over the G category lanes of one pattern.  `mask` names the
// threads of the caller's op lane, which all take the same branch
// (onchip.cuh's group_max and group_sum name the whole warp, which runs one
// op in the paired bodies).
template <int G>
__device__ __forceinline__ float lanes_max(unsigned mask, float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, o, G));
  return v;
}
template <int G>
__device__ __forceinline__ float lanes_sum(unsigned mask, float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(mask, v, o, G);
  return v;
}

// G lanes a pattern; CF the category count where it is fixed at compile
// time (1..8), else 0 and the run-time count C_run (G / 2 < C_run <= G).
template <int G, int CF>
__global__ void __launch_bounds__(onchip::kMaxThreads)
chunked_grad_onchip_kernel(const int* __restrict__ post_dst,   // [B, MW]
                           const int* __restrict__ child,      // [B, MW, 2]
                           const int* __restrict__ post_e,     // [B, MW, 2]
                           const float* __restrict__ P,   // [B, N1, C, 4, 4]
                           const float* __restrict__ dP,  // [B, N1, C, 4, 4]
                           const float* __restrict__ tips,     // [T, 4, S]
                           const float* __restrict__ pi,       // [4]
                           const float* __restrict__ props,    // [C]
                           const float* __restrict__ weights,  // [S]
                           float* __restrict__ ll_rows,        // [B, S]
                           float* __restrict__ grad_rows,  // [B, 2MW+1, S]
                           int MW, int L, int T, int N1, int S, int rows,
                           int C_run) {
  using namespace onchip;
  const int C = CF > 0 ? CF : C_run;
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int span = 32 / L;  // threads of one op lane in a warp
  const int l = tid % 32;
  const int k = l / span;
  const int g = l % G;
  const int per_warp = span / G;  // patterns a warp
  const int cols = blockDim.x / 32 * per_warp;
  const int x = tid / 32 * per_warp + l % span / G;
  const int b = blockIdx.y;
  const int s_raw = blockIdx.x * cols + x;
  // A thread past the last pattern computes a copy of it and stores
  // nothing: every thread of an op lane takes part in its shuffles.
  const int s = min(s_raw, S - 1);
  const float* const tips_s = tips + s;
  const bool writer = g == 0 && s_raw < S;
  const unsigned mask =
      (span == 32 ? 0xffffffffu : (1u << span) - 1u) << (k * span);
  const int stride = cols * G;  // float4s from one row to the next
  float4* const my = smem + x * G + g;  // row r at my[r * stride]
  float4* const mats = smem + static_cast<size_t>(rows) * stride;
  int* const t_dst = reinterpret_cast<int*>(mats + 2 * N1 * G * A);
  int* const t_child = t_dst + MW;
  int* const t_e = t_child + 2 * MW;
  const size_t tree_mats = static_cast<size_t>(b) * N1 * C * A * A;

  for (int i = tid; i < MW; i += blockDim.x)
    t_dst[i] = post_dst[static_cast<size_t>(b) * MW + i];
  for (int i = tid; i < 2 * MW; i += blockDim.x) {
    const size_t j = static_cast<size_t>(b) * 2 * MW + i;
    t_child[i] = child[j];
    t_e[i] = post_e[j];
  }
  zero_idle<G>(mats, 2 * N1, C);
  stage_all<G>(mats, P + tree_mats, dP + tree_mats, N1, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int steps = MW / L, root = 2 * MW, trash = 2 * MW + 1;
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float prop = g < C ? __ldg(props + g) : 0.f;

  // -- postorder, step by step: op g's output to row g ---------------------
  int lsc = 0;        // this op lane's running log scale, in powers of two
  float site = 0.f;   // the root op's site likelihood, on its op lane
  bool holds_root = false;
  // The next step's op and leaves are read a step ahead, before this
  // step's stores, so their latency overlaps its work.
  Op op = op_at(t_dst, t_child, t_e, k);
  float4 l0 = leaf_value(op.c0, T, S, tips_s);
  float4 l1 = leaf_value(op.c1, T, S, tips_s);
  for (int c = 0; c < steps; ++c) {
    const int gp = c * L + k;
    const Op nx = op_at(t_dst, t_child, t_e, min(gp + L, MW - L + k));
    const float4 n0 = leaf_value(nx.c0, T, S, tips_s);
    const float4 n1 = leaf_value(nx.c1, T, S, tips_s);
    if (op.dst != trash) {
      const float4 p0 = op.c0 >= 0 ? my[op.c0 * stride] : l0;
      const float4 p1 = op.c1 >= 0 ? my[op.c1 * stride] : l1;
      float4 prod = mul(evolve<G>(lane_rows<G>(mats, op.e0, g), p0),
                        evolve<G>(lane_rows<G>(mats, op.e1, g), p1));
      const int ex = scale_exponent(lanes_max<G>(mask, max4(prod)));
      prod = scale(prod, pow2_neg(ex));
      lsc += ex;
      if (op.dst == root) {
        site = lanes_sum<G>(mask, prop * dot(pi4, prod));
        holds_root = true;
      } else {
        my[gp * stride] = prod;
      }
    }
    __syncwarp();
    op = nx;
    l0 = n0;
    l1 = n1;
  }
  // The tree's log scale: the sum over the L op lanes of a pattern.
  for (int o = span; o < 32; o <<= 1)
    lsc += __shfl_xor_sync(0xffffffffu, lsc, o);
  if (holds_root && writer)
    ll_rows[static_cast<size_t>(b) * S + s_raw] = logf(site) + lsc * kLn2;

  // -- outside pass, steps in reverse: op g's outside value in row g -------
  const float w = __ldg(weights + s);
  float* const grad_b =
      grad_rows + static_cast<size_t>(b) * (2 * MW + 1) * S + s_raw;
  if (writer && k == 0) grad_b[static_cast<size_t>(2 * MW) * S] = 0.f;
  op = op_at(t_dst, t_child, t_e, (steps - 1) * L + k);
  l0 = leaf_value(op.c0, T, S, tips_s);
  l1 = leaf_value(op.c1, T, S, tips_s);
  for (int c = steps - 1; c >= 0; --c) {
    const int gp = c * L + k;
    const Op nx = op_at(t_dst, t_child, t_e, max(gp - L, k));
    const float4 n0 = leaf_value(nx.c0, T, S, tips_s);
    const float4 n1 = leaf_value(nx.c1, T, S, tips_s);
    if (op.dst != trash) {
      const float4* const M0 = lane_rows<G>(mats, op.e0, g);
      const float4* const M1 = lane_rows<G>(mats, op.e1, g);
      const float4 up = op.dst == root ? pi4 : my[gp * stride];
      const float4 p0 = op.c0 >= 0 ? my[op.c0 * stride] : l0;
      const float4 p1 = op.c1 >= 0 ? my[op.c1 * stride] : l1;
      const float4 ev0 = evolve<G>(M0, p0), ev1 = evolve<G>(M1, p1);
      float4 o0 = mul(up, ev1), o1 = mul(up, ev0);
      const float inv = pow2_neg(
          scale_exponent(lanes_max<G>(mask, fmaxf(max4(o0), max4(o1)))));
      o0 = scale(o0, inv);
      o1 = scale(o1, inv);
      const float n0s = lanes_sum<G>(
          mask, prop * dot(o0, evolve<G>(lane_rows<G>(mats, N1 + op.e0, g),
                                         p0)));
      const float n1s = lanes_sum<G>(
          mask, prop * dot(o1, evolve<G>(lane_rows<G>(mats, N1 + op.e1, g),
                                         p1)));
      float d0 = lanes_sum<G>(mask, prop * dot(o0, ev0));
      float d1 = lanes_sum<G>(mask, prop * dot(o1, ev1));
      if (writer) {
        d0 = d0 > 0.f ? d0 : 1.f;
        d1 = d1 > 0.f ? d1 : 1.f;
        grad_b[static_cast<size_t>(2 * gp) * S] = w * __fdividef(n0s, d0);
        grad_b[static_cast<size_t>(2 * gp + 1) * S] = w * __fdividef(n1s, d1);
      }
      // Each child op's outside value, over its partial, which this op was
      // the last to read.
      if (op.c0 >= 0) my[op.c0 * stride] = evolve_t<G>(M0, o0);
      if (op.c1 >= 0) my[op.c1 * stride] = evolve_t<G>(M1, o1);
    }
    __syncwarp();
    op = nx;
    l0 = n0;
    l1 = n1;
  }
}

template <int G, int CF>
cudaError_t launch(const int* post_dst, const int* child, const int* post_e,
                   const float* P, const float* dP, const float* tips,
                   const float* pi, const float* props, const float* weights,
                   float* ll_rows, float* grad_rows, int B, int MW, int W,
                   int L, int T, int N1, int C, int S, int rows, int cols,
                   cudaStream_t st) {
  if (CF == 0 && (C <= G / 2 || C > G)) return cudaErrorInvalidValue;
  // A pattern's L*G threads in one warp, L op lanes that divide the chunk,
  // and a block of whole warps.
  if (L < 1 || W % L || 32 % (L * G) || cols < 1 ||
      cols % (32 / (L * G)))
    return cudaErrorInvalidValue;
  const int threads = cols * L * G;
  if (threads > onchip::kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem =
      onchip::smem_bytes(rows, cols * G, G, N1, 4, false, 5 * MW);
  if (smem > onchip::kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      chunked_grad_onchip_kernel<G, CF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, onchip::kSmemMax);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + cols - 1) / cols, B);
  chunked_grad_onchip_kernel<G, CF><<<grid, threads, smem, st>>>(
      post_dst, child, post_e, P, dP, tips, pi, props, weights, ll_rows,
      grad_rows, MW, L, T, N1, S, rows, C);
  return cudaGetLastError();
}

}  // namespace

// `child` is the child tape of the chunked tape (paired.py child_tape);
// `rows` one more than the last grid position that stores a row (paired.py
// grad_rows_needed); `cols` patterns per block (whole warps); W the chunk
// width, which must divide MW, and `op_lanes` the op lanes a pattern,
// which must divide W (chunked.py onchip_plan).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bito_chunked_grad_onchip(
    const int* post_dst, const int* child, const int* post_e, const float* P,
    const float* dP, const float* tips, const float* pi, const float* props,
    const float* weights, float* ll_rows, float* grad_rows, int B, int MW,
    int W, int T, int N1, int C, int S, int rows, int cols, int op_lanes,
    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || MW <= 0 || W <= 0 || MW % W ||
      rows < 1 || rows > MW)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CHUNKED_LAUNCH_GRAD_AT(GV, CV)                                      \
  return static_cast<int>(launch<GV, CV>(                                   \
      post_dst, child, post_e, P, dP, tips, pi, props, weights, ll_rows,    \
      grad_rows, B, MW, W, op_lanes, T, N1, C, S, rows, cols, st))
#define CHUNKED_LAUNCH_GRAD(CV, RV) \
  CHUNKED_LAUNCH_GRAD_AT(onchip::Lanes<CV>::G, CV)
#define CHUNKED_LAUNCH_GRAD_WIDE(GV, RV) CHUNKED_LAUNCH_GRAD_AT(GV, 0)
  if (C > 8) {
    ONCHIP_DISPATCH_WIDE(C, false, CHUNKED_LAUNCH_GRAD_WIDE)
  }
  ONCHIP_DISPATCH(C, false, CHUNKED_LAUNCH_GRAD)
#undef CHUNKED_LAUNCH_GRAD_WIDE
#undef CHUNKED_LAUNCH_GRAD
#undef CHUNKED_LAUNCH_GRAD_AT
  return cudaErrorInvalidValue;
}
