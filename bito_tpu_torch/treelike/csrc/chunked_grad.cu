// Per-pattern tree log likelihoods and branch-length gradient rows over the
// chunked level-synchronous tape.
//
// Replaces bito_tpu/treelike/pallas_chunked.py::_grad_kernel (the Pallas
// TPU kernel behind chunked_ll_and_gradients).  It computes what that
// kernel computes: the postorder and root log likelihood of
// chunked_ll.cu, then an outside pass over the chunks in reverse order.
// Op g reads its outside value from slot post_dst[g] (written by the
// consuming op's chunk, which ran earlier in the pass, or seeded with pi at
// the root), forms both children's outside vectors o1 = up * (P2 p2) and
// o2 = up * (P1 p1), rescaled by their common largest entry as in
// bito_tpu, and writes the weighted gradient rows
//     w * sum_ca prop*o*(dP p) / sum_ca prop*o*(P p)
// to rows 2g and 2g+1 (grid positions; the caller maps them to nodes
// through node_row), then the up pair P^T o over its own pair slots.
// Rows no op writes (padded positions, and row 2*MW that node_row gives
// nodes without an edge) stay as the caller zeroed them.
//
// Design: the lanes of chunked_ll.cu, with one barrier per chunk in each
// direction.  One barrier is enough in the outside pass too: op g reads
// slot post_dst[g], which belongs to a later chunk, and writes only its own
// pair slots (2g, 2g+1), which no other op of its chunk reads.  Summing
// the rows over patterns is left to the caller, so the result is the same
// on every run: no float atomics.  As in paired_grad.cu, each evolve,
// derivative evolve and transpose evolve is 16 float32 FMAs per category:
// no bf16 hi/lo planes, no row-selector dots.
//
// What bounds it on the H100: as paired_grad.cu, the partials live in
// device memory and each outside op reads three columns and writes two, so
// the kernel is bound by memory bandwidth and L2.  Registers: 190 at C=4
// without spills (paired_grad.cu: 255 and a spill), still two 128-thread
// blocks to an SM.
//
// At 9..32 rate categories the kernel is paired_lanes.cuh's grad_kernel on
// the chunked tape (a category a lane, the slots in device memory as
// float4 [B, 2MW+3, Sp, G], the children by the code of `child`, grid
// order one op at a time forward and in reverse, gradient rows 2g and
// 2g+1 of op g), launched here with the same arguments: `buf` holds
// B * (2MW+3) * Sp * G * 4 floats, and `ls` and tip_slot are not read.
// Past 32 categories it is wide_grad_kernel<true> (K = ceil(C / 32)
// categories a lane of 32; `buf` B * (2MW+3) * Sp * K * 32 * 4 floats).
// This body spills 228 bytes at C = 8 already (its registers hold C * 4
// values a vector); the lane layout holds 4.
#include "common.cuh"
#include "paired_lanes.cuh"

namespace {

// One outside op over a pair of children in slots (k, k + 1) whose partials
// p1, p2 the caller has loaded, with the op's own outside value in slot
// `up`: o1 = up * (P2 p2) and o2 = up * (P1 p1), both rescaled by their
// common largest entry.  Returns both children's gradient rows in g1, g2,
// and writes the up pair P1^T o1, P2^T o2 over slots (k, k + 1), where
// each child's own op (or no op, for a tip) reads its outside value.  p1
// and p2 are clobbered.  paired_grad.cu runs the same body inline: built
// through this helper, its register allocation changed (at C=4 its spill
// grew from 16 to 72 bytes), so it stays as it was measured.
template <int C>
__device__ __forceinline__ void outside_pair(
    const bito::Column<C>& col, int k, int up, const float* __restrict__ P1,
    const float* __restrict__ P2, const float* __restrict__ dP1,
    const float* __restrict__ dP2, float (&p1)[C * bito::A],
    float (&p2)[C * bito::A], const float (&prop)[C], float w, float& g1,
    float& g2) {
  constexpr int CA = C * bito::A;
  float ev1[CA], ev2[CA], o1[CA], o2[CA];
  bito::evolve<C>(P1, p1, ev1);
  bito::evolve<C>(P2, p2, ev2);
  col.load(up, o1);
#pragma unroll
  for (int i = 0; i < CA; ++i) {
    o2[i] = o1[i] * ev1[i];
    o1[i] = o1[i] * ev2[i];
  }
  float mx = fmaxf(bito::max_of(o1), bito::max_of(o2));
  mx = mx > 0.f ? mx : 1.f;
#pragma unroll
  for (int i = 0; i < CA; ++i) {
    o1[i] /= mx;
    o2[i] /= mx;
  }
  g1 = bito::grad_ratio<C>(dP1, p1, ev1, o1, prop, w);
  g2 = bito::grad_ratio<C>(dP2, p2, ev2, o2, prop, w);
  bito::evolve_t<C>(P1, o1, p1);
  col.store(k, p1);
  bito::evolve_t<C>(P2, o2, p2);
  col.store(k + 1, p2);
}

template <int C>
__global__ void __launch_bounds__(bito::kThreads)
chunked_grad_kernel(const int* __restrict__ post_dst,   // [B, MW]
                    const int* __restrict__ tip_slot,   // [B, T]
                    const int* __restrict__ post_e,     // [B, MW, 2]
                    const float* __restrict__ P,        // [B, N1, C, 4, 4]
                    const float* __restrict__ dP,       // [B, N1, C, 4, 4]
                    const float* __restrict__ tips,     // [T, 4, S]
                    const float* __restrict__ pi,       // [4]
                    const float* __restrict__ props,    // [C]
                    const float* __restrict__ weights,  // [S]
                    float* __restrict__ buf,            // [B, NS, C*4, S]
                    float* __restrict__ ls,             // [B, NS, S]
                    float* __restrict__ ll_rows,        // [B, S]
                    float* __restrict__ grad_rows,      // [B, 2MW+1, S], zeroed
                    int MW, int W, int T, int N1, int S) {
  extern __shared__ unsigned char produced[];  // [NS]
  constexpr int CA = C * bito::A;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const int lane = threadIdx.y;
  const int b = blockIdx.y;
  const int NS = 2 * MW + 2;
  const int NR = 2 * MW + 1;
  const int root = 2 * MW;
  const int trash = 2 * MW + 1;
  const int Mc = MW / W;

  const int* dst_b = post_dst + static_cast<size_t>(b) * MW;
  const int* tip_b = tip_slot + static_cast<size_t>(b) * T;
  const int* e_b = post_e + static_cast<size_t>(b) * MW * 2;
  const bito::Column<C> col{
      buf + static_cast<size_t>(b) * NS * CA * S + s, S};
  float* ls_col = ls + static_cast<size_t>(b) * NS * S + s;
  const size_t mat_stride = static_cast<size_t>(CA) * bito::A;
  const float* P_b = P + static_cast<size_t>(b) * N1 * mat_stride;
  const float* dP_b = dP + static_cast<size_t>(b) * N1 * mat_stride;
  float* grad_col = grad_rows + static_cast<size_t>(b) * NR * S + s;

  bito::mark_produced(produced, NS, tip_b, T, dst_b, MW);
  if (active) bito::init_tips<C>(col, ls_col, tip_b, tips, T, s, lane, W);
  __syncthreads();
  bito::chunked_postorder<C>(col, ls_col, produced, dst_b, e_b, P_b, Mc, W,
                             lane, trash, active);
  if (active && lane == 0) {
    ll_rows[static_cast<size_t>(b) * S + s] =
        bito::root_ll<C>(col, ls_col, root, pi, props);
    // Seed the outside recursion: the root's outside value is pi, written
    // over the root partial, which the log likelihood above has consumed.
    bito::seed_pi<C>(col, root, pi);
  }
  __syncthreads();

  const float w = active ? weights[s] : 0.f;
  float prop[C];
#pragma unroll
  for (int c = 0; c < C; ++c) prop[c] = __ldg(props + c);

  for (int c = Mc - 1; c >= 0; --c) {
    const int g = c * W + lane;
    const int dst = dst_b[g];
    if (active && dst != trash) {
      const size_t e1 = static_cast<size_t>(e_b[2 * g]) * mat_stride;
      const size_t e2 = static_cast<size_t>(e_b[2 * g + 1]) * mat_stride;
      float p1[CA], p2[CA], g1, g2;
      bito::load_child<C>(col, ls_col, produced, 2 * g, p1);
      bito::load_child<C>(col, ls_col, produced, 2 * g + 1, p2);
      outside_pair<C>(col, 2 * g, dst, P_b + e1, P_b + e2, dP_b + e1,
                            dP_b + e2, p1, p2, prop, w, g1, g2);
      grad_col[static_cast<size_t>(2 * g) * S] = g1;
      grad_col[static_cast<size_t>(2 * g + 1) * S] = g2;
    }
    __syncthreads();
  }
}

}  // namespace

// grad_rows must be zero-filled by the caller.  Returns cudaGetLastError()
// after the launch (0 on success).  W must divide kThreads and MW; the
// caller checks both.  `child` is the chunked tape's child tape
// (treelike/paired.py child_tape), read at C > 8 only.
extern "C" int bito_chunked_grad(const int* post_dst, const int* tip_slot,
                                 const int* child, const int* post_e,
                                 const float* P, const float* dP,
                                 const float* tips, const float* pi,
                                 const float* props, const float* weights,
                                 float* buf, float* ls, float* ll_rows,
                                 float* grad_rows, int B, int MW, int W,
                                 int T, int N1, int C, int S, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0 || bito::kThreads % W ||
      MW % W)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 8) {
    float4* slots = reinterpret_cast<float4*>(buf);
    if (C <= 16)
      paired_lanes::grad_kernel<16, true>
          <<<paired_lanes::grid<16>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, child, nullptr, post_e, P, dP, tips, pi, props,
              weights, slots, ll_rows, grad_rows, MW, T, N1, C, S,
              2 * MW + 1);
    else if (C <= 32)
      paired_lanes::grad_kernel<32, true>
          <<<paired_lanes::grid<32>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, child, nullptr, post_e, P, dP, tips, pi, props,
              weights, slots, ll_rows, grad_rows, MW, T, N1, C, S,
              2 * MW + 1);
    else
      paired_lanes::wide_grad_kernel<true>
          <<<paired_lanes::wide_grid(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, child, nullptr, post_e, P, dP, tips, pi, props,
              weights, slots, ll_rows, grad_rows, MW, T, N1, C, S,
              2 * MW + 1);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 block(bito::kThreads / W, W);
  const dim3 grid((S + block.x - 1) / block.x, B);
  const size_t smem = 2 * static_cast<size_t>(MW) + 2;
#define BITO_LAUNCH_CGRAD(CV)                                              \
  chunked_grad_kernel<CV><<<grid, block, smem, st>>>(                      \
      post_dst, tip_slot, post_e, P, dP, tips, pi, props, weights, buf,   \
      ls, ll_rows, grad_rows, MW, W, T, N1, S)
  BITO_DISPATCH_C(C, BITO_LAUNCH_CGRAD)
#undef BITO_LAUNCH_CGRAD
  return static_cast<int>(cudaGetLastError());
}
