// Per-pattern tree log likelihoods over a tape of the paired-slot layout,
// with every partial on chip.
//
// Replaces three TPU kernels, each of which runs a postorder of ops that
// evolve both children by their per-category P and multiply, rescaled by
// the largest entry with exact log scales, then at the root log
// sum_ca pi*prop*partial + log scale, per (tree, pattern); the pattern
// weights are applied outside.  It computes their numbers on their tapes,
// each given as the paired layout (post_dst, child codes, edges):
//   - bito_tpu/treelike/pallas_paired.py::_ll_kernel, on the paired tape
//     (treelike/paired.py), as paired_ll.cu does for large trees;
//   - bito_tpu/treelike/pallas_chunked.py::_ll_kernel, on the chunked
//     tape (treelike/chunked.py onchip_tape), walked one grid op at a
//     time, as chunked_ll.cu does for large trees.  The chunked schedule
//     is a postorder, so the walk computes what the chunks do.  On the
//     TPU a chunk's W ops filled one MXU contraction; here the body is
//     bound by instruction issue, not by the chain of dependent ops, so
//     running a chunk's ops side by side would buy no time, and it would
//     cost the rows by liveness (an op could store over a row that
//     another op of its chunk still reads);
//   - bito_tpu/treelike/pallas_pruning.py::_kernel, on the per-node tape
//     (treelike/pernode.py ll_tape: each source the op that last wrote
//     it, so the trifurcating root's accumulator reads the earlier op),
//     as pernode_ll.cu does for large trees.
// post_dst is read only as the root (2M) and the skipped (2M + 1) codes:
// an op's other code names the slot its consumer reads, which this body
// never reads, since a row by liveness stands for it.
//
// What bounds paired_ll.cu on the H100, and what this body does about it:
//   - its partials live in device memory ([B, 2M+3, C*4, S] float32), and
//     each op reads two columns and writes one.  The TPU kernel kept them
//     in VMEM.  Here they stay in shared memory (csrc/onchip.cuh), and
//     only while they are live: the host assigns op m's output a row by
//     liveness (treelike/paired.py live_rows), so a pattern needs the
//     tape's peak count of live outputs, a few rows, not one per slot.
//     Tips are not copied into slots: an op reads tip t from tips[t, :, s]
//     (L2-resident), prefetched into registers one op ahead.
//   - one thread carried all C*4 values of an op.  Here a rate category is
//     a lane (G lanes a pattern, shuffles for the rescale max and the root
//     sum), so a thread holds 4 states.
//   - divides and logs: an op rescales by a power of two (csrc/onchip.cuh
//     scale_exponent), 4 exact multiplies a lane and no divide; every op
//     that is not padded feeds the root, so the root's log scale is the
//     running sum of the ops' exponents, one integer register, times
//     log 2: one log per pattern, no log-scale array.
//   - the matrices: the tree's P is staged in shared memory once per block
//     (ring = false) or double-buffered one op ahead (ring = true), both
//     by cp.async; paired.py's onchip_plan picks.
// What bounds it now, on the H100: instruction issue.  Beside the f32 FMAs
// of the 4x4 products (which gain nothing from tensor cores), a warp
// issues the tape's and the tips' loads and their address arithmetic, the
// matrix rows' shared-memory loads and the shuffles, with no memory stream
// to wait on; it runs at about a tenth of the FMA bound (PERF.md, chip
// runs).
#include "onchip.cuh"

namespace {

using onchip::A;

template <int C, bool kRing>
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
                        int M, int T, int N1, int S, int rows) {
  using namespace onchip;
  constexpr int G = Lanes<C>::G;
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
  float4* const my = smem + tid;  // row r at my[r * threads]
  float4* const mats = smem + static_cast<size_t>(rows) * threads;
  const int nslots = kRing ? 4 : N1;
  int* const t_dst = reinterpret_cast<int*>(mats + nslots * G * A);
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
  zero_idle<C>(mats, nslots);
  if (!kRing) stage_all<C>(mats, P_b, nullptr, N1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int root = 2 * M, trash = 2 * M + 1;
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float prop = g < C ? __ldg(props + g) : 0.f;
  int lsc = 0;  // the running log scale, in powers of two
  if (kRing) {
    stage_op<C>(mats, 0, t_e[0], t_e[1], P_b, nullptr);
    cp_async_commit();
  }
  // Op m's tape, its children's rows and its leaves are read one op
  // ahead, before op m - 1's stores, so their latency overlaps its work.
  Op op = op_at(t_dst, t_child, t_e, 0);
  float4 l0 = leaf_value(op.c0, T, S, tips_s);
  float4 l1 = leaf_value(op.c1, T, S, tips_s);
  int r0 = op.c0 >= 0 ? t_row[op.c0] : 0, r1 = op.c1 >= 0 ? t_row[op.c1] : 0;
  for (int m = 0; m < M; ++m) {
    const int mn = min(m + 1, M - 1);
    const Op nx = op_at(t_dst, t_child, t_e, mn);
    const float4 n0 = leaf_value(nx.c0, T, S, tips_s);
    const float4 n1 = leaf_value(nx.c1, T, S, tips_s);
    const int nr0 = nx.c0 >= 0 ? t_row[nx.c0] : 0;
    const int nr1 = nx.c1 >= 0 ? t_row[nx.c1] : 0;
    const int out = t_row[m];
    const float4* M0;
    const float4* M1;
    if (kRing) {
      if (m + 1 < M) stage_op<C>(mats, 2 * (mn & 1), nx.e0, nx.e1, P_b,
                                 nullptr);
      cp_async_commit();
      cp_async_wait<1>();  // op m's matrices have landed
      __syncthreads();
      M0 = lane_rows<G>(mats, 2 * (m & 1), g);
      M1 = lane_rows<G>(mats, 2 * (m & 1) + 1, g);
    } else {
      M0 = lane_rows<G>(mats, op.e0, g);
      M1 = lane_rows<G>(mats, op.e1, g);
    }
    if (op.dst != trash) {
      const float4 p0 = op.c0 >= 0 ? my[r0 * threads] : l0;
      const float4 p1 = op.c1 >= 0 ? my[r1 * threads] : l1;
      float4 prod = mul(evolve<G>(M0, p0), evolve<G>(M1, p1));
      const int ex = scale_exponent(group_max<G>(max4(prod)));
      prod = scale(prod, pow2_neg(ex));
      lsc += ex;
      if (op.dst == root) {
        const float site = group_sum<G>(prop * dot(pi4, prod));
        if (g == 0 && s_raw < S)
          ll_rows[static_cast<size_t>(b) * S + s_raw] = logf(site) + lsc * kLn2;
      } else {
        my[out * threads] = prod;
      }
    }
    if (kRing) __syncthreads();  // op m's buffer is refilled for op m + 2
    op = nx;
    l0 = n0;
    l1 = n1;
    r0 = nr0;
    r1 = nr1;
  }
}

template <int C, bool kRing>
cudaError_t launch(const int* post_dst, const int* child, const int* live_row,
                   const int* post_e, const float* P, const float* tips,
                   const float* pi, const float* props, float* ll_rows, int B,
                   int M, int T, int N1, int S, int rows, int cols,
                   cudaStream_t st) {
  constexpr int G = onchip::Lanes<C>::G;
  const int threads = cols * G;
  if (cols < 1 || threads > onchip::kMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  const size_t smem =
      onchip::smem_bytes(rows, threads, G, N1, 2, kRing, 6 * M);
  if (smem > onchip::kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      paired_ll_onchip_kernel<C, kRing>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, onchip::kSmemMax);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + cols - 1) / cols, B);
  paired_ll_onchip_kernel<C, kRing><<<grid, threads, smem, st>>>(
      post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows, M, T,
      N1, S, rows);
  return cudaGetLastError();
}

}  // namespace

// `rows` is the peak number of live outputs (paired.py live_rows); `cols`
// patterns per block (a whole number of warps); `ring` the staging.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bito_paired_ll_onchip(const int* post_dst, const int* child,
                                     const int* live_row, const int* post_e,
                                     const float* P, const float* tips,
                                     const float* pi, const float* props,
                                     float* ll_rows, int B, int M, int T,
                                     int N1, int C, int S, int rows, int cols,
                                     int ring, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || M <= 0 || rows < 1 || rows > M)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ONCHIP_LAUNCH_LL(CV, RV)                                             \
  return static_cast<int>(launch<CV, RV>(post_dst, child, live_row, post_e,  \
                                         P, tips, pi, props, ll_rows, B, M,  \
                                         T, N1, S, rows, cols, st))
  ONCHIP_DISPATCH(C, ring != 0, ONCHIP_LAUNCH_LL)
#undef ONCHIP_LAUNCH_LL
  return cudaErrorInvalidValue;
}
