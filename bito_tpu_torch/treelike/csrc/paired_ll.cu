// Per-pattern tree log likelihoods over the paired-slot tape.
//
// Replaces bito_tpu/treelike/pallas_paired.py::_ll_kernel (the Pallas TPU
// kernel behind paired_log_likelihoods).  It computes what that kernel
// computes: the postorder over the paired-slot tape (build_paired_encoding),
// each op evolving both children by their per-category P and multiplying,
// with exact per-site log scales, then at the root
// log sum_ca pi*prop*partial + log scale, per (tree, pattern).  The pattern
// weights are applied outside, as in bito_tpu.
//
// What it does not carry over: the bf16 hi/lo planes and K-stacked
// block-diagonal dots existed for the TPU's matrix unit; here each 4x4
// evolve is 16 float32 FMAs on the CUDA cores, exact to f32.  There is no
// G-way tree interleave: the card hides latency by running many
// (tree, pattern) threads at once.  The kernel rescales after every op
// where bito_tpu did so every fourth; the log scales keep the result the
// same.
//
// Grid: blockIdx.y is the tree, blockIdx.x a tile of patterns, one thread
// per pattern.  The tape loop inside the thread takes the place of the
// TPU's sequential grid.
//
// What bounds it on the H100: the paired-slot partials live in device
// memory ([B, 2M+3, C*4, S] float32, 0.77 GB at 200 trees x 27 taxa x
// 1024 patterns under Gamma4), because one pattern's column of 59 slots x
// 16 floats is 3.8 KB, and shared memory would hold too few columns per SM
// to keep it busy.  Each op reads two columns and writes one: about 200
// bytes per pattern per op against 256 FLOP, so the kernel is bound by
// memory bandwidth and L2, not by arithmetic.  Keeping the live slots
// on chip is the next step.
#include "paired_common.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(bito::kThreads)
paired_ll_kernel(const int* __restrict__ post_dst,   // [B, M]
                 const int* __restrict__ tip_slot,   // [B, T]
                 const int* __restrict__ post_e,     // [B, M, 2]
                 const float* __restrict__ P,        // [B, N1, C, 4, 4]
                 const float* __restrict__ tips,     // [T, 4, S]
                 const float* __restrict__ pi,       // [4]
                 const float* __restrict__ props,    // [C]
                 float* __restrict__ buf,            // [B, NS, C*4, S]
                 float* __restrict__ ls,             // [B, NS, S]
                 float* __restrict__ ll_rows,        // [B, S]
                 int M, int T, int N1, int S) {
  constexpr int CA = C * bito::A;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int b = blockIdx.y;
  const int NS = 2 * M + 3;
  const int root = 2 * M;
  const int trash = 2 * M + 1;

  const bito::Column<C> col{
      buf + static_cast<size_t>(b) * NS * CA * S + s, S};
  float* ls_col = ls + static_cast<size_t>(b) * NS * S + s;
  const float* P_b = P + static_cast<size_t>(b) * N1 * CA * bito::A;

  bito::init_tips<C>(col, ls_col, tip_slot + static_cast<size_t>(b) * T,
                     tips, T, s);
  bito::postorder<C>(col, ls_col, post_dst + static_cast<size_t>(b) * M,
                     post_e + static_cast<size_t>(b) * M * 2, P_b, M, trash);
  ll_rows[static_cast<size_t>(b) * S + s] =
      bito::root_ll<C>(col, ls_col, root, pi, props);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bito_paired_ll(const int* post_dst, const int* tip_slot,
                              const int* post_e, const float* P,
                              const float* tips, const float* pi,
                              const float* props, float* buf, float* ls,
                              float* ll_rows, int B, int M, int T, int N1,
                              int C, int S, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0) return cudaErrorInvalidValue;
  const dim3 grid((S + bito::kThreads - 1) / bito::kThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BITO_LAUNCH_LL(CV)                                                  \
  paired_ll_kernel<CV><<<grid, bito::kThreads, 0, st>>>(                   \
      post_dst, tip_slot, post_e, P, tips, pi, props, buf, ls, ll_rows, M, \
      T, N1, S)
  BITO_DISPATCH_C(C, BITO_LAUNCH_LL)
#undef BITO_LAUNCH_LL
  return static_cast<int>(cudaGetLastError());
}
