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
// 1024 patterns under Gamma4), and each op reads two columns and writes
// one, so a thread waits on device memory op after op.  It takes any tree.
// paired_ll_onchip.cu keeps the live partials in shared memory and is the
// body the wrappers launch (treelike/paired.py); this one takes the trees
// whose rows do not fit there.
//
// At 9..32 rate categories the kernel is paired_lanes.cuh's ll_kernel (a
// category a lane, the slots in device memory as float4 [B, NS, Sp, G]),
// launched here with the same arguments: `buf` holds B * NS * Sp * G * 4
// floats and `ls` is not read.  Past 32 it is wide_ll_kernel (K = ceil(C /
// 32) categories a lane of 32), and `buf` holds B * NS * Sp * K * 32 * 4.
#include "common.cuh"
#include "paired_lanes.cuh"

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 8) {
    float4* slots = reinterpret_cast<float4*>(buf);
    if (C <= 16)
      paired_lanes::ll_kernel<16, false>
          <<<paired_lanes::grid<16>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, tip_slot, post_e, P, tips, pi, props, slots, ll_rows,
              M, T, N1, C, S);
    else if (C <= 32)
      paired_lanes::ll_kernel<32, false>
          <<<paired_lanes::grid<32>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, tip_slot, post_e, P, tips, pi, props, slots, ll_rows,
              M, T, N1, C, S);
    else
      paired_lanes::wide_ll_kernel<false>
          <<<paired_lanes::wide_grid(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, tip_slot, post_e, P, tips, pi, props, slots, ll_rows,
              M, T, N1, C, S);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((S + bito::kThreads - 1) / bito::kThreads, B);
#define BITO_LAUNCH_LL(CV)                                                  \
  paired_ll_kernel<CV><<<grid, bito::kThreads, 0, st>>>(                   \
      post_dst, tip_slot, post_e, P, tips, pi, props, buf, ls, ll_rows, M, \
      T, N1, S)
  BITO_DISPATCH_C(C, BITO_LAUNCH_LL)
#undef BITO_LAUNCH_LL
  return static_cast<int>(cudaGetLastError());
}
