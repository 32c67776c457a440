// Per-pattern tree log likelihoods over the paired-slot tape at 64 states
// (MG94 codon models).
//
// Replaces bito_tpu/treelike/pallas_paired.py::_ll_kernel at CA = 64 C,
// where bito_tpu runs it on MG94 (kernel="pallas").  It computes what that
// kernel computes: the postorder over the paired-slot tape
// (build_paired_encoding), each op evolving both children by their
// per-category P and multiplying, with exact per-site log scales, then at
// the root log sum_ca pi*prop*partial + log scale, per (tree, pattern).
// The pattern weights are applied outside, as in bito_tpu.
//
// What it does not carry over: the bf16 hi/lo planes, the K-stacked
// block-diagonal [2CA, 6CA] operands, the fourth lo*lo pass, the G-way
// interleave and the VMEM tiles existed for the v5e matrix unit; here each
// product is float32 FMAs on the CUDA cores (paired_a64.cuh says how a
// block runs the tape, and what bounds it).  The port's 4-state kernels
// keep a column in registers or rows in shared memory; at 64 states a
// pattern's partials do not fit, so they live in device memory.
//
// Grid: (pattern tiles of a64::kTile, B), a block of a64::kThreads.
#include "paired_a64.cuh"

namespace {

// Shared memory: two matrices, two slices, one reduction, then slot_tip.
constexpr int kLLFloats = 2 * a64::kMat + 2 * a64::kSlab + a64::kRed;

template <int C>
__global__ void __launch_bounds__(a64::kThreads, 2)
paired_ll_a64_kernel(const int* __restrict__ post_dst,   // [B, M]
                     const int* __restrict__ tip_slot,   // [B, T]
                     const int* __restrict__ post_e,     // [B, M, 2]
                     const float* __restrict__ P,        // [B, N1, C, 64, 64]
                     const float* __restrict__ tips,     // [T, 64, S]
                     const float* __restrict__ pi,       // [64]
                     const float* __restrict__ props,    // [C]
                     float* __restrict__ buf,            // [B, NS, C, 64, S]
                     float* __restrict__ ls,             // [B, NS, S]
                     float* __restrict__ ll_rows,        // [B, S]
                     int M, int T, int N1, int S) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y;
  const int NS = 2 * M + 3;
  const a64::Block k = a64::make_block(
      sm, kLLFloats, NS, tip_slot + static_cast<size_t>(b) * T, T, tips, buf,
      ls, C, S);
  float* Ps = sm;
  float* X = Ps + 2 * a64::kMat;
  float* red = X + 2 * a64::kSlab;
  a64::postorder<C>(k, Ps, X, red, post_dst + static_cast<size_t>(b) * M,
                    post_e + static_cast<size_t>(b) * M * 2,
                    P + static_cast<size_t>(b) * N1 * C * a64::kMat, M);
  a64::root_ll<C>(k, red, 2 * M, pi, props,
                  ll_rows + static_cast<size_t>(b) * S);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bito_paired_ll_a64(const int* post_dst, const int* tip_slot,
                                  const int* post_e, const float* P,
                                  const float* tips, const float* pi,
                                  const float* props, float* buf, float* ls,
                                  float* ll_rows, int B, int M, int T, int N1,
                                  int C, int S, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || M <= 0) return cudaErrorInvalidValue;
  const dim3 grid((S + a64::kTile - 1) / a64::kTile, B);
  const size_t smem = a64::smem_bytes(kLLFloats, 2 * M + 3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BITO_LAUNCH_LL_A64(CV)                                              \
  {                                                                         \
    const cudaError_t err = cudaFuncSetAttribute(                           \
        paired_ll_a64_kernel<CV>,                                           \
        cudaFuncAttributeMaxDynamicSharedMemorySize,                        \
        static_cast<int>(smem));                                            \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    paired_ll_a64_kernel<CV><<<grid, a64::kThreads, smem, st>>>(            \
        post_dst, tip_slot, post_e, P, tips, pi, props, buf, ls, ll_rows,   \
        M, T, N1, S);                                                       \
  }
  BITO_DISPATCH_C(C, BITO_LAUNCH_LL_A64)
#undef BITO_LAUNCH_LL_A64
  return static_cast<int>(cudaGetLastError());
}
