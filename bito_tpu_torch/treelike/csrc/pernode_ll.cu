// Per-pattern tree log likelihoods over the scan tape's per-node ops: the
// global body, for trees past the on-chip body's limit.
//
// Replaces bito_tpu/treelike/pallas_pruning.py::_kernel (the Pallas TPU
// kernel behind pallas_log_likelihoods) on trees whose live partials do
// not fit a block's shared memory; paired_ll_onchip.cu takes the others
// over the tape of treelike/pernode.py ll_tape (pernode_log_likelihoods
// chooses before the launch, by paired.onchip_plan).  It computes what
// that kernel computes: the postorder over the scan tape's own post_ops
// [B, M, 5] (encode.py), with one slot per node, so that node dest's
// partial is (P[e1] p[s1]) * (P[e2] p[s2]) with exact per-site log
// scales, then log sum_ca pi*prop*root + log scale at node root[b], per
// (tree, pattern).  The pattern weights are applied outside.  The root
// comes as root [B]; bito_tpu appended it to the tape as an extra row for
// the TPU's scalar memory.
//
// Design: one thread per (tree, pattern) column walks the whole tape, as in
// paired_ll.cu; no barriers, no shared memory.  Each evolve is 16 float32
// FMAs per category, exact to f32: no bf16 hi/lo planes, no block-diagonal
// operand assembly.  Padded ops (dest == dummy) are skipped; slot dummy
// holds ones with log scale 0, as in bito_tpu's all-ones buffer.  The
// trifurcating root's accumulator op [u, u, I, x, x] reads its own
// destination: both children are loaded before the store.
//
// What bounds it on the H100: the per-node partials live in device memory
// ([B, N+1, C*4, S] float32, 0.69 GB at 200 trees x 53 slots x 1024
// patterns under Gamma4) and each op reads two columns and writes one, so
// the kernel is bound by memory bandwidth and L2, as paired_ll.cu.
//
// At 9..32 rate categories the kernel is pernode_lanes.cuh's ll_kernel (a
// category a lane, internal nodes' partials in device memory as float4
// [B, N1-T, Sp, G]), launched here with the same arguments: `buf` holds
// B * (N1-T) * Sp * G * 4 floats and `ls` is not read.  Past 32 it is
// wide_ll_kernel (K = ceil(C / 32) categories a lane of 32; `buf`
// B * (N1-T) * Sp * K * 32 * 4 floats).
#include "common.cuh"
#include "pernode_lanes.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(bito::kThreads)
pernode_ll_kernel(const int* __restrict__ post_ops,  // [B, M, 5]
                  const int* __restrict__ root,      // [B]
                  const float* __restrict__ P,       // [B, N1, C, 4, 4]
                  const float* __restrict__ tips,    // [T, 4, S]
                  const float* __restrict__ pi,      // [4]
                  const float* __restrict__ props,   // [C]
                  float* __restrict__ buf,           // [B, N1, C*4, S]
                  float* __restrict__ ls,            // [B, N1, S]
                  float* __restrict__ ll_rows,       // [B, S]
                  int M, int T, int N1, int S) {
  constexpr int CA = C * bito::A;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int b = blockIdx.y;
  const int dummy = N1 - 1;

  const bito::Column<C> col{
      buf + static_cast<size_t>(b) * N1 * CA * S + s, S};
  float* ls_col = ls + static_cast<size_t>(b) * N1 * S + s;
  bito::init_tips<C>(col, ls_col, nullptr, tips, T, s);
  float ones[CA];
  bito::fill(ones, 1.f);
  col.store(dummy, ones);
  ls_col[static_cast<size_t>(dummy) * S] = 0.f;
  bito::pernode_postorder<C>(col, ls_col,
                             post_ops + static_cast<size_t>(b) * M * 5,
                             P + static_cast<size_t>(b) * N1 * CA * bito::A,
                             M, dummy);
  ll_rows[static_cast<size_t>(b) * S + s] =
      bito::root_ll<C>(col, ls_col, root[b], pi, props);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bito_pernode_ll(const int* post_ops, const int* root,
                               const float* P, const float* tips,
                               const float* pi, const float* props,
                               float* buf, float* ls, float* ll_rows, int B,
                               int M, int T, int N1, int C, int S,
                               void* stream) {
  if (B <= 0 || B > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 8) {
    if (T >= N1) return cudaErrorInvalidValue;
    float4* rows = reinterpret_cast<float4*>(buf);
    if (C <= 16)
      pernode_lanes::ll_kernel<16>
          <<<paired_lanes::grid<16>(B, S), pernode_lanes::kThreads, 0, st>>>(
              post_ops, root, P, tips, pi, props, rows, ll_rows, M, T, N1, C,
              S);
    else if (C <= 32)
      pernode_lanes::ll_kernel<32>
          <<<paired_lanes::grid<32>(B, S), pernode_lanes::kThreads, 0, st>>>(
              post_ops, root, P, tips, pi, props, rows, ll_rows, M, T, N1, C,
              S);
    else
      pernode_lanes::wide_ll_kernel
          <<<paired_lanes::wide_grid(B, S), pernode_lanes::kThreads, 0,
             st>>>(post_ops, root, P, tips, pi, props, rows, ll_rows, M, T,
                   N1, C, S);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((S + bito::kThreads - 1) / bito::kThreads, B);
#define BITO_LAUNCH_NLL(CV)                                                \
  pernode_ll_kernel<CV><<<grid, bito::kThreads, 0, st>>>(                 \
      post_ops, root, P, tips, pi, props, buf, ls, ll_rows, M, T, N1, S)
  BITO_DISPATCH_C(C, BITO_LAUNCH_NLL)
#undef BITO_LAUNCH_NLL
  return static_cast<int>(cudaGetLastError());
}
