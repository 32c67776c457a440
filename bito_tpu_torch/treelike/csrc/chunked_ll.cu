// Per-pattern tree log likelihoods over the chunked level-synchronous tape:
// the global body, for trees past the on-chip body's limit.
//
// Replaces bito_tpu/treelike/pallas_chunked.py::_ll_kernel (the Pallas TPU
// kernel behind chunked_log_likelihoods) on trees whose live partials do
// not fit a block's shared memory; paired_ll_onchip.cu takes the others
// (treelike/chunked.py chunked_log_likelihoods chooses before the launch,
// by chunked.ll_plan).  It computes what that kernel computes: the
// postorder over the chunked tape (build_chunked_encoding), where each
// chunk holds up to W ops that read no slot another op of the chunk
// writes; each op evolves its pair of children by their
// per-category P, multiplies and rescales, with exact per-site log scales;
// then log sum_ca pi*prop*root + log scale at the root slot, per
// (tree, pattern).  The pattern weights are applied outside.
//
// Design: a block takes one tree and a tile of 128/W patterns, with W op
// lanes: thread (x, y) runs lane y of every chunk for pattern x.  On the
// TPU a chunk's W ops were one wide block-diagonal MXU dot; here they run
// side by side on W warps, and one __syncthreads() per chunk orders the
// chunks.  So a thread's serial chain is Mc chunks, not the M ops of the
// paired kernel (14 against 26 at the DS1 shape), and each op is 2 x 16
// float32 FMAs per category, exact to f32: no bf16 hi/lo planes, no
// materialised block diagonals.  The layout has no ones slot: a shared-
// memory mask of the slots that tips and ops write stands for bito_tpu's
// all-ones buffer fill (common.cuh, mark_produced).  Padded grid positions
// (post_dst == trash) are skipped.
//
// What bounds it on the H100: as paired_ll.cu, the partials live in device
// memory ([B, 2*Mc*W + 2, C*4, S] float32, 0.76 GB at W=2, 200 trees x 27
// taxa x 1024 patterns under Gamma4) and each op reads two columns and
// writes one, so it is bound by memory bandwidth and L2.  The lanes shorten
// the dependent chain; they do not cut the bytes.
//
// At 9..32 rate categories the kernel is paired_lanes.cuh's ll_kernel on
// the chunked tape (a category a lane, the slots in device memory as
// float4 [B, 2MW+3, Sp, G], the children by the code of `child`, grid
// order one op at a time), launched here with the same arguments: `buf`
// holds B * (2MW+3) * Sp * G * 4 floats, and `ls` and tip_slot are not
// read.  Past 32 categories it is wide_ll_kernel<true> (K = ceil(C / 32)
// categories a lane of 32; `buf` B * (2MW+3) * Sp * K * 32 * 4 floats).  This layout's registers do not scale to C * 4 values a vector
// (paired_lanes.cuh says why); its walk does not need the chunk's lanes.
#include "common.cuh"
#include "paired_lanes.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(bito::kThreads)
chunked_ll_kernel(const int* __restrict__ post_dst,   // [B, MW]
                  const int* __restrict__ tip_slot,   // [B, T]
                  const int* __restrict__ post_e,     // [B, MW, 2]
                  const float* __restrict__ P,        // [B, N1, C, 4, 4]
                  const float* __restrict__ tips,     // [T, 4, S]
                  const float* __restrict__ pi,       // [4]
                  const float* __restrict__ props,    // [C]
                  float* __restrict__ buf,            // [B, NS, C*4, S]
                  float* __restrict__ ls,             // [B, NS, S]
                  float* __restrict__ ll_rows,        // [B, S]
                  int MW, int W, int T, int N1, int S) {
  extern __shared__ unsigned char produced[];  // [NS]
  constexpr int CA = C * bito::A;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const int lane = threadIdx.y;
  const int b = blockIdx.y;
  const int NS = 2 * MW + 2;
  const int root = 2 * MW;
  const int trash = 2 * MW + 1;

  const int* dst_b = post_dst + static_cast<size_t>(b) * MW;
  const int* tip_b = tip_slot + static_cast<size_t>(b) * T;
  const bito::Column<C> col{
      buf + static_cast<size_t>(b) * NS * CA * S + s, S};
  float* ls_col = ls + static_cast<size_t>(b) * NS * S + s;

  bito::mark_produced(produced, NS, tip_b, T, dst_b, MW);
  if (active) bito::init_tips<C>(col, ls_col, tip_b, tips, T, s, lane, W);
  __syncthreads();
  bito::chunked_postorder<C>(
      col, ls_col, produced, dst_b, post_e + static_cast<size_t>(b) * MW * 2,
      P + static_cast<size_t>(b) * N1 * CA * bito::A, MW / W, W, lane, trash,
      active);
  if (active && lane == 0)
    ll_rows[static_cast<size_t>(b) * S + s] =
        bito::root_ll<C>(col, ls_col, root, pi, props);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  W must
// divide kThreads and MW; the caller checks both.  `child` is the chunked
// tape's child tape (treelike/paired.py child_tape), read at C > 8 only.
extern "C" int bito_chunked_ll(const int* post_dst, const int* tip_slot,
                               const int* child, const int* post_e,
                               const float* P, const float* tips,
                               const float* pi, const float* props,
                               float* buf, float* ls, float* ll_rows, int B,
                               int MW, int W, int T, int N1, int C, int S,
                               void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0 || bito::kThreads % W ||
      MW % W)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 8) {
    float4* slots = reinterpret_cast<float4*>(buf);
    if (C <= 16)
      paired_lanes::ll_kernel<16, true>
          <<<paired_lanes::grid<16>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, child, post_e, P, tips, pi, props, slots, ll_rows,
              MW, T, N1, C, S);
    else if (C <= 32)
      paired_lanes::ll_kernel<32, true>
          <<<paired_lanes::grid<32>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, child, post_e, P, tips, pi, props, slots, ll_rows,
              MW, T, N1, C, S);
    else
      paired_lanes::wide_ll_kernel<true>
          <<<paired_lanes::wide_grid(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, child, post_e, P, tips, pi, props, slots, ll_rows,
              MW, T, N1, C, S);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 block(bito::kThreads / W, W);
  const dim3 grid((S + block.x - 1) / block.x, B);
  const size_t smem = 2 * static_cast<size_t>(MW) + 2;
#define BITO_LAUNCH_CLL(CV)                                                \
  chunked_ll_kernel<CV><<<grid, block, smem, st>>>(                        \
      post_dst, tip_slot, post_e, P, tips, pi, props, buf, ls, ll_rows,    \
      MW, W, T, N1, S)
  BITO_DISPATCH_C(C, BITO_LAUNCH_CLL)
#undef BITO_LAUNCH_CLL
  return static_cast<int>(cudaGetLastError());
}
