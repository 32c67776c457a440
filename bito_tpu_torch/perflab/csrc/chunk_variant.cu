// The chunked LL kernel's on-chip body with the chunk lab's knobs.
//
// Replaces scripts/perf_chunk_lab.py's variant bodies (_init_tips_ablate,
// _ll_kernel_unroll, _chunk_post_ablate, _chunk_evolve_ablate), which it
// swaps into bito_tpu/treelike/pallas_chunked.py::_ll_kernel (the Pallas TPU
// kernel, called at pallas_chunked.py:481).  It has no body of its own:
// every variant is an instantiation of the body that the chunked LL kernel
// ships on the card, treelike/csrc/paired_ll_onchip.cuh, walking the chunked
// tape (treelike/chunked.py onchip_tape) one grid op at a time, whose
// template parameters are the knobs:
//   norescale  no rescale: the running log scale stays 0;
//   notips     each leaf reads as all ones instead of tips[t, :, s];
//   fixstore   op m's output row is m % rows (and a child op c's row c %
//              rows), instead of the tape's rows by liveness, with `rows`
//              the least count that keeps live outputs apart
//              (perf_chunk_lab.py fixstore_rows);
//   nodot      the evolve is skipped (P = I), the matrices not staged;
//   unroll     the op walk unrolled over MU = 28 grid ops, the flagship's
//              chunked tape (27 taxa, 26 ops in 14 chunks of W = 2).
// v0 and w<W> (the shipping body on a tape of width W) are the shipping
// instantiation itself: bito_paired_ll_onchip.
//
// It is instantiated for the chunk lab's workload only: C = 4 categories
// (GTR+Gamma4), the matrices staged once per block (the flagship's plan).
// The entry point refuses anything else.
#include "../../treelike/csrc/paired_ll_onchip.cuh"

extern "C" int bito_paired_ll_onchip(const int* post_dst, const int* child,
                                     const int* live_row, const int* post_e,
                                     const float* P, const float* tips,
                                     const float* pi, const float* props,
                                     float* ll_rows, int B, int M, int T,
                                     int N1, int C, int S, int rows, int cols,
                                     int ring, void* stream);

namespace {

constexpr int kC = 4;
constexpr int kUnrollM = 28;  // the flagship's chunked tape: Mc = 14, W = 2

// The variants, as perflab/perf_chunk_lab.py's VARIANT_CODES numbers them.
enum Variant { kV0 = 0, kNoRescale, kNoTips, kFixStore, kNoDot, kUnroll };

}  // namespace

// The operands of bito_paired_ll_onchip and the variant's code.  Returns
// cudaErrorInvalidValue for an unknown variant, or a knob's variant with
// C != 4, the ring staging, or (unroll) a tape other than M = 28; else
// cudaGetLastError() after the launch (0 on success).
extern "C" int bito_chunk_variant(const int* post_dst, const int* child,
                                  const int* live_row, const int* post_e,
                                  const float* P, const float* tips,
                                  const float* pi, const float* props,
                                  float* ll_rows, int B, int M, int T, int N1,
                                  int C, int S, int rows, int cols, int ring,
                                  int variant, void* stream) {
  if (variant == kV0)
    return bito_paired_ll_onchip(post_dst, child, live_row, post_e, P, tips,
                                 pi, props, ll_rows, B, M, T, N1, C, S, rows,
                                 cols, ring, stream);
  if (paired_ll_onchip::bad_args(B, M, S, rows) || C != kC || ring)
    return cudaErrorInvalidValue;
  if (variant == kUnroll && M != kUnrollM) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BITO_LAUNCH_CHUNK(MU, KNOBS)                                        \
  return static_cast<int>(paired_ll_onchip::launch<kC, false, MU, KNOBS>(  \
      post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows, B, M, \
      T, N1, S, rows, cols, st))
  switch (variant) {
    case kNoRescale: BITO_LAUNCH_CHUNK(0, paired_ll_onchip::kNoRescale);
    case kNoTips: BITO_LAUNCH_CHUNK(0, paired_ll_onchip::kNoTips);
    case kFixStore: BITO_LAUNCH_CHUNK(0, paired_ll_onchip::kFixStore);
    case kNoDot: BITO_LAUNCH_CHUNK(0, paired_ll_onchip::kNoDot);
    case kUnroll: BITO_LAUNCH_CHUNK(kUnrollM, 0);
    default: return cudaErrorInvalidValue;
  }
#undef BITO_LAUNCH_CHUNK
}
