// The per-node LL + gradient kernel with the perf lab's three knobs.
//
// Replaces scripts/perf_lab.py::make_variant_kernel (the Pallas TPU kernel
// behind the script's variant_ll_and_gradients), a copy of
// bito_tpu/treelike/pallas_pruning.py::_grad_kernel with three knobs.  It
// has no body of its own: every variant is an instantiation of the
// shipping per-node body, treelike/csrc/pernode_onchip.cuh, whose template
// parameters are the knobs:
//   unroll  MU = 26 post ops and GU = 25 parent groups, the flagship's tape
//           (27 taxa, trifurcating root: M = 26, Mp = 51), fully unrolled;
//   resk    with unroll, only every resk-th op and group rescales (1, 4, 8);
//   nodot   the transition products are skipped, so that P = dP = I in
//           effect (unrolled, with resk 1, as the script runs it).
// The loop (the script's base and loop_resk4) is the shipping body itself:
// bito_pernode_grad_onchip.
//
// It is instantiated for the perf lab's workload only: C = 4 categories
// (GTR+Gamma4).  The entry point refuses anything else.
#include "../../treelike/csrc/pernode_onchip.cuh"

extern "C" int bito_pernode_grad_onchip(
    const int* post, const int* groups, const int* zero, const int* root,
    const float* P, const float* dP, const float* tips, const float* pi,
    const float* props, const float* weights, float* ll_rows,
    float* grad_rows, int B, int M, int NG, int Z, int T, int N1, int C,
    int S, int rows, int cols, void* stream);

namespace {

constexpr int kC = 4;
constexpr int kUnrollM = 26;
constexpr int kUnrollMp = 51;
constexpr int kUnrollGroups = 25;  // one a parent: (Mp - 1) / 2

}  // namespace

// The operands of bito_pernode_grad_onchip, with Mp (the scan tape's
// preorder length, which the unrolled tape must have) beside them.  The
// variants are the loop (base, loop_resk4), and unrolled with resk 1
// (unroll), 4 (resk4), 8 (resk8), or 1 without the products (nodot).
// Returns cudaErrorInvalidValue for anything else (C != 4, an unrolled tape
// other than M = 26, Mp = 51 and 25 groups, resk without unroll, nodot
// with a loop or resk != 1), else cudaGetLastError() after the launch (0 on
// success).
extern "C" int bito_variant_grad(
    const int* post, const int* groups, const int* zero, const int* root,
    const float* P, const float* dP, const float* tips, const float* pi,
    const float* props, const float* weights, float* ll_rows,
    float* grad_rows, int B, int M, int Mp, int NG, int Z, int T, int N1,
    int C, int S, int rows, int cols, int unroll, int resk, int nodot,
    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C != kC) return cudaErrorInvalidValue;
  if (unroll && (M != kUnrollM || Mp != kUnrollMp || NG != kUnrollGroups))
    return cudaErrorInvalidValue;
  if (!unroll && resk != 1) return cudaErrorInvalidValue;
  if (nodot && (!unroll || resk != 1)) return cudaErrorInvalidValue;
  if (!unroll)
    return bito_pernode_grad_onchip(post, groups, zero, root, P, dP, tips, pi,
                                    props, weights, ll_rows, grad_rows, B, M,
                                    NG, Z, T, N1, C, S, rows, cols, stream);
  if (pernode_onchip::bad_args(B, M, NG, Z, S, rows))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BITO_LAUNCH_VARIANT(RK, ND)                                          \
  return static_cast<int>(                                                   \
      pernode_onchip::launch<kC, kUnrollM, kUnrollGroups, RK, ND>(           \
          post, groups, zero, root, P, dP, tips, pi, props, weights,         \
          ll_rows, grad_rows, B, M, NG, Z, T, N1, S, rows, cols, st))
  if (nodot) BITO_LAUNCH_VARIANT(1, true);
  switch (resk) {
    case 1: BITO_LAUNCH_VARIANT(1, false);
    case 4: BITO_LAUNCH_VARIANT(4, false);
    case 8: BITO_LAUNCH_VARIANT(8, false);
    default: return cudaErrorInvalidValue;
  }
#undef BITO_LAUNCH_VARIANT
}
