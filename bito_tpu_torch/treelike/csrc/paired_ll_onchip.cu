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
//
// The body is the template of paired_ll_onchip.cuh, which the perf lab's
// chunk_variant.cu instantiates with its knobs; this source compiles the
// shipping instantiations: <C, ring> for C = 1..8 with no knob, and for
// 9..32 categories one a lane count (16 or 32) and staging, with the count
// read at run time (idle lanes, g >= C, have zero matrices as at C = 3 or
// 5..7).  At G = 32 a pattern is a whole warp: the shuffles span it, and a
// block of 512 threads holds 16 patterns.  Past 32 categories one a K =
// ceil(C / 32) of 2..4 (C = 33..128) on 32 lanes and the ring: lane g
// holds categories g + 32 k, a row by liveness is K float4s a thread, and
// an op's K products stay in registers for the rescale's max and are
// stored scaled, once.  It carries the paired, chunked and per-node tapes
// past 32 as it does at 1..32.
#include "paired_ll_onchip.cuh"

// `rows` is the peak number of live outputs (paired.py live_rows); `cols`
// patterns per block (a whole number of warps); `ring` the staging (past
// 32 categories the ring only).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bito_paired_ll_onchip(const int* post_dst, const int* child,
                                     const int* live_row, const int* post_e,
                                     const float* P, const float* tips,
                                     const float* pi, const float* props,
                                     float* ll_rows, int B, int M, int T,
                                     int N1, int C, int S, int rows, int cols,
                                     int ring, void* stream) {
  if (paired_ll_onchip::bad_args(B, M, S, rows)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ONCHIP_LAUNCH_LL(CV, RV)                                       \
  return static_cast<int>(paired_ll_onchip::launch<CV, RV>(            \
      post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows, B, \
      M, T, N1, S, rows, cols, st))
#define ONCHIP_LAUNCH_LL_WIDE(GV, RV)                                   \
  return static_cast<int>(paired_ll_onchip::launch_wide<GV, RV>(        \
      post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows, B, \
      M, T, N1, C, S, rows, cols, st))
#define ONCHIP_LAUNCH_LL_K(KV)                                          \
  return static_cast<int>(paired_ll_onchip::launch_k<KV>(               \
      post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows, B, \
      M, T, N1, C, S, rows, cols, st))
  if (C > 32) {
    ONCHIP_DISPATCH_K(C, ring != 0, ONCHIP_LAUNCH_LL_K)
  }
  if (C > 8) {
    ONCHIP_DISPATCH_WIDE(C, ring != 0, ONCHIP_LAUNCH_LL_WIDE)
  }
  ONCHIP_DISPATCH(C, ring != 0, ONCHIP_LAUNCH_LL)
#undef ONCHIP_LAUNCH_LL_K
#undef ONCHIP_LAUNCH_LL_WIDE
#undef ONCHIP_LAUNCH_LL
  return cudaErrorInvalidValue;
}
