// The per-node grad kernel with every partial on chip: the shipping
// instantiations of pernode_onchip.cuh's body, for C = 1..8 rate
// categories one count at a time, and for 9..32 one a lane count (G = 16
// or 32 lanes a pattern, a group's sums over categories over G lanes) with
// the count read at run time.  At G >= 16 the tree's P and dP staged at
// once take 2 KB (G = 16) or 4 KB (G = 32) an edge, so pernode.py's
// onchip_plan hands trees to pernode_grad.cu sooner.
//
// Replaces bito_tpu/treelike/pallas_pruning.py::_grad_kernel, as
// pernode_grad.cu does; treelike/pernode.py's onchip_plan chooses between
// the two before the launch (pernode_grad.cu takes the trees whose rows
// leave too few warps an SM).
//
// What bounded pernode_grad.cu on the H100 (PERF.md), and what this body
// does about it: a pattern's column of N+1 partial and N+1 up slots lived
// in device memory (1.4 GB a call at the flagship), zero-filled gradient
// rows, five evolves a preorder op, an IEEE divide per rescaled value, P
// and dP through the cache on every op.  Here a node's partial and then
// its up value share one shared-memory row, a parent's children are
// evolved together (three evolves an edge), the rescale is by a power of
// two, P and dP are staged by cp.async, and the kernel writes every
// gradient row itself.
#include "pernode_onchip.cuh"

// `post`, `groups`, `zero` and `rows` are the tape of treelike/pernode.py
// onchip_tape; `cols` patterns per block (whole warps).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bito_pernode_grad_onchip(
    const int* post, const int* groups, const int* zero, const int* root,
    const float* P, const float* dP, const float* tips, const float* pi,
    const float* props, const float* weights, float* ll_rows,
    float* grad_rows, int B, int M, int NG, int Z, int T, int N1, int C,
    int S, int rows, int cols, void* stream) {
  if (pernode_onchip::bad_args(B, M, NG, Z, S, rows))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERNODE_LAUNCH_GRAD(CV)                                             \
  case CV:                                                                  \
    return static_cast<int>(pernode_onchip::launch<CV>(                     \
        post, groups, zero, root, P, dP, tips, pi, props, weights, ll_rows, \
        grad_rows, B, M, NG, Z, T, N1, S, rows, cols, st))
  if (C > 8 && C <= 32) {
    if (C <= 16)
      return static_cast<int>(pernode_onchip::launch_wide<16>(
          post, groups, zero, root, P, dP, tips, pi, props, weights, ll_rows,
          grad_rows, B, M, NG, Z, T, N1, C, S, rows, cols, st));
    return static_cast<int>(pernode_onchip::launch_wide<32>(
        post, groups, zero, root, P, dP, tips, pi, props, weights, ll_rows,
        grad_rows, B, M, NG, Z, T, N1, C, S, rows, cols, st));
  }
  switch (C) {
    PERNODE_LAUNCH_GRAD(1);
    PERNODE_LAUNCH_GRAD(2);
    PERNODE_LAUNCH_GRAD(3);
    PERNODE_LAUNCH_GRAD(4);
    PERNODE_LAUNCH_GRAD(5);
    PERNODE_LAUNCH_GRAD(6);
    PERNODE_LAUNCH_GRAD(7);
    PERNODE_LAUNCH_GRAD(8);
    default: return cudaErrorInvalidValue;
  }
#undef PERNODE_LAUNCH_GRAD
}
