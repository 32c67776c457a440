// Per-pattern tree log likelihoods and branch-length gradient rows over
// the paired-slot tape at 64 states (MG94 codon models).
//
// Replaces bito_tpu/treelike/pallas_paired.py::_grad_kernel at CA = 64 C,
// where bito_tpu runs it on MG94 (kernel="pallas").  It computes what that
// kernel computes: the postorder and root log likelihood of
// paired_ll_a64.cu, then an outside pass in reverse tape order, as
// bito_tpu's _pre_op (pallas_paired.py:347-400) and the port's plain
// paired_ll_and_gradients_ref.  Op m reads its outside value `up` from
// slot post_dst[m] (written earlier in the pass by the op that consumes
// m's output, or pi at the root), and for each child j in two steps:
//   1. with P, dP and the child's partial p staged: ev = P p and
//      dv = dP p; o_j = up * ev of the sibling; the weighted gradient row
//      w * sum_ca prop*o*dv / sum_ca prop*o*ev to row post_src[m, j]
//      (the ratio does not depend on the scale of o);
//   2. after the largest o over both children and all C x 64 entries of a
//      pattern is known, the up value P^T (o 2^-e) over the child's slot,
//      where the child's own op reads it.  A tip child needs none.
// Between the steps o waits in the child's slot, whose partial op m was
// the last to read.  Rows of nodes that no op writes (the root, the trash
// row N1-1) stay as the caller zeroed them; summing the rows over
// patterns is left to the caller, so no float atomics.
//
// What it does not carry over: the bf16 hi/lo planes, the K-stacked
// [4CA, 6CA] forward/derivative operand, the row-stacked transpose
// operand and the exact fourth lo*lo pass of bito_tpu's products; here
// every product (P p, dP p, P^T o) is float32 FMAs on the CUDA cores
// (paired_a64.cuh).
//
// Grid: (pattern tiles of a64::kTile, B), a block of a64::kThreads.
#include "paired_a64.cuh"

namespace {

// Shared memory: P and dP of both children, both children's slices, five
// reductions (num and den of each child, the largest o) and the tile's
// scales, then slot_tip.
constexpr int kGradFloats =
    4 * a64::kMat + 2 * a64::kSlab + 5 * a64::kRed + a64::kTile;

template <int C>
__global__ void __launch_bounds__(a64::kThreads, 2)
paired_grad_a64_kernel(const int* __restrict__ post_dst,   // [B, M]
                       const int* __restrict__ tip_slot,   // [B, T]
                       const int* __restrict__ post_src,   // [B, M, 2]
                       const int* __restrict__ post_e,     // [B, M, 2]
                       const float* __restrict__ P,        // [B, N1, C, 64, 64]
                       const float* __restrict__ dP,       // [B, N1, C, 64, 64]
                       const float* __restrict__ tips,     // [T, 64, S]
                       const float* __restrict__ pi,       // [64]
                       const float* __restrict__ props,    // [C]
                       const float* __restrict__ weights,  // [S]
                       float* __restrict__ buf,            // [B, NS, C, 64, S]
                       float* __restrict__ ls,             // [B, NS, S]
                       float* __restrict__ ll_rows,        // [B, S]
                       float* __restrict__ grad_rows,      // [B, N1, S], zeroed
                       int M, int T, int N1, int S) {
  using a64::kMat;
  using a64::kRed;
  using a64::kRows;
  using a64::kSlab;
  using a64::kTile;
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y;
  const int NS = 2 * M + 3;
  const int root = 2 * M;
  const int trash = 2 * M + 1;
  const a64::Block k = a64::make_block(
      sm, kGradFloats, NS, tip_slot + static_cast<size_t>(b) * T, T, tips,
      buf, ls, C, S);
  float* Ps = sm;                // P of both children
  float* dPs = Ps + 2 * kMat;    // dP of both children
  float* X = dPs + 2 * kMat;     // both children's slices
  float* red = X + 2 * kSlab;    // num0, den0, num1, den1, max
  float* scale = red + 5 * kRed; // 2^-e of each tile column
  const int* dst_b = post_dst + static_cast<size_t>(b) * M;
  const int* e_b = post_e + static_cast<size_t>(b) * M * 2;
  const int* src_b = post_src + static_cast<size_t>(b) * M * 2;
  const float* P_b = P + static_cast<size_t>(b) * N1 * C * kMat;
  const float* dP_b = dP + static_cast<size_t>(b) * N1 * C * kMat;
  float* grad_b = grad_rows + static_cast<size_t>(b) * N1 * S;

  a64::postorder<C>(k, Ps, X, red, dst_b, e_b, P_b, M);
  a64::root_ll<C>(k, red, root, pi, props,
                  ll_rows + static_cast<size_t>(b) * S);

  for (int m = M - 1; m >= 0; --m) {
    const int dst = dst_b[m];
    if (dst == trash) continue;  // padded op
    const int slot[2] = {2 * m, 2 * m + 1};
    const bool is_op[2] = {k.slot_tip[slot[0]] < 0, k.slot_tip[slot[1]] < 0};
    float num[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [child][pattern]
    float den[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float mx[2] = {0.f, 0.f};

    // Step 1: ratios, and o into the op children's slots.
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t mat_at =
            (static_cast<size_t>(e_b[2 * m + j]) * C + c) * kMat;
        a64::stage_mat(Ps + j * kMat, P_b + mat_at);
        a64::stage_mat(dPs + j * kMat, dP_b + mat_at);
        a64::stage_child(X + j * kSlab, k, slot[j], c);
      }
      __syncthreads();
      const float prop = __ldg(props + c);
      float o0[kRows][2], o1[kRows][2];  // ev1, ev0 until overwritten by o
      a64::mat(Ps, X, k, o1);            // ev0
      a64::mat(Ps + kMat, X + kSlab, k, o0);  // ev1
      const float* up = k.at(dst, c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float u =
              dst == root ? __ldg(pi + k.r0 + i)
              : k.in(q) ? up[static_cast<size_t>(k.r0 + i) * k.S + k.c0 + q]
                        : 0.f;
          const float ev0 = o1[i][q], ev1 = o0[i][q];
          o0[i][q] = u * ev1;
          o1[i][q] = u * ev0;
          den[0][q] = fmaf(prop * o0[i][q], ev0, den[0][q]);
          den[1][q] = fmaf(prop * o1[i][q], ev1, den[1][q]);
          mx[q] = fmaxf(mx[q], fmaxf(o0[i][q], o1[i][q]));
        }
      float dv[kRows][2];
      a64::mat(dPs, X, k, dv);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          num[0][q] = fmaf(prop * o0[i][q], dv[i][q], num[0][q]);
      a64::mat(dPs + kMat, X + kSlab, k, dv);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          num[1][q] = fmaf(prop * o1[i][q], dv[i][q], num[1][q]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!is_op[j]) continue;
        float* out = k.at(slot[j], c);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (k.in(q))
              out[static_cast<size_t>(k.r0 + i) * k.S + k.c0 + q] =
                  j == 0 ? o0[i][q] : o1[i][q];
      }
      __syncthreads();  // before the next category's staging
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = k.warp * kTile + k.c0 + q;
      red[col] = num[0][q];
      red[kRed + col] = den[0][q];
      red[2 * kRed + col] = num[1][q];
      red[3 * kRed + col] = den[1][q];
      red[4 * kRed + col] = mx[q];
    }
    __syncthreads();
    if (k.warp == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = k.c0 + q;
        scale[col] = ldexpf(1.f, -a64::exponent_of(
                                     a64::warp_max(red + 4 * kRed, col)));
        if (!k.in(q)) continue;
        const int s = k.s0 + col;
        const float w = __ldg(weights + s);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float d = a64::warp_sum(red + (2 * j + 1) * kRed, col);
          d = d > 0.f ? d : 1.f;
          grad_b[static_cast<size_t>(src_b[2 * m + j]) * S + s] =
              w * a64::warp_sum(red + 2 * j * kRed, col) / d;
        }
      }
    }
    __syncthreads();

    // Step 2: the up values P^T (o 2^-e) of the op children.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!is_op[j]) continue;
      for (int c = 0; c < C; ++c) {
        a64::stage_mat(Ps, P_b + (static_cast<size_t>(e_b[2 * m + j]) * C +
                                  c) * kMat);
        a64::stage_slab(X, k.at(slot[j], c), k, scale);
        __syncthreads();
        float upv[kRows][2];
        a64::mat_t(Ps, X, k, upv);
        float* out = k.at(slot[j], c);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (k.in(q))
              out[static_cast<size_t>(k.r0 + i) * k.S + k.c0 + q] = upv[i][q];
        __syncthreads();  // before the next staging
      }
    }
  }
}

}  // namespace

// grad_rows must be zero-filled by the caller.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int bito_paired_grad_a64(const int* post_dst, const int* tip_slot,
                                    const int* post_src, const int* post_e,
                                    const float* P, const float* dP,
                                    const float* tips, const float* pi,
                                    const float* props, const float* weights,
                                    float* buf, float* ls, float* ll_rows,
                                    float* grad_rows, int B, int M, int T,
                                    int N1, int C, int S, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || M <= 0) return cudaErrorInvalidValue;
  const dim3 grid((S + a64::kTile - 1) / a64::kTile, B);
  const size_t smem = a64::smem_bytes(kGradFloats, 2 * M + 3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BITO_LAUNCH_GRAD_A64(CV)                                            \
  {                                                                         \
    const cudaError_t err = cudaFuncSetAttribute(                           \
        paired_grad_a64_kernel<CV>,                                         \
        cudaFuncAttributeMaxDynamicSharedMemorySize,                        \
        static_cast<int>(smem));                                            \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    paired_grad_a64_kernel<CV><<<grid, a64::kThreads, smem, st>>>(          \
        post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props,       \
        weights, buf, ls, ll_rows, grad_rows, M, T, N1, S);                 \
  }
  BITO_DISPATCH_C(C, BITO_LAUNCH_GRAD_A64)
#undef BITO_LAUNCH_GRAD_A64
  return static_cast<int>(cudaGetLastError());
}
