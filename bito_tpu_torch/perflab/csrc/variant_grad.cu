// The per-node LL + gradient kernel with the perf lab's three knobs.
//
// Replaces scripts/perf_lab.py::make_variant_kernel (the Pallas TPU kernel
// behind the script's variant_ll_and_gradients), a copy of
// bito_tpu/treelike/pallas_pruning.py::_grad_kernel with three knobs, which
// are template parameters here:
//   MU, MPU  the trip counts of the postorder and preorder op loops, fixed
//            at compile time and fully unrolled (unroll); 0 for the loops
//            over the run-time counts M and Mp.
//   RESK     with an unrolled loop, op m rescales only when m % RESK ==
//            RESK - 1, in both passes (resk); 1 rescales every op.
//   NODOT    the transition products are skipped, so that P = dP = I in
//            effect (nodot): ev = p, dP p = p and up[dest] = o.
// With MU = 0, RESK = 1 and NODOT false it computes what
// treelike/csrc/pernode_grad.cu computes, through a copy of its body.
//
// It is instantiated for the perf lab's workload only: C = 4 categories
// (GTR+Gamma4), the script's variants and, unrolled, the flagship's tape
// lengths M = 26 and Mp = 51 (27 taxa, trifurcating root).  The entry
// point refuses anything else.
//
// Design: one thread per (tree, pattern), no barriers, as pernode_grad.cu.
// What bounds it on the H100 is what bounds pernode_grad: the traffic of
// the column of 53 partial and 53 up slots, which lives in device memory.
// The knobs measure what the products (nodot) and the rescale (resk) add
// to that.
#include "../../treelike/csrc/common.cuh"

namespace {

constexpr int kC = 4;
constexpr int kCA = kC * bito::A;
constexpr int kUnrollM = 26;
constexpr int kUnrollMp = 51;

using Col = bito::Column<kC>;

// ev = P[e] p, or p itself without the products.
template <bool NODOT>
__device__ __forceinline__ void evolve_or_copy(const float* __restrict__ Pe,
                                               const float (&p)[kCA],
                                               float (&ev)[kCA]) {
  if constexpr (NODOT) {
#pragma unroll
    for (int i = 0; i < kCA; ++i) ev[i] = p[i];
  } else {
    bito::evolve<kC>(Pe, p, ev);
  }
}

// Postorder op m: (dest, src1, edge1, src2, edge2).
template <bool NODOT>
__device__ __forceinline__ void post_op(const Col& col, float* ls_col,
                                        const int* __restrict__ op,
                                        const float* __restrict__ P_b,
                                        int dummy, bool rescale) {
  constexpr int mat = kCA * bito::A;
  const int dst = op[0];
  if (dst == dummy) return;  // padded op
  float p[kCA], prod[kCA], ev[kCA];
  col.load(op[1], p);
  evolve_or_copy<NODOT>(P_b + static_cast<size_t>(op[2]) * mat, p, prod);
  col.load(op[3], p);
  evolve_or_copy<NODOT>(P_b + static_cast<size_t>(op[4]) * mat, p, ev);
#pragma unroll
  for (int i = 0; i < kCA; ++i) prod[i] *= ev[i];
  const int S = col.S;
  float ls = ls_col[static_cast<size_t>(op[1]) * S] +
             ls_col[static_cast<size_t>(op[3]) * S];
  if (rescale) {
    const float mx = bito::scale_of(prod);
#pragma unroll
    for (int i = 0; i < kCA; ++i) prod[i] /= mx;
    ls += logf(mx);
  }
  col.store(dst, prod);
  ls_col[static_cast<size_t>(dst) * S] = ls;
}

// Preorder op m: (dest, parent, sib1, edge1, sib2, edge2); writes the
// gradient row of dest and up[dest].
template <bool NODOT>
__device__ __forceinline__ void pre_op(const Col& col, const Col& upc,
                                       float* grad_col,
                                       const int* __restrict__ op,
                                       const float* __restrict__ P_b,
                                       const float* __restrict__ dP_b,
                                       const float (&prop)[kC], float w,
                                       int T, int dummy, bool rescale) {
  constexpr int mat = kCA * bito::A;
  const int dst = op[0];
  if (dst == dummy) return;  // padded op
  float p[kCA], ev[kCA], o[kCA];
  upc.load(op[1], o);
  col.load(op[2], p);
  evolve_or_copy<NODOT>(P_b + static_cast<size_t>(op[3]) * mat, p, ev);
#pragma unroll
  for (int i = 0; i < kCA; ++i) o[i] *= ev[i];
  col.load(op[4], p);
  evolve_or_copy<NODOT>(P_b + static_cast<size_t>(op[5]) * mat, p, ev);
#pragma unroll
  for (int i = 0; i < kCA; ++i) o[i] *= ev[i];
  if (rescale) {
    const float mx = bito::scale_of(o);
#pragma unroll
    for (int i = 0; i < kCA; ++i) o[i] /= mx;
  }
  col.load(dst, p);
  float* grad = grad_col + static_cast<size_t>(dst) * col.S;
  if constexpr (NODOT) {
    // num = den = sum_c prop_c o.p
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float x = 0.f;
#pragma unroll
      for (int a = 0; a < bito::A; ++a)
        x = fmaf(o[c * bito::A + a], p[c * bito::A + a], x);
      d = fmaf(prop[c], x, d);
    }
    *grad = w * d / (d > 0.f ? d : 1.f);
    if (dst >= T) upc.store(dst, o);
  } else {
    const float* Pd = P_b + static_cast<size_t>(dst) * mat;
    bito::evolve<kC>(Pd, p, ev);
    *grad = bito::grad_ratio<kC>(dP_b + static_cast<size_t>(dst) * mat, p,
                                 ev, o, prop, w);
    if (dst >= T) {
      bito::evolve_t<kC>(Pd, o, p);
      upc.store(dst, p);
    }
  }
}

template <int MU, int MPU, int RESK, bool NODOT>
__global__ void __launch_bounds__(bito::kThreads)
variant_grad_kernel(const int* __restrict__ post_ops,   // [B, M, 5]
                    const int* __restrict__ pre_ops,    // [B, Mp, 6]
                    const int* __restrict__ root,       // [B]
                    const float* __restrict__ P,        // [B, N1, C, 4, 4]
                    const float* __restrict__ dP,       // [B, N1, C, 4, 4]
                    const float* __restrict__ tips,     // [T, 4, S]
                    const float* __restrict__ pi,       // [4]
                    const float* __restrict__ props,    // [C]
                    const float* __restrict__ weights,  // [S]
                    float* __restrict__ buf,            // [B, N1, C*4, S]
                    float* __restrict__ up,             // [B, N1, C*4, S]
                    float* __restrict__ ls,             // [B, N1, S]
                    float* __restrict__ ll_rows,        // [B, S]
                    float* __restrict__ grad_rows,      // [B, N1, S], zeroed
                    int M, int Mp, int T, int N1, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int b = blockIdx.y;
  const int dummy = N1 - 1;
  const size_t col_off = static_cast<size_t>(b) * N1 * kCA * S + s;
  const Col col{buf + col_off, S};
  const Col upc{up + col_off, S};
  float* ls_col = ls + static_cast<size_t>(b) * N1 * S + s;
  const size_t mat_stride = static_cast<size_t>(kCA) * bito::A;
  const float* P_b = P + static_cast<size_t>(b) * N1 * mat_stride;
  const float* dP_b = dP + static_cast<size_t>(b) * N1 * mat_stride;
  float* grad_col = grad_rows + static_cast<size_t>(b) * N1 * S + s;

  bito::init_tips<kC>(col, ls_col, nullptr, tips, T, s);
  {
    float ones[kCA];
    bito::fill(ones, 1.f);
    col.store(dummy, ones);
    ls_col[static_cast<size_t>(dummy) * S] = 0.f;
  }
  const int* post_b = post_ops + static_cast<size_t>(b) * M * 5;
  if constexpr (MU > 0) {
#pragma unroll
    for (int m = 0; m < MU; ++m)
      post_op<NODOT>(col, ls_col, post_b + 5 * m, P_b, dummy,
                     RESK == 1 || m % RESK == RESK - 1);
  } else {
    for (int m = 0; m < M; ++m)
      post_op<NODOT>(col, ls_col, post_b + 5 * m, P_b, dummy, true);
  }
  const int r = root[b];
  ll_rows[static_cast<size_t>(b) * S + s] =
      bito::root_ll<kC>(col, ls_col, r, pi, props);
  bito::seed_pi<kC>(upc, r, pi);

  const float w = weights[s];
  float prop[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) prop[c] = __ldg(props + c);
  const int* pre_b = pre_ops + static_cast<size_t>(b) * Mp * 6;
  if constexpr (MPU > 0) {
#pragma unroll
    for (int m = 0; m < MPU; ++m)
      pre_op<NODOT>(col, upc, grad_col, pre_b + 6 * m, P_b, dP_b, prop, w, T,
                    dummy, RESK == 1 || m % RESK == RESK - 1);
  } else {
    for (int m = 0; m < Mp; ++m)
      pre_op<NODOT>(col, upc, grad_col, pre_b + 6 * m, P_b, dP_b, prop, w, T,
                    dummy, true);
  }
}

}  // namespace

// grad_rows must be zero-filled by the caller.  The five instantiations are
// the script's variants: the loop (base, loop_resk4), and unrolled with
// resk 1 (unroll), 4 (resk4), 8 (resk8), or 1 without the products (nodot).
// Returns cudaErrorInvalidValue for anything else (C != 4, an unrolled tape
// other than M = 26 and Mp = 51, resk without unroll, nodot with a loop or
// resk != 1), else cudaGetLastError() after the launch (0 on success).
extern "C" int bito_variant_grad(const int* post_ops, const int* pre_ops,
                                 const int* root, const float* P,
                                 const float* dP, const float* tips,
                                 const float* pi, const float* props,
                                 const float* weights, float* buf, float* up,
                                 float* ls, float* ll_rows, float* grad_rows,
                                 int B, int M, int Mp, int T, int N1, int C,
                                 int S, int unroll, int resk, int nodot,
                                 void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C != kC) return cudaErrorInvalidValue;
  if (unroll && (M != kUnrollM || Mp != kUnrollMp)) return cudaErrorInvalidValue;
  if (!unroll && resk != 1) return cudaErrorInvalidValue;
  if (nodot && (!unroll || resk != 1)) return cudaErrorInvalidValue;
  const dim3 grid((S + bito::kThreads - 1) / bito::kThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BITO_LAUNCH_VARIANT(MU, MPU, RK, ND)                                \
  variant_grad_kernel<MU, MPU, RK, ND><<<grid, bito::kThreads, 0, st>>>(    \
      post_ops, pre_ops, root, P, dP, tips, pi, props, weights, buf, up,    \
      ls, ll_rows, grad_rows, M, Mp, T, N1, S)
  if (!unroll) {
    BITO_LAUNCH_VARIANT(0, 0, 1, false);
  } else if (nodot) {
    BITO_LAUNCH_VARIANT(kUnrollM, kUnrollMp, 1, true);
  } else {
    switch (resk) {
      case 1: BITO_LAUNCH_VARIANT(kUnrollM, kUnrollMp, 1, false); break;
      case 4: BITO_LAUNCH_VARIANT(kUnrollM, kUnrollMp, 4, false); break;
      case 8: BITO_LAUNCH_VARIANT(kUnrollM, kUnrollMp, 8, false); break;
      default: return cudaErrorInvalidValue;
    }
  }
#undef BITO_LAUNCH_VARIANT
  return static_cast<int>(cudaGetLastError());
}
