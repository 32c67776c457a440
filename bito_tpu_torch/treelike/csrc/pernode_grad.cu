// Per-pattern tree log likelihoods and branch-length gradient rows over the
// scan tape's per-node ops.
//
// Replaces bito_tpu/treelike/pallas_pruning.py::_grad_kernel (the Pallas
// TPU kernel behind pallas_ll_and_gradients).  It computes what that kernel
// computes: the postorder and root log likelihood of pernode_ll.cu, then
// the preorder over the scan tape's pre_ops [B, Mp, 6] = (dest, parent,
// s1, e1, s2, e2) with a separate up buffer seeded with pi at the root:
//     o        = up[parent] * (P[e1] p[s1]) * (P[e2] p[s2])   (rescaled)
//     row dest = w * sum_ca prop*o*(dP[dest] p[dest])
//                  / sum_ca prop*o*(P[dest] p[dest])
//     up[dest] = P[dest]^T o
// The partials are never overwritten in the preorder; that is how this
// kernel differs from the paired one, which writes its up pairs over the
// dead partials.  A binary root's child reads slot dummy (all ones) as its
// missing sibling.  Padded ops (dest == dummy) are skipped, and up[dest] is
// not stored for a tip, which has no children to read it.  Rows no op
// writes (the root, dummy) stay as the caller zeroed them, and summing the
// rows over patterns is left to the caller: no float atomics.
//
// Design: one thread per (tree, pattern), no barriers, as paired_grad.cu.
//
// What bounds it on the H100: memory traffic.  A column holds N+1 partial
// slots and N+1 up slots (2 x 53 x 16 floats = 6.8 KB at the DS1 shape,
// against 3.8 KB for the paired kernel's 59 slots), and each preorder op
// reads four columns (up[parent], both siblings, p[dest]) and writes one,
// where a paired outside op reads three and writes two for two edges.
//
// At 9..32 rate categories the kernel is pernode_lanes.cuh's grad_kernel (a
// category a lane, internal nodes' partials and up values in device memory
// as float4 [B, N1-T, Sp, G] each), launched here with the same arguments:
// `buf` and `up` hold B * (N1-T) * Sp * G * 4 floats each and `ls` is not
// read.  Past 32 it is wide_grad_kernel (K = ceil(C / 32) categories a
// lane of 32; `buf` and `up` B * (N1-T) * Sp * K * 32 * 4 floats each).
#include "common.cuh"
#include "pernode_lanes.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(bito::kThreads)
pernode_grad_kernel(const int* __restrict__ post_ops,   // [B, M, 5]
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
  constexpr int CA = C * bito::A;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int b = blockIdx.y;
  const int dummy = N1 - 1;
  const size_t col_off = static_cast<size_t>(b) * N1 * CA * S + s;
  const bito::Column<C> col{buf + col_off, S};
  const bito::Column<C> upc{up + col_off, S};
  float* ls_col = ls + static_cast<size_t>(b) * N1 * S + s;
  const size_t mat_stride = static_cast<size_t>(CA) * bito::A;
  const float* P_b = P + static_cast<size_t>(b) * N1 * mat_stride;
  const float* dP_b = dP + static_cast<size_t>(b) * N1 * mat_stride;
  float* grad_col = grad_rows + static_cast<size_t>(b) * N1 * S + s;

  bito::init_tips<C>(col, ls_col, nullptr, tips, T, s);
  {
    float ones[CA];
    bito::fill(ones, 1.f);
    col.store(dummy, ones);
    ls_col[static_cast<size_t>(dummy) * S] = 0.f;
  }
  bito::pernode_postorder<C>(col, ls_col,
                             post_ops + static_cast<size_t>(b) * M * 5, P_b,
                             M, dummy);
  const int r = root[b];
  ll_rows[static_cast<size_t>(b) * S + s] =
      bito::root_ll<C>(col, ls_col, r, pi, props);
  bito::seed_pi<C>(upc, r, pi);

  const float w = weights[s];
  float prop[C];
#pragma unroll
  for (int c = 0; c < C; ++c) prop[c] = __ldg(props + c);

  const int* pre_b = pre_ops + static_cast<size_t>(b) * Mp * 6;
  for (int m = 0; m < Mp; ++m) {
    const int* op = pre_b + 6 * m;
    const int dst = op[0];
    if (dst == dummy) continue;  // padded op
    float p[CA], ev[CA], o[CA];
    // o = up[parent] * (P[e1] p[s1]) * (P[e2] p[s2]), rescaled.
    upc.load(op[1], o);
    col.load(op[2], p);
    bito::evolve<C>(P_b + static_cast<size_t>(op[3]) * mat_stride, p, ev);
#pragma unroll
    for (int i = 0; i < CA; ++i) o[i] *= ev[i];
    col.load(op[4], p);
    bito::evolve<C>(P_b + static_cast<size_t>(op[5]) * mat_stride, p, ev);
#pragma unroll
    for (int i = 0; i < CA; ++i) o[i] *= ev[i];
    const float mx = bito::scale_of(o);
#pragma unroll
    for (int i = 0; i < CA; ++i) o[i] /= mx;

    const float* Pd = P_b + static_cast<size_t>(dst) * mat_stride;
    col.load(dst, p);
    bito::evolve<C>(Pd, p, ev);
    grad_col[static_cast<size_t>(dst) * S] = bito::grad_ratio<C>(
        dP_b + static_cast<size_t>(dst) * mat_stride, p, ev, o, prop, w);
    if (dst >= T) {
      bito::evolve_t<C>(Pd, o, p);
      upc.store(dst, p);
    }
  }
}

}  // namespace

// grad_rows must be zero-filled by the caller.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int bito_pernode_grad(const int* post_ops, const int* pre_ops,
                                 const int* root, const float* P,
                                 const float* dP, const float* tips,
                                 const float* pi, const float* props,
                                 const float* weights, float* buf, float* up,
                                 float* ls, float* ll_rows, float* grad_rows,
                                 int B, int M, int Mp, int T, int N1, int C,
                                 int S, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 8) {
    if (T >= N1) return cudaErrorInvalidValue;
    float4* rows = reinterpret_cast<float4*>(buf);
    float4* ups = reinterpret_cast<float4*>(up);
    if (C <= 16)
      pernode_lanes::grad_kernel<16>
          <<<paired_lanes::grid<16>(B, S), pernode_lanes::kThreads, 0, st>>>(
              post_ops, pre_ops, root, P, dP, tips, pi, props, weights, rows,
              ups, ll_rows, grad_rows, M, Mp, T, N1, C, S);
    else if (C <= 32)
      pernode_lanes::grad_kernel<32>
          <<<paired_lanes::grid<32>(B, S), pernode_lanes::kThreads, 0, st>>>(
              post_ops, pre_ops, root, P, dP, tips, pi, props, weights, rows,
              ups, ll_rows, grad_rows, M, Mp, T, N1, C, S);
    else
      pernode_lanes::wide_grad_kernel
          <<<paired_lanes::wide_grid(B, S), pernode_lanes::kThreads, 0,
             st>>>(post_ops, pre_ops, root, P, dP, tips, pi, props, weights,
                   rows, ups, ll_rows, grad_rows, M, Mp, T, N1, C, S);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((S + bito::kThreads - 1) / bito::kThreads, B);
#define BITO_LAUNCH_NGRAD(CV)                                              \
  pernode_grad_kernel<CV><<<grid, bito::kThreads, 0, st>>>(               \
      post_ops, pre_ops, root, P, dP, tips, pi, props, weights, buf, up,  \
      ls, ll_rows, grad_rows, M, Mp, T, N1, S)
  BITO_DISPATCH_C(C, BITO_LAUNCH_NGRAD)
#undef BITO_LAUNCH_NGRAD
  return static_cast<int>(cudaGetLastError());
}
