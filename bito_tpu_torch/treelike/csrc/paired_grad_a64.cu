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
// m's output, scaled on reading by 2^-E of that slot; pi at the root),
// and at each category:
//   ev_j = P_j p_j for both children, o_0 = up ev_1, o_1 = up ev_0, and
//   den += prop sum_a up ev_0 ev_1 (the same for both children);
//   up_j = P_j^T o_j over slot 2m+j (its partial was staged at the start
//   of the step), for each op child;
//   then, with dP split over P in the planes, dv_j = dP_j p_j and
//   num_j += prop sum_a o_j dv_j.
// After the last category the gradient rows w num_j / den go to row
// post_src[m, j].  Every factor and sum is scaled as paired_a64.cuh's
// Rescaling says; the ratio does not depend on the scales, which keep
// each value relative to its largest.  A tip child needs no up value.  Rows of nodes
// that no op writes (the root, the trash row N1-1) stay as the caller
// zeroed them; summing the rows over patterns is left to the caller.
//
// What bounds it: the products, six 64x64 products an op and category in
// the outside pass beside the postorder's two, on the tensor cores in
// 3xTF32 (paired_a64.cuh).  ev_j is recomputed there, not kept from the
// postorder: keeping it would store and reload two more [64, S] slices an
// op through device memory, which the products' time does not cover.
// What it does not carry over from bito_tpu: the bf16 hi/lo planes, the
// K-stacked [4CA, 6CA] forward/derivative operand, the row-stacked
// transpose operand and the exact fourth lo*lo pass of its products.
//
// Grid: (pattern tiles of a64::kTile, B), a64::kWarps warps a block, one
// block an SM (208 KB of shared memory: a step's raw P and dP of both children,
// the hi and lo planes of two of them, and each warp's slices).
#include "paired_a64.cuh"

namespace {

constexpr int kRaw = 4;  // raw matrices a step: P, then dP, of both children
constexpr size_t kSmem = a64::smem_bytes(kRaw);

// What an outside op carries across its categories, for rows r = 0, 1:
// sums over the categories, each category's terms by 2^(e_c - emax).
struct OutAcc {
  float num0[2], num1[2];  // sum prop o_j dv_j
  float den[2];            // sum prop up ev_0 ev_1
  float emax[2];           // the largest e_c of o so far
};

// Outside step (m, c): Ms the planes, which hold P0 and P1 split, and
// swap() (a barrier, dP0 and dP1 split over them, a barrier) once the P
// products are done.
template <class Swap>
__device__ __forceinline__ void out_step(
    const a64::Warp& w, const float* Ms, int m, int c, int C, int M,
    const int* __restrict__ dst_b, const int* __restrict__ src_b,
    const float* __restrict__ pi, const float* __restrict__ props,
    const float* __restrict__ weights, OutAcc& st, float* grad_b,
    Swap&& swap) {
  using a64::kMat;
  const int dst = __ldg(dst_b + m);
  const bool root = dst == 2 * M;
  const bool op0 = w.code[2 * m] == a64::kBuf;
  const bool op1 = w.code[2 * m + 1] == a64::kBuf;
  // fu: up's factor 2^(e_c - E) (1 at the root); f: the children's.
  float fu[2], f[2][2], mx[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    fu[r] = root ? 1.f : w.rel_scale(dst, c, r);
#pragma unroll
    for (int j = 0; j < 2; ++j) f[j][r] = w.child_scale(m, j, c, r);
    if (c == 0) st.num0[r] = st.num1[r] = st.den[r] = 0.f;
  }
  float up[8][4];
  const float* upc = w.at(dst, c);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = 8 * n + 2 * w.t + (i & 1);
      up[n][i] = root ? __ldg(pi + a)
                 : w.in(i >> 1)
                     ? upc[static_cast<size_t>(a) * w.S + w.g + 8 * (i >> 1)]
                     : 0.f;
    }
  float o0[8][4], o1[8][4], x[8][4];
  a64::evolve(Ms + 2 * kMat, w.X + a64::kSlice, o0, w.bo, w.g, w.t);  // ev1
  a64::evolve(Ms, w.X, o1, w.bo, w.g, w.t);                           // ev0
  // The largest o = up ev_sibling of the category, then its exponent e_c.
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const float u = up[n][i] * fu[r];
      mx[r] = fmaxf(mx[r], fmaxf(u * (o0[n][i] * f[1][r]),
                                 u * (o1[n][i] * f[0][r])));
    }
  const float prop = __ldg(props + c);
  float g[2], wc[2];  // 2^-e_c; prop 2^(e_c - emax)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float e = static_cast<float>(a64::exponent_of(a64::quad_max(mx[r])));
    if (c == 0 || e > st.emax[r]) {
      if (c > 0) {
        const float k = a64::inv_pow2(e - st.emax[r]);
        st.num0[r] *= k;
        st.num1[r] *= k;
        st.den[r] *= k;
      }
      st.emax[r] = e;
    }
    g[r] = a64::inv_pow2(e);
    wc[r] = prop * a64::inv_pow2(st.emax[r] - e);
    if (w.t == 0 && w.in(r)) {
      if (op0) w.e(2 * m, c)[w.s(r)] = e;
      if (op1) w.e(2 * m + 1, c)[w.s(r)] = e;
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const float u = up[n][i] * (fu[r] * g[r]);
      const float ev1 = o0[n][i] * f[1][r], ev0 = o1[n][i] * f[0][r];
      o0[n][i] = u * ev1;
      o1[n][i] = u * ev0;
      st.den[r] = fmaf(wc[r] * o0[n][i], ev0, st.den[r]);
    }
  if (op0) {
    a64::evolve_t(Ms, o0, x, w.bo);  // up0
    a64::store(w, w.at(2 * m, c), x);
  }
  if (op1) {
    a64::evolve_t(Ms + 2 * kMat, o1, x, w.bo);  // up1
    a64::store(w, w.at(2 * m + 1, c), x);
  }
  swap();
  a64::evolve(Ms, w.X, x, w.bo, w.g, w.t);  // dv0
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      st.num0[r] = fmaf(wc[r] * o0[n][i], x[n][i] * f[0][r], st.num0[r]);
    }
  a64::evolve(Ms + 2 * kMat, w.X + a64::kSlice, x, w.bo, w.g, w.t);  // dv1
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      st.num1[r] = fmaf(wc[r] * o1[n][i], x[n][i] * f[1][r], st.num1[r]);
    }
  if (c + 1 < C) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float num0 = a64::quad_sum(st.num0[r]);
    const float num1 = a64::quad_sum(st.num1[r]);
    const float den = a64::quad_sum(st.den[r]);
    if (w.t != 0 || !w.in(r)) continue;
    const int s = w.s(r);
    const float wd = __ldg(weights + s) / (den > 0.f ? den : 1.f);
    grad_b[static_cast<size_t>(__ldg(src_b + 2 * m)) * w.S + s] = wd * num0;
    grad_b[static_cast<size_t>(__ldg(src_b + 2 * m + 1)) * w.S + s] =
        wd * num1;
    if (op0) w.E(2 * m)[s] = st.emax[r];
    if (op1) w.E(2 * m + 1)[s] = st.emax[r];
  }
}

__global__ void __launch_bounds__(a64::kThreads, 1)
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
                       float* __restrict__ scratch,        // paired_a64.cuh
                       float* __restrict__ ll_rows,        // [B, S]
                       float* __restrict__ grad_rows,      // [B, N1, S], zeroed
                       int M, int T, int N1, int C, int S) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y;
  const int NS = 2 * M + 3;
  const int* dst_b = post_dst + static_cast<size_t>(b) * M;
  const int* e_b = post_e + static_cast<size_t>(b) * M * 2;
  const int* src_b = post_src + static_cast<size_t>(b) * M * 2;
  const size_t tree = static_cast<size_t>(b) * N1 * C * a64::kMat;
  const float* P_b = P + tree;
  const float* dP_b = dP + tree;
  float* raw = sm;
  float* planes = raw + kRaw * a64::kMat;
  int* codes = reinterpret_cast<int*>(
      scratch + static_cast<size_t>(gridDim.y) * NS * (2 + C) * S);
  const a64::Warp w = a64::make_warp(
      planes + 2 * a64::kPlanes * a64::kMat, buf, scratch, codes, tips, C, S,
      NS);
  a64::fill_codes(const_cast<int*>(w.code), dst_b,
                            tip_slot + static_cast<size_t>(b) * T, M, T);
  float* ll_row = ll_rows + static_cast<size_t>(b) * S;
  float* grad_b = grad_rows + static_cast<size_t>(b) * N1 * S;

  a64::Step cur = a64::next_step({0, -1, C - 1}, dst_b, M, C, true);
  a64::stage_mats(raw, cur, e_b, P_b, dP_b, C);
  a64::cp_commit();
  // The postorder, then the outside pass: two loops, so that neither
  // phase's accumulators hold registers in the other.
  {
    a64::PostAcc post;
    while (cur.phase == 0) {
      const a64::Step nxt = a64::next_step(cur, dst_b, M, C, true);
      a64::begin_step(w, cur, raw, planes);
      if (nxt.m >= 0)  // the next step's matrices, during the products
        a64::stage_mats(raw, nxt, e_b, P_b, dP_b, C);
      a64::cp_commit();
      a64::post_step<2>(w, planes, cur.m, cur.c, C, M, dst_b, pi, props,
                        post, ll_row);
      cur = nxt;
    }
  }
  OutAcc out;
  while (cur.m >= 0) {
    const a64::Step nxt = a64::next_step(cur, dst_b, M, C, true);
    a64::begin_step(w, cur, raw, planes);
    out_step(w, planes, cur.m, cur.c, C, M, dst_b, src_b, pi, props, weights,
             out, grad_b, [&] {
               __syncthreads();  // every warp is done with P's planes
               a64::split_mats(planes, raw + 2 * a64::kMat, 2);
               __syncthreads();
               // The next step's matrices, once this step's are split.
               if (nxt.m >= 0) a64::stage_mats(raw, nxt, e_b, P_b, dP_b, C);
               a64::cp_commit();
             });
    cur = nxt;
  }
}

}  // namespace

// grad_rows must be zero-filled by the caller.  Returns cudaGetLastError()
// after the launch (0 on success).  S, the operands and `scratch` as in
// bito_paired_ll_a64.
extern "C" int bito_paired_grad_a64(const int* post_dst, const int* tip_slot,
                                    const int* post_src, const int* post_e,
                                    const float* P, const float* dP,
                                    const float* tips, const float* pi,
                                    const float* props, const float* weights,
                                    float* buf, float* scratch,
                                    float* ll_rows, float* grad_rows, int B,
                                    int M, int T, int N1, int C, int S,
                                    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || S % 4 != 0 || M <= 0 || C < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((S + a64::kTile - 1) / a64::kTile, B);
  cudaError_t err = cudaFuncSetAttribute(
      paired_grad_a64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paired_grad_a64_kernel<<<grid, a64::kThreads, kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props, weights,
      buf, scratch, ll_rows, grad_rows, M, T, N1, C, S);
  return static_cast<int>(cudaGetLastError());
}
