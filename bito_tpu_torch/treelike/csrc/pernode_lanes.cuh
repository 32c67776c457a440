// The global bodies of the per-node kernels past 8 rate categories:
// pernode_ll.cu and pernode_grad.cu launch them where C > 8.  They compute
// what those sources' C = 1..8 bodies compute, over the scan tape's own
// post_ops [B, M, 5] = (dest, src1, edge1, src2, edge2) and pre_ops
// [B, Mp, 6] = (dest, parent, sib1, edge1, sib2, edge2), in the lane layout
// of paired_lanes.cuh: a pattern has G = 16 or 32 lanes, lane g holding
// category g's 4 states as one float4 (idle lanes, g >= C, compute zeros),
// and the sums over categories are shuffles over the G lanes.  Past 32
// categories (the wide kernels at the end of this file) lane g of a
// pattern's 32 holds K = ceil(C / 32) categories, in paired_lanes.cuh's
// wide layout: rows float4 [B, N1-T, Sp, K, 32].
//
// Why not the C = 1..8 layout: there one thread takes a pattern and holds
// C*4 values of each vector in registers; pernode_grad.cu holds five
// vectors an op, which at C = 32 is 640 values.
//
// A block of paired_lanes::kThreads threads takes one tree (blockIdx.y) and
// kThreads / G patterns.  Internal node v's partial lives in row v - T of
// `rows`, float4 [B, R, Sp, G] (R = N1 - T rows a tree: the internal ids
// and the dummy's, which nothing writes; Sp is S rounded up to a block's
// patterns, as in paired_lanes.cuh).  A tip is read in place from
// tips[t, :, s], and the dummy N as all ones, which the op still evolves
// through its edge (the identity N), as pernode_ll.cu does.  Padded ops
// (dest N) are skipped.  The trifurcating root's accumulator [u, u, N, x, x]
// reads row u before it writes it, in one thread's program order.  Each
// op rescales by a power of two over the pattern's lanes, and the root's
// log scale is the running sum of the exponents: every op's output enters
// the root's partial once.
//
// The grad body then walks pre_ops in order with the up values of the
// internal nodes in rows of their own (`up`, laid out as `rows`), as
// pernode_grad.cu does: the partials stay, so an op may read any node's.
// Op (c, v, s1, e1, s2, e2):
//     o        = up[v] * (P[e1] p[s1]) * (P[e2] p[s2])   (rescaled; up at
//                the root is pi)
//     row c    = w * sum_ca prop*o*(dP[c] p[c]) / sum_ca prop*o*(P[c] p[c])
//     up[c]    = P[c]^T o, for an internal c
// Gradient rows of nodes that no op writes stay as the caller zeroed them.
// The matrices are read from device memory (L1 and L2 resident: every
// pattern of a tree reads the same ones).
#pragma once

#include "paired_lanes.cuh"

namespace pernode_lanes {

using onchip::A;
using paired_lanes::kThreads;

namespace {

// Node n's partial: a tip in place, the dummy as ones, else its row.
__device__ __forceinline__ float4 node_value(const paired_lanes::Slots& row,
                                             int n, int T, int N, int S,
                                             const float* __restrict__ tips_s) {
  if (n < T) {
    const float* p = tips_s + static_cast<size_t>(n) * A * S;
    return make_float4(__ldg(p), __ldg(p + S), __ldg(p + 2 * S),
                       __ldg(p + 3 * S));
  }
  if (n == N) return make_float4(1.f, 1.f, 1.f, 1.f);
  return row[n - T];
}

// The postorder over post_ops into the rows; returns the root's log
// likelihood (the same on every lane of the pattern).
template <int G>
__device__ __forceinline__ float postorder(
    const paired_lanes::Lane<G>& ln, const paired_lanes::Slots& row,
    const int* __restrict__ ops_b, int root, const float* __restrict__ P_b,
    const float* __restrict__ tips, const float* __restrict__ pi, float prop,
    int M, int T, int N1, int C, int S) {
  const float* const tips_s = tips + ln.s;
  const int N = N1 - 1;
  const size_t mat = static_cast<size_t>(C) * A * A;
  int lsc = 0;  // the running log scale, in powers of two
  for (int m = 0; m < M; ++m) {
    const int* op = ops_b + 5 * m;
    const int dst = op[0];
    if (dst == N) continue;  // a padded op: the whole block skips it
    float4 prod = onchip::mul(
        paired_lanes::evolve(P_b + op[2] * mat, ln.g, C,
                             node_value(row, op[1], T, N, S, tips_s)),
        paired_lanes::evolve(P_b + op[4] * mat, ln.g, C,
                             node_value(row, op[3], T, N, S, tips_s)));
    const int ex = onchip::scale_exponent(
        onchip::group_max<G>(onchip::max4(prod)));
    row[dst - T] = onchip::scale(prod, onchip::pow2_neg(ex));
    lsc += ex;
  }
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float site =
      onchip::group_sum<G>(prop * onchip::dot(pi4, row[root - T]));
  return logf(site) + lsc * onchip::kLn2;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
ll_kernel(const int* __restrict__ post_ops,  // [B, M, 5]
          const int* __restrict__ root,      // [B]
          const float* __restrict__ P,       // [B, N1, C, 4, 4]
          const float* __restrict__ tips,    // [T, 4, S]
          const float* __restrict__ pi,      // [4]
          const float* __restrict__ props,   // [C]
          float4* __restrict__ rows,         // [B, N1-T, Sp, G]
          float* __restrict__ ll_rows,       // [B, S]
          int M, int T, int N1, int C, int S) {
  const paired_lanes::Lane<G> ln(S);
  const int b = blockIdx.y;
  const float ll = postorder<G>(
      ln, ln.slots(rows, N1 - T), post_ops + static_cast<size_t>(b) * 5 * M,
      __ldg(root + b), P + static_cast<size_t>(b) * N1 * C * A * A, tips, pi,
      ln.g < C ? __ldg(props + ln.g) : 0.f, M, T, N1, C, S);
  if (ln.g == 0 && ln.s_raw < S)
    ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const int* __restrict__ post_ops,  // [B, M, 5]
            const int* __restrict__ pre_ops,   // [B, Mp, 6]
            const int* __restrict__ root,      // [B]
            const float* __restrict__ P,       // [B, N1, C, 4, 4]
            const float* __restrict__ dP,      // [B, N1, C, 4, 4]
            const float* __restrict__ tips,    // [T, 4, S]
            const float* __restrict__ pi,      // [4]
            const float* __restrict__ props,   // [C]
            const float* __restrict__ weights, // [S]
            float4* __restrict__ rows,         // [B, N1-T, Sp, G]
            float4* __restrict__ up,           // [B, N1-T, Sp, G]
            float* __restrict__ ll_rows,       // [B, S]
            float* __restrict__ grad_rows,     // [B, N1, S], zeroed
            int M, int Mp, int T, int N1, int C, int S) {
  const paired_lanes::Lane<G> ln(S);
  const int b = blockIdx.y;
  const int N = N1 - 1;
  const paired_lanes::Slots row = ln.slots(rows, N1 - T);
  const paired_lanes::Slots upr = ln.slots(up, N1 - T);
  const size_t mat = static_cast<size_t>(C) * A * A;
  const float* const P_b = P + static_cast<size_t>(b) * N1 * mat;
  const float* const dP_b = dP + static_cast<size_t>(b) * N1 * mat;
  const float* const tips_s = tips + ln.s;
  const float prop = ln.g < C ? __ldg(props + ln.g) : 0.f;
  const bool writer = ln.g == 0 && ln.s_raw < S;
  const int r = __ldg(root + b);
  const float ll = postorder<G>(ln, row,
                                post_ops + static_cast<size_t>(b) * 5 * M, r,
                                P_b, tips, pi, prop, M, T, N1, C, S);
  if (writer) ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;

  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float w = __ldg(weights + ln.s);
  float* const grad_b = grad_rows + static_cast<size_t>(b) * N1 * S +
                        ln.s_raw;
  const int* pre_b = pre_ops + static_cast<size_t>(b) * 6 * Mp;
  for (int m = 0; m < Mp; ++m) {
    const int* op = pre_b + 6 * m;
    const int dst = op[0];
    if (dst == N) continue;  // a padded op
    const int par = op[1];
    float4 o = onchip::mul(
        par == r ? pi4 : upr[par - T],
        onchip::mul(
            paired_lanes::evolve(P_b + op[3] * mat, ln.g, C,
                                 node_value(row, op[2], T, N, S, tips_s)),
            paired_lanes::evolve(P_b + op[5] * mat, ln.g, C,
                                 node_value(row, op[4], T, N, S, tips_s))));
    o = onchip::scale(o, onchip::pow2_neg(onchip::scale_exponent(
                             onchip::group_max<G>(onchip::max4(o)))));
    const float* const Pd = P_b + dst * mat;
    const float4 p = node_value(row, dst, T, N, S, tips_s);
    const float num = onchip::group_sum<G>(prop * onchip::dot(
        o, paired_lanes::evolve(dP_b + dst * mat, ln.g, C, p)));
    float den = onchip::group_sum<G>(
        prop * onchip::dot(o, paired_lanes::evolve(Pd, ln.g, C, p)));
    if (writer) {
      den = den > 0.f ? den : 1.f;
      grad_b[static_cast<size_t>(dst) * S] = w * num / den;
    }
    if (dst >= T) upr[dst - T] = paired_lanes::evolve_t(Pd, ln.g, C, o);
  }
}

// ---------------------------------------------------------------------------
// Past 32 categories: the wide kernels (paired_lanes.cuh's wide layout)
// ---------------------------------------------------------------------------

using paired_lanes::kWideLanes;
using paired_lanes::prop_of;
using paired_lanes::WideLane;
using paired_lanes::WideSlots;

// Node n's partial at the lane's k-th category, as node_value.
__device__ __forceinline__ float4 wide_node(const WideSlots& row, int n,
                                            int k, int T, int N, int S,
                                            const float* __restrict__ tips_s) {
  if (n < T) {
    const float* p = tips_s + static_cast<size_t>(n) * A * S;
    return make_float4(__ldg(p), __ldg(p + S), __ldg(p + 2 * S),
                       __ldg(p + 3 * S));
  }
  if (n == N) return make_float4(1.f, 1.f, 1.f, 1.f);
  return row(n - T, k);
}

// postorder past 32 categories: each op's products to its row unscaled,
// then scaled in place after the group's rescale (the accumulator op
// reads row u and writes it, category by category, in one thread's
// order).
__device__ __forceinline__ float wide_postorder(
    const WideLane& ln, const WideSlots& row, const int* __restrict__ ops_b,
    int root, const float* __restrict__ P_b, const float* __restrict__ tips,
    const float* __restrict__ pi, const float* __restrict__ props, int M,
    int T, int N1, int C, int S) {
  const float* const tips_s = tips + ln.s;
  const int N = N1 - 1;
  const size_t mat = static_cast<size_t>(C) * A * A;
  int lsc = 0;  // the running log scale, in powers of two
  for (int m = 0; m < M; ++m) {
    const int* op = ops_b + 5 * m;
    const int dst = op[0];
    if (dst == N) continue;  // a padded op: the whole block skips it
    float mx = 0.f;
    for (int k = 0; k < ln.K; ++k) {
      const int c = ln.cat(k);
      const float4 prod = onchip::mul(
          paired_lanes::evolve(P_b + op[2] * mat, c, C,
                               wide_node(row, op[1], k, T, N, S, tips_s)),
          paired_lanes::evolve(P_b + op[4] * mat, c, C,
                               wide_node(row, op[3], k, T, N, S, tips_s)));
      mx = fmaxf(mx, onchip::max4(prod));
      row(dst - T, k) = prod;
    }
    const int ex = onchip::scale_exponent(
        onchip::group_max<kWideLanes>(mx));
    const float inv = onchip::pow2_neg(ex);
    for (int k = 0; k < ln.K; ++k)
      row(dst - T, k) = onchip::scale(row(dst - T, k), inv);
    lsc += ex;
  }
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  float acc = 0.f;
  for (int k = 0; k < ln.K; ++k)
    acc += prop_of(props, ln.cat(k), C) * onchip::dot(pi4, row(root - T, k));
  return logf(onchip::group_sum<kWideLanes>(acc)) + lsc * onchip::kLn2;
}

__global__ void __launch_bounds__(kThreads)
wide_ll_kernel(const int* __restrict__ post_ops,  // [B, M, 5]
               const int* __restrict__ root,      // [B]
               const float* __restrict__ P,       // [B, N1, C, 4, 4]
               const float* __restrict__ tips,    // [T, 4, S]
               const float* __restrict__ pi,      // [4]
               const float* __restrict__ props,   // [C]
               float4* __restrict__ rows,         // [B, N1-T, Sp, K, 32]
               float* __restrict__ ll_rows,       // [B, S]
               int M, int T, int N1, int C, int S) {
  const WideLane ln(S, C);
  const int b = blockIdx.y;
  const float ll = wide_postorder(
      ln, ln.slots(rows, N1 - T), post_ops + static_cast<size_t>(b) * 5 * M,
      __ldg(root + b), P + static_cast<size_t>(b) * N1 * C * A * A, tips, pi,
      props, M, T, N1, C, S);
  if (ln.g == 0 && ln.s_raw < S)
    ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;
}

// grad_kernel past 32 categories: each pre op in two passes over the
// lane's categories, the first for the largest o, the second forming the
// scaled o again, the sums and up[dest].
__global__ void __launch_bounds__(kThreads)
wide_grad_kernel(const int* __restrict__ post_ops,  // [B, M, 5]
                 const int* __restrict__ pre_ops,   // [B, Mp, 6]
                 const int* __restrict__ root,      // [B]
                 const float* __restrict__ P,       // [B, N1, C, 4, 4]
                 const float* __restrict__ dP,      // [B, N1, C, 4, 4]
                 const float* __restrict__ tips,    // [T, 4, S]
                 const float* __restrict__ pi,      // [4]
                 const float* __restrict__ props,   // [C]
                 const float* __restrict__ weights, // [S]
                 float4* __restrict__ rows,         // [B, N1-T, Sp, K, 32]
                 float4* __restrict__ up,           // [B, N1-T, Sp, K, 32]
                 float* __restrict__ ll_rows,       // [B, S]
                 float* __restrict__ grad_rows,     // [B, N1, S], zeroed
                 int M, int Mp, int T, int N1, int C, int S) {
  const WideLane ln(S, C);
  const int b = blockIdx.y;
  const int N = N1 - 1;
  const WideSlots row = ln.slots(rows, N1 - T);
  const WideSlots upr = ln.slots(up, N1 - T);
  const size_t mat = static_cast<size_t>(C) * A * A;
  const float* const P_b = P + static_cast<size_t>(b) * N1 * mat;
  const float* const dP_b = dP + static_cast<size_t>(b) * N1 * mat;
  const float* const tips_s = tips + ln.s;
  const bool writer = ln.g == 0 && ln.s_raw < S;
  const int r = __ldg(root + b);
  const float ll = wide_postorder(ln, row,
                                  post_ops + static_cast<size_t>(b) * 5 * M,
                                  r, P_b, tips, pi, props, M, T, N1, C, S);
  if (writer) ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;

  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float w = __ldg(weights + ln.s);
  float* const grad_b = grad_rows + static_cast<size_t>(b) * N1 * S +
                        ln.s_raw;
  const int* pre_b = pre_ops + static_cast<size_t>(b) * 6 * Mp;
  for (int m = 0; m < Mp; ++m) {
    const int* op = pre_b + 6 * m;
    const int dst = op[0];
    if (dst == N) continue;  // a padded op
    const int par = op[1];
    // o at the lane's k-th category, unscaled.
    auto outside = [&](int k) {
      const int c = ln.cat(k);
      return onchip::mul(
          par == r ? pi4 : upr(par - T, k),
          onchip::mul(
              paired_lanes::evolve(P_b + op[3] * mat, c, C,
                                   wide_node(row, op[2], k, T, N, S, tips_s)),
              paired_lanes::evolve(P_b + op[5] * mat, c, C,
                                   wide_node(row, op[4], k, T, N, S,
                                             tips_s))));
    };
    float mx = 0.f;
    for (int k = 0; k < ln.K; ++k) mx = fmaxf(mx, onchip::max4(outside(k)));
    const float inv = onchip::pow2_neg(
        onchip::scale_exponent(onchip::group_max<kWideLanes>(mx)));
    const float* const Pd = P_b + dst * mat;
    float num = 0.f, den = 0.f;
    for (int k = 0; k < ln.K; ++k) {
      const int c = ln.cat(k);
      const float prop = prop_of(props, c, C);
      const float4 o = onchip::scale(outside(k), inv);
      const float4 p = wide_node(row, dst, k, T, N, S, tips_s);
      num += prop * onchip::dot(
          o, paired_lanes::evolve(dP_b + dst * mat, c, C, p));
      den += prop * onchip::dot(o, paired_lanes::evolve(Pd, c, C, p));
      if (dst >= T) upr(dst - T, k) = paired_lanes::evolve_t(Pd, c, C, o);
    }
    num = onchip::group_sum<kWideLanes>(num);
    den = onchip::group_sum<kWideLanes>(den);
    if (writer) {
      den = den > 0.f ? den : 1.f;
      grad_b[static_cast<size_t>(dst) * S] = w * num / den;
    }
  }
}

}  // namespace
}  // namespace pernode_lanes
