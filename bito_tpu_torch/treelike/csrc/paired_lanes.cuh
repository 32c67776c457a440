// The global bodies of the paired kernels past 8 rate categories:
// paired_ll.cu and paired_grad.cu launch them where C > 8, and so do
// chunked_ll.cu and chunked_grad.cu on the chunked tape.  They compute
// what those sources' C = 1..8 bodies compute, over the same paired-slot
// tape, in the on-chip bodies' lane layout (onchip.cuh) with the slots in
// device memory.
//
// Why not the C = 1..8 layout: there one thread takes a pattern and holds
// all C*4 values of each vector of an op in registers; the grad body
// already spills at C = 8, and at C = 32 (128 values a vector, six
// vectors) that cannot hold.  Here a pattern has G = 16 or 32 lanes, lane g
// holding category g's 4 states as one float4 (idle lanes, g >= C, compute
// zeros), and the sums over categories are shuffles over the G lanes.
// Past 32 categories (the wide kernels at the end of this file) a pattern
// keeps G = 32 lanes and lane g holds K = ceil(C / 32) categories, g,
// g + 32, ..., each as one float4 (idle pairs, c >= C, compute zeros); K
// is read at run time, so one instantiation takes every count.
//
// A block of kThreads threads takes one tree (blockIdx.y) and kThreads / G
// patterns.  The slots are float4 [B, NS, Sp, G]: slot k of pattern s,
// lane g at ((b NS + k) Sp + s) G + g, so that a warp's lanes touch 512
// contiguous bytes.  Sp is S rounded up to a block's patterns: a thread
// past the last pattern computes a copy of it in a column of its own
// (every lane of a warp takes part in the shuffles) and writes no output.
// One group of lanes walks the whole tape for its pattern, so, as in
// paired_grad.cu, the outside pass's in-place writes need no barrier.  As
// in the on-chip bodies, each op rescales by a power of two and the root's
// log scale is the running sum of the exponents: no log-scale slots.
// The matrices are read from device memory (L1 and L2 resident: every
// pattern of a tree reads the same ones).
//
// Two tapes (the template's kChunked):
//   - the paired tape (false): the tips are copied into the slots that
//     tip_slot names, and op m's gradient rows are post_src[m, j];
//   - the chunked tape (true, treelike/chunked.py), walked one grid op at a
//     time as a paired tape, which it is: grid op g reads pair slots (2g,
//     2g+1) and writes slot post_dst[g], the root is slot 2MW and the trash
//     slot 2MW+1.  A chunk's ops read no slot another of them writes, so
//     grid order is a postorder.  Its children come by child code
//     (treelike/paired.py child_tape): an op's output from its slot, a tip
//     read in place, ones for a slot that nothing writes (a DUMMY child,
//     which the paired tape's trees never read); op g's gradient rows are
//     its grid rows 2g and 2g+1 (chunked.py finish_rows maps them to
//     nodes).
#pragma once

#include "onchip.cuh"

namespace paired_lanes {

using onchip::A;
constexpr int kThreads = 128;  // threads a block (treelike/paired.py GLOBAL_THREADS)

namespace {

// This lane's slots of one pattern: slot k at base[k * stride].
struct Slots {
  float4* base;
  size_t stride;
  __device__ __forceinline__ float4& operator[](int k) const {
    return base[static_cast<size_t>(k) * stride];
  }
};

// The lane's category of matrix Pe ([C, 4, 4]) times p, or zeros on an
// idle lane.
__device__ __forceinline__ float4 evolve(const float* __restrict__ Pe, int g,
                                         int C, float4 p) {
  if (g >= C) return make_float4(0.f, 0.f, 0.f, 0.f);
  return onchip::evolve<1>(reinterpret_cast<const float4*>(Pe) + g * A, p);
}

// Its transpose times o, or zeros on an idle lane.
__device__ __forceinline__ float4 evolve_t(const float* __restrict__ Pe,
                                           int g, int C, float4 o) {
  if (g >= C) return make_float4(0.f, 0.f, 0.f, 0.f);
  return onchip::evolve_t<1>(reinterpret_cast<const float4*>(Pe) + g * A, o);
}

// Where a thread's pattern lies: its lane, its column (s_raw) and the
// pattern whose tips and weight it reads (s).
template <int G>
struct Lane {
  int g, s_raw, s;
  __device__ __forceinline__ explicit Lane(int S)
      : g(threadIdx.x % G),
        s_raw(blockIdx.x * (kThreads / G) + threadIdx.x / G),
        s(min(s_raw, S - 1)) {}
  __device__ __forceinline__ Slots slots(float4* buf, int NS) const {
    const int Sp = gridDim.x * (kThreads / G);
    return Slots{buf + (static_cast<size_t>(blockIdx.y) * NS * Sp + s_raw) *
                           G + g,
                 static_cast<size_t>(Sp) * G};
  }
};

// Child j of op m: on the chunked tape by its code (slot 2m+j where an op
// wrote it, else a tip in place or ones), on the paired tape its slot.
template <bool kChunked>
__device__ __forceinline__ float4 child_value(const Slots& col,
                                              const int* __restrict__ ch_b,
                                              int k, int T, int S,
                                              const float* __restrict__ tips_s) {
  if constexpr (kChunked) {
    const int code = ch_b[k];
    if (code < 0) return onchip::leaf_value(code, T, S, tips_s);
  }
  return col[k];
}

// The tips into their slots (paired tape), then the postorder: op m
// evolves its children along its edges, multiplies, rescales over the
// pattern's lanes and writes slot post_dst[m]; at the root op, the
// pattern's log likelihood (the same on every lane), which is returned.
// `tip_b` is the tree's tip_slot on the paired tape, its child codes on
// the chunked tape.
template <int G, bool kChunked>
__device__ __forceinline__ float postorder(
    const Lane<G>& ln, const Slots& col, const int* __restrict__ dst_b,
    const int* __restrict__ tip_b, const int* __restrict__ e_b,
    const float* __restrict__ P_b, const float* __restrict__ tips,
    const float* __restrict__ pi, float prop, int M, int T, int C, int S) {
  const float* const tips_s = tips + ln.s;
  if constexpr (!kChunked) {
    for (int t = 0; t < T; ++t) {
      const float* p = tips_s + static_cast<size_t>(t) * A * S;
      col[tip_b[t]] = make_float4(__ldg(p), __ldg(p + S), __ldg(p + 2 * S),
                                  __ldg(p + 3 * S));
    }
  }
  const int root = 2 * M, trash = 2 * M + 1;
  const size_t mat = static_cast<size_t>(C) * A * A;
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  int lsc = 0;  // the running log scale, in powers of two
  float site = 1.f;
  for (int m = 0; m < M; ++m) {
    const int dst = dst_b[m];
    if (dst == trash) continue;  // a padded op: the whole block skips it
    float4 prod = onchip::mul(
        evolve(P_b + e_b[2 * m] * mat, ln.g, C,
               child_value<kChunked>(col, tip_b, 2 * m, T, S, tips_s)),
        evolve(P_b + e_b[2 * m + 1] * mat, ln.g, C,
               child_value<kChunked>(col, tip_b, 2 * m + 1, T, S, tips_s)));
    const int ex = onchip::scale_exponent(
        onchip::group_max<G>(onchip::max4(prod)));
    prod = onchip::scale(prod, onchip::pow2_neg(ex));
    lsc += ex;
    if (dst == root)
      site = onchip::group_sum<G>(prop * onchip::dot(pi4, prod));
    else
      col[dst] = prod;
  }
  return logf(site) + lsc * onchip::kLn2;
}

template <int G, bool kChunked>
__global__ void __launch_bounds__(kThreads)
ll_kernel(const int* __restrict__ post_dst,   // [B, M]
          const int* __restrict__ tip_slot,   // [B, T]; chunked: child [B, M, 2]
          const int* __restrict__ post_e,     // [B, M, 2]
          const float* __restrict__ P,        // [B, N1, C, 4, 4]
          const float* __restrict__ tips,     // [T, 4, S]
          const float* __restrict__ pi,       // [4]
          const float* __restrict__ props,    // [C]
          float4* __restrict__ buf,           // [B, 2M+3, Sp, G]
          float* __restrict__ ll_rows,        // [B, S]
          int M, int T, int N1, int C, int S) {
  const Lane<G> ln(S);
  const int b = blockIdx.y;
  const float ll = postorder<G, kChunked>(
      ln, ln.slots(buf, 2 * M + 3), post_dst + static_cast<size_t>(b) * M,
      tip_slot + static_cast<size_t>(b) * (kChunked ? 2 * M : T),
      post_e + static_cast<size_t>(b) * 2 * M,
      P + static_cast<size_t>(b) * N1 * C * A * A, tips, pi,
      ln.g < C ? __ldg(props + ln.g) : 0.f, M, T, C, S);
  if (ln.g == 0 && ln.s_raw < S)
    ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;
}

// The postorder, then the outside pass in reverse tape order: op m takes
// its outside value from slot post_dst[m] (pi at the root op), forms both
// children's outside vectors o0 = up * ev1 and o1 = up * ev0, rescales
// them over the pattern's lanes, writes each child's weighted gradient
// row w * sum_ca prop*o*(dP p) / sum_ca prop*o*(P p) to row post_src[m, j]
// (the chunked tape: 2m + j) of the tree's NR rows, then P^T o over slots
// (2m, 2m+1), whose partials op m was the last to read (on the chunked
// tape only where an op's output is there: nothing reads a tip's).
template <int G, bool kChunked>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const int* __restrict__ post_dst,   // [B, M]
            const int* __restrict__ tip_slot,   // [B, T]; chunked: child [B, M, 2]
            const int* __restrict__ post_src,   // [B, M, 2]; chunked: unread
            const int* __restrict__ post_e,     // [B, M, 2]
            const float* __restrict__ P,        // [B, N1, C, 4, 4]
            const float* __restrict__ dP,       // [B, N1, C, 4, 4]
            const float* __restrict__ tips,     // [T, 4, S]
            const float* __restrict__ pi,       // [4]
            const float* __restrict__ props,    // [C]
            const float* __restrict__ weights,  // [S]
            float4* __restrict__ buf,           // [B, 2M+3, Sp, G]
            float* __restrict__ ll_rows,        // [B, S]
            float* __restrict__ grad_rows,      // [B, NR, S], zeroed
            int M, int T, int N1, int C, int S, int NR) {
  const Lane<G> ln(S);
  const int b = blockIdx.y;
  const Slots col = ln.slots(buf, 2 * M + 3);
  const int* dst_b = post_dst + static_cast<size_t>(b) * M;
  const int* tip_b =
      tip_slot + static_cast<size_t>(b) * (kChunked ? 2 * M : T);
  const int* e_b = post_e + static_cast<size_t>(b) * 2 * M;
  const int* src_b =
      kChunked ? nullptr : post_src + static_cast<size_t>(b) * 2 * M;
  const float* const tips_s = tips + ln.s;
  const size_t tree = static_cast<size_t>(b) * N1 * C * A * A;
  const size_t mat = static_cast<size_t>(C) * A * A;
  const float prop = ln.g < C ? __ldg(props + ln.g) : 0.f;
  const bool writer = ln.g == 0 && ln.s_raw < S;
  const float ll = postorder<G, kChunked>(ln, col, dst_b, tip_b, e_b,
                                          P + tree, tips, pi, prop, M, T, C,
                                          S);
  if (writer) ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;

  const int root = 2 * M, trash = 2 * M + 1;
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float w = __ldg(weights + ln.s);
  float* const grad_b = grad_rows + static_cast<size_t>(b) * NR * S +
                        ln.s_raw;
  for (int m = M - 1; m >= 0; --m) {
    const int dst = dst_b[m];
    if (dst == trash) continue;
    const float* P0 = P + tree + e_b[2 * m] * mat;
    const float* P1 = P + tree + e_b[2 * m + 1] * mat;
    const float4 p0 = child_value<kChunked>(col, tip_b, 2 * m, T, S, tips_s);
    const float4 p1 =
        child_value<kChunked>(col, tip_b, 2 * m + 1, T, S, tips_s);
    const float4 ev0 = evolve(P0, ln.g, C, p0), ev1 = evolve(P1, ln.g, C, p1);
    const float4 up = dst == root ? pi4 : col[dst];
    float4 o0 = onchip::mul(up, ev1), o1 = onchip::mul(up, ev0);
    const float inv = onchip::pow2_neg(onchip::scale_exponent(
        onchip::group_max<G>(fmaxf(onchip::max4(o0), onchip::max4(o1)))));
    o0 = onchip::scale(o0, inv);
    o1 = onchip::scale(o1, inv);
    const float n0 = onchip::group_sum<G>(prop * onchip::dot(
        o0, evolve(dP + tree + e_b[2 * m] * mat, ln.g, C, p0)));
    const float n1 = onchip::group_sum<G>(prop * onchip::dot(
        o1, evolve(dP + tree + e_b[2 * m + 1] * mat, ln.g, C, p1)));
    float d0 = onchip::group_sum<G>(prop * onchip::dot(o0, ev0));
    float d1 = onchip::group_sum<G>(prop * onchip::dot(o1, ev1));
    if (writer) {
      d0 = d0 > 0.f ? d0 : 1.f;
      d1 = d1 > 0.f ? d1 : 1.f;
      const int r0 = kChunked ? 2 * m : src_b[2 * m];
      const int r1 = kChunked ? 2 * m + 1 : src_b[2 * m + 1];
      grad_b[static_cast<size_t>(r0) * S] = w * n0 / d0;
      grad_b[static_cast<size_t>(r1) * S] = w * n1 / d1;
    }
    if (!kChunked || tip_b[2 * m] >= 0) col[2 * m] = evolve_t(P0, ln.g, C, o0);
    if (!kChunked || tip_b[2 * m + 1] >= 0)
      col[2 * m + 1] = evolve_t(P1, ln.g, C, o1);
  }
}

// The grid of either kernel: blocks of kThreads / G patterns by trees.
template <int G>
dim3 grid(int B, int S) {
  constexpr int per = kThreads / G;
  return dim3((S + per - 1) / per, B);
}

// ---------------------------------------------------------------------------
// Past 32 categories: the wide kernels
// ---------------------------------------------------------------------------
//
// A pattern has kWideLanes = 32 lanes (a warp) and lane g holds categories
// g + 32 k for k < K = ceil(C / 32).  The slots are float4
// [B, NS, Sp, K, 32]: slot j of pattern s, lane g, its k-th category at
// (((b NS + j) Sp + s) K + k) 32 + g, so that for each k a warp still
// touches 512 contiguous bytes (at K = 1 the layout of G = 32 above).
// Each lane folds its own K values first (the rescale's max, each sum
// over categories), then the warp's shuffles fold the lanes.  No array
// is sized by K: an op's rescale needs the largest of all its products
// before any is scaled, so the postorder stores its products unscaled and
// scales them in place in a second pass over k (both passes by the same
// thread, in program order), and the outside pass takes the largest o in
// a first pass and forms everything from the scaled o in a second,
// evaluating the children's evolves again.  Sp is S rounded up to 4, a
// block's patterns.

constexpr int kWideLanes = 32;

// Categories a lane holds past 32: K = ceil(C / 32).
__host__ __device__ __forceinline__ int wide_categories(int C) {
  return (C + kWideLanes - 1) / kWideLanes;
}

// This lane's slots of one pattern: slot j's k-th category at
// base[j * stride + k * kWideLanes].
struct WideSlots {
  float4* base;
  size_t stride;
  __device__ __forceinline__ float4& operator()(int j, int k) const {
    return base[static_cast<size_t>(j) * stride +
                static_cast<size_t>(k) * kWideLanes];
  }
};

// Where a thread's pattern lies, as Lane<32>, with K categories a lane.
struct WideLane {
  int g, s_raw, s, K;
  __device__ __forceinline__ WideLane(int S, int C)
      : g(threadIdx.x % kWideLanes),
        s_raw(blockIdx.x * (kThreads / kWideLanes) +
              threadIdx.x / kWideLanes),
        s(min(s_raw, S - 1)),
        K(wide_categories(C)) {}
  // The lane's category at its k-th place.
  __device__ __forceinline__ int cat(int k) const {
    return g + kWideLanes * k;
  }
  __device__ __forceinline__ WideSlots slots(float4* buf, int NS) const {
    const int Sp = gridDim.x * (kThreads / kWideLanes);
    const size_t col = static_cast<size_t>(K) * kWideLanes;
    return WideSlots{
        buf + (static_cast<size_t>(blockIdx.y) * NS * Sp + s_raw) * col + g,
        static_cast<size_t>(Sp) * col};
  }
};

// Category c's proportion, 0 past C.
__device__ __forceinline__ float prop_of(const float* __restrict__ props,
                                         int c, int C) {
  return c < C ? __ldg(props + c) : 0.f;
}

// Child j of op m at the lane's k-th category, as child_value.
template <bool kChunked>
__device__ __forceinline__ float4 wide_child(const WideSlots& col,
                                             const int* __restrict__ ch_b,
                                             int j, int k, int T, int S,
                                             const float* __restrict__ tips_s) {
  if constexpr (kChunked) {
    const int code = ch_b[j];
    if (code < 0) return onchip::leaf_value(code, T, S, tips_s);
  }
  return col(j, k);
}

// postorder past 32 categories: each op's products go to slot post_dst[m]
// (the root op's too, to slot 2M, which the outside pass does not read),
// then the group's rescale over all of them, then each is scaled in place
// (at the root op, folded into the site sum instead).
template <bool kChunked>
__device__ __forceinline__ float wide_postorder(
    const WideLane& ln, const WideSlots& col, const int* __restrict__ dst_b,
    const int* __restrict__ tip_b, const int* __restrict__ e_b,
    const float* __restrict__ P_b, const float* __restrict__ tips,
    const float* __restrict__ pi, const float* __restrict__ props, int M,
    int T, int C, int S) {
  const float* const tips_s = tips + ln.s;
  if constexpr (!kChunked) {
    for (int t = 0; t < T; ++t) {
      const float* p = tips_s + static_cast<size_t>(t) * A * S;
      const float4 v = make_float4(__ldg(p), __ldg(p + S), __ldg(p + 2 * S),
                                   __ldg(p + 3 * S));
      for (int k = 0; k < ln.K; ++k) col(tip_b[t], k) = v;
    }
  }
  const int root = 2 * M, trash = 2 * M + 1;
  const size_t mat = static_cast<size_t>(C) * A * A;
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  int lsc = 0;  // the running log scale, in powers of two
  float site = 1.f;
  for (int m = 0; m < M; ++m) {
    const int dst = dst_b[m];
    if (dst == trash) continue;  // a padded op: the whole block skips it
    const float* const P0 = P_b + e_b[2 * m] * mat;
    const float* const P1 = P_b + e_b[2 * m + 1] * mat;
    float mx = 0.f;
    for (int k = 0; k < ln.K; ++k) {
      const int c = ln.cat(k);
      const float4 prod = onchip::mul(
          evolve(P0, c, C,
                 wide_child<kChunked>(col, tip_b, 2 * m, k, T, S, tips_s)),
          evolve(P1, c, C,
                 wide_child<kChunked>(col, tip_b, 2 * m + 1, k, T, S,
                                      tips_s)));
      mx = fmaxf(mx, onchip::max4(prod));
      col(dst, k) = prod;
    }
    const int ex = onchip::scale_exponent(
        onchip::group_max<kWideLanes>(mx));
    const float inv = onchip::pow2_neg(ex);
    lsc += ex;
    float acc = 0.f;
    for (int k = 0; k < ln.K; ++k) {
      const float4 p = onchip::scale(col(dst, k), inv);
      if (dst == root)
        acc += prop_of(props, ln.cat(k), C) * onchip::dot(pi4, p);
      else
        col(dst, k) = p;
    }
    if (dst == root) site = onchip::group_sum<kWideLanes>(acc);
  }
  return logf(site) + lsc * onchip::kLn2;
}

template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
wide_ll_kernel(const int* __restrict__ post_dst,   // [B, M]
               const int* __restrict__ tip_slot,   // [B, T]; chunked: child [B, M, 2]
               const int* __restrict__ post_e,     // [B, M, 2]
               const float* __restrict__ P,        // [B, N1, C, 4, 4]
               const float* __restrict__ tips,     // [T, 4, S]
               const float* __restrict__ pi,       // [4]
               const float* __restrict__ props,    // [C]
               float4* __restrict__ buf,           // [B, 2M+3, Sp, K, 32]
               float* __restrict__ ll_rows,        // [B, S]
               int M, int T, int N1, int C, int S) {
  const WideLane ln(S, C);
  const int b = blockIdx.y;
  const float ll = wide_postorder<kChunked>(
      ln, ln.slots(buf, 2 * M + 3), post_dst + static_cast<size_t>(b) * M,
      tip_slot + static_cast<size_t>(b) * (kChunked ? 2 * M : T),
      post_e + static_cast<size_t>(b) * 2 * M,
      P + static_cast<size_t>(b) * N1 * C * A * A, tips, pi, props, M, T, C,
      S);
  if (ln.g == 0 && ln.s_raw < S)
    ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;
}

// grad_kernel past 32 categories.  Op m's outside step in two passes over
// the lane's categories: the first takes the largest of o0 = up ev1 and
// o1 = up ev0 over them, the second forms the scaled o's again, adds
// their terms to the lane's four sums (num and den of both children) and
// writes P^T o over the children's slots (each category's after its own
// reads).
template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
wide_grad_kernel(const int* __restrict__ post_dst,   // [B, M]
                 const int* __restrict__ tip_slot,   // [B, T]; chunked: child [B, M, 2]
                 const int* __restrict__ post_src,   // [B, M, 2]; chunked: unread
                 const int* __restrict__ post_e,     // [B, M, 2]
                 const float* __restrict__ P,        // [B, N1, C, 4, 4]
                 const float* __restrict__ dP,       // [B, N1, C, 4, 4]
                 const float* __restrict__ tips,     // [T, 4, S]
                 const float* __restrict__ pi,       // [4]
                 const float* __restrict__ props,    // [C]
                 const float* __restrict__ weights,  // [S]
                 float4* __restrict__ buf,           // [B, 2M+3, Sp, K, 32]
                 float* __restrict__ ll_rows,        // [B, S]
                 float* __restrict__ grad_rows,      // [B, NR, S], zeroed
                 int M, int T, int N1, int C, int S, int NR) {
  const WideLane ln(S, C);
  const int b = blockIdx.y;
  const WideSlots col = ln.slots(buf, 2 * M + 3);
  const int* dst_b = post_dst + static_cast<size_t>(b) * M;
  const int* tip_b =
      tip_slot + static_cast<size_t>(b) * (kChunked ? 2 * M : T);
  const int* e_b = post_e + static_cast<size_t>(b) * 2 * M;
  const int* src_b =
      kChunked ? nullptr : post_src + static_cast<size_t>(b) * 2 * M;
  const float* const tips_s = tips + ln.s;
  const size_t tree = static_cast<size_t>(b) * N1 * C * A * A;
  const size_t mat = static_cast<size_t>(C) * A * A;
  const bool writer = ln.g == 0 && ln.s_raw < S;
  const float ll = wide_postorder<kChunked>(ln, col, dst_b, tip_b, e_b,
                                            P + tree, tips, pi, props, M, T,
                                            C, S);
  if (writer) ll_rows[static_cast<size_t>(b) * S + ln.s_raw] = ll;

  const int root = 2 * M, trash = 2 * M + 1;
  const float4 pi4 = make_float4(__ldg(pi), __ldg(pi + 1), __ldg(pi + 2),
                                 __ldg(pi + 3));
  const float w = __ldg(weights + ln.s);
  float* const grad_b = grad_rows + static_cast<size_t>(b) * NR * S +
                        ln.s_raw;
  for (int m = M - 1; m >= 0; --m) {
    const int dst = dst_b[m];
    if (dst == trash) continue;
    const float* P0 = P + tree + e_b[2 * m] * mat;
    const float* P1 = P + tree + e_b[2 * m + 1] * mat;
    float mx = 0.f;
    for (int k = 0; k < ln.K; ++k) {
      const int c = ln.cat(k);
      const float4 ev0 = evolve(
          P0, c, C, wide_child<kChunked>(col, tip_b, 2 * m, k, T, S, tips_s));
      const float4 ev1 = evolve(
          P1, c, C,
          wide_child<kChunked>(col, tip_b, 2 * m + 1, k, T, S, tips_s));
      const float4 up = dst == root ? pi4 : col(dst, k);
      mx = fmaxf(mx, fmaxf(onchip::max4(onchip::mul(up, ev1)),
                           onchip::max4(onchip::mul(up, ev0))));
    }
    const float inv = onchip::pow2_neg(
        onchip::scale_exponent(onchip::group_max<kWideLanes>(mx)));
    float n0 = 0.f, n1 = 0.f, d0 = 0.f, d1 = 0.f;
    for (int k = 0; k < ln.K; ++k) {
      const int c = ln.cat(k);
      const float prop = prop_of(props, c, C);
      const float4 p0 =
          wide_child<kChunked>(col, tip_b, 2 * m, k, T, S, tips_s);
      const float4 p1 =
          wide_child<kChunked>(col, tip_b, 2 * m + 1, k, T, S, tips_s);
      const float4 ev0 = evolve(P0, c, C, p0), ev1 = evolve(P1, c, C, p1);
      const float4 up = dst == root ? pi4 : col(dst, k);
      const float4 o0 = onchip::scale(onchip::mul(up, ev1), inv);
      const float4 o1 = onchip::scale(onchip::mul(up, ev0), inv);
      n0 += prop * onchip::dot(
          o0, evolve(dP + tree + e_b[2 * m] * mat, c, C, p0));
      n1 += prop * onchip::dot(
          o1, evolve(dP + tree + e_b[2 * m + 1] * mat, c, C, p1));
      d0 += prop * onchip::dot(o0, ev0);
      d1 += prop * onchip::dot(o1, ev1);
      if (!kChunked || tip_b[2 * m] >= 0)
        col(2 * m, k) = evolve_t(P0, c, C, o0);
      if (!kChunked || tip_b[2 * m + 1] >= 0)
        col(2 * m + 1, k) = evolve_t(P1, c, C, o1);
    }
    n0 = onchip::group_sum<kWideLanes>(n0);
    n1 = onchip::group_sum<kWideLanes>(n1);
    d0 = onchip::group_sum<kWideLanes>(d0);
    d1 = onchip::group_sum<kWideLanes>(d1);
    if (writer) {
      d0 = d0 > 0.f ? d0 : 1.f;
      d1 = d1 > 0.f ? d1 : 1.f;
      const int r0 = kChunked ? 2 * m : src_b[2 * m];
      const int r1 = kChunked ? 2 * m + 1 : src_b[2 * m + 1];
      grad_b[static_cast<size_t>(r0) * S] = w * n0 / d0;
      grad_b[static_cast<size_t>(r1) * S] = w * n1 / d1;
    }
  }
}

// The grid of either wide kernel: blocks of kThreads / 32 patterns by
// trees.
inline dim3 wide_grid(int B, int S) { return grid<kWideLanes>(B, S); }

}  // namespace
}  // namespace paired_lanes
