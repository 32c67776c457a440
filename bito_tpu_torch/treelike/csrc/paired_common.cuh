// Device helpers shared by paired_ll.cu and paired_grad.cu.
//
// Layouts (all row-major, patterns last so that neighbouring threads, which
// own neighbouring patterns, touch neighbouring addresses):
//   P, dP     [B, N1, C, 4, 4]   per-edge transition matrices; N1-1 is the
//                                identity edge (P = I, dP = 0)
//   tips      [T, 4, S]          tip partials, the same for every category
//   buf       [B, NS, C*4, S]    paired-slot partials (scratch), NS = 2M+3
//   ls        [B, NS, S]         per-slot log scales (scratch)
//
// One thread owns one (tree, pattern) column and keeps all C*4 values of
// an op in registers.  Every reduction of the algorithm runs over
// (category, state) of one pattern, so a thread never reads what another
// thread wrote: the tape needs no barrier and no shared memory.
#pragma once

#include <cuda_runtime.h>

namespace bito {

constexpr int A = 4;  // nucleotide states; the kernels take 4-state models only
constexpr int kThreads = 128;  // patterns per block, one thread per pattern

// Column view of one (tree, pattern): slot k, row ca lives at
// col[(k * CA + ca) * S].
template <int C>
struct Column {
  static constexpr int CA = C * A;
  float* base;  // &buf[b, 0, 0, s]
  int S;

  __device__ __forceinline__ float* slot(int k) const {
    return base + static_cast<size_t>(k) * CA * S;
  }
  __device__ __forceinline__ void load(int k, float (&v)[CA]) const {
    const float* p = slot(k);
#pragma unroll
    for (int i = 0; i < CA; ++i) v[i] = p[static_cast<size_t>(i) * S];
  }
  __device__ __forceinline__ void store(int k, const float (&v)[CA]) const {
    float* p = slot(k);
#pragma unroll
    for (int i = 0; i < CA; ++i) p[static_cast<size_t>(i) * S] = v[i];
  }
};

// Row a of category c of one edge's matrix, as one 16-byte load.  Every
// thread of a block reads the same address, so the load is a broadcast.
__device__ __forceinline__ float4 mat_row(const float* __restrict__ Pe,
                                          int c, int a) {
  return __ldg(reinterpret_cast<const float4*>(Pe) + c * A + a);
}

// ev[c, a] = sum_k Pe[c, a, k] * p[c, k]
template <int C>
__device__ __forceinline__ void evolve(const float* __restrict__ Pe,
                                       const float (&p)[C * A],
                                       float (&ev)[C * A]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float4 r = mat_row(Pe, c, a);
      float acc = r.x * p[c * A + 0];
      acc = fmaf(r.y, p[c * A + 1], acc);
      acc = fmaf(r.z, p[c * A + 2], acc);
      acc = fmaf(r.w, p[c * A + 3], acc);
      ev[c * A + a] = acc;
    }
  }
}

// up[c, k] = sum_a Pe[c, a, k] * o[c, a]   (the transpose evolve)
template <int C>
__device__ __forceinline__ void evolve_t(const float* __restrict__ Pe,
                                         const float (&o)[C * A],
                                         float (&up)[C * A]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float4 r = mat_row(Pe, c, a);
      const float x = o[c * A + a];
      u0 = fmaf(r.x, x, u0);
      u1 = fmaf(r.y, x, u1);
      u2 = fmaf(r.z, x, u2);
      u3 = fmaf(r.w, x, u3);
    }
    up[c * A + 0] = u0;
    up[c * A + 1] = u1;
    up[c * A + 2] = u2;
    up[c * A + 3] = u3;
  }
}

template <int N>
__device__ __forceinline__ float max_of(const float (&v)[N]) {
  float mx = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mx = fmaxf(mx, v[i]);
  return mx;
}

// Largest entry, or 1 when it is not positive (the rescale guard of
// bito_tpu: an all-zero column keeps scale 1).
template <int N>
__device__ __forceinline__ float scale_of(const float (&v)[N]) {
  const float mx = max_of(v);
  return mx > 0.f ? mx : 1.f;
}

// Load every tip's partial into its pair slot, for all categories, with
// log scale 0.
template <int C>
__device__ __forceinline__ void init_tips(const Column<C>& col,
                                          float* ls_col,
                                          const int* __restrict__ tip_slot_b,
                                          const float* __restrict__ tips,
                                          int T, int s) {
  const int S = col.S;
  for (int t = 0; t < T; ++t) {
    const int k = tip_slot_b[t];
    float v[C * A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float x = tips[(static_cast<size_t>(t) * A + a) * S + s];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c * A + a] = x;
    }
    col.store(k, v);
    ls_col[static_cast<size_t>(k) * S] = 0.f;
  }
}

// The postorder tape.  Op m evolves the pair in slots (2m, 2m+1) along its
// two edges, multiplies, rescales by the largest entry and writes the
// product to slot post_dst[m], with the children's log scales plus
// log(max).  Padded ops (post_dst == trash) are skipped: they only ever
// write the trash slot.
template <int C>
__device__ __forceinline__ void postorder(const Column<C>& col, float* ls_col,
                                          const int* __restrict__ post_dst_b,
                                          const int* __restrict__ post_e_b,
                                          const float* __restrict__ P_b,
                                          int M, int trash) {
  constexpr int CA = C * A;
  const int S = col.S;
  for (int m = 0; m < M; ++m) {
    const int dst = post_dst_b[m];
    if (dst == trash) continue;
    const float* P1 = P_b + static_cast<size_t>(post_e_b[2 * m]) * CA * A;
    const float* P2 = P_b + static_cast<size_t>(post_e_b[2 * m + 1]) * CA * A;
    float p[CA], ev1[CA], ev2[CA];
    col.load(2 * m, p);
    evolve<C>(P1, p, ev1);
    col.load(2 * m + 1, p);
    evolve<C>(P2, p, ev2);
#pragma unroll
    for (int i = 0; i < CA; ++i) ev1[i] *= ev2[i];
    const float mx = scale_of(ev1);
#pragma unroll
    for (int i = 0; i < CA; ++i) ev1[i] /= mx;
    col.store(dst, ev1);
    ls_col[static_cast<size_t>(dst) * S] =
        ls_col[static_cast<size_t>(2 * m) * S] +
        ls_col[static_cast<size_t>(2 * m + 1) * S] + logf(mx);
  }
}

// log sum_c prop_c sum_a pi_a root[c, a] + log scale of the root slot.
template <int C>
__device__ __forceinline__ float root_ll(const Column<C>& col,
                                         const float* ls_col, int root,
                                         const float* __restrict__ pi,
                                         const float* __restrict__ props) {
  float r[C * A];
  col.load(root, r);
  float site = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < A; ++a) acc = fmaf(__ldg(pi + a), r[c * A + a], acc);
    site = fmaf(__ldg(props + c), acc, site);
  }
  return logf(site) + ls_col[static_cast<size_t>(root) * col.S];
}

}  // namespace bito

// Instantiate a launcher for every category count the kernels take.
#define BITO_DISPATCH_C(C_VALUE, LAUNCH) \
  switch (C_VALUE) {                     \
    case 1: LAUNCH(1); break;            \
    case 2: LAUNCH(2); break;            \
    case 3: LAUNCH(3); break;            \
    case 4: LAUNCH(4); break;            \
    case 5: LAUNCH(5); break;            \
    case 6: LAUNCH(6); break;            \
    case 7: LAUNCH(7); break;            \
    case 8: LAUNCH(8); break;            \
    default: return cudaErrorInvalidValue; \
  }
