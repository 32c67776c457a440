// Device helpers shared by the six tree-likelihood kernels: the paired-slot
// kernels (paired_ll.cu, paired_grad.cu), the chunked ones (chunked_ll.cu,
// chunked_grad.cu) and the per-node ones (pernode_ll.cu, pernode_grad.cu).
//
// Layouts (all row-major, patterns last so that neighbouring threads, which
// own neighbouring patterns, touch neighbouring addresses):
//   P, dP     [B, N1, C, 4, 4]   per-edge transition matrices; N1-1 is the
//                                identity edge (P = I, dP = 0)
//   tips      [T, 4, S]          tip partials, the same for every category
//   buf       [B, NS, C*4, S]    partials by slot (scratch); what a slot
//                                is depends on the kernel's tape
//   ls        [B, NS, S]         per-slot log scales (scratch)
//
// One thread owns one (tree, pattern) column and keeps all C*4 values of
// an op in registers.  Every reduction of the algorithm runs over
// (category, state) of one pattern, so within one op a thread never reads
// what another thread wrote.  The paired and per-node kernels give a thread
// the whole tape and need no barrier; the chunked kernels share a tape
// between W threads of a block and order its chunks with one barrier each.
#pragma once

#include <cuda_runtime.h>

namespace bito {

constexpr int A = 4;  // nucleotide states; the kernels take 4-state models only
constexpr int kThreads = 128;  // threads per block

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

template <int N>
__device__ __forceinline__ void fill(float (&v)[N], float x) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = x;
}

// Load tips first, first + step, ... into their slots, for all categories,
// with log scale 0.  Tip t goes to slot tip_slot_b[t], or to slot t where
// tip_slot_b is null (the per-node layout).
template <int C>
__device__ __forceinline__ void init_tips(const Column<C>& col,
                                          float* ls_col,
                                          const int* __restrict__ tip_slot_b,
                                          const float* __restrict__ tips,
                                          int T, int s, int first = 0,
                                          int step = 1) {
  const int S = col.S;
  for (int t = first; t < T; t += step) {
    const int k = tip_slot_b ? tip_slot_b[t] : t;
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

// Evolve both children along their edges, multiply, and rescale by the
// largest entry: ev1 <- (P1 p1) * (P2 p2) / mx.  Returns log(mx).
template <int C>
__device__ __forceinline__ float pair_product(const float* __restrict__ P1,
                                              const float* __restrict__ P2,
                                              const float (&p1)[C * A],
                                              const float (&p2)[C * A],
                                              float (&ev1)[C * A]) {
  float ev2[C * A];
  evolve<C>(P1, p1, ev1);
  evolve<C>(P2, p2, ev2);
#pragma unroll
  for (int i = 0; i < C * A; ++i) ev1[i] *= ev2[i];
  const float mx = scale_of(ev1);
#pragma unroll
  for (int i = 0; i < C * A; ++i) ev1[i] /= mx;
  return logf(mx);
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

// The per-node postorder over the scan tape's own ops [M, 5] = (dest, src1,
// edge1, src2, edge2): node dest's partial is (P[e1] p[src1]) *
// (P[e2] p[src2]), rescaled, in slot dest.  Both children are loaded before
// the store, so the trifurcating root's accumulator op [u, u, I, x, x],
// which reads its own destination, is right in place.  Padded ops
// (dest == dummy) are skipped.
template <int C>
__device__ __forceinline__ void pernode_postorder(
    const Column<C>& col, float* ls_col, const int* __restrict__ ops_b,
    const float* __restrict__ P_b, int M, int dummy) {
  constexpr int CA = C * A;
  const int S = col.S;
  for (int m = 0; m < M; ++m) {
    const int* op = ops_b + 5 * m;
    const int dst = op[0];
    if (dst == dummy) continue;
    float p1[CA], p2[CA], prod[CA];
    col.load(op[1], p1);
    col.load(op[3], p2);
    const float lmx = pair_product<C>(
        P_b + static_cast<size_t>(op[2]) * CA * A,
        P_b + static_cast<size_t>(op[4]) * CA * A, p1, p2, prod);
    const float ls = ls_col[static_cast<size_t>(op[1]) * S] +
                     ls_col[static_cast<size_t>(op[3]) * S] + lmx;
    col.store(dst, prod);
    ls_col[static_cast<size_t>(dst) * S] = ls;
  }
}

// -- chunked tapes -----------------------------------------------------------
// A block runs one tree's tape for a tile of patterns with W op lanes:
// thread (x, y) runs lane y for pattern x of the tile.  Chunk c's lane k runs
// the op at grid position g = c*W + k, which reads pair slots (2g, 2g+1).
// No op reads a slot that an op of its own chunk writes (the schedule's
// guarantee), so one barrier per chunk orders the tape.

// Marks, in shared memory, the slots that hold a value before the tape reads
// them: the tips' slots and the ops' destinations.  A child whose source is
// the dummy node has an unmarked pair slot and reads as all ones with log
// scale 0, as it did in bito_tpu's kernel, which filled its whole buffer
// with ones.  Ends with a barrier.
__device__ __forceinline__ void mark_produced(unsigned char* produced, int NS,
                                              const int* __restrict__ tip_slot_b,
                                              int T,
                                              const int* __restrict__ dst_b,
                                              int MW) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int i = tid; i < NS; i += nt) produced[i] = 0;
  __syncthreads();
  for (int i = tid; i < T; i += nt) produced[tip_slot_b[i]] = 1;
  for (int i = tid; i < MW; i += nt) produced[dst_b[i]] = 1;
  __syncthreads();
}

// Load the partial in pair slot k (all ones where no tip or op wrote it);
// returns its log scale.
template <int C>
__device__ __forceinline__ float load_child(const Column<C>& col,
                                            const float* ls_col,
                                            const unsigned char* produced,
                                            int k, float (&v)[C * A]) {
  if (!produced[k]) {
    fill(v, 1.f);
    return 0.f;
  }
  col.load(k, v);
  return ls_col[static_cast<size_t>(k) * col.S];
}

// The chunked postorder: Mc chunks in order, lane `lane` of each; `active`
// is false for threads past the last pattern, which only keep the barriers.
// Padded grid positions (post_dst == trash) are skipped.
template <int C>
__device__ __forceinline__ void chunked_postorder(
    const Column<C>& col, float* ls_col, const unsigned char* produced,
    const int* __restrict__ dst_b, const int* __restrict__ e_b,
    const float* __restrict__ P_b, int Mc, int W, int lane, int trash,
    bool active) {
  constexpr int CA = C * A;
  for (int c = 0; c < Mc; ++c) {
    const int g = c * W + lane;
    const int dst = dst_b[g];
    if (active && dst != trash) {
      float p1[CA], p2[CA], prod[CA];
      const float l1 = load_child<C>(col, ls_col, produced, 2 * g, p1);
      const float l2 = load_child<C>(col, ls_col, produced, 2 * g + 1, p2);
      const float lmx = pair_product<C>(
          P_b + static_cast<size_t>(e_b[2 * g]) * CA * A,
          P_b + static_cast<size_t>(e_b[2 * g + 1]) * CA * A, p1, p2, prod);
      col.store(dst, prod);
      ls_col[static_cast<size_t>(dst) * col.S] = l1 + l2 + lmx;
    }
    __syncthreads();
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

// Write pi, for every category, to slot k: the outside value at the root.
template <int C>
__device__ __forceinline__ void seed_pi(const Column<C>& col, int k,
                                        const float* __restrict__ pi) {
  float seed[C * A];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int a = 0; a < A; ++a) seed[c * A + a] = __ldg(pi + a);
  col.store(k, seed);
}

// The weighted gradient row of one edge:
//   w * sum_c prop_c o.(dP p) / sum_c prop_c o.(P p)
// with ev = P p given and dP p computed here.  The ratio does not depend on
// the scale of o.
template <int C>
__device__ __forceinline__ float grad_ratio(const float* __restrict__ dPe,
                                            const float (&p)[C * A],
                                            const float (&ev)[C * A],
                                            const float (&o)[C * A],
                                            const float (&prop)[C], float w) {
  float dv[C * A];
  evolve<C>(dPe, p, dv);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float n = 0.f, d = 0.f;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      n = fmaf(o[c * A + a], dv[c * A + a], n);
      d = fmaf(o[c * A + a], ev[c * A + a], d);
    }
    num = fmaf(prop[c], n, num);
    den = fmaf(prop[c], d, den);
  }
  den = den > 0.f ? den : 1.f;
  return w * num / den;
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
