// Device helpers of the two on-chip paired kernels (paired_ll_onchip.cu,
// paired_grad_onchip.cu).  They are kept apart from common.cuh, whose
// helpers set the register allocation of the six other tree kernels.
//
// The layout they share.  A block takes one tree (blockIdx.y) and a tile of
// `cols` patterns (blockIdx.x).  A pattern has G lanes, G the power of two
// at or above the category count C: lane g holds category g's 4 states as
// one float4, and lanes g >= C are idle (their matrices are zero, so they
// compute zeros).  Thread tid = x * G + g is lane g of pattern x of the
// tile.  G runs to 32 (C = 17..32: a pattern is a whole warp).  The
// helpers take G as a template parameter and C as an argument: the
// kernels of 1..8 categories pass a compile-time C, those of 9..32 the
// run-time count (one instantiation a G).
//
// Past 32 categories a lane holds K = ceil(C / 32) of them (G = 32, K =
// 2..kMaxK, fixed at compile time, C read at run time): lane g's place k
// is category g + 32 k, its K float4s in registers, and places c >= C are
// idle (zero matrices, as idle lanes).  The helpers then take the row
// width G K as their G: a matrix row of the tree's C categories is G K
// float4s, and place k of lane g is entry g + 32 k of it.
//
// Dynamic shared memory, in this order:
//   rows   [rows][K][threads] float4
//                                   place k of row r of thread tid at
//                                   rows[(r * K + k) * threads + tid]: one
//                                   16-byte access per lane, neighbouring
//                                   threads on neighbouring addresses, no
//                                   bank conflicts.  A thread reads and
//                                   writes only its own slices.
//   mats   [nmat][4][G K] float4    transition matrices by (matrix, row,
//                                   category): the G lanes of a pattern
//                                   read one row of one place's
//                                   categories from 16*G contiguous bytes.
//                                   Either the tree's P (and dP) for every
//                                   edge, staged once, or a ring of two
//                                   buffers of one op's matrices (always
//                                   the ring past 32 categories)
//   tape   int32                    the tree's tape, staged once
// treelike/paired.py's smem_bytes computes the same sizes to choose
// `cols`; the launchers compute them again and refuse more than kSmemMax.
#pragma once

#include <cuda_runtime.h>

namespace onchip {

constexpr int A = 4;               // nucleotide states
constexpr int kMaxThreads = 512;   // launch bound: at most 128 registers
constexpr int kSmemMax = 232448;   // shared memory one block can take
constexpr int kMaxK = 4;           // categories a lane at most: C <= 128
// The grad body's launch bound past 32 categories: its K places' o0 and
// o1 stay in registers through the outside pass, which at 128 registers
// spilled (up to 80 bytes at K = 4); at 256 threads it may take 255.  Its
// blocks hold at most 7 warps at the flagship anyway.
constexpr int kMaxThreadsK = 256;

template <int C>
struct Lanes {
  static constexpr int G = C <= 1   ? 1
                           : C <= 2 ? 2
                           : C <= 4 ? 4
                           : C <= 8 ? 8
                           : C <= 16 ? 16
                                     : 32;
};

// Bytes of dynamic shared memory: `mats_per_op` is 2 for the LL kernel (P
// of both children) and 4 for the grad kernel (P and dP); `tape_ints` the
// staged tape's ints; K the categories a lane.
inline size_t smem_bytes(int rows, int threads, int G, int N1,
                         int mats_per_op, bool ring, int tape_ints,
                         int K = 1) {
  const size_t mats = ring ? 2 * mats_per_op : N1 * mats_per_op / 2;
  return static_cast<size_t>(rows) * K * threads * 16 +
         mats * G * K * A * 16 +
         (static_cast<size_t>(tape_ints) * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Reductions over the G lanes of one pattern.  Every thread of the warp
// takes part (threads past the last pattern compute a copy of it), so the
// full mask is right.
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, G));
  return v;
}
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, G);
  return v;
}

// The rescale.  A vector is scaled by 2^-e, e the exponent that puts its
// largest entry mx in [0.5, 1) (0 where mx is not positive; at most 126,
// so that 2^-e is a normal float).  The product by 2^-e is exact, and the
// log scale is the integer sum of the e's times log 2.
constexpr float kLn2 = 0.693147180559945309f;

__device__ __forceinline__ int scale_exponent(float mx) {
  if (!(mx > 0.f)) return 0;
  return min(((__float_as_int(mx) >> 23) & 0xff) - 126, 126);
}
__device__ __forceinline__ float pow2_neg(int e) {
  return __int_as_float((127 - e) << 23);
}

__device__ __forceinline__ float4 mul(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 scale(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float dot(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ float max4(float4 a) {
  return fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w));
}

// The lane's 4 rows of matrix slot k: row a at Mg[a * G].
template <int G>
__device__ __forceinline__ const float4* lane_rows(const float4* mats, int k,
                                                   int g) {
  return mats + k * A * G + g;
}

// ev[a] = sum_k M[a][k] p[k], M the lane's 4 rows.
template <int G>
__device__ __forceinline__ float4 evolve(const float4* __restrict__ Mg,
                                         float4 p) {
  return make_float4(dot(Mg[0], p), dot(Mg[G], p), dot(Mg[2 * G], p),
                     dot(Mg[3 * G], p));
}

// up[k] = sum_a M[a][k] o[a]   (the transpose evolve)
template <int G>
__device__ __forceinline__ float4 evolve_t(const float4* __restrict__ Mg,
                                           float4 o) {
  const float4 r0 = Mg[0], r1 = Mg[G], r2 = Mg[2 * G], r3 = Mg[3 * G];
  return make_float4(
      fmaf(r0.x, o.x, fmaf(r1.x, o.y, fmaf(r2.x, o.z, r3.x * o.w))),
      fmaf(r0.y, o.x, fmaf(r1.y, o.y, fmaf(r2.y, o.z, r3.y * o.w))),
      fmaf(r0.z, o.x, fmaf(r1.z, o.y, fmaf(r2.z, o.z, r3.z * o.w))),
      fmaf(r0.w, o.x, fmaf(r1.w, o.y, fmaf(r2.w, o.z, r3.w * o.w))));
}

// Copy row i % 4 of category i / 4 of matrix `e` of one tree ([N1, C, 4,
// 4] float32, row-major) into slot `k` of `dst` ([slot][4][G] float4), as
// one 16-byte cp.async.  Idle lanes' rows are not touched (zero_idle
// zeroes them once).
template <int G>
__device__ __forceinline__ void copy_matrix(float4* dst, int k,
                                            const float* __restrict__ src_b,
                                            int C, int e, int i) {
  const int c = i / A, a = i % A;
  cp_async16(dst + (k * A + a) * G + c,
             src_b + (static_cast<size_t>(e) * C + c) * A * A + a * A);
}

// Zero the rows of idle lanes (g >= C) of `nmat` matrix slots.
template <int G>
__device__ __forceinline__ void zero_idle(float4* mats, int nmat, int C) {
  if (G > C) {
    const int idle = G - C;
    for (int i = threadIdx.x; i < nmat * A * idle; i += blockDim.x)
      mats[i / idle * G + C + i % idle] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Stage the tree's P for every edge into slots 0 .. N1-1 and, with dP_b,
// its dP into slots N1 .. 2*N1-1.  The caller commits, waits and
// synchronises.
template <int G>
__device__ __forceinline__ void stage_all(float4* mats,
                                          const float* __restrict__ P_b,
                                          const float* __restrict__ dP_b,
                                          int N1, int C) {
  const int per = C * A;
  const int n = N1 * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    copy_matrix<G>(mats, i / per, P_b, C, i / per, i % per);
  if (dP_b)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      copy_matrix<G>(mats, N1 + i / per, dP_b, C, i / per, i % per);
}

// Stage one op's matrices into the ring, slots slot0 ..: P of both
// children's edges (e0, e1), then with dP_b their dP.  The caller commits.
template <int G>
__device__ __forceinline__ void stage_op(float4* mats, int slot0, int e0,
                                         int e1,
                                         const float* __restrict__ P_b,
                                         const float* __restrict__ dP_b,
                                         int C) {
  const int per = C * A;
  const int n = (dP_b ? 4 : 2) * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / per;
    const float* src = k < 2 ? P_b : dP_b;
    copy_matrix<G>(mats, slot0 + k, src, C, (k & 1) ? e1 : e0, i % per);
  }
}

// The partial of a child that is not an op's output.  Child codes
// (treelike/paired.py child_tape): op m' >= 0; tip t as -1 - t; any code
// below -T (INT_MIN) for a slot that nothing writes, read as all ones.
// Tips are read in place from tips [T, 4, S]; tips_s is &tips[0, 0, s].
__device__ __forceinline__ float4 leaf_value(int code, int T, int S,
                                             const float* __restrict__ tips_s) {
  const int t = -1 - code;
  if (code < 0 && t < T) {
    const float* p = tips_s + t * A * S;
    return make_float4(__ldg(p), __ldg(p + S), __ldg(p + 2 * S),
                       __ldg(p + 3 * S));
  }
  return make_float4(1.f, 1.f, 1.f, 1.f);
}

// One op of the staged tape, read into registers an op ahead of its use:
// its destination slot, its children's codes and their edges.
struct Op {
  int dst, c0, c1, e0, e1;
};

__device__ __forceinline__ Op op_at(const int* t_dst, const int* t_child,
                                    const int* t_e, int m) {
  return Op{t_dst[m], t_child[2 * m], t_child[2 * m + 1], t_e[2 * m],
            t_e[2 * m + 1]};
}

}  // namespace onchip

// Instantiate a launcher for every category count 1..8 and both stagings.
#define ONCHIP_DISPATCH(C_VALUE, RING, LAUNCH)                \
  switch ((C_VALUE) * 2 + ((RING) ? 1 : 0)) {                 \
    case 2: LAUNCH(1, false); break;                          \
    case 3: LAUNCH(1, true); break;                           \
    case 4: LAUNCH(2, false); break;                          \
    case 5: LAUNCH(2, true); break;                           \
    case 6: LAUNCH(3, false); break;                          \
    case 7: LAUNCH(3, true); break;                           \
    case 8: LAUNCH(4, false); break;                          \
    case 9: LAUNCH(4, true); break;                           \
    case 10: LAUNCH(5, false); break;                         \
    case 11: LAUNCH(5, true); break;                          \
    case 12: LAUNCH(6, false); break;                         \
    case 13: LAUNCH(6, true); break;                          \
    case 14: LAUNCH(7, false); break;                         \
    case 15: LAUNCH(7, true); break;                          \
    case 16: LAUNCH(8, false); break;                         \
    case 17: LAUNCH(8, true); break;                          \
    default: return cudaErrorInvalidValue;                    \
  }

// The same for 9..32 categories: one launcher a lane count G (16 or 32)
// and staging, which takes the run-time count.
#define ONCHIP_DISPATCH_WIDE(C_VALUE, RING, LAUNCH)            \
  switch (((C_VALUE) <= 16 ? 16 : 32) * 2 + ((RING) ? 1 : 0)) { \
    case 32: LAUNCH(16, false); break;                          \
    case 33: LAUNCH(16, true); break;                           \
    case 64: LAUNCH(32, false); break;                          \
    case 65: LAUNCH(32, true); break;                           \
    default: return cudaErrorInvalidValue;                      \
  }

// Past 32 categories: one launcher a K = ceil(C / 32) of 2..kMaxK, on 32
// lanes and the ring, which takes the run-time count.
#define ONCHIP_DISPATCH_K(C_VALUE, RING, LAUNCH)                \
  if (!(RING)) return cudaErrorInvalidValue;                    \
  switch (((C_VALUE) + 31) / 32) {                              \
    case 2: LAUNCH(2); break;                                   \
    case 3: LAUNCH(3); break;                                   \
    case 4: LAUNCH(4); break;                                   \
    default: return cudaErrorInvalidValue;                      \
  }
