// Device code shared by the two paired-slot kernels at 64 states
// (paired_ll_a64.cu, paired_grad_a64.cu): MG94 codon models, the 61 sense
// codons padded to 64 (models/codon.py).
//
// Layouts (row-major, patterns last):
//   P, dP   [B, N1, C, 64, 64]  per-edge matrices; N1-1 the identity edge
//   tips    [T, 64, S]          tip partials, the same for every category
//   buf     [B, NS, C, 64, S]   partials by pair slot (scratch, device
//                               memory): NS = 2M+3, slot 2M the root, 2M+1
//                               the trash slot of padded ops
//   ls      [B, NS, S]          base-2 log scale of each slot (scratch)
//
// A block takes one tree (blockIdx.y) and a tile of kTile patterns
// (blockIdx.x) and walks the tree's whole tape, with a barrier between
// steps.  Thread (w, l) of its 8 warps owns states 8w..8w+7 of patterns
// 2l, 2l+1 of the tile.  For each op, child and category the block stages
// the 64x64 matrix (16 KB) and the child's [64, tile] slice (16 KB) in
// shared memory, and each thread forms its 16 outputs as 64-term float32
// FMA dot products (mat, mat_t).  A 4-state thread keeps a column in
// registers; at 64 states one pattern's partials for a 27-taxon tree are
// 53 rows x 256 B a category, so they stay in device memory and each op
// reads them through L2.
//
// Precision: float32 FMAs on the CUDA cores only, no tensor core.  TF32
// keeps about 3 digits, and dP p is a signed contraction that cancels
// (bito_tpu measured a 7e-3 gradient error without the exact fourth pass
// of its bf16 products).
//
// Rescaling: after each postorder op, every pattern's partial is scaled
// by 2^-e, e the exponent of its largest entry over C x 64 (frexp), so the
// largest lies in [0.5, 1), and ls adds e exactly.  Tips are read from
// `tips` where their slot is staged (slot_tip), never copied into buf.
//
// What bounds it: the products, 64 x 64 x tile FMAs for each staged
// matrix; a float4 of the matrix (the same for the whole warp, one
// broadcast) and four float2 of the slice feed 32 FMAs, so the shared
// memory loads keep pace with the FMA pipes at best.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"  // BITO_DISPATCH_C

namespace a64 {

constexpr int kA = 64;                // states
constexpr int kTile = 64;             // patterns a block
constexpr int kThreads = 256;         // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kA / kWarps;    // states a thread: 8
constexpr int kMat = kA * kA;         // floats of one category's matrix
constexpr int kSlab = kA * kTile;     // floats of one [64, tile] slice
constexpr int kRed = kWarps * kTile;  // floats of one cross-warp reduction
constexpr float kLn2 = 0.693147180559945309f;

// What a block reads and writes of its tree and tile.
struct Block {
  int S;                   // patterns
  int s0;                  // first pattern of the tile
  int ncols;               // patterns of the tile inside S
  int r0;                  // first state of the thread: 8 * warp
  int c0;                  // first tile column of the thread: 2 * lane
  int warp;
  size_t slot_floats;      // C * 64 * S, one slot of buf
  float* buf;              // buf of the tree
  float* ls;               // ls of the tree
  const float* tips;
  const int* slot_tip;     // shared memory: the tip in each slot, or -1

  // &buf[slot][c][0][s0]
  __device__ __forceinline__ float* at(int slot, int c) const {
    return buf + static_cast<size_t>(slot) * slot_floats +
           static_cast<size_t>(c) * kA * S + s0;
  }
  // The thread's pattern q (0 or 1) lies inside S.
  __device__ __forceinline__ bool in(int q) const { return c0 + q < ncols; }
};

// Bytes of dynamic shared memory: `floats` floats, then NS ints.
__host__ __device__ constexpr size_t smem_bytes(int floats, int NS) {
  return (static_cast<size_t>(floats) + NS) * 4;
}

// The block's context; fills slot_tip from the tree's tip slots, then a
// barrier.  slot_tip lies after `floats` floats of the dynamic region.
__device__ __forceinline__ Block make_block(float* sm, int floats, int NS,
                                            const int* __restrict__ tip_slot_b,
                                            int T, const float* tips,
                                            float* buf, float* ls, int C,
                                            int S) {
  Block k;
  k.S = S;
  k.s0 = blockIdx.x * kTile;
  k.ncols = min(kTile, S - k.s0);
  k.warp = threadIdx.x / 32;
  k.r0 = k.warp * kRows;
  k.c0 = 2 * (threadIdx.x % 32);
  k.slot_floats = static_cast<size_t>(C) * kA * S;
  k.buf = buf + static_cast<size_t>(blockIdx.y) * NS * k.slot_floats;
  k.ls = ls + static_cast<size_t>(blockIdx.y) * NS * S;
  k.tips = tips;
  int* slot_tip = reinterpret_cast<int*>(sm + floats);
  for (int i = threadIdx.x; i < NS; i += kThreads) slot_tip[i] = -1;
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += kThreads) slot_tip[tip_slot_b[t]] = t;
  __syncthreads();
  k.slot_tip = slot_tip;
  return k;
}

// One category's 64x64 matrix into shared memory, as float4s.
__device__ __forceinline__ void stage_mat(float* __restrict__ dst,
                                          const float* __restrict__ src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < kMat / 4 / kThreads; ++i)
    d4[i * kThreads + threadIdx.x] = __ldg(s4 + i * kThreads + threadIdx.x);
}

// A [64, tile] slice from src = &x[0][s0] of a [64, S] array into shared
// memory, column by column scaled by col_scale where given; columns past
// the tile's ncols read as 1 (their outputs are never stored).
__device__ __forceinline__ void stage_slab(float* __restrict__ dst,
                                           const float* src, const Block& k,
                                           const float* col_scale = nullptr) {
  for (int i = threadIdx.x; i < kSlab; i += kThreads) {
    const int row = i / kTile, col = i % kTile;
    float v = 1.f;
    if (col < k.ncols) {
      v = src[static_cast<size_t>(row) * k.S + col];
      if (col_scale) v *= col_scale[col];
    }
    dst[i] = v;
  }
}

// Child slot `slot` at category c: the tip's partial where a tip lies
// there, else the slot's partial in buf.
__device__ __forceinline__ void stage_child(float* dst, const Block& k,
                                            int slot, int c) {
  const int t = k.slot_tip[slot];
  stage_slab(dst, t >= 0 ? k.tips + static_cast<size_t>(t) * kA * k.S + k.s0
                         : k.at(slot, c), k);
}

// The base-2 log scale of child slot `slot` at pattern s (0 for a tip).
__device__ __forceinline__ float child_ls(const Block& k, int slot, int s) {
  return k.slot_tip[slot] >= 0 ? 0.f
                               : k.ls[static_cast<size_t>(slot) * k.S + s];
}

// acc[i][q] = sum_j M[r0 + i][j] * X[j][c0 + q]: M 64x64 and X [64, tile]
// in shared memory.
__device__ __forceinline__ void mat(const float* __restrict__ M,
                                    const float* __restrict__ X,
                                    const Block& k, float (&acc)[kRows][2]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 2
  for (int j = 0; j < kA; j += 4) {
    float2 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = *reinterpret_cast<const float2*>(X + (j + u) * kTile + k.c0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 m =
          *reinterpret_cast<const float4*>(M + (k.r0 + i) * kA + j);
      acc[i][0] = fmaf(m.x, x[0].x, acc[i][0]);
      acc[i][1] = fmaf(m.x, x[0].y, acc[i][1]);
      acc[i][0] = fmaf(m.y, x[1].x, acc[i][0]);
      acc[i][1] = fmaf(m.y, x[1].y, acc[i][1]);
      acc[i][0] = fmaf(m.z, x[2].x, acc[i][0]);
      acc[i][1] = fmaf(m.z, x[2].y, acc[i][1]);
      acc[i][0] = fmaf(m.w, x[3].x, acc[i][0]);
      acc[i][1] = fmaf(m.w, x[3].y, acc[i][1]);
    }
  }
}

// acc[i][q] = sum_a M[a][r0 + i] * X[a][c0 + q]   (the transpose product)
__device__ __forceinline__ void mat_t(const float* __restrict__ M,
                                      const float* __restrict__ X,
                                      const Block& k,
                                      float (&acc)[kRows][2]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
  for (int a = 0; a < kA; ++a) {
    const float2 x = *reinterpret_cast<const float2*>(X + a * kTile + k.c0);
    const float4 m0 = *reinterpret_cast<const float4*>(M + a * kA + k.r0);
    const float4 m1 = *reinterpret_cast<const float4*>(M + a * kA + k.r0 + 4);
    const float m[kRows] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i][0] = fmaf(m[i], x.x, acc[i][0]);
      acc[i][1] = fmaf(m[i], x.y, acc[i][1]);
    }
  }
}

// The largest of red[w][col] over the warps.
__device__ __forceinline__ float warp_max(const float* red, int col) {
  float mx = red[col];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w * kTile + col]);
  return mx;
}

// The sum of red[w][col] over the warps, in warp order.
__device__ __forceinline__ float warp_sum(const float* red, int col) {
  float sum = red[col];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) sum += red[w * kTile + col];
  return sum;
}

// The exponent e of mx (mx = f 2^e, f in [0.5, 1)), 0 where mx is not
// positive: scaling by 2^-e puts the largest entry in [0.5, 1) exactly.
__device__ __forceinline__ int exponent_of(float mx) {
  int e = 0;
  if (mx > 0.f) frexpf(mx, &e);
  return e;
}

// The postorder over the paired slots: op m evolves slots (2m, 2m+1) along
// its two edges, multiplies, and writes the product to slot post_dst[m],
// rescaled (see the head of this file), with ls the children's plus e.
// Padded ops (post_dst == trash) are skipped.  Shared memory: Ps 2 x kMat,
// X 2 x kSlab, red kRed floats.
template <int C>
__device__ void postorder(const Block& k, float* Ps, float* X, float* red,
                          const int* __restrict__ dst_b,
                          const int* __restrict__ e_b,
                          const float* __restrict__ P_b, int M) {
  const int trash = 2 * M + 1;
  for (int m = 0; m < M; ++m) {
    const int dst = dst_b[m];
    if (dst == trash) continue;
    float mx[2] = {0.f, 0.f};
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        stage_mat(Ps + j * kMat,
                  P_b + (static_cast<size_t>(e_b[2 * m + j]) * C + c) * kMat);
        stage_child(X + j * kSlab, k, 2 * m + j, c);
      }
      __syncthreads();
      float ev0[kRows][2], ev1[kRows][2];
      mat(Ps, X, k, ev0);
      mat(Ps + kMat, X + kSlab, k, ev1);
      float* out = k.at(dst, c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float v = ev0[i][q] * ev1[i][q];
          mx[q] = fmaxf(mx[q], v);
          if (k.in(q)) out[static_cast<size_t>(k.r0 + i) * k.S + k.c0 + q] = v;
        }
      __syncthreads();  // before the next category's staging
    }
    red[k.warp * kTile + k.c0] = mx[0];
    red[k.warp * kTile + k.c0 + 1] = mx[1];
    __syncthreads();
    int e[2];
    float f[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      e[q] = exponent_of(warp_max(red, k.c0 + q));
      f[q] = ldexpf(1.f, -e[q]);
    }
    // Each thread scales the outputs it stored itself.
    for (int c = 0; c < C; ++c) {
      float* out = k.at(dst, c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (k.in(q)) out[static_cast<size_t>(k.r0 + i) * k.S + k.c0 + q] *= f[q];
    }
    if (k.warp == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!k.in(q)) continue;
        const int s = k.s0 + k.c0 + q;
        k.ls[static_cast<size_t>(dst) * k.S + s] =
            child_ls(k, 2 * m, s) + child_ls(k, 2 * m + 1, s) +
            static_cast<float>(e[q]);
      }
    }
    __syncthreads();  // the scaled slot and red, before the next op
  }
}

// Per-pattern log likelihood at the root slot:
// log sum_c prop_c sum_a pi_a root[c, a] + ls * ln 2, into ll_row[s]
// (the tree's row of ll_rows).  Uses red; ends with a barrier.
template <int C>
__device__ void root_ll(const Block& k, float* red, int root,
                        const float* __restrict__ pi,
                        const float* __restrict__ props, float* ll_row) {
  float part[2] = {0.f, 0.f};
  for (int c = 0; c < C; ++c) {
    const float* r = k.at(root, c);
    const float prop = __ldg(props + c);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!k.in(q)) continue;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc = fmaf(__ldg(pi + k.r0 + i),
                   r[static_cast<size_t>(k.r0 + i) * k.S + k.c0 + q], acc);
      part[q] = fmaf(prop, acc, part[q]);
    }
  }
  red[k.warp * kTile + k.c0] = part[0];
  red[k.warp * kTile + k.c0 + 1] = part[1];
  __syncthreads();
  if (k.warp == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!k.in(q)) continue;
      const int s = k.s0 + k.c0 + q;
      ll_row[s] = logf(warp_sum(red, k.c0 + q)) +
                  k.ls[static_cast<size_t>(root) * k.S + s] * kLn2;
    }
  }
  __syncthreads();
}

}  // namespace a64
