// Device code shared by the two paired-slot kernels at 64 states
// (paired_ll_a64.cu, paired_grad_a64.cu): MG94 codon models, the 61 sense
// codons padded to 64 (models/codon.py).  They replace
// bito_tpu/treelike/pallas_paired.py::_ll_kernel and ::_grad_kernel at
// CA = 64 C.
//
// Layouts (row-major):
//   P, dP    [B, N1, C, 64, 64]  per-edge matrices; N1-1 the identity edge
//   tips     [T, 64, S]          tip partials, the same for every category
//   buf      [B, NS, C, 64, S]   partials by pair slot (scratch, device
//                                memory), NS = 2M+3, each category scaled
//                                by its own power of two (see Rescaling)
//   scratch  [B, NS, 2 + C, S] floats, then [B, tiles, NS] ints: each
//            slot's base-2 log scale L, exponent E and each category's
//            exponent e_c; then each block's own table of slot codes (a
//            tip's index, kBuf, or kOnes), tiles = ceil(S / kTile)
// S is a multiple of 4 (the wrappers pad it), so every [64, S] row is
// 16-byte aligned for cp.async.
//
// The products.  Every 64x64 product runs on the tensor cores as
// mma.sync.m16n8k8 in TF32, three passes to an operand pair (3xTF32):
// hi = tf32(x), lo = tf32(x - hi) for both operands, rounded as
// cvt.rna.tf32.f32 rounds, acc += lo*hi, then hi*lo, then hi*hi, in
// float32.  The split happens inside the kernel, where an operand is
// staged: a step's matrices once a block, into hi and lo planes in shared
// memory (split_mats); the warp's partials as their fragments are loaded.
// The caller's operands are the plain float32 arrays.  That keeps about
// 22 bits of each operand, so the signed contraction dP p (whose
// cancellation amplifies truncation, bito_tpu's pallas_paired.py:618-624)
// stays at float32's error; one TF32 pass does not
// (tests/test_torch_a64_tf32.py holds both).  mma.sync rather than
// wgmma: wgmma takes 32-bit operands from shared memory only K-major and
// would need P^T staged as its own copy for the outside pass, and its
// warpgroup-wide accumulators leave no registers for the grad body's
// three live products; mma.sync takes fragments from registers, so the
// outside pass feeds its o straight from the accumulators (below).  Its
// TF32 rate on an H100 is below wgmma's, which bounds PERF.md's 3xTF32
// share of these kernels.
//
// A warp owns 16 patterns (the M of one m16 tile) and all 64 states of
// them: it computes out^T[s, a] = sum_b x^T[s, b] M^T[b, a], each product
// 8 n-tiles x 8 k-blocks x 3 passes.  The K index inside a k-block is
// permuted (logical t <-> state 2t, t+4 <-> 2t+1), which leaves the sum
// unchanged and makes
//   - B fragments of M p: (M[8n+g][8k+2t], M[8n+g][8k+2t+1]), one 64-bit
//     shared load;
//   - A fragments of M^T o: the accumulator of the product that formed o,
//     as it stands: c0, c2, c1, c3 of n-tile k.
// Matrices sit in shared memory swizzled (swz below): the 64-bit loads of
// M p and the 32-bit loads of M^T o are both free of bank conflicts.
// Every per-pattern reduction (rescaling, the root sum, the gradient
// ratio) is over the 64 states of one pattern, which lie in the 4 lanes
// of a quad: two shuffles, no shared memory and no barrier.
//
// Staging.  A block of W warps (W*16 patterns) walks its tree's tape one
// step at a time, a step being (op, category) of the postorder, then
// (grad) of the outside pass.  The step's raw matrices (P of both
// children; and dP in the outside pass) arrive by cp.async during the
// step before, from the tape (post_e); at the start of the step each
// warp stages its own patterns' slices of both children ([64, 16] each:
// tips from `tips`, partials from buf, all ones where nothing writes the
// slot) with cp.async; the block splits P of both children into the
// planes while the slices arrive (begin_step), then stages the next step's
// raw matrices while the products run.  The outside pass splits dP into
// the planes once the P products are done.  A warp's wait for its slices
// is hidden behind the split and the other warps' work.
//
// The partials stay in device memory: a 27-taxon tree's outside pass reads
// every slot of the postorder, 53 x 32 KB a category for a block's 128
// patterns, past one SM's shared memory.  Each op stores its output once
// (no pass rereads it to rescale it: see Rescaling), the root op stores
// none, and the next op reads it back, mostly from L2.
//
// What bounds it: the products.  mma.sync's TF32 rate is the ceiling
// (three HMMAs for each float32-accurate one), at the 8 warps an SM that
// registers and shared memory leave, and each step adds a serial part:
// what of the children's loads the split does not cover, two barriers
// around the split, the scaling and the epilogue's stores.  PERF.md has
// the times against both bounds.
//
// Rescaling, so that float32's range holds however far apart the
// children's states are (short branches, tips that differ at every codon
// position).  An op stores each category c of its output scaled by 2^-e_c,
// e_c the exponent of that category's largest entry over the 64 states
// (frexp; at least -126, so that 2^-e_c is a float32), as the products
// leave it: no op rereads its output to scale it.  The slot's E is the
// largest e_c and its base-2 log scale L = L0 + L1 + E.  A reader puts
// category c on the slot's common scale by 2^(e_c - E) (exact: a power of
// two) before anything else: in the postorder, q = (f0 P0 p0)(f1 P1 p1),
// f_j child j's factor, each at most about 1.  The outside pass scales the
// children's products (ev and dv) by the same factors and its up values
// by theirs, and stores P^T o the same way, by the exponent of the
// largest o of the category over both children; its den and num sums
// over the categories take o scaled so, and each category by 2^(e_c -
// e_max), e_max the largest e_c so far (the sums rescaled when it grows).
// So every stored value and every sum is relative to its largest entry,
// as a store scaled after the op would be.  Tips and unwritten slots have
// E = L = e_c = 0.
//
// Categories.  Both kernels take any count C >= 1, as bito_tpu's paired
// Pallas kernels take any count at 64 states: a step is one (op,
// category) and next_step reads C at run time; no array is sized by C
// (PostAcc and the grad body's OutAcc hold two rows' sums, rescaled by
// 2^(e_c - e_max) as e_max grows, so any number of terms keeps each sum
// relative to its largest; the root's sum takes each category on its
// children's common scale, each term at most about 1); every offset that C
// scales (a slot of buf, the scales [NS, 2 + C, S], the code tables after
// them, a category's matrix) is taken in size_t.  What grows with C is the
// scratch in device memory, which the launchers in treelike/paired.py size
// and split by trees; where one tree's does not fit they raise.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace a64 {

constexpr int kA = 64;                 // states
constexpr int kMat = kA * kA;          // floats of one category's matrix
constexpr int kCols = 16;              // patterns a warp: one m16 tile
constexpr int kWarps = 8;              // warps a block
constexpr int kTile = kWarps * kCols;  // patterns a block
constexpr int kThreads = kWarps * 32;
constexpr int kXStride = kCols + 4;    // floats a state row of a slice
constexpr int kSlice = kA * kXStride;  // floats of a warp's staged slice
constexpr int kBuf = -1;               // slot code: an op writes it to buf
constexpr int kOnes = -2;              // slot code: nothing writes it
constexpr float kLn2 = 0.693147180559945309f;

constexpr int kPlanes = 2;  // matrices split into hi and lo planes at once

// Dynamic shared memory of a block that stages `raw` matrices a step: the
// raw matrices, the hi and lo planes of kPlanes matrices, then each warp's
// two slices.
__host__ __device__ constexpr size_t smem_bytes(int raw) {
  return (static_cast<size_t>(raw + 2 * kPlanes) * kMat +
          static_cast<size_t>(kWarps) * 2 * kSlice) * 4;
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory; zero-filled where !valid (then
// `src` is only an address inside the array and is not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

// Offset of entry (r, c) of a 64x64 matrix in shared memory: columns XORed
// in groups of 8 by a function of r.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kA + (c ^ (((r ^ (r >> 1)) & 3) << 3));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (round to
// nearest on the magnitude's bits, ties away from zero), in two integer
// instructions: ptxas expands cvt.rna.tf32.f32 to a longer sequence that
// also guards NaN and infinity.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value; x - hi is exact in float32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's offsets of its B fragments in a swizzled plane, so that each
// shared load is a register plus a constant.  Lane (g, t), q and p_h the
// swizzle's 8-column group of its rows:
//   M p:   swz(8n+g, 8k+2t)     = 512n + 64g + 2t + 8(k ^ q), q = (g^g/2)&3
//   M^T o: swz(8k+2t+h, 8n+g)  = 512k + 32(n/4) + tr[h][n % 4], with
//          tr[h][b] = 64(2t+h) + 8(b ^ p_h) + g, p_h = ((2t+h) ^ t) & 3.
struct BOffsets {
  int base;  // 64g + 2t
  int q;
  int tr[2][4];
};

__device__ __forceinline__ BOffsets b_offsets(int g, int t) {
  BOffsets bo;
  bo.base = 64 * g + 2 * t;
  bo.q = (g ^ (g >> 1)) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = ((2 * t + h) ^ t) & 3;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bo.tr[h][b] = 64 * (2 * t + h) + 8 * (b ^ p) + g;
  }
  return bo;
}

// acc[n] += A_k B_k over k-block k, in three passes: A's fragment given
// (patterns g, g+8 x states 8k+2t, 8k+2t+1) and split here; B from the
// split matrix M in shared memory (its hi plane at M, its lo plane at
// M + kMat), M p (kTrans false) or M^T o (kTrans true).
template <bool kTrans>
__device__ __forceinline__ void kblock(const float* __restrict__ M, int k,
                                       const float (&av)[4],
                                       float (&acc)[8][4],
                                       const BOffsets& bo) {
  uint32_t ahi[4], alo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(av[i], ahi[i], alo[i]);
  uint32_t bhi[8][2], blo[8][2];
  const float* Mk = M + (kTrans ? 512 * k : bo.base + 8 * (k ^ bo.q));
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (kTrans) {
      const int o0 = 32 * (n >> 2) + bo.tr[0][n & 3];
      const int o1 = 32 * (n >> 2) + bo.tr[1][n & 3];
      bhi[n][0] = __float_as_uint(Mk[o0]);
      bhi[n][1] = __float_as_uint(Mk[o1]);
      blo[n][0] = __float_as_uint(Mk[kMat + o0]);
      blo[n][1] = __float_as_uint(Mk[kMat + o1]);
    } else {
      const float2 h = *reinterpret_cast<const float2*>(Mk + 512 * n);
      const float2 l = *reinterpret_cast<const float2*>(Mk + kMat + 512 * n);
      bhi[n][0] = __float_as_uint(h.x);
      bhi[n][1] = __float_as_uint(h.y);
      blo[n][0] = __float_as_uint(l.x);
      blo[n][1] = __float_as_uint(l.y);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(acc[n], alo, bhi[n][0], bhi[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(acc[n], ahi, blo[n][0], blo[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(acc[n], ahi, bhi[n][0], bhi[n][1]);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// acc = M x for the warp's 16 patterns: M split (kblock), x the warp's
// staged [64, 16] slice.  acc[n][i] is state 8n + 2t + (i & 1) of pattern g + 8 (i >> 1).
template <int kUnroll = 2>
__device__ __forceinline__ void evolve(const float* __restrict__ M,
                                       const float* __restrict__ X,
                                       float (&acc)[8][4],
                                       const BOffsets& bo, int g, int t) {
  zero(acc);
  const float* x = X + 2 * t * kXStride + g;
#pragma unroll kUnroll
  for (int k = 0; k < 8; ++k) {
    const float* r = x + 8 * k * kXStride;
    const float av[4] = {r[0], r[8], r[kXStride], r[kXStride + 8]};
    kblock<false>(M, k, av, acc, bo);
  }
}

// acc = M^T o, M split (kblock), o in the accumulator layout of evolve.
__device__ __forceinline__ void evolve_t(const float* __restrict__ M,
                                         const float (&o)[8][4],
                                         float (&acc)[8][4],
                                         const BOffsets& bo) {
  zero(acc);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float av[4] = {o[k][0], o[k][2], o[k][1], o[k][3]};
    kblock<true>(M, k, av, acc, bo);
  }
}

// Sum and largest over the 4 lanes of a quad (the 64 states of a pattern).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The exponent e of mx (mx = f 2^e, f in [0.5, 1)), at least kMinExp
// (kMinExp where mx is not positive): scaling by 2^-e puts the largest
// entry in [0.5, 1) exactly (below that where mx is subnormal), and 2^-e
// is a float32.
constexpr int kMinExp = -126;
__device__ __forceinline__ int exponent_of(float mx) {
  int e = kMinExp;
  if (mx > 0.f) frexpf(mx, &e);
  return e > kMinExp ? e : kMinExp;
}

// 2^-e for an exponent e held in a float (an integer; 0 where e > 149).
__device__ __forceinline__ float inv_pow2(float e) {
  return ldexpf(1.f, -static_cast<int>(e));
}

// ---------------------------------------------------------------------------
// The block's tree and tape
// ---------------------------------------------------------------------------

// What a warp reads and writes of its tree and its 16 patterns.  Lane
// (g, t) = (lane / 4, lane % 4) holds patterns s0 + g and s0 + g + 8 (its
// rows r = 0, 1).
struct Warp {
  int S;               // row stride of tips, buf and the scales
  int C;               // rate categories
  int s0;              // the warp's first pattern
  int g, t;
  size_t slot_floats;  // C * 64 * S, one slot of buf
  float* buf;          // the tree's buf
  float* scales;       // the tree's [NS, 2 + C, S] scales (see Rescaling)
  const float* tips;
  const int* code;     // the block's slot codes
  float* X;            // the warp's two staged slices
  BOffsets bo;         // the lane's B-fragment offsets

  __device__ __forceinline__ int s(int r) const { return s0 + g + 8 * r; }
  __device__ __forceinline__ bool in(int r) const { return s(r) < S; }
  // &buf[slot][c][0][s0]
  __device__ __forceinline__ float* at(int slot, int c) const {
    return buf + static_cast<size_t>(slot) * slot_floats +
           static_cast<size_t>(c) * kA * S + s0;
  }
  // A slot's log scale L, exponent E and each category's exponent e_c.
  __device__ __forceinline__ float* L(int slot) const {
    return scales + static_cast<size_t>(slot) * (2 + C) * S;
  }
  __device__ __forceinline__ float* E(int slot) const { return L(slot) + S; }
  __device__ __forceinline__ float* e(int slot, int c) const {
    return L(slot) + static_cast<size_t>(2 + c) * S;
  }
  // 2^(e_c - E) of `slot` at row r: what puts its category c on its
  // common scale.
  __device__ __forceinline__ float rel_scale(int slot, int c, int r) const {
    return in(r) ? inv_pow2(E(slot)[s(r)] - e(slot, c)[s(r)]) : 1.f;
  }
  // The same for child j of op m: 1 for a tip or an unwritten slot.
  __device__ __forceinline__ float child_scale(int m, int j, int c,
                                               int r) const {
    return code[2 * m + j] == kBuf ? rel_scale(2 * m + j, c, r) : 1.f;
  }
};

// One step of the walk: op m at category c of the postorder (phase 0) or
// the outside pass (phase 1); m < 0 past the end.
struct Step {
  int phase, m, c;
};

// The step after `s`: its next category, else the next op of its phase
// that runs (the postorder ascending, the outside pass descending; padded
// ops, whose post_dst is the trash slot, are skipped), and after the
// postorder the outside pass where `outside`.  Step{0, -1, C - 1} gives
// the first step.
__device__ __forceinline__ Step next_step(Step s, const int* __restrict__ dst,
                                          int M, int C, bool outside) {
  if (s.c + 1 < C && s.m >= 0) return {s.phase, s.m, s.c + 1};
  const int trash = 2 * M + 1;
  if (s.phase == 0) {
    for (int m = s.m + 1; m < M; ++m)
      if (__ldg(dst + m) != trash) return {0, m, 0};
    if (!outside) return {0, -1, 0};
    s.m = M;
  }
  for (int m = s.m - 1; m >= 0; --m)
    if (__ldg(dst + m) != trash) return {1, m, 0};
  return {1, -1, 0};
}

// Fills the block's slot codes: kOnes, then kBuf for every slot an op
// writes, then each tip's index at its slot.  Ends with a barrier.
__device__ __forceinline__ void fill_codes(int* code,
                                           const int* __restrict__ dst,
                                           const int* __restrict__ tip_slot,
                                           int M, int T) {
  const int NS = 2 * M + 3, trash = 2 * M + 1;
  for (int i = threadIdx.x; i < NS; i += kThreads) code[i] = kOnes;
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const int d = __ldg(dst + m);
    if (d != trash) code[d] = kBuf;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += kThreads)
    code[__ldg(tip_slot + t)] = t;
  __syncthreads();
}

// One category's 64x64 matrix into shared memory (swizzled), by the
// block's kThreads threads.
__device__ __forceinline__ void stage_mat(float* dst, const float* src) {
#pragma unroll
  for (int k = 0; k < kMat / 4 / kThreads; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int r = i >> 4, c = (i & 15) * 4;
    cp16(dst + swz(r, c), src + r * kA + c, true);
  }
}

// Splits `n` raw matrices (swizzled as staged) into planes: matrix j's hi
// plane at planes + 2 j kMat, its lo plane after it; by the block's
// kThreads threads, 16 bytes at a time.
__device__ __forceinline__ void split_mats(float* planes, const float* raw,
                                           int n) {
  for (int i = 4 * threadIdx.x; i < n * kMat; i += 4 * kThreads) {
    const float4 x = *reinterpret_cast<const float4*>(raw + i);
    const int j = i / kMat, o = i % kMat;
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(planes + 2 * j * kMat + o) = hi;
    *reinterpret_cast<uint4*>(planes + (2 * j + 1) * kMat + o) = lo;
  }
}

// A step's raw matrices: P of both children, and in the outside pass dP of
// both after them.
__device__ __forceinline__ void stage_mats(float* stage, Step s,
                                           const int* __restrict__ e,
                                           const float* P, const float* dP,
                                           int C) {
  const size_t m0 = (static_cast<size_t>(__ldg(e + 2 * s.m)) * C + s.c) * kMat;
  const size_t m1 =
      (static_cast<size_t>(__ldg(e + 2 * s.m + 1)) * C + s.c) * kMat;
  stage_mat(stage, P + m0);
  stage_mat(stage + kMat, P + m1);
  if (s.phase == 1) {
    stage_mat(stage + 2 * kMat, dP + m0);
    stage_mat(stage + 3 * kMat, dP + m1);
  }
}

// The warp's slices of op m's two children at category c into X (child j
// at X + j * kSlice), each [64, 16] with rows of kXStride floats: a tip
// from `tips`, a partial from buf, all ones where nothing writes the slot.
// Patterns past S are zero-filled.
__device__ __forceinline__ void stage_children(const Warp& w, int m, int c) {
  const int lane = 4 * w.g + w.t;
  const int ncols = w.S - w.s0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* dst = w.X + j * kSlice;
    const int code = w.code[2 * m + j];
    if (code == kOnes) {
      for (int i = lane; i < kA * kCols / 4; i += 32)
        *reinterpret_cast<float4*>(dst + (i >> 2) * kXStride + (i & 3) * 4) =
            make_float4(1.f, 1.f, 1.f, 1.f);
      continue;
    }
    const float* src = code >= 0
                           ? w.tips + static_cast<size_t>(code) * kA * w.S + w.s0
                           : w.at(2 * m + j, c);
#pragma unroll
    for (int i = lane; i < kA * kCols / 4; i += 32) {
      const int row = i >> 2, col = (i & 3) * 4;
      const bool ok = col < ncols;
      cp16(dst + row * kXStride + col,
           ok ? src + static_cast<size_t>(row) * w.S + col : w.tips, ok);
    }
  }
}

// The start of step `cur`: the warp stages its children's slices, the
// block waits for the step's raw matrices (staged during the step
// before) and splits raw matrices 0 and 1 (P of both children) into the
// planes while the slices arrive.  Barriers: before the split (the raw
// matrices of every thread; no warp still reads the planes), after it
// (the planes, and each warp's slices, which every lane has waited for).
__device__ __forceinline__ void begin_step(const Warp& w, Step cur,
                                           const float* raw, float* planes) {
  __syncwarp();  // the warp's reads of its slices in the step before
  stage_children(w, cur.m, cur.c);
  cp_commit();
  cp_wait<1>();  // the raw matrices, committed before the slices
  __syncthreads();
  split_mats(planes, raw, kPlanes);
  cp_wait<0>();
  __syncthreads();
}

// Stores v (accumulator layout) to the warp's patterns of a [64, S] slice
// at out = &x[0][s0].
__device__ __forceinline__ void store(const Warp& w, float* out,
                                      const float (&v)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (w.in(i >> 1))
        out[static_cast<size_t>(8 * n + 2 * w.t + (i & 1)) * w.S + w.g +
            8 * (i >> 1)] = v[n][i];
}

// ---------------------------------------------------------------------------
// The postorder
// ---------------------------------------------------------------------------

// What a postorder op carries across its categories, for rows r = 0, 1.
struct PostAcc {
  float lsum[2];  // L0 + L1
  float red[2];   // at the root, the site sum
  float emax[2];  // the largest e_c so far
};

// Postorder step (m, c), its products' k-loops unrolled kUnroll k-blocks
// at a time: q = (f0 P0 p0)(f1 P1 p1), f_j the child's rel_scale, from
// the split P0 and P1 (planes Ms) and the warp's staged children, stored
// to slot post_dst[m] at category c scaled by 2^-e_c, e_c the exponent
// of its largest entry; at the root op no store, but the site sum of
// pi * prop * q.  After the last category: the slot's E (the largest
// e_c) and L, or at the root the per-pattern log likelihood into ll_row.
template <int kUnroll>
__device__ __forceinline__ void post_step(const Warp& w, const float* Ms,
                                          int m, int c, int C, int M,
                                          const int* __restrict__ dst_b,
                                          const float* __restrict__ pi,
                                          const float* __restrict__ props,
                                          PostAcc& st, float* ll_row) {
  const int dst = __ldg(dst_b + m);
  const bool root = dst == 2 * M;
  float f[2][2], mx[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) f[j][r] = w.child_scale(m, j, c, r);
    if (c > 0) continue;
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (w.code[2 * m + j] == kBuf && w.in(r)) l += w.L(2 * m + j)[w.s(r)];
    st.lsum[r] = l;
    st.red[r] = 0.f;
    st.emax[r] = kMinExp;
  }
  float ev0[8][4], ev1[8][4];
  evolve<kUnroll>(Ms, w.X, ev0, w.bo, w.g, w.t);
  evolve<kUnroll>(Ms + 2 * kMat, w.X + kSlice, ev1, w.bo, w.g, w.t);
  const float prop = __ldg(props + c);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const float q = (ev0[n][i] * f[0][r]) * (ev1[n][i] * f[1][r]);
      if (root) {
        st.red[r] = fmaf(prop * __ldg(pi + 8 * n + 2 * w.t + (i & 1)), q,
                         st.red[r]);
      } else {
        mx[r] = fmaxf(mx[r], q);
        ev0[n][i] = q;
      }
    }
  if (!root) {
    float g[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = exponent_of(quad_max(mx[r]));
      g[r] = inv_pow2(static_cast<float>(e));
      st.emax[r] = fmaxf(st.emax[r], static_cast<float>(e));
      if (w.t == 0 && w.in(r)) w.e(dst, c)[w.s(r)] = static_cast<float>(e);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) ev0[n][i] *= g[i >> 1];
    store(w, w.at(dst, c), ev0);
  }
  if (c + 1 < C) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x = root ? quad_sum(st.red[r]) : 0.f;
    if (w.t != 0 || !w.in(r)) continue;
    if (root) {
      ll_row[w.s(r)] = logf(x) + st.lsum[r] * kLn2;
    } else {
      w.L(dst)[w.s(r)] = st.lsum[r] + st.emax[r];
      w.E(dst)[w.s(r)] = st.emax[r];
    }
  }
}

// Sets up the warp of a block of kWarps warps: grid (pattern tiles of
// kWarps * 16, B).  `codes` is the scratch's table area, one table of NS
// ints for each block.
__device__ __forceinline__ Warp make_warp(float* sm_x, float* buf,
                                          float* scratch, int* codes,
                                          const float* tips, int C, int S,
                                          int NS) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Warp w;
  w.bo = b_offsets(lane / 4, lane % 4);
  w.S = S;
  w.C = C;
  w.s0 = (blockIdx.x * kWarps + warp) * kCols;
  w.g = lane / 4;
  w.t = lane % 4;
  w.slot_floats = static_cast<size_t>(C) * kA * S;
  w.buf = buf + static_cast<size_t>(blockIdx.y) * NS * w.slot_floats;
  w.scales = scratch + static_cast<size_t>(blockIdx.y) * NS * (2 + C) * S;
  w.tips = tips;
  w.code = codes +
           (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * NS;
  w.X = sm_x + warp * 2 * kSlice;
  return w;
}

}  // namespace a64
