// What one op of a dependent chain costs, with offsets read from a tape at
// run time against offsets fixed at compile time.
//
// Replaces scripts/perf_static_probe.py::_kernel (the Pallas TPU kernel at
// :50).  It runs R repetitions of an M = 52-op chain over a scratch of
// (2 M + 3) * 16 rows x S = 1024 columns, f32, filled with ones.  Op m
//     rows = buf[src : src + 32] + t
//     ev   = L [32 x 96] @ [rows; rows; rows]
//     buf[dst : dst + 16] = ev[0:16] * ev[16:32];   t = t / 2
// with (src, dst) = 16 * tape[:, m] (DYNAMIC) or 16 * (2 m, 2 m + 2) as
// compile-time constants of a fully unrolled chain.  The tape holds the
// same offsets, so both give the same output: buf[2 M * 16 : +8] + t.
//
// Every column is independent, so the 7.0 MB scratch splits by column
// into shared memory, as the TPU kept it in VMEM (6,848 bytes a column).
// One op of one column is 32 outputs x 96 terms, plain f32 FMAs (the
// three stacked copies are not folded, no tensor cores).  1,024 columns
// over 132 SMs put 8 on the busiest SM, and the ops of a column are a
// chain, so the parallelism beyond those 8 columns has to come from
// inside one column's op.  W warps take a column (W = 1, 2 or 4, the
// host's choice; a block holds two columns, so the busiest SM holds 8 W
// warps).  Its Q = 2 W parts split the 32 source rows: thread (p, q) of
// the column, q = lane % Q and p = 16 / W * warp + lane / Q, reads the
// 16 / W rows from 16 / W * q (float4 loads) and sums their 3 * 16 / W
// terms for both ev[p] and ev[p + 16], which so meet in one thread, in
// one accumulator per stacked copy; log2 Q xor shuffles add the parts,
// and thread (p, 0) stores ev[p] * ev[p + 16].  W = 1 gives a lane 96 L
// values and two 48-term sums; W = 4 gives it 24 and two 12-term sums.
// A column's threads meet after each op's store (the next op reads it):
// __syncwarp for one warp, a named barrier (bar.sync id, 32 W) for more;
// and before the store too where the host could not show that the op's
// source and destination rows are disjoint (the kernel takes any tape
// entry in [0, 2 M + 1]).  The dynamic variant reads each op's offsets
// before the previous op's store, off the chain.
// What bounds it: the FP32 FMAs (3,072 a column and op) at the busiest
// SM's 8 columns, and beside them the issue slots of the loads, adds,
// shuffles and barriers, which grow with W, against the chain's latency
// (loads, shuffles, the store read back by the next op), which more
// warps hide.  On the H100 the barriers and shuffles of W = 2 and 4 cost
// more than their warps hide: the host launches W = 1
// (perf_static_probe.WARPS), and PERF.md section 6 has every W's times.
#include <cuda_runtime.h>

namespace {

constexpr int kCA = 16;
constexpr int kM = 52;
constexpr int kRows = (2 * kM + 3) * kCA;   // scratch rows, 1,712
constexpr int kK = 6 * kCA;                 // contraction length, 96
constexpr int kPair = 2 * kCA;              // rows read per op, 32
constexpr int kColsPerBlock = 2;            // perf_static_probe.COLS_PER_BLOCK
constexpr int kOutRows = 8;

// The column's threads meet: one warp at __syncwarp, more at the named
// barrier `id` (0 is __syncthreads').
template <int W>
__device__ __forceinline__ void column_sync(int id) {
  if constexpr (W == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(32 * W) : "memory");
  }
}

// Thread (p, q) sums ev[p] and ev[p + 16] over its 16 / W rows from
// 16 / W * q; perf_static_probe.thread_outputs mirrors the map and
// emulate_chain the sum order.
template <int W>
__device__ __forceinline__ float chain_op(float* buf,
                                          const float (&Lr)[2][3][16 / W],
                                          int src, int dst, float t, int q,
                                          int p, bool overlap, int bar) {
  constexpr int kQ = 2 * W, kOwn = 16 / W;
  float x[kOwn];
  const float4* s4 = reinterpret_cast<const float4*>(buf + src + kOwn * q);
#pragma unroll
  for (int v = 0; v < kOwn / 4; ++v) {
    const float4 a = s4[v];
    x[4 * v + 0] = a.x + t;
    x[4 * v + 1] = a.y + t;
    x[4 * v + 2] = a.z + t;
    x[4 * v + 3] = a.w + t;
  }
  float ev[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float acc[3] = {0.f, 0.f, 0.f};   // one per stacked copy
#pragma unroll
    for (int r = 0; r < kOwn; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = fmaf(Lr[h][c][r], x[r], acc[c]);
    ev[h] = (acc[0] + acc[1]) + acc[2];
  }
#pragma unroll
  for (int s = 1; s < kQ; s <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) ev[h] += __shfl_xor_sync(0xffffffffu, ev[h], s);
  if (overlap) column_sync<W>(bar);   // every thread has read src
  if (q == 0) buf[dst + p] = ev[0] * ev[1];
  column_sync<W>(bar);                // the store is visible to the next op
  return t * 0.5f;
}

template <bool DYNAMIC, int W>
__global__ void __launch_bounds__(32 * W * kColsPerBlock)
static_chain_kernel(const int* __restrict__ tape,  // [2, M]
                    const float* __restrict__ L,   // [32, 96]
                    float* __restrict__ out,       // [8, S]
                    int S, int R, int overlap) {
  constexpr int kQ = 2 * W, kOwn = 16 / W;
  __shared__ __align__(16) float scr[kColsPerBlock][kRows];
  __shared__ int offs[2][kM];
  const int w = threadIdx.x / (32 * W);    // the block's column
  const int u = threadIdx.x % (32 * W);    // the thread's place in it
  const int q = u % kQ, p = (u / 32) * kOwn + (u % 32) / kQ;
  const int col = blockIdx.x * kColsPerBlock + w;
  const int bar = 1 + w;
  if (DYNAMIC) {
    for (int i = threadIdx.x; i < 2 * kM; i += blockDim.x)
      offs[i / kM][i % kM] = tape[i] * kCA;
  }
  float* buf = scr[w];
  for (int r = u; r < kRows; r += 32 * W) buf[r] = 1.f;
  float Lr[2][3][kOwn];   // L[p + 16 h][32 c + kOwn q + r]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int r = 0; r < kOwn; ++r)
        Lr[h][c][r] = __ldg(L + (p + kCA * h) * kK + kPair * c + kOwn * q + r);
  __syncthreads();
  if (col >= S) return;   // the whole column: its barrier loses no thread

  float t = 1e-8f;
  for (int rep = 0; rep < R; ++rep) {
    if constexpr (DYNAMIC) {
      int src = offs[0][0], dst = offs[1][0];
#pragma unroll 1
      for (int m = 0; m < kM; ++m) {
        const int next = m + 1 < kM ? m + 1 : 0;
        const int nsrc = offs[0][next], ndst = offs[1][next];
        t = chain_op<W>(buf, Lr, src, dst, t, q, p, overlap != 0, bar);
        src = nsrc;
        dst = ndst;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m)
        t = chain_op<W>(buf, Lr, 2 * m * kCA, 2 * (m + 1) * kCA, t, q, p,
                        false, bar);
    }
  }
  if (u < kOutRows)
    out[static_cast<size_t>(u) * S + col] = buf[2 * kM * kCA + u] + t;
}

template <int W>
void launch(const int* tape, const float* L, float* out, int S, int R,
            int dynamic, int overlap, cudaStream_t st) {
  const int blocks = (S + kColsPerBlock - 1) / kColsPerBlock;
  if (dynamic) {
    static_chain_kernel<true, W><<<blocks, 32 * W * kColsPerBlock, 0, st>>>(
        tape, L, out, S, R, overlap);
  } else {
    static_chain_kernel<false, W><<<blocks, 32 * W * kColsPerBlock, 0, st>>>(
        tape, L, out, S, R, 0);
  }
}

}  // namespace

// Every tape entry must lie in [0, 2 M + 1] (a read of 32 rows stays in the
// scratch); `overlap` is 0 only where no op's destination rows meet its
// source rows (dst not in {src, src + 1}); `warps` (a column's) is 1, 2
// or 4.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without launching.
extern "C" int bito_static_chain(const int* tape, const float* L, float* out,
                                 int S, int R, int dynamic, int overlap,
                                 int warps, void* stream) {
  if (S <= 0 || R < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (warps) {
    case 1: launch<1>(tape, L, out, S, R, dynamic, overlap, st); break;
    case 2: launch<2>(tape, L, out, S, R, dynamic, overlap, st); break;
    case 4: launch<4>(tape, L, out, S, R, dynamic, overlap, st); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
