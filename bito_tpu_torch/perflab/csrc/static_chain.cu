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
// into shared memory, as the TPU kept it in VMEM: a warp owns one column
// (6,848 bytes) and a block four.  Lane i computes ev[i] with the 96-long
// contraction as the script writes it (the three stacked copies are not
// folded; plain f32 FMAs, no tensor cores), reading the 32 rows as
// broadcasts from shared memory; lanes 0-15 multiply by ev[i + 16] from a
// shuffle and store.  Each op's store is read by all lanes of the next op,
// across lanes, so the compiler cannot forward it in registers: the chain
// stays a chain in the static variant too.
// What bounds it: the chain's latency at 8 warps or fewer an SM, above the
// floor of its FP32 FMAs (3,072 per column and op).
#include <cuda_runtime.h>

namespace {

constexpr int kCA = 16;
constexpr int kM = 52;
constexpr int kRows = (2 * kM + 3) * kCA;   // scratch rows, 1,712
constexpr int kK = 6 * kCA;                 // contraction length, 96
constexpr int kPair = 2 * kCA;              // rows read per op, 32
constexpr int kColsPerBlock = 4;            // one warp per column (perf_static_probe.COLS_PER_BLOCK)
constexpr int kOutRows = 8;

__device__ __forceinline__ float chain_op(float* buf, const float (&Lrow)[kK],
                                          int src, int dst, float t,
                                          int lane) {
  float rows[kPair];
  const float4* s4 = reinterpret_cast<const float4*>(buf + src);
#pragma unroll
  for (int q = 0; q < kPair / 4; ++q) {
    const float4 v = s4[q];
    rows[4 * q + 0] = v.x + t;
    rows[4 * q + 1] = v.y + t;
    rows[4 * q + 2] = v.z + t;
    rows[4 * q + 3] = v.w + t;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kK; ++j)
    acc[j % 4] = fmaf(Lrow[j], rows[j % kPair], acc[j % 4]);
  const float ev = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  const float other = __shfl_down_sync(0xffffffffu, ev, kCA);
  __syncwarp();  // every lane has read src before dst is written
  if (lane < kCA) buf[dst + lane] = ev * other;
  __syncwarp();  // the store is visible to the next op's reads
  return t * 0.5f;
}

template <bool DYNAMIC>
__global__ void __launch_bounds__(32 * kColsPerBlock)
static_chain_kernel(const int* __restrict__ tape,  // [2, M]
                    const float* __restrict__ L,   // [32, 96]
                    float* __restrict__ out,       // [8, S]
                    int S, int R) {
  __shared__ __align__(16) float scr[kColsPerBlock][kRows];
  __shared__ int offs[2][kM];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * kColsPerBlock + w;
  if (DYNAMIC) {
    for (int i = threadIdx.x; i < 2 * kM; i += blockDim.x)
      offs[i / kM][i % kM] = tape[i] * kCA;
  }
  float* buf = scr[w];
  for (int r = lane; r < kRows; r += 32) buf[r] = 1.f;
  float Lrow[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) Lrow[j] = __ldg(L + lane * kK + j);
  __syncthreads();
  if (col >= S) return;

  float t = 1e-8f;
  for (int rep = 0; rep < R; ++rep) {
    if constexpr (DYNAMIC) {
#pragma unroll 1
      for (int m = 0; m < kM; ++m)
        t = chain_op(buf, Lrow, offs[0][m], offs[1][m], t, lane);
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m)
        t = chain_op(buf, Lrow, 2 * m * kCA, 2 * (m + 1) * kCA, t, lane);
    }
  }
  if (lane < kOutRows)
    out[static_cast<size_t>(lane) * S + col] = buf[2 * kM * kCA + lane] + t;
}

}  // namespace

// Every tape entry must lie in [0, 2 M + 1] (a read of 32 rows stays in the
// scratch).  Returns cudaGetLastError() after the launch.
extern "C" int bito_static_chain(const int* tape, const float* L, float* out,
                                 int S, int R, int dynamic, void* stream) {
  if (S <= 0 || R < 0) return cudaErrorInvalidValue;
  const int blocks = (S + kColsPerBlock - 1) / kColsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dynamic) {
    static_chain_kernel<true><<<blocks, 32 * kColsPerBlock, 0, st>>>(
        tape, L, out, S, R);
  } else {
    static_chain_kernel<false><<<blocks, 32 * kColsPerBlock, 0, st>>>(
        tape, L, out, S, R);
  }
  return static_cast<int>(cudaGetLastError());
}
