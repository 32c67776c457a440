// What one grid cell costs for its scratch and its streamed block.
//
// Replaces the kernel of scripts/perf_pipe_lab.py::run (the Pallas TPU
// kernel at :29).  Each of `cells` cells
//   1. streams its bf16 block big[cell] [block_rows, S] into on-chip
//      memory (on the TPU, the BlockSpec's DMA into VMEM);
//   2. fills its f32 scratch [scratch_rows, S] with ones, when init;
//   3. runs `loops` iterations c that read the 16 rows at 16 * (c % 64),
//      add 1 and store them to the 16 rows at 16 * idx[cell, (c + k) % 64]
//      for k < stores, the offsets read at run time;
//   4. writes out[cell] = scratch[0:8] + big[cell, 0:8] (bf16 -> f32).
// Without init the scratch holds whatever the block's shared memory held
// (on the TPU, an earlier cell's VMEM), and so does the output: the
// experiment leaves the fill out of the timed work on purpose.
//
// The TPU kept the scratch in VMEM, so it does here: every column is
// independent, so a block takes one cell x a tile of T columns, and its
// scratch [scratch_rows, T] f32 and its whole block slice [block_rows, T]
// bf16 live in dynamic shared memory (perf_pipe_lab.pipe_plan chooses T so
// that both fit in 227 KB; the host refuses a scratch that does not fit at
// T = 8).  The block's 16 T threads fill the scratch with 16-byte stores,
// one run of neighbouring chunks, and meet at one barrier; then thread
// (i, col), i in 0-15, owns the rows = i (mod 16) of its column: the loop
// reads row 16 (c % 64) + i and writes rows 16 idx + i, so every thread
// touches only its own rows and the loop needs no barrier.  The body is
// specialised on the number of stores (0-4), so that an iteration loads
// its offsets together with its row and waits once.  A warp's
// threads sit on neighbouring words of neighbouring rows, free of bank
// conflicts.  A scratch of 1,024-4,160 rows leaves room for a few blocks
// an SM, so the threads of a column, not more columns, give the SM the
// warps that hide the loop's load-to-store latency.  The block slice is
// streamed by TMA (a 3-D tensor map, boxes of T columns x stage_rows rows)
// into shared memory, every byte of it, issued by one thread at the
// block's start and completed on one mbarrier, so it overlaps the fill and
// the loop; rows 0-7 serve step 4.  At T = 8 a row of the box is 16
// bytes, half of a 32-byte sector: the neighbouring tile's block reads the
// other half, from L2 when it hits.
// What bounds it: the scratch's shared-memory bytes (128 B a clock an SM)
// where the cell fills or stores, else the block's device-memory bytes.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIdx = 64;           // offsets per cell
constexpr int kOwn = 16;           // rows per loop load and store
constexpr int kMaxSmem = 232448;   // 227 KB, a block's limit on sm_90
constexpr int kAlign = 128;        // TMA's shared-memory alignment
constexpr int kMaxTile = 64;       // 16 threads a column, 1,024 a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// Dynamic shared memory: block slice [block_rows, T] bf16 | scratch
// [scratch_rows, T] f32, from the first 128-byte boundary (TMA writes
// there).  The offsets and the mbarrier are arrays of their own, so the
// compiler knows that the loop's scratch stores do not write them.
template <int STORES>
__global__ void __launch_bounds__(16 * kMaxTile)
pipe_cell_kernel(const __grid_constant__ CUtensorMap map,  // big [cells, rows, S]
                 const int* __restrict__ idx,               // [cells, 64]
                 float* __restrict__ out,                   // [cells, 8, S]
                 int block_rows, int scratch_rows, int S, int T,
                 int stage_rows, int init, int loops) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int offs[kIdx];       // 16 T idx: the first float of a store
  __shared__ uint64_t bar[1];
  __nv_bfloat16* blk = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  float* scr = reinterpret_cast<float*>(blk + static_cast<size_t>(block_rows) * T);
  const int cell = blockIdx.y;
  const int col0 = blockIdx.x * T;
  const int t = threadIdx.x;
  const int col = t % T;         // the thread's column of the tile
  const int i = t / T;           // its rows = i (mod 16)

  if (t == 0) mbar_init(bar);
  for (int k = t; k < kIdx; k += blockDim.x)
    offs[k] = idx[cell * kIdx + k] * kOwn * T;
  __syncthreads();

  // 1. the whole block slice, by TMA, in flight during steps 2-3
  if (t == 0) {
    mbar_expect(bar, static_cast<uint32_t>(block_rows) * T * 2);
    for (int r0 = 0; r0 < block_rows; r0 += stage_rows)
      tma_load_3d(blk + static_cast<size_t>(r0) * T, &map, col0, r0, cell, bar);
  }

  // 2. the fill, 16-byte stores over the whole scratch
  if (init) {
    const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
    float4* scr4 = reinterpret_cast<float4*>(scr);
#pragma unroll 4
    for (int k = t; k < scratch_rows * T / 4; k += blockDim.x) scr4[k] = one;
  }
  __syncthreads();   // the fill's rows belong to other threads' loops
  // 3. the loop: row 16 (c % 64) + i to rows 16 idx + i, all this thread's.
  // With no store it feeds nothing, and the compiler drops it.  An
  // iteration's offsets are read with its row, one latency for all.
  const int own = i * T + col;     // row i, column col, of a 16-row group
  for (int c = 0; c < loops; ++c) {
    int dst[STORES > 0 ? STORES : 1];
#pragma unroll
    for (int k = 0; k < STORES; ++k) dst[k] = offs[(c + k) & (kIdx - 1)] + own;
    const float v = scr[kOwn * T * (c & (kIdx - 1)) + own] + 1.f;
#pragma unroll
    for (int k = 0; k < STORES; ++k) scr[dst[k]] = v;
  }

  // 4. the output rows, once the stream has landed
  mbar_wait(bar, 0);
  if (i < 8)
    out[(static_cast<size_t>(cell) * 8 + i) * S + col0 + col] =
        scr[i * T + col] + __bfloat162float(blk[i * T + col]);
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

using Body = void (*)(const CUtensorMap, const int*, float*, int, int, int,
                     int, int, int, int);
constexpr int kMaxStores = 4;      // the script's experiments store 0, 2, 4
const Body kBodies[kMaxStores + 1] = {
    pipe_cell_kernel<0>, pipe_cell_kernel<1>, pipe_cell_kernel<2>,
    pipe_cell_kernel<3>, pipe_cell_kernel<4>};

}  // namespace

// stores in [0, 4]; T in {8, 16, 32, 64} dividing S; block_rows a multiple of 8 and of
// stage_rows (at most 256, a multiple of 8); big 16-byte aligned; scratch
// and block within 227 KB (perf_pipe_lab.pipe_plan); scratch_rows >= 1024
// when loops > 0 (the loop reads rows up to 16 * 64), and every idx entry
// below scratch_rows / 16.  Returns cudaGetLastError() after the launch,
// or without launching: cudaErrorInvalidValue for arguments it does not
// take, cudaErrorInvalidConfiguration for shared memory past the block's,
// cudaErrorInvalidPitchValue where the tensor map cannot be encoded.
extern "C" int bito_pipe_cell(const int* idx, const void* big, float* out,
                              int cells, int block_rows, int scratch_rows,
                              int S, int init, int loops, int stores, int T,
                              int stage_rows, void* stream) {
  const long long dynamic = static_cast<long long>(block_rows) * T * 2 +
                            static_cast<long long>(scratch_rows) * T * 4;
  if (cells <= 0 || cells > 65535 || S <= 0 || loops < 0 || stores < 0 ||
      stores > kMaxStores ||
      (T != 8 && T != 16 && T != 32 && T != 64) || S % T != 0 ||
      block_rows < 8 || block_rows % 8 != 0 || stage_rows < 8 ||
      stage_rows > 256 || stage_rows % 8 != 0 || block_rows % stage_rows != 0 ||
      scratch_rows < 8 || dynamic + kAlign > kMaxSmem ||
      reinterpret_cast<uintptr_t>(big) % 16 != 0)
    return cudaErrorInvalidValue;
  // Once per body, outside any stream capture: a block may take 227 KB,
  // its static arrays (the offsets, the mbarrier) included.
  static long long max_dynamic[kMaxStores + 1] = {-1, -1, -1, -1, -1};
  if (max_dynamic[stores] < 0) {
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, kBodies[stores]);
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(
          kBodies[stores], cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem - static_cast<int>(attr.sharedSizeBytes));
    }
    if (rc != cudaSuccess) {
      cudaGetLastError();  // leave no error for the next launch to find
      return static_cast<int>(rc);
    }
    max_dynamic[stores] =
        kMaxSmem - static_cast<long long>(attr.sharedSizeBytes);
  }
  if (dynamic + kAlign > max_dynamic[stores])
    return cudaErrorInvalidConfiguration;
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(block_rows),
                              static_cast<cuuint64_t>(cells)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(S) * 2,
                                 static_cast<cuuint64_t>(block_rows) * S * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T),
                             static_cast<cuuint32_t>(stage_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(big), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidPitchValue;   // the tensor map refused the block
  const dim3 grid(S / T, cells);
  kBodies[stores]<<<grid, 16 * T, static_cast<size_t>(dynamic + kAlign),
                    static_cast<cudaStream_t>(stream)>>>(
      map, idx, out, block_rows, scratch_rows, S, T, stage_rows, init, loops);
  return static_cast<int>(cudaGetLastError());
}
