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
// Without init the scratch holds whatever was there before (on the TPU, an
// earlier cell's VMEM; here whatever the allocation held), and so does the
// output: the experiment leaves the fill out of the timed work on purpose.
//
// On the H100 a scratch of 2,080-4,160 rows (8.5-17 MB) does not fit in
// shared memory, so each cell has its own scratch in device memory (0.85-
// 1.7 GB at 100 cells), allocated by the caller.  Every column of the
// computation is independent, so a block takes one cell and 128 columns,
// one thread each: a thread's loads and stores of a row are neighbours of
// its warp's, and it reads its own stores in program order.  The block is
// streamed with cp.async, 16 bytes a copy, in stages of 64 rows through
// 16 KB of shared memory; rows 0-7 of the first stage are kept for step 4.
// What bounds it: device-memory bytes, the scratch fill's writes (up to
// 17 MB a cell) and the block's reads (up to 2 MB a cell).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;       // columns per block, one thread each
constexpr int kStageRows = 64;   // block rows per cp.async stage
constexpr int kIdx = 64;         // offsets per cell
constexpr int kChunk = 8;        // bf16 values per 16-byte copy

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__global__ void __launch_bounds__(kCols)
pipe_cell_kernel(const int* __restrict__ idx,             // [cells, 64]
                 const __nv_bfloat16* __restrict__ big,   // [cells, rows, S]
                 float* __restrict__ scratch,  // [cells, scratch_rows, S]
                 float* __restrict__ out,      // [cells, 8, S]
                 int block_rows, int scratch_rows, int S, int init, int loops,
                 int stores) {
  __shared__ __align__(16) __nv_bfloat16 stage[kStageRows][kCols];
  __shared__ int offs[kIdx];
  const int cell = blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int t = threadIdx.x;
  if (t < kIdx) offs[t] = idx[cell * kIdx + t];

  // 1. the streamed block, through shared memory
  const __nv_bfloat16* blk = big + static_cast<size_t>(cell) * block_rows * S +
                             col0;
  constexpr int kChunksPerRow = kCols / kChunk;
  float head[8];
  for (int r0 = 0; r0 < block_rows; r0 += kStageRows) {
    const int rows = min(kStageRows, block_rows - r0);
    for (int k = t; k < rows * kChunksPerRow; k += kCols) {
      const int r = k / kChunksPerRow;
      const int c = (k % kChunksPerRow) * kChunk;
      cp_async16(&stage[r][c], blk + static_cast<size_t>(r0 + r) * S + c);
    }
    cp_async_wait_all();
    __syncthreads();
    if (r0 == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) head[i] = __bfloat162float(stage[i][t]);
    }
    __syncthreads();  // the stage is free for the next rows
  }

  // 2.-3. the scratch column of this thread
  float* scr = scratch + static_cast<size_t>(cell) * scratch_rows * S + col0 + t;
  if (init) {
    for (int r = 0; r < scratch_rows; ++r) scr[static_cast<size_t>(r) * S] = 1.f;
  }
  for (int c = 0; c < loops; ++c) {
    const float* src = scr + static_cast<size_t>(16 * (c % kIdx)) * S;
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = src[static_cast<size_t>(i) * S] + 1.f;
    for (int k = 0; k < stores; ++k) {
      float* dst = scr + static_cast<size_t>(16 * offs[(c + k) % kIdx]) * S;
#pragma unroll
      for (int i = 0; i < 16; ++i) dst[static_cast<size_t>(i) * S] = v[i];
    }
  }

  // 4. the output rows
  float* o = out + static_cast<size_t>(cell) * 8 * S + col0 + t;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[static_cast<size_t>(i) * S] = scr[static_cast<size_t>(i) * S] + head[i];
}

}  // namespace

// S must be a multiple of 128, block_rows >= 8, scratch_rows >= 1024 when
// loops > 0 (the loop reads rows up to 16 * 64), and every idx entry below
// scratch_rows / 16.  Returns cudaGetLastError() after the launch.
extern "C" int bito_pipe_cell(const int* idx, const void* big, float* scratch,
                              float* out, int cells, int block_rows,
                              int scratch_rows, int S, int init, int loops,
                              int stores, void* stream) {
  if (cells <= 0 || cells > 65535 || S <= 0 || S % kCols != 0 ||
      block_rows < 8 || scratch_rows < 8 || loops < 0 || stores < 0)
    return cudaErrorInvalidValue;
  const dim3 grid(S / kCols, cells);
  pipe_cell_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, static_cast<const __nv_bfloat16*>(big), scratch, out, block_rows,
      scratch_rows, S, init, loops, stores);
  return static_cast<int>(cudaGetLastError());
}
