// Sums of 8-row groups of a streamed bf16 block, in two layouts.
//
// Replaces the two kernels of scripts/perf_pipe_lab.py::run4d (the Pallas
// TPU kernels kernel4 at :101 and kernel3 at :109).  Each of `cells` cells
// sums its block, nslices x rows x cols bf16 values, in groups of 8 rows:
//     out[cell, i, :] = sum over groups g of block row (8 g + i), in f32.
// On the TPU the two kernels asked whether a 4-D block [nslices, rows,
// cols] costs one DMA per leading slice against a 3-D block [nslices *
// rows, cols].  On the card both are the same bytes in row-major order, so
// the two entry points differ only in how a thread walks them: slice by
// slice (SLICES, kernel4's loop nest) or flat over the groups (kernel3's
// rows as one axis).  Both add in the same order and give identical sums.
//
// Design: a thread owns two neighbouring columns (one bf16x2 load a row)
// and one of the 8 row phases; a block is 32 column pairs x 8 phases, and
// a warp reads 128 contiguous bytes of a row.  No shared memory and no
// atomics: each output element has one owner, which adds its 1,024 values
// (at 32 x 256 rows) in order.  What bounds it: device-memory bytes, 210
// MB for 100 cells of 32 x 256 x 128, at the loads a thread keeps in
// flight; nvcc schedules the two walks' unrolled loads differently.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 32;   // column pairs per block (one warp)
constexpr int kPhases = 8;   // rows per group

template <bool SLICES>
__global__ void __launch_bounds__(kPairs * kPhases)
stream_sum_kernel(const __nv_bfloat162* __restrict__ big,  // [cells, n, rows, cols/2]
                  float* __restrict__ out,                 // [cells, 8, cols]
                  int nslices, int rows, int cols) {
  const int half = cols / 2;
  const int cp = blockIdx.x * kPairs + threadIdx.x;
  if (cp >= half) return;
  const int i = threadIdx.y;
  const int cell = blockIdx.y;
  const __nv_bfloat162* base =
      big + static_cast<size_t>(cell) * nslices * rows * half + cp;
  float ax = 0.f, ay = 0.f;
  if constexpr (SLICES) {
    for (int o = 0; o < nslices; ++o) {
      const __nv_bfloat162* sl = base + static_cast<size_t>(o) * rows * half;
#pragma unroll 8
      for (int rb = 0; rb < rows / kPhases; ++rb) {
        const float2 v = __bfloat1622float2(
            sl[static_cast<size_t>(rb * kPhases + i) * half]);
        ax += v.x;
        ay += v.y;
      }
    }
  } else {
    const int groups = nslices * (rows / kPhases);
#pragma unroll 8
    for (int g = 0; g < groups; ++g) {
      const float2 v =
          __bfloat1622float2(base[static_cast<size_t>(g * kPhases + i) * half]);
      ax += v.x;
      ay += v.y;
    }
  }
  float* o = out + (static_cast<size_t>(cell) * kPhases + i) * cols + 2 * cp;
  o[0] = ax;
  o[1] = ay;
}

}  // namespace

// rows must be a multiple of 8 and cols even.  slices: 1 walks slice by
// slice (kernel4), 0 walks the groups flat (kernel3).  Returns
// cudaGetLastError() after the launch.
extern "C" int bito_stream_sum(const void* big, float* out, int cells,
                               int nslices, int rows, int cols, int slices,
                               void* stream) {
  if (cells <= 0 || cells > 65535 || nslices <= 0 || rows <= 0 ||
      rows % kPhases != 0 || cols <= 0 || cols % 2 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((cols / 2 + kPairs - 1) / kPairs, cells);
  const dim3 block(kPairs, kPhases);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const __nv_bfloat162*>(big);
  if (slices) {
    stream_sum_kernel<true><<<grid, block, 0, st>>>(b, out, nslices, rows, cols);
  } else {
    stream_sum_kernel<false><<<grid, block, 0, st>>>(b, out, nslices, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
