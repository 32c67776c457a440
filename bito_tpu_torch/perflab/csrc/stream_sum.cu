// Sums of 8-row groups of a streamed bf16 block, in two walks.
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
// rows as one axis).  One body serves both, the walk a template parameter.
//
// A group, 8 rows of `cols` values, is 8 * cols contiguous bf16 values in
// the shape of out[cell]: a cell's sums are the column sums of a [groups,
// 8 * cols] matrix whose rows start 16 * cols bytes apart, so every row is
// `cols` 16-byte chunks, whatever cols is.
//
// Design (what bounds it: device-memory bytes, 210 MB for 100 cells of 32 x
// 256 x 128, which HBM's latency lets through only with enough loads in
// flight): a thread owns one 16-byte chunk (8 bf16 values, 8 float32 sums)
// and one of kLanes lanes, and adds its share of the groups in order, one
// 16-byte load each, unrolled by 8: the flat walk takes groups lane, lane +
// kLanes, ...; the slice walk takes slices lane, lane + kLanes, ... and
// every group of each.  A block is kChunks chunks x kLanes lanes (256
// threads; a warp reads 512 contiguous bytes), and the grid (chunk tiles,
// cells): 400 blocks at the script's shape, all resident at once, with 8
// loads of 16 bytes in flight a thread, about 100 KB an SM.  The kLanes
// partial sums of a chunk are then added in lane order in shared memory: a
// fixed order, no atomics, the same result on every run.  The two walks
// add in different orders, so on data whose partial sums float32 rounds
// they may differ in the last bits.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunks = 32;  // 16-byte chunks of a group per block
constexpr int kLanes = 8;    // lanes per block (shares of the groups)

// acc += the 8 bf16 values of v (a bf16's bits are the top half of its
// float32's).
__device__ __forceinline__ void add_chunk(float (&acc)[8], uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc[2 * q] += __uint_as_float(w[q] << 16);
    acc[2 * q + 1] += __uint_as_float(w[q] & 0xffff0000u);
  }
}

template <bool SLICES>
__global__ void __launch_bounds__(kChunks * kLanes)
stream_sum_kernel(const uint4* __restrict__ big,  // [cells, groups, cols]
                  float4* __restrict__ out,       // [cells, cols, 2]
                  int nslices, int rows, int cols) {
  __shared__ float4 part[kLanes][kChunks][2];
  const int j = blockIdx.x * kChunks + threadIdx.x;  // chunk of a group
  const int lane = threadIdx.y;
  const int cell = blockIdx.y;
  const int per_slice = rows / 8;  // groups a slice
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (j < cols) {
    const uint4* base =
        big + static_cast<size_t>(cell) * nslices * per_slice * cols + j;
    if constexpr (SLICES) {
      for (int o = lane; o < nslices; o += kLanes) {
        const uint4* sl = base + static_cast<size_t>(o) * per_slice * cols;
#pragma unroll 8
        for (int r = 0; r < per_slice; ++r)
          add_chunk(acc, __ldcs(sl + static_cast<size_t>(r) * cols));
      }
    } else {
      const int groups = nslices * per_slice;
#pragma unroll 8
      for (int gi = lane; gi < groups; gi += kLanes)
        add_chunk(acc, __ldcs(base + static_cast<size_t>(gi) * cols));
    }
  }
  part[lane][threadIdx.x][0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  part[lane][threadIdx.x][1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  if (lane < 2 && j < cols) {  // lane h adds half h of the chunk's 8 sums
    float4 t = part[0][threadIdx.x][lane];
#pragma unroll
    for (int m = 1; m < kLanes; ++m) {
      const float4 v = part[m][threadIdx.x][lane];
      t = make_float4(t.x + v.x, t.y + v.y, t.z + v.z, t.w + v.w);
    }
    out[(static_cast<size_t>(cell) * cols + j) * 2 + lane] = t;
  }
}

}  // namespace

// rows must be a multiple of 8, and big and out 16-byte aligned.  slices: 1
// walks slice by slice (kernel4), 0 walks the groups flat (kernel3).
// Returns cudaGetLastError() after the launch.
extern "C" int bito_stream_sum(const void* big, float* out, int cells,
                               int nslices, int rows, int cols, int slices,
                               void* stream) {
  if (cells <= 0 || cells > 65535 || nslices <= 0 || rows <= 0 ||
      rows % 8 != 0 || cols <= 0 ||
      reinterpret_cast<uintptr_t>(big) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((cols + kChunks - 1) / kChunks, cells);
  const dim3 block(kChunks, kLanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint4*>(big);
  auto* o = reinterpret_cast<float4*>(out);
  if (slices) {
    stream_sum_kernel<true><<<grid, block, 0, st>>>(b, o, nslices, rows, cols);
  } else {
    stream_sum_kernel<false><<<grid, block, 0, st>>>(b, o, nslices, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
