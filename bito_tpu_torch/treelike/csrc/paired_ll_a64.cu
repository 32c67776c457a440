// Per-pattern tree log likelihoods over the paired-slot tape at 64 states
// (MG94 codon models).
//
// Replaces bito_tpu/treelike/pallas_paired.py::_ll_kernel at CA = 64 C,
// where bito_tpu runs it on MG94 (kernel="pallas").  It computes what that
// kernel computes: the postorder over the paired-slot tape
// (build_paired_encoding), each op evolving both children by their
// per-category P and multiplying, with exact per-site log scales, then at
// the root log sum_ca pi*prop*partial + log scale, per (tree, pattern).
// The pattern weights are applied outside, as in bito_tpu.
//
// What bounds it: the products, 2 x 64 x 64 x S multiply-adds an op and
// category, which run on the tensor cores in 3xTF32 (paired_a64.cuh: the
// instruction, the split, the staging and the rescaling).  The partials
// go to device memory once each, at 16 patterns x 64 states a warp, and
// come back mostly from L2.  What it does not carry over from
// bito_tpu: the bf16 hi/lo planes, the K-stacked block-diagonal
// [2CA, 6CA] operands, the fourth lo*lo pass, the G-way interleave and
// the VMEM tiles existed for the v5e matrix unit.
//
// Grid: (pattern tiles of a64::kTile, B), a64::kWarps warps a block, one
// block an SM (176 KB of shared memory: a step's raw P of both children,
// their hi and lo planes, and each warp's slices).
#include "paired_a64.cuh"

namespace {

constexpr int kRaw = 2;  // raw matrices a step: P of both children
constexpr size_t kSmem = a64::smem_bytes(kRaw);

__global__ void __launch_bounds__(a64::kThreads, 1)
paired_ll_a64_kernel(const int* __restrict__ post_dst,  // [B, M]
                     const int* __restrict__ tip_slot,  // [B, T]
                     const int* __restrict__ post_e,    // [B, M, 2]
                     const float* __restrict__ P,       // [B, N1, C, 64, 64]
                     const float* __restrict__ tips,    // [T, 64, S]
                     const float* __restrict__ pi,      // [64]
                     const float* __restrict__ props,   // [C]
                     float* __restrict__ buf,           // [B, NS, C, 64, S]
                     float* __restrict__ scratch,       // paired_a64.cuh
                     float* __restrict__ ll_rows,       // [B, S]
                     int M, int T, int N1, int C, int S) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y;
  const int NS = 2 * M + 3;
  const int* dst_b = post_dst + static_cast<size_t>(b) * M;
  const int* e_b = post_e + static_cast<size_t>(b) * M * 2;
  const float* P_b = P + static_cast<size_t>(b) * N1 * C * a64::kMat;
  float* raw = sm;
  float* planes = raw + kRaw * a64::kMat;
  int* codes = reinterpret_cast<int*>(
      scratch + static_cast<size_t>(gridDim.y) * NS * (2 + C) * S);
  const a64::Warp w = a64::make_warp(
      planes + 2 * a64::kPlanes * a64::kMat, buf, scratch, codes, tips, C, S,
      NS);
  a64::fill_codes(const_cast<int*>(w.code), dst_b,
                            tip_slot + static_cast<size_t>(b) * T, M, T);
  float* ll_row = ll_rows + static_cast<size_t>(b) * S;

  a64::Step cur = a64::next_step({0, -1, C - 1}, dst_b, M, C, false);
  a64::stage_mats(raw, cur, e_b, P_b, nullptr, C);
  a64::cp_commit();
  a64::PostAcc st;
  while (cur.m >= 0) {
    const a64::Step nxt = a64::next_step(cur, dst_b, M, C, false);
    a64::begin_step(w, cur, raw, planes);
    if (nxt.m >= 0)  // the next step's matrices, during this one's products
      a64::stage_mats(raw, nxt, e_b, P_b, nullptr, C);
    a64::cp_commit();
    a64::post_step<8>(w, planes, cur.m, cur.c, C, M, dst_b, pi, props, st,
                   ll_row);
    cur = nxt;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  S must be a
// multiple of 4 and the float operands 16-byte aligned; `scratch` holds
// B*NS*(2+C)*S floats and then B * ceil(S/kTile) * NS ints
// (bito_paired_a64_tile() gives kTile).
extern "C" int bito_paired_ll_a64(const int* post_dst, const int* tip_slot,
                                  const int* post_e, const float* P,
                                  const float* tips, const float* pi,
                                  const float* props, float* buf,
                                  float* scratch, float* ll_rows, int B, int M,
                                  int T, int N1, int C, int S, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || S % 4 != 0 || M <= 0 || C < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((S + a64::kTile - 1) / a64::kTile, B);
  cudaError_t err = cudaFuncSetAttribute(
      paired_ll_a64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paired_ll_a64_kernel<<<grid, a64::kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      post_dst, tip_slot, post_e, P, tips, pi, props, buf, scratch, ll_rows,
      M, T, N1, C, S);
  return static_cast<int>(cudaGetLastError());
}

// Patterns a block of either A=64 kernel takes: the scratch's slot-code
// tables are sized by it.
extern "C" int bito_paired_a64_tile() { return a64::kTile; }
