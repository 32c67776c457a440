// Per-pattern tree log likelihoods and branch-length gradient rows over the
// paired-slot tape.
//
// Replaces bito_tpu/treelike/pallas_paired.py::_grad_kernel (the Pallas TPU
// kernel behind paired_ll_and_gradients).  It computes what that kernel
// computes: the postorder and root log likelihood of paired_ll.cu, then an
// outside pass in reverse tape order.  Op m reads its outside value from
// slot post_dst[m] (written earlier in the pass by the op that consumes
// m's output, or seeded with pi at the root), forms both children's
// outside vectors o1 = up * ev2 and o2 = up * ev1, and writes for each
// child the weighted gradient row
//     w * sum_ca prop*o*(dP p) / sum_ca prop*o*(P p)
// to row post_src[m, j], then the up pair P^T o over the pair slots
// (2m, 2m+1), whose partials op m was the last to read.  Rows of nodes
// that no op writes (the root, the trash row N1-1) stay as the caller
// zeroed them.  Summing the rows over patterns is left to the caller, so
// the result is the same on every run: no float atomics.
//
// What it does not carry over: the bf16 hi/lo planes, the K-stacked
// forward/derivative operand and the row-stacked transpose operand existed
// for the TPU's matrix unit; here each evolve, derivative evolve and
// transpose evolve is 16 float32 FMAs per category on the CUDA cores.  The
// outside vectors are rescaled after every op (bito_tpu: every fourth);
// each gradient row is a ratio that does not depend on that scale.
//
// In place, without barriers: a thread owns one (tree, pattern) column and
// runs the whole tape over it, so the read of slot post_dst[m] and the
// overwrite of slots (2m, 2m+1) are ordered by the thread's own program
// order.
//
// What bounds it on the H100: as paired_ll.cu, the paired-slot partials
// live in device memory, and the outside pass reads three columns and
// writes two per op; at 255 registers (C=4, with a spill) two blocks of
// 128 threads fit an SM, so it is bound by the latency of device memory.
// paired_grad_onchip.cu keeps every partial in shared memory and is the
// body the wrappers launch (treelike/paired.py); this one takes the trees
// whose rows do not fit there.
//
// At 9..32 rate categories the kernel is paired_lanes.cuh's grad_kernel (a
// category a lane, the slots in device memory as float4 [B, NS, Sp, G]),
// launched here with the same arguments: `buf` holds B * NS * Sp * G * 4
// floats and `ls` is not read.  Past 32 it is wide_grad_kernel (K = ceil(C
// / 32) categories a lane of 32), and `buf` holds B * NS * Sp * K * 32 * 4.
#include "common.cuh"
#include "paired_lanes.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(bito::kThreads)
paired_grad_kernel(const int* __restrict__ post_dst,   // [B, M]
                   const int* __restrict__ tip_slot,   // [B, T]
                   const int* __restrict__ post_src,   // [B, M, 2]
                   const int* __restrict__ post_e,     // [B, M, 2]
                   const float* __restrict__ P,        // [B, N1, C, 4, 4]
                   const float* __restrict__ dP,       // [B, N1, C, 4, 4]
                   const float* __restrict__ tips,     // [T, 4, S]
                   const float* __restrict__ pi,       // [4]
                   const float* __restrict__ props,    // [C]
                   const float* __restrict__ weights,  // [S]
                   float* __restrict__ buf,            // [B, NS, C*4, S]
                   float* __restrict__ ls,             // [B, NS, S]
                   float* __restrict__ ll_rows,        // [B, S]
                   float* __restrict__ grad_rows,      // [B, N1, S], zeroed
                   int M, int T, int N1, int S) {
  constexpr int A = bito::A;
  constexpr int CA = C * A;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int b = blockIdx.y;
  const int NS = 2 * M + 3;
  const int root = 2 * M;
  const int trash = 2 * M + 1;

  const bito::Column<C> col{
      buf + static_cast<size_t>(b) * NS * CA * S + s, S};
  float* ls_col = ls + static_cast<size_t>(b) * NS * S + s;
  const size_t mat_stride = static_cast<size_t>(CA) * A;
  const float* P_b = P + static_cast<size_t>(b) * N1 * mat_stride;
  const float* dP_b = dP + static_cast<size_t>(b) * N1 * mat_stride;
  const int* dst_b = post_dst + static_cast<size_t>(b) * M;
  const int* e_b = post_e + static_cast<size_t>(b) * M * 2;
  const int* src_b = post_src + static_cast<size_t>(b) * M * 2;
  float* grad_col = grad_rows + static_cast<size_t>(b) * N1 * S + s;

  bito::init_tips<C>(col, ls_col, tip_slot + static_cast<size_t>(b) * T,
                     tips, T, s);
  bito::postorder<C>(col, ls_col, dst_b, e_b, P_b, M, trash);
  ll_rows[static_cast<size_t>(b) * S + s] =
      bito::root_ll<C>(col, ls_col, root, pi, props);

  // Seed the outside recursion: the root's outside value is pi, written
  // over the root partial, which the log likelihood above has consumed.
  {
    float seed[CA];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int a = 0; a < A; ++a) seed[c * A + a] = __ldg(pi + a);
    col.store(root, seed);
  }

  const float w = weights[s];
  float prop[C];
#pragma unroll
  for (int c = 0; c < C; ++c) prop[c] = __ldg(props + c);

  for (int m = M - 1; m >= 0; --m) {
    const int dst = dst_b[m];
    if (dst == trash) continue;  // padded op
    const float* P1 = P_b + static_cast<size_t>(e_b[2 * m]) * mat_stride;
    const float* P2 = P_b + static_cast<size_t>(e_b[2 * m + 1]) * mat_stride;
    const float* dP1 = dP_b + static_cast<size_t>(e_b[2 * m]) * mat_stride;
    const float* dP2 = dP_b + static_cast<size_t>(e_b[2 * m + 1]) * mat_stride;

    float p1[CA], p2[CA], ev1[CA], ev2[CA], o1[CA], o2[CA];
    col.load(2 * m, p1);
    col.load(2 * m + 1, p2);
    bito::evolve<C>(P1, p1, ev1);
    bito::evolve<C>(P2, p2, ev2);
    col.load(dst, o1);  // the op's own outside value
#pragma unroll
    for (int i = 0; i < CA; ++i) {
      o2[i] = o1[i] * ev1[i];
      o1[i] = o1[i] * ev2[i];
    }
    float mx = fmaxf(bito::max_of(o1), bito::max_of(o2));
    mx = mx > 0.f ? mx : 1.f;
#pragma unroll
    for (int i = 0; i < CA; ++i) {
      o1[i] /= mx;
      o2[i] /= mx;
    }

    // Gradient rows: num = sum_c prop_c o.(dP p), den = sum_c prop_c o.(P p).
    float dv[CA];
    float num1 = 0.f, den1 = 0.f, num2 = 0.f, den2 = 0.f;
    bito::evolve<C>(dP1, p1, dv);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float n = 0.f, d = 0.f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        n = fmaf(o1[c * A + a], dv[c * A + a], n);
        d = fmaf(o1[c * A + a], ev1[c * A + a], d);
      }
      num1 = fmaf(prop[c], n, num1);
      den1 = fmaf(prop[c], d, den1);
    }
    bito::evolve<C>(dP2, p2, dv);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float n = 0.f, d = 0.f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        n = fmaf(o2[c * A + a], dv[c * A + a], n);
        d = fmaf(o2[c * A + a], ev2[c * A + a], d);
      }
      num2 = fmaf(prop[c], n, num2);
      den2 = fmaf(prop[c], d, den2);
    }
    den1 = den1 > 0.f ? den1 : 1.f;
    den2 = den2 > 0.f ? den2 : 1.f;
    grad_col[static_cast<size_t>(src_b[2 * m]) * S] = w * num1 / den1;
    grad_col[static_cast<size_t>(src_b[2 * m + 1]) * S] = w * num2 / den2;

    // Up pair over the dead pair partials, where each child's own op (or
    // no op, for a tip) reads its outside value.
    bito::evolve_t<C>(P1, o1, p1);
    col.store(2 * m, p1);
    bito::evolve_t<C>(P2, o2, p2);
    col.store(2 * m + 1, p2);
  }
}

}  // namespace

// grad_rows must be zero-filled by the caller.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int bito_paired_grad(const int* post_dst, const int* tip_slot,
                                const int* post_src, const int* post_e,
                                const float* P, const float* dP,
                                const float* tips, const float* pi,
                                const float* props, const float* weights,
                                float* buf, float* ls, float* ll_rows,
                                float* grad_rows, int B, int M, int T, int N1,
                                int C, int S, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 8) {
    float4* slots = reinterpret_cast<float4*>(buf);
    if (C <= 16)
      paired_lanes::grad_kernel<16, false>
          <<<paired_lanes::grid<16>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props,
              weights, slots, ll_rows, grad_rows, M, T, N1, C, S, N1);
    else if (C <= 32)
      paired_lanes::grad_kernel<32, false>
          <<<paired_lanes::grid<32>(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props,
              weights, slots, ll_rows, grad_rows, M, T, N1, C, S, N1);
    else
      paired_lanes::wide_grad_kernel<false>
          <<<paired_lanes::wide_grid(B, S), paired_lanes::kThreads, 0, st>>>(
              post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props,
              weights, slots, ll_rows, grad_rows, M, T, N1, C, S, N1);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((S + bito::kThreads - 1) / bito::kThreads, B);
#define BITO_LAUNCH_GRAD(CV)                                               \
  paired_grad_kernel<CV><<<grid, bito::kThreads, 0, st>>>(                \
      post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props,       \
      weights, buf, ls, ll_rows, grad_rows, M, T, N1, S)
  BITO_DISPATCH_C(C, BITO_LAUNCH_GRAD)
#undef BITO_LAUNCH_GRAD
  return static_cast<int>(cudaGetLastError());
}
