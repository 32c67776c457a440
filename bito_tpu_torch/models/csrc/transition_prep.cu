// The paired route's kernel operands at 4 states: the transition matrices
// P and their branch-length derivatives dP, float32 [B, N+1, C, 4, 4],
// from the float64 model ingredients and the branch lengths, in one launch.
//
// Replaces no Pallas kernel: bito_tpu left this prep to XLA
// (bito_tpu/treelike/pallas_pruning.py prepare_inputs_grad_q), and the
// port ran it as torch ops (treelike/prep.py transition_prep_plain, its
// plain version), among them two batched 4x4 float64 matrix products that
// cuBLAS tiles 32x32 or 64x32.  It computes what those ops compute, in
// float64 and in their order, for tree b, edge e < N, category c:
//   t  = double(bl[b, e]) * rate[b, c] * clock[b]
//   P  = max(U diag(exp(lambda t)) U^-1, 0)
//   Q  = U diag(lambda) U^-1
//   dP = ((rate[b, c] * clock[b]) Q) P        (the clamped P)
// and at the identity edge e = N, P = I and dP = 0; both are cast to
// float32 last.  Every operand is read through its strides: a shared
// model's rows expanded over the trees have a tree stride of 0, and a
// slice of a wider buffer of branch lengths is read where it lies.
//
// What bounds it on the H100: the writes, 128 bytes a matrix (10.85 MB at
// 400 trees x 53 edges x 4 categories, 3.3 us at 3.35 TB/s).  It reads the
// branch lengths once and the ingredients, a few hundred bytes a tree,
// through the cache; its float64 arithmetic is about 150 operations a row.
//
// Design: four neighbouring threads own one (tree, edge, category) matrix,
// thread r its row r of P and of dP, so a warp stores eight matrices as 32
// neighbouring float4s of P and 32 of dP.  Thread r takes exp(lambda_r t)
// and the four share the exponentials by shuffles; each then forms the
// whole of P (a row of dP needs every row of P), which takes fewer
// instructions than shuffling P's rows.  Every thread runs the shuffles,
// those past the last matrix on its operands, and only the stores are
// masked.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// A [.., 4, 4] float64 matrix of one tree, read through its strides.
struct Mat {
  const double* p;
  int si, sj;
  __device__ double operator()(int i, int j) const {
    return __ldg(p + i * si + j * sj);
  }
};

// sum_k a[k] * m(k, j), the products summed from k = 0 on.
__device__ __forceinline__ double row_times(const double a[4], const Mat& m,
                                            int j) {
  double acc = a[0] * m(0, j);
#pragma unroll
  for (int k = 1; k < 4; ++k) acc = fma(a[k], m(k, j), acc);
  return acc;
}

template <typename BL>
__global__ void __launch_bounds__(kThreads)
transition_prep_kernel(const BL* __restrict__ bl,         // [B, N]
                       const double* __restrict__ U,      // [B, 4, 4]
                       const double* __restrict__ U_inv,  // [B, 4, 4]
                       const double* __restrict__ lam,    // [B, 4]
                       const double* __restrict__ rates,  // [B, C]
                       const double* __restrict__ clock,  // [B]
                       float4* __restrict__ P,            // [B, N+1, C, 4]
                       float4* __restrict__ dP,           // [B, N+1, C, 4]
                       int N, int C, unsigned matrices, int bl_b, int bl_e,
                       int u_b, int u_i, int u_j, int v_b, int v_i, int v_j,
                       int l_b, int l_k, int r_b, int r_c, int k_b) {
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  const int r = threadIdx.x & 3;
  const int group = threadIdx.x & 28;  // the group's first lane in the warp
  const bool live = (g >> 2) < matrices;
  const unsigned m = live ? g >> 2 : matrices - 1;
  const int c = m % C;
  const unsigned be = m / C;
  const int e = be % (N + 1);
  const int b = be / (N + 1);

  const Mat u{U + static_cast<size_t>(b) * u_b, u_i, u_j};
  const Mat v{U_inv + static_cast<size_t>(b) * v_b, v_i, v_j};
  const double* lb = lam + static_cast<size_t>(b) * l_b;
  const double rate = __ldg(rates + static_cast<size_t>(b) * r_b + c * r_c);
  const double clk = __ldg(clock + static_cast<size_t>(b) * k_b);
  const double t =
      e < N ? static_cast<double>(
                  bl[static_cast<long long>(b) * bl_b +
                     static_cast<long long>(e) * bl_e]) *
                  rate * clk
            : 0.0;

  const double own = exp(__ldg(lb + r * l_k) * t);
  double ex[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ex[k] = __shfl_sync(kFullMask, own, group + k);

  // P = max(U diag(ex) U^-1, 0), every row.
  double p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    double ue[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ue[k] = u(i, k) * ex[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double x = row_times(ue, v, j);
      p[i][j] = x < 0.0 ? 0.0 : x;  // keeps a NaN, as clamp_min does
    }
  }

  // Row r of (rate clock) Q, with Q = U diag(lambda) U^-1.
  double ul[4], qc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ul[k] = u(r, k) * __ldg(lb + k * l_k);
  const double scale = rate * clk;
#pragma unroll
  for (int j = 0; j < 4; ++j) qc[j] = scale * row_times(ul, v, j);

  // Row r of dP = (rate clock Q) P, and row r of P.
  float d[4], q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    double acc = qc[0] * p[0][j];
#pragma unroll
    for (int k = 1; k < 4; ++k) acc = fma(qc[k], p[k][j], acc);
    d[j] = static_cast<float>(acc);
    double own_p = p[0][j];
#pragma unroll
    for (int i = 1; i < 4; ++i) own_p = i == r ? p[i][j] : own_p;
    q[j] = static_cast<float>(own_p);
  }
  if (e == N) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = j == r ? 1.f : 0.f;
      d[j] = 0.f;
    }
  }
  if (live) {
    const size_t at = static_cast<size_t>(m) * 4 + r;
    P[at] = make_float4(q[0], q[1], q[2], q[3]);
    dP[at] = make_float4(d[0], d[1], d[2], d[3]);
  }
}

}  // namespace

// P and dP [B, N+1, C, 4, 4] float32 (contiguous) from bl [B, N]
// (float64 where bl_f64, else float32) and the float64 ingredients U,
// U_inv [B, 4, 4], lambda [B, 4], rates [B, C] and clock [B], each read
// through the element strides given (bl_b, bl_e: bl's tree and edge
// strides; u_b, u_i, u_j: U's tree, row and column strides; v_*: U_inv's;
// l_*: lambda's; r_*: rates'; k_b: clock's).  Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int bito_transition_prep(
    const void* bl, const double* U, const double* U_inv, const double* lam,
    const double* rates, const double* clock, float* P, float* dP, int B,
    int N, int C, int bl_f64, int bl_b, int bl_e, int u_b, int u_i, int u_j,
    int v_b, int v_i, int v_j, int l_b, int l_k, int r_b, int r_c, int k_b,
    void* stream) {
  const long long matrices = static_cast<long long>(B) * (N + 1) * C;
  if (B < 0 || N < 0 || C < 1 || matrices * 4 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (matrices == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((matrices * 4 + kThreads - 1) / kThreads);
  float4* p4 = reinterpret_cast<float4*>(P);
  float4* d4 = reinterpret_cast<float4*>(dP);
  const unsigned mm = static_cast<unsigned>(matrices);
  if (bl_f64)
    transition_prep_kernel<double><<<blocks, kThreads, 0, st>>>(
        static_cast<const double*>(bl), U, U_inv, lam, rates, clock, p4, d4,
        N, C, mm, bl_b, bl_e, u_b, u_i, u_j, v_b, v_i, v_j, l_b, l_k, r_b,
        r_c, k_b);
  else
    transition_prep_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(bl), U, U_inv, lam, rates, clock, p4, d4,
        N, C, mm, bl_b, bl_e, u_b, u_i, u_j, v_b, v_i, v_j, l_b, l_k, r_b,
        r_c, k_b);
  return static_cast<int>(cudaGetLastError());
}
