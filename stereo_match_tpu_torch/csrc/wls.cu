// K7 fgs_solve: batched tridiagonal (Thomas) solves of the WLS smoother.
//
// Replaces, in stereo_match_tpu/ops/pallas_wls.py, fgs_solve_pallas
// (_fgs_fwd_kernel, _fgs_bwd_kernel); with the torch glue of
// ops/wls.py::_fgs_stack it also replaces the per-iteration loop of
// fast_global_smoother_pallas. It solves (I + lam A) u = f along axis 1 of
// a (C, S, N) slab: N independent lines of S unknowns, C right-hand sides
// sharing one elimination. Per step s, operation for operation as
// stereo_match_tpu/ops/wls.py:55-72 and pallas_wls.py:62-88:
//   a = -lam * wp[s],  c = -lam * wn[s],  b = (1 - a) - c
//   denom = b - a * cp,  cp = c / denom,  dp_k = (f_k[s] - a * dp_k) / denom
// then back substitution u_k[s] = dp_k[s] - cp[s] * u_k[s+1], from a zero
// carry at both ends. wp[0] = wn[S-1] = 0 is the Neumann boundary. Every
// multiply, subtract and divide is an explicitly rounded intrinsic
// (__fmul_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract a multiply
// and a subtract into an FMA: the result equals the plain PyTorch version
// (separate, rounded tensor operations) bit for bit.
//
// The TPU split the solve into a forward and a reversed kernel only for
// its reversed index map; here one thread owns one line and runs both
// sweeps, so one launch per solve. The eliminated cp goes to a scratch
// (S, N) slab and the dp's straight into u, which back substitution then
// overwrites in place. The line index is the contiguous one, so the 32
// threads of a warp read and write 32 neighbouring floats each step. The
// row solve of the smoother passes the (C, W, H) transpose of the image
// slab (torch glue, as fast_global_smoother_pallas does), the column
// solve the (C, H, W) slab itself.
//
// Bound on the H100: latency of the sequential chain (a division per step
// and right-hand side). A KITTI row solve runs H = 375 lines of 1242 steps:
// 12 warps on 132 SMs. Loads do not depend on the chain, so the
// compiler can issue them ahead of it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <int C>
__global__ void fgs_solve_kernel(const float* __restrict__ f,
                                 const float* __restrict__ wp,
                                 const float* __restrict__ wn,
                                 float* __restrict__ cp_buf,
                                 float* __restrict__ u, int S, int N,
                                 float lam) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t plane = (size_t)S * N;
  const float neg_lam = -lam;
  float cp = 0.f;
  float dp[C];
#pragma unroll
  for (int k = 0; k < C; ++k) dp[k] = 0.f;

  for (int s = 0; s < S; ++s) {
    const size_t off = (size_t)s * N + n;
    const float a = __fmul_rn(neg_lam, wp[off]);
    const float c = __fmul_rn(neg_lam, wn[off]);
    const float b = __fsub_rn(__fsub_rn(1.f, a), c);
    const float denom = __fsub_rn(b, __fmul_rn(a, cp));
    cp = __fdiv_rn(c, denom);
    cp_buf[off] = cp;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      dp[k] = __fdiv_rn(__fsub_rn(f[k * plane + off], __fmul_rn(a, dp[k])),
                        denom);
      u[k * plane + off] = dp[k];
    }
  }

  float un[C];
#pragma unroll
  for (int k = 0; k < C; ++k) un[k] = 0.f;
  for (int s = S - 1; s >= 0; --s) {
    const size_t off = (size_t)s * N + n;
    const float cps = cp_buf[off];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      un[k] = __fsub_rn(u[k * plane + off], __fmul_rn(cps, un[k]));
      u[k * plane + off] = un[k];
    }
  }
}

template <int C>
void launch(const float* f, const float* wp, const float* wn, float* cp,
            float* u, int S, int N, float lam, cudaStream_t stream) {
  fgs_solve_kernel<C><<<(N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      f, wp, wn, cp, u, S, N, lam);
}

}  // namespace

// f, u: (C, S, N) float32; wp, wn, cp: (S, N) float32, cp a scratch.
// C = 1 or 2.
extern "C" int smt_fgs_solve(const float* f, const float* wp, const float* wn,
                             float* cp, float* u, int C, int S, int N,
                             float lam, void* stream) {
  if (S < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(f, wp, wn, cp, u, S, N, lam, st); break;
    case 2: launch<2>(f, wp, wn, cp, u, S, N, lam, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
