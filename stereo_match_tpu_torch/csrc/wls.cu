// K7 fgs_solve: the batched tridiagonal solves of the WLS smoother, each
// line split into segments that are solved in parallel.
//
// Replaces, in stereo_match_tpu/ops/pallas_wls.py, fgs_solve_pallas
// (_fgs_fwd_kernel, _fgs_bwd_kernel); with the torch glue of
// ops/wls.py::_fgs_stack it also replaces the per-iteration loop of
// fast_global_smoother_pallas. It solves (I + lam A) u = f along axis 1
// (the rows) or axis 0 (the columns) of a (C, H, W) slab as it lies, C = 1
// or 2 right-hand sides sharing one elimination. Row i of a line is
//   a_i u_(i-1) + b_i u_i + c_i u_(i+1) = f_i,
//   a = -lam * wp,  c = -lam * wn,  b = (1 - a) - c,
// with wp and wn zero at the line's two ends (the Neumann boundary).
//
// Bound on the H100: the bytes (f, wp and wn read once, u written once:
// 11.2 MB at KITTI with C = 2, 0.0033 ms at 3.35 TB/s) and the latency of
// the dependent chain. The TPU kernel, and this kernel's first version, ran
// a line per thread through its S steps, each a device-memory round trip:
// 2484 dependent steps for a KITTI row, on 12 warps of the 132 SMs. The
// TPU's row solve also needed the slab transposed (two copies an
// iteration); here both axes read the slab as it lies.
//
// Design: a partitioned Thomas algorithm (the Thomas-PCR hybrid of Laszlo,
// Giles and Appleyard, ACM TOMS 42(4), 2016). A line is padded with
// identity rows (zero weights and data) to P segments of
// m = max(2, ceil(S / P)) unknowns, and each thread owns one segment:
//  1. it eliminates forward, keeping the spike a' that couples every row to
//     the segment's first unknown x_s: a'_j x_s + x_j + c'_j x_(j+1) = d'_j
//     (rows 0 and 1 only normalised; row 0's a' couples to the previous
//     segment's last unknown);
//  2. it runs that recurrence back to row 0, which becomes
//     A x_(e-1) + x_s + B x_e = D, x_e the segment's last unknown;
//  3. rows 0 and m - 1 of the P segments form a tridiagonal system of 2P
//     unknowns: one step of cyclic reduction leaves P rows in the x_e,
//     parallel cyclic reduction solves them (log2 P levels), then x_s;
//  4. it back-substitutes x_j = (d'_j - a'_j x_s) - c'_j x_(j+1).
// Every pivot is taken without a cancelling subtraction (Grassmann, Taksar
// and Heyman's rule for M-matrices): A is a Laplacian, so I + lam A maps
// all ones to all ones; one more right-hand side of ones rides along, and
// a pivot is that side's value plus the magnitudes of its row's
// off-diagonals. At lam = 30476 (the first step of settings.ini's
// schedule) b = 1 + lam (wp + wn) rounds away some 15 bits of the 1 that
// the solution hangs on, and b - a c' cancels them: the sequential float32
// solve is off a float64 one by about 0.1 px on a KITTI frame, this one by
// about 5e-5 px.
// Rows (axis 1): a warp a row, its 32 lanes the segments (m = 39 at
// KITTI). The warp copies its row of wp, wn and f into shared memory with
// cp.async, coalesced; a lane walks its segment at an odd pitch (m | 1),
// so the lanes' reads at one offset hit distinct banks. The forward values
// overwrite the inputs in place and the result overwrites them again; the
// warp writes u coalesced. The reduced system goes by shuffles.
// Columns (axis 0): a block is 32 neighbouring columns, a lane each, so
// every row access is one 128-B line, by 16 warps, the segments along H
// (m = 24 at KITTI). The forward values go to a device scratch that stays
// in L2, each pass loading kChunk rows ahead of its dependent chain, and
// the reduced system goes through shared memory, a barrier a level.
// A lane's dependent chain is about 3m + 2 log2 P steps: some 130 for a
// KITTI row, against 2484 before.
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fsub_rn,
// __fdiv_rn), so nvcc contracts nothing into an FMA, and the result equals
// ops/cuda_kernels.py::fgs_solve_partitioned_plain (separate, rounded
// tensor operations in this order) bit for bit. That model is the kernel's
// oracle; it differs from the sequential plain solve by that solve's
// rounding, so both are held to a float64 solve.

#include <cuda_runtime.h>

namespace {

constexpr int kRowSegments = 32;   // a row's segments: the lanes of a warp
constexpr int kColWarps = 16;      // a column's segments: a block's warps
constexpr int kChunk = 8;          // rows a column pass loads at once
constexpr int kSmemMax = 232448;   // dynamic shared memory a block

__host__ __device__ inline int segment_len(int S, int P) {
  const int m = (S + P - 1) / P;
  return m < 2 ? 2 : m;
}

__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Row j of a segment: its (a, b, c) from the weights, in the plain
// version's operations, then one step of the forward elimination; (ap, cp,
// dp) hold row j - 1's values and become row j's, dp[C] the side of ones.
template <int C>
__device__ inline void forward_step(int j, float neg_lam, float wp, float wn,
                                    const float (&f)[C], float& ap,
                                    float& cp, float (&dp)[C + 1]) {
  const float a = __fmul_rn(neg_lam, wp);
  const float c = __fmul_rn(neg_lam, wn);
  const float b = __fsub_rn(__fsub_rn(1.f, a), c);
  if (j < 2) {
    ap = __fdiv_rn(a, b);
#pragma unroll
    for (int k = 0; k < C; ++k) dp[k] = __fdiv_rn(f[k], b);
    dp[C] = __fdiv_rn(1.f, b);
    cp = __fdiv_rn(c, b);
  } else {
    float g[C + 1];
#pragma unroll
    for (int k = 0; k < C; ++k) g[k] = __fsub_rn(f[k], __fmul_rn(a, dp[k]));
    g[C] = __fsub_rn(1.f, __fmul_rn(a, dp[C]));
    const float spike = -__fmul_rn(a, ap);
    const float den = __fsub_rn(__fsub_rn(g[C], spike), c);
    ap = __fdiv_rn(spike, den);
#pragma unroll
    for (int k = 0; k <= C; ++k) dp[k] = __fdiv_rn(g[k], den);
    cp = __fdiv_rn(c, den);
  }
}

// One step of the recurrence from row m - 2 back to row 1: (app, cpp, dpp)
// express x_(j+1) in x_s and x_e, and become x_j's.
template <int N>
__device__ inline void backward_step(float apj, float cpj,
                                     const float (&dpj)[N], float& app,
                                     float& cpp, float (&dpp)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    dpp[k] = __fsub_rn(dpj[k], __fmul_rn(cpj, dpp[k]));
  app = __fsub_rn(apj, __fmul_rn(cpj, app));
  cpp = -__fmul_rn(cpj, cpp);
}

// Row 0 from row 1's (app, cpp, dpp): A x_(e-1) + x_s + B x_e = D; on entry
// (A, B, D) hold row 0's forward values (a'_0, c'_0, d'_0), D[C] the ones'.
template <int C>
__device__ inline void first_row(float app, float cpp,
                                 const float (&dpp)[C + 1], float& A,
                                 float& B, float (&D)[C + 1]) {
  float g[C + 1];
#pragma unroll
  for (int k = 0; k <= C; ++k) g[k] = __fsub_rn(D[k], __fmul_rn(B, dpp[k]));
  const float Bn = -__fmul_rn(B, cpp);
  const float den = __fsub_rn(__fsub_rn(g[C], A), Bn);
  A = __fdiv_rn(A, den);
  B = __fdiv_rn(Bn, den);
#pragma unroll
  for (int k = 0; k <= C; ++k) D[k] = __fdiv_rn(g[k], den);
}

// The values of segment k - s (lo) and k + s (hi) of the line, by
// shuffles: the lanes of a warp are a row's segments.
struct ShuffleExchange {
  template <int N>
  __device__ void operator()(const float (&v)[N], int s, float (&lo)[N],
                             float (&hi)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      lo[i] = __shfl_up_sync(0xffffffffu, v[i], s);
      hi[i] = __shfl_down_sync(0xffffffffu, v[i], s);
    }
  }
};

// The same through shared memory: the warps of a block are a column's
// segments, lane l of each on column l. Two buffers alternate, so one
// block barrier an exchange orders every write after the last reads.
template <int N_MAX>
struct SmemExchange {
  float (*buf)[N_MAX][kColWarps][32];
  int k, lane, cur;
  template <int N>
  __device__ void operator()(const float (&v)[N], int s, float (&lo)[N],
                             float (&hi)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) buf[cur][i][k][lane] = v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      lo[i] = k >= s ? buf[cur][i][k - s][lane] : 0.f;
      hi[i] = k + s < kColWarps ? buf[cur][i][k + s][lane] : 0.f;
    }
    cur ^= 1;
  }
};

// Step 3: the reduced system of the P segments of a line, segment k
// holding its row 0 (A, B, D) and its row m - 1
// F x_s + x_e + G x_s(k+1) = R, D[C] and R[C] the side of ones. Gives
// this segment's x_s and x_e.
template <int C, int P, class X>
__device__ void reduced_solve(X& exchange, int k, float A, float B,
                              const float (&D)[C + 1], float F, float G,
                              const float (&R)[C + 1], float (&xs)[C],
                              float (&xe)[C]) {
  // one step of cyclic reduction: x_s of this segment and of the next
  // one leave row m - 1, with zero rows past the end
  float v[3 + C], lo1[3 + C], hi1[3 + C];
  v[0] = A;
  v[1] = B;
#pragma unroll
  for (int i = 0; i <= C; ++i) v[2 + i] = D[i];
  exchange(v, 1, lo1, hi1);
  if (k + 1 >= P) {
#pragma unroll
    for (int i = 0; i < 3 + C; ++i) hi1[i] = 0.f;
  }
  float e[4 + C];   // a, b, c, d[C + 1] of this segment's row in the x_e
  e[0] = -__fmul_rn(F, A);
  e[2] = -__fmul_rn(G, hi1[1]);
#pragma unroll
  for (int i = 0; i <= C; ++i)
    e[3 + i] = __fsub_rn(__fsub_rn(R[i], __fmul_rn(F, D[i])),
                         __fmul_rn(G, hi1[2 + i]));
  e[1] = __fsub_rn(__fsub_rn(e[3 + C], e[0]), e[2]);
  // parallel cyclic reduction, identity rows (ones side 1) past either end
#pragma unroll
  for (int s = 1; s < P; s *= 2) {
    float lo[4 + C], hi[4 + C];
    exchange(e, s, lo, hi);
    if (k < s) {
#pragma unroll
      for (int i = 0; i < 4 + C; ++i) lo[i] = i == 1 || i == 3 + C ? 1.f : 0.f;
    }
    if (k + s >= P) {
#pragma unroll
      for (int i = 0; i < 4 + C; ++i) hi[i] = i == 1 || i == 3 + C ? 1.f : 0.f;
    }
    const float k1 = __fdiv_rn(e[0], lo[1]);
    const float k2 = __fdiv_rn(e[2], hi[1]);
    e[0] = -__fmul_rn(k1, lo[0]);
    e[2] = -__fmul_rn(k2, hi[2]);
#pragma unroll
    for (int i = 3; i < 4 + C; ++i)
      e[i] = __fsub_rn(__fsub_rn(e[i], __fmul_rn(k1, lo[i])),
                       __fmul_rn(k2, hi[i]));
    e[1] = __fsub_rn(__fsub_rn(e[3 + C], e[0]), e[2]);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) xe[i] = __fdiv_rn(e[3 + i], e[1]);
  float lo2[C], hi2[C];
  exchange(xe, 1, lo2, hi2);
#pragma unroll
  for (int i = 0; i < C; ++i)
    xs[i] = __fsub_rn(__fsub_rn(D[i], __fmul_rn(A, k >= 1 ? lo2[i] : 0.f)),
                      __fmul_rn(B, xe[i]));
}

// Axis 1: a warp a row (blockDim.x / 32 rows a block), a lane a segment of
// m unknowns, the row staged in shared memory: wp, wn, f[C] and the side
// of ones, 3 + C arrays of 32 segments at an odd pitch.
template <int C>
__global__ void __launch_bounds__(64)
fgs_rows_kernel(const float* __restrict__ f, const float* __restrict__ wp,
                const float* __restrict__ wn, float* __restrict__ u, int H,
                int W, int m, float lam) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int y = blockIdx.x * (blockDim.x >> 5) + warp;
  if (y >= H) return;   // a whole warp; this kernel has no block barrier
  const int pitch = m | 1;
  const int plane = kRowSegments * pitch;   // floats of one staged array
  float* s_wp = smem + (size_t)warp * (3 + C) * plane;
  float* s_wn = s_wp + plane;
  float* s_d = s_wn + plane;                // f[C], then the side of ones
  const size_t row = (size_t)y * W;
  const size_t hw = (size_t)H * W;

  // element x of the row at (x / m) * pitch + x % m; zeros past W (the
  // identity rows of the padding)
  for (int x = lane; x < kRowSegments * m; x += 32) {
    const int at = (x / m) * pitch + x % m;
    if (x < W) {
      cp_async4(s_wp + at, wp + row + x);
      cp_async4(s_wn + at, wn + row + x);
#pragma unroll
      for (int k = 0; k < C; ++k)
        cp_async4(s_d + k * plane + at, f + k * hw + row + x);
    } else {
      s_wp[at] = 0.f;
      s_wn[at] = 0.f;
#pragma unroll
      for (int k = 0; k < C; ++k) s_d[k * plane + at] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncwarp();

  const float neg_lam = -lam;
  const int base = lane * pitch;
  float ap = 0.f, cp = 0.f, dp[C + 1];
#pragma unroll
  for (int k = 0; k <= C; ++k) dp[k] = 0.f;
  for (int j = 0; j < m; ++j) {
    const int p = base + j;
    float fj[C];
#pragma unroll
    for (int k = 0; k < C; ++k) fj[k] = s_d[k * plane + p];
    forward_step<C>(j, neg_lam, s_wp[p], s_wn[p], fj, ap, cp, dp);
    s_wp[p] = ap;
    s_wn[p] = cp;
#pragma unroll
    for (int k = 0; k <= C; ++k) s_d[k * plane + p] = dp[k];
  }

  float A = s_wp[base], B = s_wn[base], D[C + 1];
#pragma unroll
  for (int k = 0; k <= C; ++k) D[k] = s_d[k * plane + base];
  if (m > 2) {
    float app = s_wp[base + m - 2], cpp = s_wn[base + m - 2], dpp[C + 1];
#pragma unroll
    for (int k = 0; k <= C; ++k) dpp[k] = s_d[k * plane + base + m - 2];
    for (int j = m - 3; j >= 1; --j) {
      float dpj[C + 1];
#pragma unroll
      for (int k = 0; k <= C; ++k) dpj[k] = s_d[k * plane + base + j];
      backward_step(s_wp[base + j], s_wn[base + j], dpj, app, cpp, dpp);
    }
    first_row<C>(app, cpp, dpp, A, B, D);
  }

  ShuffleExchange exchange;
  float xs[C], xe[C];
  reduced_solve<C, kRowSegments>(exchange, lane, A, B, D, ap, cp, dp, xs,
                                 xe);

  float x[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    s_d[k * plane + base] = xs[k];
    s_d[k * plane + base + m - 1] = xe[k];
    x[k] = xe[k];
  }
  for (int j = m - 2; j >= 1; --j) {
    const int p = base + j;
    const float apj = s_wp[p], cpj = s_wn[p];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      x[k] = __fsub_rn(__fsub_rn(s_d[k * plane + p], __fmul_rn(apj, xs[k])),
                       __fmul_rn(cpj, x[k]));
      s_d[k * plane + p] = x[k];
    }
  }
  __syncwarp();
  for (int xx = lane; xx < W; xx += 32) {
    const int at = (xx / m) * pitch + xx % m;
#pragma unroll
    for (int k = 0; k < C; ++k) u[k * hw + row + xx] = s_d[k * plane + at];
  }
}

// Axis 0: a block of 32 columns (a lane each) by kColWarps segments (a warp
// each); the forward values in a (3 + C, kColWarps * m, 32 * gridDim.x)
// device scratch: a', c', d'[C] and the side of ones.
template <int C>
__global__ void __launch_bounds__(kColWarps * 32)
fgs_cols_kernel(const float* __restrict__ f, const float* __restrict__ wp,
                const float* __restrict__ wn, float* scratch,
                float* __restrict__ u, int H, int W, int m, float lam) {
  __shared__ float buf[2][4 + C][kColWarps][32];
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  const int x = blockIdx.x * 32 + lane;
  const bool in = x < W;   // lanes past W solve identity rows
  const size_t Wp = (size_t)gridDim.x * 32;
  const size_t sp = (size_t)kColWarps * m * Wp;   // a scratch plane
  const size_t hw = (size_t)H * W;
  float* s_ap = scratch;
  float* s_cp = scratch + sp;
  float* s_dp = scratch + 2 * sp;                 // C + 1 planes
  const int i0 = seg * m;

  // Each pass loads kChunk rows at once before it walks them: the walk is
  // a dependent chain, and a load a step would put a device-memory (or L2)
  // latency on every step of it.
  const float neg_lam = -lam;
  float ap = 0.f, cp = 0.f, dp[C + 1];
#pragma unroll
  for (int k = 0; k <= C; ++k) dp[k] = 0.f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    float cw[kChunk][2 + C];   // wp, wn, f[C] of rows j0 ..
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int i = i0 + j0 + t;
      const bool real = in && j0 + t < m && i < H;
      const size_t g = (size_t)i * W + x;
      cw[t][0] = real ? wp[g] : 0.f;
      cw[t][1] = real ? wn[g] : 0.f;
#pragma unroll
      for (int k = 0; k < C; ++k) cw[t][2 + k] = real ? f[k * hw + g] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int j = j0 + t;
      if (j >= m) break;
      float fj[C];
#pragma unroll
      for (int k = 0; k < C; ++k) fj[k] = cw[t][2 + k];
      forward_step<C>(j, neg_lam, cw[t][0], cw[t][1], fj, ap, cp, dp);
      const size_t q = (size_t)(i0 + j) * Wp + x;
      s_ap[q] = ap;
      s_cp[q] = cp;
#pragma unroll
      for (int k = 0; k <= C; ++k) s_dp[k * sp + q] = dp[k];
    }
  }

  // rows m - 3 .. 1 (backward) and m - 2 .. 1 (back substitution) of the
  // scratch, kChunk at a time from row `top` down
  float cr[kChunk][3 + C];   // a', c', d'[C + 1]
  auto load_down = [&](int top) {
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (top - t < 1) break;
      const size_t q = (size_t)(i0 + top - t) * Wp + x;
      cr[t][0] = s_ap[q];
      cr[t][1] = s_cp[q];
#pragma unroll
      for (int k = 0; k <= C; ++k) cr[t][2 + k] = s_dp[k * sp + q];
    }
  };

  const size_t q0 = (size_t)i0 * Wp + x;
  float A = s_ap[q0], B = s_cp[q0], D[C + 1];
#pragma unroll
  for (int k = 0; k <= C; ++k) D[k] = s_dp[k * sp + q0];
  if (m > 2) {
    const size_t qm = (size_t)(i0 + m - 2) * Wp + x;
    float app = s_ap[qm], cpp = s_cp[qm], dpp[C + 1];
#pragma unroll
    for (int k = 0; k <= C; ++k) dpp[k] = s_dp[k * sp + qm];
    for (int top = m - 3; top >= 1; top -= kChunk) {
      load_down(top);
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (top - t < 1) break;
        float dpj[C + 1];
#pragma unroll
        for (int k = 0; k <= C; ++k) dpj[k] = cr[t][2 + k];
        backward_step(cr[t][0], cr[t][1], dpj, app, cpp, dpp);
      }
    }
    first_row<C>(app, cpp, dpp, A, B, D);
  }

  SmemExchange<4 + C> exchange{buf, seg, lane, 0};
  float xs[C], xe[C];
  reduced_solve<C, kColWarps>(exchange, seg, A, B, D, ap, cp, dp, xs, xe);

  auto put = [&](int j, const float (&v)[C]) {
    const int i = i0 + j;
    if (in && i < H) {
#pragma unroll
      for (int k = 0; k < C; ++k) u[k * hw + (size_t)i * W + x] = v[k];
    }
  };
  put(0, xs);
  put(m - 1, xe);
  float xv[C];
#pragma unroll
  for (int k = 0; k < C; ++k) xv[k] = xe[k];
  for (int top = m - 2; top >= 1; top -= kChunk) {
    load_down(top);
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (top - t < 1) break;
#pragma unroll
      for (int k = 0; k < C; ++k)
        xv[k] = __fsub_rn(__fsub_rn(cr[t][2 + k], __fmul_rn(cr[t][0], xs[k])),
                          __fmul_rn(cr[t][1], xv[k]));
      put(top - t, xv);
    }
  }
}

template <int C>
int launch(const float* f, const float* wp, const float* wn, float* scratch,
           float* u, int H, int W, int axis, float lam, cudaStream_t stream) {
  if (axis == 1) {
    const int m = segment_len(W, kRowSegments);
    const size_t warp_bytes =
        (size_t)(3 + C) * kRowSegments * (m | 1) * sizeof(float);
    const int rows = 2 * warp_bytes <= (size_t)kSmemMax ? 2 : 1;
    if (warp_bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    // the attribute belongs to the current device: set it at every launch
    const cudaError_t err = cudaFuncSetAttribute(
        fgs_rows_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(rows * warp_bytes));
    if (err != cudaSuccess) return (int)err;
    fgs_rows_kernel<C><<<(H + rows - 1) / rows, rows * 32, rows * warp_bytes,
                         stream>>>(f, wp, wn, u, H, W, m, lam);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int m = segment_len(H, kColWarps);
    fgs_cols_kernel<C><<<(W + 31) / 32, kColWarps * 32, 0, stream>>>(
        f, wp, wn, scratch, u, H, W, m, lam);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f, u: (C, H, W) float32, C = 1 or 2; wp, wn: (H, W) float32. axis = 1
// solves the rows, axis = 0 the columns; scratch is the column solve's
// (3 + C, 16 * max(2, ceil(H / 16)), 32 * ceil(W / 32)) float32 scratch
// (null for the rows).
extern "C" int smt_fgs_solve(const float* f, const float* wp, const float* wn,
                             float* scratch, float* u, int C, int H, int W,
                             int axis, float lam, void* stream) {
  if (H < 1 || W < 1 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1>(f, wp, wn, scratch, u, H, W, axis, lam, st);
    case 2: return launch<2>(f, wp, wn, scratch, u, H, W, axis, lam, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
