// K3 sgm_path_scan: one SGM path direction, added into the running total.
//
// Replaces, in stereo_match_tpu/ops/pallas_kernels.py, the scans of
// sgm_census_hpair_pallas (directions (0, +1), (0, -1)), sgm_scan3_pallas
// (S, SE, SW) and the scan half of sgm_scan3_stats_pallas (N, NE, NW): one
// kernel parameterised by the direction (dy, dx), launched once per path.
// The recurrence is ops/sgm.py's, operation for operation:
//   m    = min(min(L[d], pmin + P2), min(L[d-1], L[d+1]) + P1)
//   L'   = (C + m) - pmin,   L[-1] = L[D] = 1e9,   pmin = min_k L[k]
// with a zero carry where a path enters the frame, which is what the
// reference's shear (out-of-frame cells: cost 0, carry 0) gives. The
// horizontal directions read the (D, H, W) volume that K2 wrote, whose x < d
// cells hold 1e4 as the census-fused TPU scan's rebuilt rows do, so the
// totals equal sgm_census_hpair_pallas + scan3 bit for bit on census costs.
//
// Bound on the H100: latency of the sequential walk. Each block walks one
// path line; a step is one cost load, one total read-modify-write, a
// shared-memory exchange of the d +- 1 neighbours and a block-wide min,
// separated by one __syncthreads. The (D, H, W) layout makes the per-step
// loads strided across d (one 32 B sector per thread); consecutive steps of
// horizontal lines and neighbouring vertical lines share sectors in L1/L2.
// Design: one thread per disparity; the next step's cost and total are
// loaded before the current step's barrier so their latency overlaps it;
// the carry and the warp minima are double-buffered in shared memory so
// one barrier per step suffices. Each (d, y, x) is visited once per
// direction, so the update needs no atomics; the first launch of a frame
// writes `total` instead of adding to it (ops/sgm.py sums 0 + L first).

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxWarps = 32;

__global__ void sgm_path_scan_kernel(const float* __restrict__ cost,
                                     float* __restrict__ total, int D, int H,
                                     int W, int dy, int dx, float p1,
                                     float p2, int accumulate) {
  extern __shared__ float carry[];            // [2][D]
  __shared__ float warp_min[2][kMaxWarps];
  const int d = threadIdx.x;
  const bool active = d < D;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int n_warps = blockDim.x >> 5;

  // Start of this block's path line on the frame edge.
  const int b = blockIdx.x;
  int y, x;
  if (dy == 0) {
    y = b;
    x = dx > 0 ? 0 : W - 1;
  } else if (b < W) {
    y = dy > 0 ? 0 : H - 1;
    x = b;
  } else {                                    // diagonal, side edge
    const int k = b - W + 1;
    y = dy > 0 ? k : H - 1 - k;
    x = dx > 0 ? 0 : W - 1;
  }

  const size_t plane = (size_t)H * W;
  const size_t dplane = (size_t)(active ? d : 0) * plane;
  if (active) carry[d] = 0.f;
  float L = 0.f;
  float pmin = 0.f;
  int cur = 0;
  size_t off = dplane + (size_t)y * W + x;
  float c = active ? cost[off] : 0.f;
  float t = (active && accumulate) ? total[off] : 0.f;
  __syncthreads();

  while (true) {
    const int ny = y + dy;
    const int nx = x + dx;
    const bool more = ny >= 0 && ny < H && nx >= 0 && nx < W;
    const size_t noff = dplane + (size_t)(more ? ny : y) * W + (more ? nx : x);
    float c_next = 0.f;
    float t_next = 0.f;
    if (active && more) {
      c_next = cost[noff];
      if (accumulate) t_next = total[noff];
    }

    float Lnew = kBig;
    if (active) {
      const float* prev = carry + cur * D;
      const float up = d > 0 ? prev[d - 1] : kBig;
      const float down = d < D - 1 ? prev[d + 1] : kBig;
      const float m = fminf(fminf(L, pmin + p2), fminf(up, down) + p1);
      Lnew = (c + m) - pmin;
      total[off] = accumulate ? t + Lnew : Lnew;
      carry[(cur ^ 1) * D + d] = Lnew;
    }
    float wmin = Lnew;
    for (int o = 16; o > 0; o >>= 1)
      wmin = fminf(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
    if (lane == 0) warp_min[cur ^ 1][warp] = wmin;
    __syncthreads();
    if (!more) break;

    float mm = warp_min[cur ^ 1][0];
    for (int w = 1; w < n_warps; ++w) mm = fminf(mm, warp_min[cur ^ 1][w]);
    pmin = mm;
    L = Lnew;
    cur ^= 1;
    y = ny;
    x = nx;
    off = noff;
    c = c_next;
    t = t_next;
  }
}

}  // namespace

// cost, total: (D, H, W) float32. One launch aggregates direction (dy, dx),
// dy, dx in {-1, 0, 1}, not both 0; accumulate = 0 writes total = L.
extern "C" int smt_sgm_path_scan(const float* cost, float* total, int D,
                                 int H, int W, int dy, int dx, float p1,
                                 float p2, int accumulate, void* stream) {
  if (D < 1 || D > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const int threads = (D + 31) / 32 * 32;
  int lines;
  if (dy == 0) lines = H;
  else if (dx == 0) lines = W;
  else lines = W + H - 1;
  const size_t smem = 2 * (size_t)D * sizeof(float);
  sgm_path_scan_kernel<<<lines, threads, smem, (cudaStream_t)stream>>>(
      cost, total, D, H, W, dy, dx, p1, p2, accumulate);
  return (int)cudaGetLastError();
}
