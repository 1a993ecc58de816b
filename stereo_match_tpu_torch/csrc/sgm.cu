// K3 sgm_path_scan: one SGM path direction, added into the running total.
//
// Replaces, in stereo_match_tpu/ops/pallas_kernels.py, the scans of
// sgm_census_hpair_pallas (directions (0, +1), (0, -1)), sgm_scan3_pallas
// (S, SE, SW, with its init_carry / return_carry and int16 storage),
// sgm_scan_pallas (any one direction, with the same carry and int16
// features) and the scan half of sgm_scan3_stats_pallas (N, NE, NW): one
// kernel parameterised by the direction (dy, dx), launched once per path.
// The recurrence is ops/sgm.py's, operation for operation:
//   m    = min(min(L[d], pmin + P2), min(L[d-1], L[d+1]) + P1)
//   L'   = (C + m) - pmin,   L[-1] = L[D] = big,   pmin = min_k L[k]
// with a zero carry where a path enters the frame, which is what the
// reference's shear (out-of-frame cells: cost 0, carry 0) gives. The
// horizontal directions read the (D, H, W) volume that K2 wrote, whose x < d
// cells hold 1e4 as the census-fused TPU scan's rebuilt rows do, so the
// totals equal sgm_census_hpair_pallas + scan3 bit for bit on census costs.
//
// Storage: float32 volumes compute in float (big = 1e9). int16 volumes (the
// census volume with INVALID 1024) compute in int32 with P1 and P2 truncated
// to integers and big = 30000, as the XLA int16 path does (ops/sgm.py casts
// P1, P2 to int16); the config bounds num_paths * (1024 + P2) < 2^15, so
// every value and total is exact. (The TPU kernels widened int16 to f32 and
// kept a fractional P1 inside an 8/16-row block; the port follows XLA.)
//
// Carries, for row-sharded scans (parallel/tiling.py): the carry is the
// (D, W) L of the scan-order-last row, unshifted, as the TPU scan3 slab is.
// With init_carry, a line that starts on the volume's first row (in scan
// order) at column x starts from init_carry[:, x - dx], zero where x - dx
// leaves the frame; diagonal lines that start on a side edge start from
// zero. carry_out receives L of the last row. Horizontal lines take none.
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

constexpr int kMaxWarps = 32;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using V = float;
  static __device__ V big() { return 1e9f; }
  static __device__ V vmin(V a, V b) { return fminf(a, b); }
};

template <>
struct Arith<short> {
  using V = int;
  static __device__ V big() { return 30000; }
  static __device__ V vmin(V a, V b) { return min(a, b); }
};

template <typename T>
__global__ void sgm_path_scan_kernel(const T* __restrict__ cost,
                                     T* __restrict__ total,
                                     const T* __restrict__ init_carry,
                                     T* __restrict__ carry_out, int D, int H,
                                     int W, int dy, int dx,
                                     typename Arith<T>::V p1,
                                     typename Arith<T>::V p2,
                                     int accumulate) {
  using A = Arith<T>;
  using V = typename A::V;
  extern __shared__ unsigned char smem_raw[];
  V* carry = reinterpret_cast<V*>(smem_raw);  // [2][D]
  __shared__ V warp_min[2][kMaxWarps];
  const int d = threadIdx.x;
  const bool active = d < D;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int n_warps = blockDim.x >> 5;
  const V big = A::big();

  // Start of this block's path line on the frame edge.
  const int b = blockIdx.x;
  int y, x;
  bool first_row;
  if (dy == 0) {
    y = b;
    x = dx > 0 ? 0 : W - 1;
    first_row = false;
  } else if (b < W) {
    y = dy > 0 ? 0 : H - 1;
    x = b;
    first_row = true;
  } else {                                    // diagonal, side edge
    const int k = b - W + 1;
    y = dy > 0 ? k : H - 1 - k;
    x = dx > 0 ? 0 : W - 1;
    first_row = false;
  }
  const int last_y = dy > 0 ? H - 1 : 0;

  // The incoming state: zero, or the previous shard's carry at x - dx.
  V L = 0;
  if (active && first_row && init_carry != nullptr) {
    const int xs = x - dx;
    if (xs >= 0 && xs < W) L = (V)init_carry[(size_t)d * W + xs];
  }
  if (active) carry[d] = L;
  V wmin = active ? L : big;
  for (int o = 16; o > 0; o >>= 1)
    wmin = A::vmin(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
  if (lane == 0) warp_min[0][warp] = wmin;

  const size_t plane = (size_t)H * W;
  const size_t dplane = (size_t)(active ? d : 0) * plane;
  int cur = 0;
  size_t off = dplane + (size_t)y * W + x;
  V c = active ? (V)cost[off] : 0;
  V t = (active && accumulate) ? (V)total[off] : 0;
  __syncthreads();
  V pmin = warp_min[0][0];
  for (int w = 1; w < n_warps; ++w) pmin = A::vmin(pmin, warp_min[0][w]);

  while (true) {
    const int ny = y + dy;
    const int nx = x + dx;
    const bool more = ny >= 0 && ny < H && nx >= 0 && nx < W;
    const size_t noff = dplane + (size_t)(more ? ny : y) * W + (more ? nx : x);
    V c_next = 0;
    V t_next = 0;
    if (active && more) {
      c_next = (V)cost[noff];
      if (accumulate) t_next = (V)total[noff];
    }

    V Lnew = big;
    if (active) {
      const V* prev = carry + cur * D;
      const V up = d > 0 ? prev[d - 1] : big;
      const V down = d < D - 1 ? prev[d + 1] : big;
      const V m = A::vmin(A::vmin(L, pmin + p2), A::vmin(up, down) + p1);
      Lnew = (c + m) - pmin;
      total[off] = (T)(accumulate ? t + Lnew : Lnew);
      carry[(cur ^ 1) * D + d] = Lnew;
    }
    V wm = Lnew;
    for (int o = 16; o > 0; o >>= 1)
      wm = A::vmin(wm, __shfl_xor_sync(0xffffffffu, wm, o));
    if (lane == 0) warp_min[cur ^ 1][warp] = wm;
    __syncthreads();
    L = Lnew;
    if (!more) break;

    V mm = warp_min[cur ^ 1][0];
    for (int w = 1; w < n_warps; ++w) mm = A::vmin(mm, warp_min[cur ^ 1][w]);
    pmin = mm;
    cur ^= 1;
    y = ny;
    x = nx;
    off = noff;
    c = c_next;
    t = t_next;
  }
  if (active && carry_out != nullptr && dy != 0 && y == last_y)
    carry_out[(size_t)d * W + x] = (T)L;
}

template <typename T>
int launch(const void* cost, void* total, const void* init_carry,
           void* carry_out, int D, int H, int W, int dy, int dx,
           typename Arith<T>::V p1, typename Arith<T>::V p2, int accumulate,
           cudaStream_t stream) {
  const int threads = (D + 31) / 32 * 32;
  int lines;
  if (dy == 0) lines = H;
  else if (dx == 0) lines = W;
  else lines = W + H - 1;
  const size_t smem = 2 * (size_t)D * sizeof(typename Arith<T>::V);
  sgm_path_scan_kernel<T><<<lines, threads, smem, stream>>>(
      static_cast<const T*>(cost), static_cast<T*>(total),
      static_cast<const T*>(init_carry), static_cast<T*>(carry_out), D, H, W,
      dy, dx, p1, p2, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// cost, total: (D, H, W), float32 (i16 = 0) or int16 (i16 = 1). One launch
// aggregates direction (dy, dx), dy, dx in {-1, 0, 1}, not both 0;
// accumulate = 0 writes total = L. init_carry and carry_out are (D, W) of
// the same type, or null; only for dy != 0. For int16, p1 and p2 must be
// integers (the wrapper truncates them).
extern "C" int smt_sgm_path_scan(const void* cost, void* total,
                                 const void* init_carry, void* carry_out,
                                 int D, int H, int W, int dy, int dx,
                                 float p1, float p2, int accumulate, int i16,
                                 void* stream) {
  if (D < 1 || D > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  if (i16)
    return launch<short>(cost, total, init_carry, carry_out, D, H, W, dy, dx,
                         (int)p1, (int)p2, accumulate, (cudaStream_t)stream);
  return launch<float>(cost, total, init_carry, carry_out, D, H, W, dy, dx,
                       p1, p2, accumulate, (cudaStream_t)stream);
}
