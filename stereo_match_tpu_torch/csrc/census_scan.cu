// K10 sgm_census_scan: one horizontal SGM scan whose costs are rebuilt from
// the census words of both views, added into (or written to) the total.
//
// Replaces stereo_match_tpu/ops/pallas_kernels.py::sgm_census_scan_pallas
// (_census_scan_padded, _sgm_scan_census_kernel), the pass the streaming
// pipeline's census-payload stages 0 and 1 run. For dx = +1 (left to
// right) or -1 the scan visits every x of row y with
//   C(i, y, x) = popc(cl[y, x] ^ cr[y, x - min_d - i]),   x >= min_d + i
//              = invalid_cost                          otherwise
// (1e4, or 1024 for the int16 wire), then K3's recurrence in K3's float
// operation order, so at invalid_cost = 1e4 the totals equal K2's volume
// scanned by K3 along (0, +-1) bit for bit.
//
// Bound on the H100: latency of the sequential walk, like K3's horizontal
// directions, without the volume read. Design: one block per image row,
// one thread per disparity; the row's census words of both views are
// staged in shared memory (2 x 5 KB at KITTI), so a step reads its costs'
// words from shared memory and the only device-memory traffic is the total
// (read-modify-write, or write). The TPU kernel's ring of right-view rows,
// its anti-identity reversal matmul and the <= 24-bit word gate that matmul
// needed are Mosaic mechanics and have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxWarps = 32;

__global__ void census_scan_kernel(const int* __restrict__ cl,
                                   const int* __restrict__ cr,
                                   float* __restrict__ total, int D, int H,
                                   int W, int min_d, float p1, float p2,
                                   float invalid, int dx, int accumulate) {
  extern __shared__ unsigned char smem_raw[];
  float* carry = reinterpret_cast<float*>(smem_raw);   // [2][D]
  int* row_l = reinterpret_cast<int*>(carry + 2 * D);  // [W]
  int* row_r = row_l + W;                              // [W]
  __shared__ float warp_min[2][kMaxWarps];
  const int d = threadIdx.x;
  const bool active = d < D;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int n_warps = blockDim.x >> 5;
  const int y = blockIdx.x;

  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    row_l[i] = cl[(size_t)y * W + i];
    row_r[i] = cr[(size_t)y * W + i];
  }
  if (active) carry[d] = 0.f;
  const int shift = min_d + (active ? d : 0);
  const size_t dplane = (size_t)(active ? d : 0) * H * W + (size_t)y * W;
  int x = dx > 0 ? 0 : W - 1;
  float L = 0.f;
  float pmin = 0.f;
  int cur = 0;
  float t = (active && accumulate) ? total[dplane + x] : 0.f;
  __syncthreads();
  // The step's cost is built one step ahead, as K3 loads it, so the
  // shared-memory reads and the popcount stay off the post-barrier chain.
  float c = x >= shift
                ? (float)__popc((unsigned)(row_l[x] ^ row_r[x - shift]))
                : invalid;

  while (true) {
    const int nx = x + dx;
    const bool more = nx >= 0 && nx < W;
    float c_next = 0.f;
    float t_next = 0.f;
    if (active && more) {
      c_next = nx >= shift
                   ? (float)__popc((unsigned)(row_l[nx] ^ row_r[nx - shift]))
                   : invalid;
      if (accumulate) t_next = total[dplane + nx];
    }

    float Lnew = kBig;
    if (active) {
      const float* prev = carry + cur * D;
      const float up = d > 0 ? prev[d - 1] : kBig;
      const float down = d < D - 1 ? prev[d + 1] : kBig;
      const float m = fminf(fminf(L, pmin + p2), fminf(up, down) + p1);
      Lnew = (c + m) - pmin;
      total[dplane + x] = accumulate ? t + Lnew : Lnew;
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
    x = nx;
    c = c_next;
    t = t_next;
  }
}

}  // namespace

// cl, cr: (H, W) int32 single-word census of the left and right views;
// total: (D, H, W) float32. dx = +1 or -1; accumulate = 0 writes total = L.
extern "C" int smt_census_scan(const int* cl, const int* cr, float* total,
                               int D, int H, int W, int min_d, float p1,
                               float p2, float invalid, int dx,
                               int accumulate, void* stream) {
  if (D < 1 || D > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const int threads = (D + 31) / 32 * 32;
  const size_t smem =
      2 * (size_t)D * sizeof(float) + 2 * (size_t)W * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        census_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  census_scan_kernel<<<H, threads, smem, (cudaStream_t)stream>>>(
      cl, cr, total, D, H, W, min_d, p1, p2, invalid, dx, accumulate);
  return (int)cudaGetLastError();
}
