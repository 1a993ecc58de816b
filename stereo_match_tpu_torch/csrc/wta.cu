// K4 wta_lr: winner-take-all, subpixel, uniqueness and the disp12 check.
//
// Replaces, in stereo_match_tpu/ops/pallas_kernels.py, the statistics half
// of sgm_scan3_stats_pallas (_wta_stats_rows: best, first argmin, c(idx-1),
// c(idx+1), best outside idx +- 1, and the right-view argmin) and all of
// lr_mask_pallas (_lr_mask_kernel). With the elementwise tail of
// ops/wta.py::extract_disparity_fast it gives that function's output:
//   disp  = idx + clip((c0 - c2) / (2 max(c0 - 2 best + c2, 1e-9)), +-0.5)
//           (offset 0 at the D-range edges or when the denominator <= 1e-9),
//           + min_d;
//   valid = second * 100 > best * (100 + ratio)            (ratio > 0)
//         & |disp - dR(rint(x - disp))| <= tol, rint(x - disp) in frame
//                                                          (tol >= 0),
// where dR(xr) = min_d + argmin over in-frame d of C(d, y, xr + d), ties to
// the smallest d. rintf rounds half to even, as jnp.round does (roundf
// would round half away from zero).
//
// Bound on the H100: device-memory reads of the aggregated volume (238 MB
// at KITTI D=128, read three times: argmin, neighbour statistics, right
// view; the second and third passes partly hit L2). Design: one block per
// image row; threads run along x, so every d-plane read is a coalesced row
// segment; the row's left disparities, uniqueness flags and right-view
// disparities are kept in shared memory, so the disp12 check's sampling at
// x - disp needs no gather from device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 3e9f;

__global__ void wta_lr_kernel(const float* __restrict__ tot,
                              float* __restrict__ disp,
                              float* __restrict__ disp_right, int D, int H,
                              int W, int min_d, int uniqueness_ratio,
                              int disp12_max_diff, int subpixel) {
  extern __shared__ float smem[];
  float* s_left = smem;                       // [W] disparity before masking
  float* s_right = smem + W;                  // [W] right-view disparity
  unsigned char* s_unique = (unsigned char*)(smem + 2 * W);  // [W]
  const int y = blockIdx.x;
  const size_t plane = (size_t)H * W;
  const float* row = tot + (size_t)y * W;

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    float best = row[x];
    int idx = 0;
    for (int d = 1; d < D; ++d) {
      const float v = row[d * plane + x];
      if (v < best) {
        best = v;
        idx = d;
      }
    }
    const float c0 = idx > 0 ? row[(idx - 1) * plane + x] : kBig;
    const float c2 = idx < D - 1 ? row[(idx + 1) * plane + x] : kBig;
    float second = kBig;
    for (int d = 0; d < D; ++d)
      if (d < idx - 1 || d > idx + 1)
        second = fminf(second, row[d * plane + x]);

    float dv = (float)idx;
    if (subpixel && idx > 0 && idx < D - 1) {
      const float denom = c0 - 2.0f * best + c2;
      float offset = 0.f;
      if (denom > 1e-9f) offset = (c0 - c2) / (2.0f * fmaxf(denom, 1e-9f));
      dv = dv + fminf(fmaxf(offset, -0.5f), 0.5f);
    }
    s_left[x] = dv + (float)min_d;
    s_unique[x] = uniqueness_ratio <= 0 ||
                  second * 100.0f > best * (100.0f + (float)uniqueness_ratio);
  }

  for (int xr = threadIdx.x; xr < W; xr += blockDim.x) {
    float best = row[xr];
    int idx = 0;
    const int d_end = min(D, W - xr);
    for (int d = 1; d < d_end; ++d) {
      const float v = row[d * plane + xr + d];
      if (v < best) {
        best = v;
        idx = d;
      }
    }
    const float r = (float)(idx + min_d);
    s_right[xr] = r;
    disp_right[(size_t)y * W + xr] = r;
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float dl = s_left[x];
    bool ok = s_unique[x];
    if (disp12_max_diff >= 0) {
      const float xr = rintf((float)x - dl);
      const bool inframe = xr >= 0.f && xr < (float)W;   // NaN -> false
      const float dr = s_right[inframe ? (int)xr : 0];
      ok = ok && inframe && fabsf(dl - dr) <= (float)disp12_max_diff;
    }
    disp[(size_t)y * W + x] = ok ? dl : __int_as_float(0x7fc00000);
  }
}

}  // namespace

// tot: (D, H, W) float32; disp: (H, W) float32, NaN where invalid;
// disp_right: (H, W) float32.
extern "C" int smt_wta_lr(const float* tot, float* disp, float* disp_right,
                          int D, int H, int W, int min_d,
                          int uniqueness_ratio, int disp12_max_diff,
                          int subpixel, void* stream) {
  const size_t smem = 2 * (size_t)W * sizeof(float) + (size_t)W;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wta_lr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  wta_lr_kernel<<<H, 256, smem, (cudaStream_t)stream>>>(
      tot, disp, disp_right, D, H, W, min_d, uniqueness_ratio,
      disp12_max_diff, subpixel);
  return (int)cudaGetLastError();
}
