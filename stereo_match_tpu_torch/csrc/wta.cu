// K4 wta_lr: winner-take-all, subpixel, uniqueness and the disp12 check;
// with three stand-alone entries, wta_stats and right_wta over a finished
// volume and lr_mask over finished disparity maps.
//
// Replaces, in stereo_match_tpu/ops/pallas_kernels.py, the statistics half
// of sgm_scan3_stats_pallas (_wta_stats_rows: best, first argmin, c(idx-1),
// c(idx+1), best outside idx +- 1, and the right-view argmin), all of
// lr_mask_pallas (_lr_mask_kernel: fused into wta_lr on the main path, and
// the lr_mask entry), wta_stats_pallas (_wta_stats_kernel: the five
// statistics, as the wta_stats entry) and right_wta_pallas
// (_right_wta_kernel: the right-view argmin, as the right_wta entry). With
// the elementwise tail of ops/wta.py::disparity_from_stats the three entries
// give ops/cuda_kernels.py::extract_disparity_fast's output:
//   disp  = idx + clip((c0 - c2) / (2 max(c0 - 2 best + c2, 1e-9)), +-0.5)
//           (offset 0 at the D-range edges or when the denominator <= 1e-9),
//           + min_d;
//   valid = second * 100 > best * (100 + ratio)            (ratio > 0)
//         & |disp - dR(rint(x - disp))| <= tol, rint(x - disp) in frame
//                                                          (tol >= 0),
// where dR(xr) = min_d + argmin over in-frame d of C(d, y, xr + d), ties to
// the smallest d. rintf rounds half to even, as jnp.round does (roundf
// would round half away from zero). The volume is float32 or int16; int16
// costs are widened to float, which is exact for them (|C| < 2^15), so the
// uniqueness products equal the int32 ones of the XLA int16 path. c0, c2
// and second are 3e9 where no such d exists, as in _wta_stats_rows.
//
// Bound on the H100: device-memory reads of the aggregated volume (238 MB
// at KITTI D=128, read three times: argmin, neighbour statistics, right
// view; the second and third passes partly hit L2). Design: one block per
// image row; threads run along x, so every d-plane read is a coalesced row
// segment; the row's left disparities, uniqueness flags and right-view
// disparities are kept in shared memory, so the disp12 check's sampling at
// x - disp needs no gather from device memory. lr_mask stages the row of
// the right-view map in shared memory the same way.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 3e9f;
constexpr int kThreads = 256;

// Best cost, its first index, the costs at idx -+ 1 and the best cost
// outside idx +- 1 of pixel x of a row (plane stride `plane`).
template <typename T>
__device__ void pixel_stats(const T* __restrict__ row, size_t plane, int D,
                            int x, float& best, int& idx, float& c0,
                            float& c2, float& second) {
  best = (float)row[x];
  idx = 0;
  for (int d = 1; d < D; ++d) {
    const float v = (float)row[d * plane + x];
    if (v < best) {
      best = v;
      idx = d;
    }
  }
  c0 = idx > 0 ? (float)row[(idx - 1) * plane + x] : kBig;
  c2 = idx < D - 1 ? (float)row[(idx + 1) * plane + x] : kBig;
  second = kBig;
  for (int d = 0; d < D; ++d)
    if (d < idx - 1 || d > idx + 1)
      second = fminf(second, (float)row[d * plane + x]);
}

// argmin over in-frame d of C(d, y, xr + d), ties to the smallest d.
template <typename T>
__device__ int right_argmin(const T* __restrict__ row, size_t plane, int D,
                            int W, int xr) {
  float best = (float)row[xr];
  int idx = 0;
  const int d_end = min(D, W - xr);
  for (int d = 1; d < d_end; ++d) {
    const float v = (float)row[d * plane + xr + d];
    if (v < best) {
      best = v;
      idx = d;
    }
  }
  return idx;
}

// The disp12 check of pixel x: rint(x - dl) in frame and
// |dl - s_right[rint(x - dl)]| <= tol (NaN dl -> false). The tolerance is a
// float, as lr_mask_pallas takes it (ELAS's lr_tol); wta_lr passes its
// integer disp12_max_diff.
__device__ bool disp12_ok(float dl, const float* s_right, int x, int W,
                          float tol) {
  const float xr = rintf((float)x - dl);
  const bool inframe = xr >= 0.f && xr < (float)W;   // NaN -> false
  const float dr = s_right[inframe ? (int)xr : 0];
  return inframe && fabsf(dl - dr) <= tol;
}

template <typename T>
__global__ void wta_lr_kernel(const T* __restrict__ tot,
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
  const T* row = tot + (size_t)y * W;

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    float best, c0, c2, second;
    int idx;
    pixel_stats(row, plane, D, x, best, idx, c0, c2, second);
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
    const float r = (float)(right_argmin(row, plane, D, W, xr) + min_d);
    s_right[xr] = r;
    disp_right[(size_t)y * W + xr] = r;
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float dl = s_left[x];
    const bool ok = s_unique[x] && (disp12_max_diff < 0 ||
                                     disp12_ok(dl, s_right, x, W,
                                               (float)disp12_max_diff));
    disp[(size_t)y * W + x] = ok ? dl : __int_as_float(0x7fc00000);
  }
}

template <typename T>
__global__ void wta_stats_kernel(const T* __restrict__ tot,
                                 float* __restrict__ best_out,
                                 int* __restrict__ idx_out,
                                 float* __restrict__ c0_out,
                                 float* __restrict__ c2_out,
                                 float* __restrict__ second_out, int D,
                                 int H, int W) {
  const int y = blockIdx.x;
  const size_t plane = (size_t)H * W;
  const T* row = tot + (size_t)y * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    float best, c0, c2, second;
    int idx;
    pixel_stats(row, plane, D, x, best, idx, c0, c2, second);
    const size_t at = (size_t)y * W + x;
    best_out[at] = best;
    idx_out[at] = idx;
    c0_out[at] = c0;
    c2_out[at] = c2;
    second_out[at] = second;
  }
}

template <typename T>
__global__ void right_wta_kernel(const T* __restrict__ tot,
                                 int* __restrict__ ridx, int D, int H,
                                 int W) {
  const int y = blockIdx.x;
  const size_t plane = (size_t)H * W;
  const T* row = tot + (size_t)y * W;
  for (int xr = threadIdx.x; xr < W; xr += blockDim.x)
    ridx[(size_t)y * W + xr] = right_argmin(row, plane, D, W, xr);
}

__global__ void lr_mask_kernel(const float* __restrict__ disp,
                               const float* __restrict__ disp_right,
                               bool* __restrict__ mask, int W, float tol) {
  extern __shared__ float s_right[];           // [W] the row of disp_right
  const size_t at = (size_t)blockIdx.x * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x)
    s_right[x] = disp_right[at + x];
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x)
    mask[at + x] = tol < 0.f || disp12_ok(disp[at + x], s_right, x, W, tol);
}

// Raise the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_wta_lr(const void* tot, float* disp, float* disp_right, int D,
                  int H, int W, int min_d, int uniqueness_ratio,
                  int disp12_max_diff, int subpixel, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)W * sizeof(float) + (size_t)W;
  const cudaError_t err = allow_smem(wta_lr_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  wta_lr_kernel<T><<<H, kThreads, smem, stream>>>(
      static_cast<const T*>(tot), disp, disp_right, D, H, W, min_d,
      uniqueness_ratio, disp12_max_diff, subpixel);
  return (int)cudaGetLastError();
}

}  // namespace

// tot: (D, H, W), float32 (i16 = 0) or int16 (i16 = 1); disp: (H, W)
// float32, NaN where invalid; disp_right: (H, W) float32.
extern "C" int smt_wta_lr(const void* tot, float* disp, float* disp_right,
                          int D, int H, int W, int min_d,
                          int uniqueness_ratio, int disp12_max_diff,
                          int subpixel, int i16, void* stream) {
  if (i16)
    return launch_wta_lr<short>(tot, disp, disp_right, D, H, W, min_d,
                                uniqueness_ratio, disp12_max_diff, subpixel,
                                (cudaStream_t)stream);
  return launch_wta_lr<float>(tot, disp, disp_right, D, H, W, min_d,
                              uniqueness_ratio, disp12_max_diff, subpixel,
                              (cudaStream_t)stream);
}

// tot: (D, H, W) float32 or int16; best, c0, c2, second: (H, W) float32;
// idx: (H, W) int32.
extern "C" int smt_wta_stats(const void* tot, float* best, int* idx,
                             float* c0, float* c2, float* second, int D,
                             int H, int W, int i16, void* stream) {
  if (i16)
    wta_stats_kernel<short><<<H, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const short*>(tot), best, idx, c0, c2, second, D, H, W);
  else
    wta_stats_kernel<float><<<H, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(tot), best, idx, c0, c2, second, D, H, W);
  return (int)cudaGetLastError();
}

// tot: (D, H, W) float32 or int16; ridx: (H, W) int32 right-view argmin
// (without min_d).
extern "C" int smt_right_wta(const void* tot, int* ridx, int D, int H, int W,
                             int i16, void* stream) {
  if (i16)
    right_wta_kernel<short><<<H, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const short*>(tot), ridx, D, H, W);
  else
    right_wta_kernel<float><<<H, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(tot), ridx, D, H, W);
  return (int)cudaGetLastError();
}

// disp, disp_right: (H, W) float32 (the left map before the check, NaN
// allowed; the right-view map); mask: (H, W) bool, the disp12 check at the
// float tolerance tol (all true for tol < 0).
extern "C" int smt_lr_mask(const float* disp, const float* disp_right,
                           bool* mask, int H, int W, float tol,
                           void* stream) {
  const size_t smem = (size_t)W * sizeof(float);
  const cudaError_t err = allow_smem(lr_mask_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lr_mask_kernel<<<H, kThreads, smem, (cudaStream_t)stream>>>(
      disp, disp_right, mask, W, tol);
  return (int)cudaGetLastError();
}
