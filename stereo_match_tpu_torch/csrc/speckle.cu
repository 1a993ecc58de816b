// K5 speckle_sweep and K6 speckle_count_keep: the speckle filter.
//
// Replace, in stereo_match_tpu/ops/pallas_speckle.py, speckle_filter_pallas
// (_labels_kernel, _dist_kernel, _deliver_kernel, _keep_kernel). What they
// port is the XLA path of stereo_match_tpu/ops/speckle.py, not the Mosaic
// mechanics: the BFS distances, spanning-tree parents and count delivery of
// the TPU kernels exist only because Mosaic has no scatter. Here the count
// is one pass of integer atomics.
//
// K5: one launch is half a sweep. With axis = 1 each thread owns one image
// row and runs the x-forward then the x-reverse segmented min scan over it,
// in place on the int32 label map; with axis = 0 each thread owns one
// column and runs the y-forward then the y-reverse scan. A scan step is
//   forward:  lab[i] = min(lab[i], lab[i-1])  if pixel i connects to i-1,
//   reverse:  lab[i] = min(lab[i], lab[i+1])  if pixel i+1 connects to i,
// walking i in scan order, so lab[i -+ 1] already holds the scan's running
// minimum: the inclusive segmented scan of the reference, step for step.
// Connectivity arrives packed (bit 0: connected to the left neighbour, bit
// 1: to the pixel above), built once per frame in torch glue. Labels only
// ever decrease, so "the sweep changed something" is "some step lowered a
// label": such a step sets *changed, which the host reads after the sweep.
//
// K6: the first kernel adds 1 per valid pixel (label < H*W) to
// count[label] with integer atomicAdd, whose result does not depend on the
// order; the lanes of a warp that hold the same label add their number
// once (__match_any_sync), since the pixels of a row mostly share one
// component and would otherwise queue on one address. The second kernel
// writes d where the pixel is valid and its component holds >= threshold
// pixels (or the sweeps did not converge), else NaN.
//
// Bound on the H100: latency of the sequential walk, not bandwidth. A row
// launch runs H lines (375 at KITTI) of W steps: a few warps on 132 SMs,
// each thread streaming its own row through L1; a column launch runs W
// lines of H steps, with neighbouring threads on neighbouring addresses.
// Each step loads the next pixel's label and connectivity before it
// resolves the current one, so one load is always in flight. K6 is two
// elementwise passes over the map.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // one warp per block: spread lines over SMs

__global__ void speckle_sweep_kernel(int* __restrict__ lab,
                                     const uint8_t* __restrict__ conn, int H,
                                     int W, int axis,
                                     int* __restrict__ changed) {
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  const int lines = axis == 1 ? H : W;
  if (line >= lines) return;
  const int n = axis == 1 ? W : H;
  const size_t step = axis == 1 ? 1 : (size_t)W;
  const size_t base = axis == 1 ? (size_t)line * W : (size_t)line;
  const uint8_t bit = axis == 1 ? 1 : 2;
  bool lowered = false;

  // Forward: pixel i joins the run of i - 1 when its own bit is set.
  int prev = lab[base];
  int cur = 0;
  uint8_t cur_c = 0;
  if (n > 1) {
    cur = lab[base + step];
    cur_c = conn[base + step];
  }
  for (int i = 1; i < n; ++i) {
    int next = 0;
    uint8_t next_c = 0;
    if (i + 1 < n) {
      next = lab[base + (size_t)(i + 1) * step];
      next_c = conn[base + (size_t)(i + 1) * step];
    }
    if ((cur_c & bit) && prev < cur) {
      cur = prev;
      lab[base + (size_t)i * step] = cur;
      lowered = true;
    }
    prev = cur;
    cur = next;
    cur_c = next_c;
  }

  // Reverse: pixel i joins the run of i + 1 when i + 1's bit is set.
  // prev holds the final label of pixel n - 1.
  uint8_t prev_c = conn[base + (size_t)(n - 1) * step];
  if (n > 1) {
    cur = lab[base + (size_t)(n - 2) * step];
    cur_c = conn[base + (size_t)(n - 2) * step];
  }
  for (int i = n - 2; i >= 0; --i) {
    int next = 0;
    uint8_t next_c = 0;
    if (i > 0) {
      next = lab[base + (size_t)(i - 1) * step];
      next_c = conn[base + (size_t)(i - 1) * step];
    }
    if ((prev_c & bit) && prev < cur) {
      cur = prev;
      lab[base + (size_t)i * step] = cur;
      lowered = true;
    }
    prev = cur;
    prev_c = cur_c;
    cur = next;
    cur_c = next_c;
  }
  if (lowered) atomicOr(changed, 1);
}

__global__ void speckle_count_kernel(const int* __restrict__ lab,
                                     int* __restrict__ count, int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = i < hw ? lab[i] : hw;         // hw: counts nowhere
  // The lanes of a warp that share a label add once, through the lowest
  // of them: a large component costs one atomic per warp, not per pixel.
  const unsigned peers = __match_any_sync(0xffffffffu, l);
  if (l < hw && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(count + l, __popc(peers));
}

__global__ void speckle_keep_kernel(const float* __restrict__ d,
                                    const int* __restrict__ lab,
                                    const int* __restrict__ count,
                                    float* __restrict__ out, int hw,
                                    int threshold, int unconverged) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int l = lab[i];
  const bool keep = l < hw && (unconverged || count[l] >= threshold);
  out[i] = keep ? d[i] : __int_as_float(0x7fc00000);   // torch's NaN
}

}  // namespace

// labels: (H, W) int32, updated in place; conn: (H, W) uint8 packed
// connectivity; changed: one int32 that is set to 1 when a label drops.
// axis = 1 scans the rows, axis = 0 the columns.
extern "C" int smt_speckle_sweep(int* labels, const uint8_t* conn, int H,
                                 int W, int axis, int* changed,
                                 void* stream) {
  if (H < 1 || W < 1 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const int lines = axis == 1 ? H : W;
  speckle_sweep_kernel<<<(lines + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(labels, conn, H, W, axis,
                                                 changed);
  return (int)cudaGetLastError();
}

// d: (H, W) float32; labels: (H, W) int32 after the sweeps; count: H*W
// int32, zeroed by the caller; out: (H, W) float32.
extern "C" int smt_speckle_count_keep(const float* d, const int* labels,
                                      int* count, float* out, int H, int W,
                                      int threshold, int unconverged,
                                      void* stream) {
  const int hw = H * W;
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;                    // whole warps: __match_any_sync
  const int blocks = (hw + threads - 1) / threads;
  speckle_count_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      labels, count, hw);
  speckle_keep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      d, labels, count, out, hw, threshold, unconverged);
  return (int)cudaGetLastError();
}
