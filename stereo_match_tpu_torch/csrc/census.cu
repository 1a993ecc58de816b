// K1 census_words: single-word census descriptors of both views.
//
// Replaces stereo_match_tpu/ops/pallas_kernels.py::census_words_pallas
// (_census_words_kernel). Same semantics as ops/census.py::census_transform
// for windows of at most 33 pixels: bit k is set when the k-th neighbour in
// row-major window order (centre skipped) is strictly darker than the
// centre; borders read edge-replicated pixels.
//
// Bound on the H100: device-memory bytes (4 B read + 4 B written per pixel
// and view, 7.5 MB at KITTI); the wh*ww neighbour reads of a block overlap
// and hit L1. Design: one thread per pixel, threads along x so loads and
// stores coalesce; edge replication is a clamp of the neighbour coordinate,
// so no padded copy of the image is made (the TPU kernel padded and rolled
// lanes instead).

#include <cuda_runtime.h>

namespace {

__global__ void census_words_kernel(const float* __restrict__ imgs,
                                    int* __restrict__ out, int H, int W,
                                    int ry, int rx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t view = (size_t)blockIdx.z * H * W;
  const float* img = imgs + view;
  const float centre = img[(size_t)y * W + x];
  unsigned word = 0u;
  int bit = 0;
  for (int dy = -ry; dy <= ry; ++dy) {
    const float* row = img + (size_t)min(max(y + dy, 0), H - 1) * W;
    for (int dx = -rx; dx <= rx; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float v = row[min(max(x + dx, 0), W - 1)];
      word |= (unsigned)(v < centre) << bit;
      ++bit;
    }
  }
  out[view + (size_t)y * W + x] = (int)word;
}

}  // namespace

// imgs: (n_views, H, W) float32; out: (n_views, H, W) int32.
// Window (wh, ww) odd, wh * ww - 1 <= 32 (checked by the Python wrapper).
extern "C" int smt_census_words(const float* imgs, int* out, int n_views,
                                int H, int W, int wh, int ww,
                                void* stream) {
  const int threads = 128;
  dim3 grid((W + threads - 1) / threads, H, n_views);
  census_words_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      imgs, out, H, W, wh / 2, ww / 2);
  return (int)cudaGetLastError();
}
