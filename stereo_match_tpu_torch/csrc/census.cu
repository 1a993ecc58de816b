// K1 census_words: census descriptors of both views, in one or more words.
//
// Replaces stereo_match_tpu/ops/pallas_kernels.py::census_words_pallas
// (_census_words_kernel, one word) and, for windows over 33 pixels, the XLA
// ops/census.py::census_transform that the JAX package runs there. Same
// semantics as census_transform: bit k of word k / 32 (bit k % 32 there) is
// set when the k-th neighbour in row-major window order (centre skipped) is
// strictly darker than the centre; borders read edge-replicated pixels.
//
// Bound on the H100: device-memory bytes (4 B read per pixel and view, 4 B
// written per pixel, view and word: 7.5 MB at KITTI with one word, 11 MB
// with two); the wh*ww neighbour reads of a block overlap and hit L1.
// Design: one thread per pixel, threads along x so loads and stores
// coalesce; a thread assembles its words in registers and stores each when
// it fills; edge replication is a clamp of the neighbour coordinate, so no
// padded copy of the image is made (the TPU kernel padded and rolled lanes
// instead).

#include <cuda_runtime.h>

namespace {

__global__ void census_words_kernel(const float* __restrict__ imgs,
                                    int* __restrict__ out, int H, int W,
                                    int ry, int rx, int n_words) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
  const float* img = imgs + (size_t)blockIdx.z * plane;
  int* dst = out + (size_t)blockIdx.z * n_words * plane + (size_t)y * W + x;
  const float centre = img[(size_t)y * W + x];
  unsigned word = 0u;
  int bit = 0;
  for (int dy = -ry; dy <= ry; ++dy) {
    const float* row = img + (size_t)min(max(y + dy, 0), H - 1) * W;
    for (int dx = -rx; dx <= rx; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float v = row[min(max(x + dx, 0), W - 1)];
      word |= (unsigned)(v < centre) << (bit & 31);
      if ((++bit & 31) == 0) {            // the word is full
        dst[(size_t)(bit / 32 - 1) * plane] = (int)word;
        word = 0u;
      }
    }
  }
  if (bit & 31) dst[(size_t)(bit / 32) * plane] = (int)word;
}

}  // namespace

// imgs: (n_views, H, W) float32; out: (n_views, n_words, H, W) int32 with
// n_words = ceil((wh * ww - 1) / 32). Window (wh, ww) odd (checked by the
// Python wrapper).
extern "C" int smt_census_words(const float* imgs, int* out, int n_views,
                                int H, int W, int wh, int ww,
                                void* stream) {
  const int threads = 128;
  const int n_words = (wh * ww - 1 + 31) / 32;
  dim3 grid((W + threads - 1) / threads, H, n_views);
  census_words_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      imgs, out, H, W, wh / 2, ww / 2, n_words);
  return (int)cudaGetLastError();
}
