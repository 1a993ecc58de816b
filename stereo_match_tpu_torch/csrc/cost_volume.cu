// K2 census_volume: Hamming cost volume from single-word census images.
//
// Replaces stereo_match_tpu/ops/pallas_kernels.py::census_volume_pallas
// (_census_vol_kernel). out[i, y, x] = popc(cl[y, x] ^ cr[y, x - d]) with
// d = min_d + i, or INVALID = 1e4 where x < d (ops/cost_volume.py), float32.
//
// Bound on the H100: device-memory writes (the 238 MB float32 volume at
// KITTI D=128, ~71 us at 3.35 TB/s); the word reads are 3.7 MB and stay in
// L2 across the D planes. Design: one thread per output cell, threads along
// x so every store is a coalesced row segment; the shifted right word is
// read directly at x - d (the TPU kernel rolled lanes incrementally).

#include <cuda_runtime.h>

namespace {

__global__ void census_volume_kernel(const int* __restrict__ cl,
                                     const int* __restrict__ cr,
                                     float* __restrict__ out, int H, int W,
                                     int min_d) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int i = blockIdx.z;
  if (x >= W) return;
  const int d = min_d + i;
  const size_t row = (size_t)y * W;
  float v = 1e4f;
  if (x >= d) v = (float)__popc((unsigned)(cl[row + x] ^ cr[row + x - d]));
  out[((size_t)i * H + y) * W + x] = v;
}

}  // namespace

// cl, cr: (H, W) int32; out: (D, H, W) float32.
extern "C" int smt_census_volume(const int* cl, const int* cr, float* out,
                                 int H, int W, int D, int min_d,
                                 void* stream) {
  const int threads = 128;
  dim3 grid((W + threads - 1) / threads, H, D);
  census_volume_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      cl, cr, out, H, W, min_d);
  return (int)cudaGetLastError();
}
