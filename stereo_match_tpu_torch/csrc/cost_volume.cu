// K2 census_volume: Hamming cost volume from census words (one or more).
//
// Replaces, in stereo_match_tpu/ops/pallas_kernels.py, census_volume_pallas
// (_census_vol_kernel; float32 with INVALID 1e4, or int16 with INVALID 1024;
// popcounts summed over the words) and census_volume_T_pallas
// (_census_vol_T_kernel: the same volume in the transposed (D, W, H) layout,
// from transposed (words, W, H) census words). In the planes layout
// out[i, y, x] = sum_w popc(cl[w, y, x] ^ cr[w, y, x - d]) with
// d = min_d + i, INVALID where x < d (ops/cost_volume.py); transposed,
// out[i, x, y] = sum_w popc(clT[w, x, y] ^ crT[w, x - d, y]), INVALID where
// x < d. One kernel serves both: it builds an (R, C) volume per plane whose
// shift runs along the columns (planes layout) or along the rows
// (transposed layout).
//
// Bound on the H100: device-memory writes (the 238 MB float32 volume at
// KITTI D=128, ~71 us at 3.35 TB/s; 119 MB in int16); the word reads are
// 3.7 MB a word and stay in L2 across the D planes. Design: one thread per
// output cell, threads along the last axis so every store is a coalesced row
// segment; the shifted right words are read directly at the shifted
// position (the TPU kernels rolled lanes incrementally, or read aligned row
// windows), one plane of words after another.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void census_volume_kernel(const int* __restrict__ cl,
                                     const int* __restrict__ cr,
                                     T* __restrict__ out, int R, int C,
                                     int n_words, int min_d, int shift_rows,
                                     T invalid) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  const int i = blockIdx.z;
  if (c >= C) return;
  const int d = min_d + i;
  const size_t plane = (size_t)R * C;
  const size_t at = (size_t)r * C + c;
  T v = invalid;
  if ((shift_rows ? r : c) >= d) {
    const size_t src = shift_rows ? at - (size_t)d * C : at - d;
    int ham = 0;
    for (int w = 0; w < n_words; ++w)
      ham += __popc((unsigned)(cl[w * plane + at] ^ cr[w * plane + src]));
    v = (T)ham;
  }
  out[(size_t)i * plane + at] = v;
}

}  // namespace

// cl, cr: (n_words, R, C) int32; out: (D, R, C), float32 (i16 = 0, INVALID
// 1e4) or int16 (i16 = 1, INVALID 1024). transposed = 0: (R, C) = (H, W),
// the shift runs along C; transposed = 1: (R, C) = (W, H), the shift runs
// along R.
extern "C" int smt_census_volume(const int* cl, const int* cr, void* out,
                                 int R, int C, int n_words, int D, int min_d,
                                 int transposed, int i16, void* stream) {
  const int threads = 128;
  dim3 grid((C + threads - 1) / threads, R, D);
  if (i16)
    census_volume_kernel<short><<<grid, threads, 0, (cudaStream_t)stream>>>(
        cl, cr, static_cast<short*>(out), R, C, n_words, min_d, transposed,
        (short)1024);
  else
    census_volume_kernel<float><<<grid, threads, 0, (cudaStream_t)stream>>>(
        cl, cr, static_cast<float*>(out), R, C, n_words, min_d, transposed,
        1e4f);
  return (int)cudaGetLastError();
}
