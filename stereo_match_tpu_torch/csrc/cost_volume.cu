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
// x < d. Both build an (R, C) volume per plane whose shift runs along the
// columns (planes layout) or along the rows (transposed layout).
//
// Bound on the H100: device-memory writes (the 238 MB float32 volume at
// KITTI D=128, ~71 us at 3.35 TB/s; 119 MB and ~36 us in int16); the words
// are 1.9 MB a view and word. Design: a thread holds its pixels' left words
// in registers, read once, and walks all D planes (in groups of at most 256
// planes for deeper volumes), storing its cells of each plane; the right
// words a block needs are staged in shared memory.
//  - planes layout: a block is one image row (up to 1024 threads), a
//    thread V consecutive cells stored as one vector (V = 4, 2 or 1: the
//    widest at which every row of every plane starts aligned; 2 at KITTI,
//    4 at 720p). The block stages cr[w, y, -d_hi .. W - d_lo) and cell x
//    reads x - d. The stores, not the bytes, bound the one-cell-a-thread
//    form: a warp's vector store moves V times the bytes of a scalar one
//    (at KITTI, 4-cell stores shifted to each row's alignment measured no
//    faster than pairs on the H100).
//  - transposed layout: a block is 4 rows of all H columns (a thread a
//    column), so each plane's stores are 4 whole rows; per chunk of 16
//    planes it stages the 19 crT rows the chunk reads at its columns.
//    (Blocks of 32 columns by 16 rows, which store 16 pieces of 128 bytes
//    a plane, took 0.233 ms at KITTI on the H100 against 0.132.)

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kPlanesGroup = 256;
constexpr int kMaxWords = 8;
constexpr int kMaxBlock = 1024;
constexpr int kWideRows = 4;     // transposed, full rows: rows a block
constexpr int kWideChunk = 16;   // planes a staged chunk

// V consecutive cells, stored as one aligned vector (V * sizeof(T) bytes).
template <typename T, int V>
struct alignas(sizeof(T) * V) Cells {
  T v[V];
};

// Planes layout: a block is one image row (or a tile of it), a thread V
// consecutive cells c .. c + V - 1 stored as one vector.
template <typename T, int NW, int V>
__global__ void __launch_bounds__(kMaxBlock)
census_volume_planes(const int* __restrict__ cl, const int* __restrict__ cr,
                     T* __restrict__ out, int R, int C, int nw, int D,
                     int min_d, int G, T invalid) {
  extern __shared__ int s_cr[];                 // [nw][span]
  const int t = threadIdx.x, nt = blockDim.x;
  const int r = blockIdx.x, c0 = blockIdx.z * nt * V;
  const int i0 = blockIdx.y * G, i1 = min(D, i0 + G);
  const int d_lo = min_d + i0, d_hi = min_d + i1 - 1;
  const int c1 = min(C, c0 + nt * V);           // the block's columns
  const int base = c0 - d_hi;                   // column of s_cr[w][0]
  const int span = c1 - c0 + d_hi - d_lo;
  const size_t plane = (size_t)R * C;
  const size_t at_row = (size_t)r * C;
  for (int w = 0; w < nw; ++w)
    for (int q = t; q < span; q += nt) {
      const int c = base + q;
      s_cr[w * span + q] = c >= 0 ? cr[w * plane + at_row + c] : 0;
    }
  __syncthreads();
  const int c = c0 + t * V;                     // this thread's V cells
  if (c >= c1) return;
  unsigned lw[V][NW];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int w = 0; w < NW; ++w)
      lw[v][w] = w < nw ? (unsigned)cl[w * plane + at_row + c + v] : 0u;
  Cells<T, V>* o = reinterpret_cast<Cells<T, V>*>(out + (size_t)i0 * plane +
                                                  at_row + c);
  for (int i = i0; i < i1; ++i, o += plane / V) {
    const int d = min_d + i;
    Cells<T, V> cells;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      cells.v[v] = invalid;
      if (c + v >= d) {
        const int q = c + v - d - base;
        int ham = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          if (w < nw) ham += __popc(lw[v][w] ^ (unsigned)s_cr[w * span + q]);
        cells.v[v] = (T)ham;
      }
    }
    *o = cells;
  }
}

// Transposed layout, full rows: a block is kWideRows rows of all C
// columns (a thread a column, up to 1024, then column tiles), walking all
// its planes; per chunk of planes it stages the crT rows the chunk needs
// at its columns, so every plane's stores are kWideRows whole rows.
template <typename T, int NW>
__global__ void __launch_bounds__(kMaxBlock)
census_volume_wide(const int* __restrict__ cl, const int* __restrict__ cr,
                   T* __restrict__ out, int R, int C, int nw, int D,
                   int min_d, int G, int chunk, T invalid) {
  extern __shared__ int s_cr[];       // [nw][kWideRows + chunk - 1][nt]
  const int t = threadIdx.x, nt = blockDim.x;
  const int c = blockIdx.z * nt + t, r0 = blockIdx.x * kWideRows;
  const int i0 = blockIdx.y * G, i1 = min(D, i0 + G);
  const int span = kWideRows + chunk - 1;
  const size_t plane = (size_t)R * C;
  const bool live = c < C;
  unsigned lw[kWideRows][NW];
#pragma unroll
  for (int m = 0; m < kWideRows; ++m)
#pragma unroll
    for (int w = 0; w < NW; ++w)
      lw[m][w] = w < nw && live && r0 + m < R
                     ? (unsigned)cl[w * plane + (size_t)(r0 + m) * C + c]
                     : 0u;
  for (int ia = i0; ia < i1; ia += chunk) {
    const int ib = min(i1, ia + chunk);
    const int base = r0 - (min_d + ib - 1);   // row of s_cr[w][0]
    const int rows = kWideRows + ib - 1 - ia;
    __syncthreads();                           // the last chunk is read
    for (int w = 0; w < nw; ++w)
      for (int q = 0; q < rows; ++q) {
        const int rr = base + q;
        s_cr[(w * span + q) * nt + t] =
            live && rr >= 0 && rr < R ? cr[w * plane + (size_t)rr * C + c]
                                      : 0;
      }
    __syncthreads();
    if (!live) continue;
    for (int i = ia; i < ib; ++i) {
      const int d = min_d + i;
      T* o = out + (size_t)i * plane + c;
#pragma unroll
      for (int m = 0; m < kWideRows; ++m) {
        const int r = r0 + m;
        if (r < R) {
          T v = invalid;
          if (r >= d) {
            const int q = r - d - base;
            int ham = 0;
#pragma unroll
            for (int w = 0; w < NW; ++w)
              if (w < nw)
                ham += __popc(lw[m][w] ^ (unsigned)s_cr[(w * span + q) * nt +
                                                         t]);
            v = (T)ham;
          }
          o[(size_t)r * C] = v;
        }
      }
    }
  }
}

// Raise the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB (per card, so at every launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NW, int V>
int launch_planes(const int* cl, const int* cr, T* out, int R, int C, int nw,
                  int D, int min_d, T invalid, cudaStream_t stream) {
  const int G = std::min(D, kPlanesGroup);
  const int vectors = (C + V - 1) / V;
  const int nt = std::min(kMaxBlock, (vectors + 31) / 32 * 32);
  const int tiles = (vectors + nt - 1) / nt;
  const size_t smem =
      (size_t)nw * (std::min(C, nt * V) + G - 1) * sizeof(int);
  const cudaError_t err = allow_smem(census_volume_planes<T, NW, V>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(R, (D + G - 1) / G, tiles);
  census_volume_planes<T, NW, V><<<grid, nt, smem, stream>>>(
      cl, cr, out, R, C, nw, D, min_d, G, invalid);
  return (int)cudaGetLastError();
}

template <typename T, int NW>
int launch_wide(const int* cl, const int* cr, T* out, int R, int C, int nw,
                int D, int min_d, T invalid, cudaStream_t stream) {
  const int G = std::min(D, kPlanesGroup);
  const int nt = std::min(kMaxBlock, (C + 31) / 32 * 32);
  int chunk = std::min(G, kWideChunk);
  auto bytes = [&](int k) {
    return (size_t)nw * (kWideRows + k - 1) * nt * sizeof(int);
  };
  while (chunk > 1 && bytes(chunk) > 96 * 1024) chunk = (chunk + 1) / 2;
  const size_t smem = bytes(chunk);
  const cudaError_t err = allow_smem(census_volume_wide<T, NW>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + kWideRows - 1) / kWideRows, (D + G - 1) / G,
            (C + nt - 1) / nt);
  census_volume_wide<T, NW><<<grid, nt, smem, stream>>>(
      cl, cr, out, R, C, nw, D, min_d, G, chunk, invalid);
  return (int)cudaGetLastError();
}

template <typename T, int NW>
int launch(const int* cl, const int* cr, T* out, int R, int C, int nw, int D,
           int min_d, int transposed, T invalid, cudaStream_t stream) {
  if (!transposed) {
    // the widest vector of cells (4, 2 or 1) at which every row of every
    // plane starts aligned (2 at KITTI's 1242, 4 at 720p's 1280)
    auto fits = [&](int v) {
      return C % v == 0 && ((size_t)R * C) % v == 0 &&
             reinterpret_cast<uintptr_t>(out) % (v * sizeof(T)) == 0;
    };
    if (fits(4))
      return launch_planes<T, NW, 4>(cl, cr, out, R, C, nw, D, min_d,
                                     invalid, stream);
    if (fits(2))
      return launch_planes<T, NW, 2>(cl, cr, out, R, C, nw, D, min_d,
                                     invalid, stream);
    return launch_planes<T, NW, 1>(cl, cr, out, R, C, nw, D, min_d, invalid,
                                   stream);
  }
  return launch_wide<T, NW>(cl, cr, out, R, C, nw, D, min_d, invalid,
                            stream);
}

template <typename T>
int launch_words(const int* cl, const int* cr, T* out, int R, int C, int nw,
                 int D, int min_d, int transposed, T invalid,
                 cudaStream_t stream) {
  if (nw <= 1)
    return launch<T, 1>(cl, cr, out, R, C, nw, D, min_d, transposed,
                        invalid, stream);
  if (nw <= 2)
    return launch<T, 2>(cl, cr, out, R, C, nw, D, min_d, transposed,
                        invalid, stream);
  if (nw <= 4)
    return launch<T, 4>(cl, cr, out, R, C, nw, D, min_d, transposed,
                        invalid, stream);
  return launch<T, kMaxWords>(cl, cr, out, R, C, nw, D, min_d, transposed,
                              invalid, stream);
}

}  // namespace

// cl, cr: (n_words, R, C) int32, 1 <= n_words <= 8; out: (D, R, C), float32
// (i16 = 0, INVALID 1e4) or int16 (i16 = 1, INVALID 1024). transposed = 0:
// (R, C) = (H, W), the shift runs along C; transposed = 1: (R, C) = (W, H),
// the shift runs along R.
extern "C" int smt_census_volume(const int* cl, const int* cr, void* out,
                                 int R, int C, int n_words, int D, int min_d,
                                 int transposed, int i16, void* stream) {
  if (n_words < 1 || n_words > kMaxWords) return (int)cudaErrorInvalidValue;
  if (D < 1 || R < 1 || C < 1) return (int)cudaSuccess;
  if (i16)
    return launch_words<short>(cl, cr, static_cast<short*>(out), R, C,
                               n_words, D, min_d, transposed, (short)1024,
                               (cudaStream_t)stream);
  return launch_words<float>(cl, cr, static_cast<float*>(out), R, C, n_words,
                             D, min_d, transposed, 1e4f,
                             (cudaStream_t)stream);
}


