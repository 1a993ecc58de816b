// K1 census_words: census descriptors of both views, in one or more words.
//
// Replaces stereo_match_tpu/ops/pallas_kernels.py::census_words_pallas
// (_census_words_kernel, one word) and, for windows over 33 pixels, the XLA
// ops/census.py::census_transform that the JAX package runs there. Same
// semantics as census_transform: bit k of word k / 32 (bit k % 32 there) is
// set when the k-th neighbour in row-major window order (centre skipped) is
// strictly darker than the centre; borders read edge-replicated pixels, and
// a NaN compares false.
//
// Bound on the H100: device-memory bytes (4 B read per pixel and view, 4 B
// written per pixel, view and word: 7.5 MB at KITTI with one word, 11 MB
// with two, 2.2 and 3.3 us at 3.35 TB/s), so a launch of a few us is what
// is left of it; the compares (24 a pixel at 5x5) are the next cost. Design
// (its CPU model is cuda_kernels.census_words_tiled_plain):
// - A block stages one tile of one view with its halo in shared memory
//   once: kRows = 16 rows x kTW = 128 columns of output, (kRows + wh - 1) x
//   (kTW + ww - 1) pixels, by 4-byte cp.async. It does so in two bands of
//   kTH = 8 output rows: the second band's rows are in flight while the
//   first band computes, and the first band's stores drain while the
//   second computes. The edge replication is the clamp of the copies'
//   source coordinates; nothing else clamps.
// - A warp computes one row of each band, a lane kPX = 4 adjacent pixels.
//   For each window row a lane reads the slice its 4 pixels share with
//   16-byte shared loads (a warp reads 512 contiguous bytes, no bank
//   conflict), so each value read feeds up to 4 compares. A compare is an
//   FSETP and the bit's predicated add into the word (written as an `if`:
//   a mask and an AND-OR took three instructions a compare, SEL among them,
//   and ran 1.5x (5x5) to 1.8x (7x9) longer).
// - The windows the paths run (5x5, the default, and 7x9) are templates:
//   every bit's word and position is a constant, so the words are built
//   in place in registers. Any other odd window takes the generic body:
//   a window row in passes of kPass = 16 columns (bits past the window's
//   edge masked off), a pass's bits put into a 64-bit accumulator a pixel
//   at its fill, and a word stored whenever 32 have filled: any number of
//   words.
// - A lane stores its 4 pixels' word with one 16-byte store where the row
//   of the word plane is 16-byte aligned, two 8-byte stores where it is
//   8-byte aligned (every other row at W = 1242), four 4-byte ones at an
//   odd W, and scalars for the last pixels of a row. Both views are one
//   launch (grid z).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTW = 128;             // tile columns: 32 lanes x kPX pixels
constexpr int kTH = 8;               // rows of a band: a warp each
constexpr int kParts = 2;            // bands of a tile, staged in turn
constexpr int kRows = kTH * kParts;  // output rows of a tile
constexpr int kPX = 4;               // adjacent pixels a lane
constexpr int kThreads = 32 * kTH;
static_assert(kParts == 2, "the kernels stage and wait for two bands");
constexpr int kPass = 16;            // window columns a generic pass compares
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may take

// Floats a staged tile row takes: the tile's columns and halo, and the last
// lane's 16-byte reads of the last pass (whose values past the halo only
// feed masked bits), in whole float4s.
inline int tile_pitch(int ww) {
  const int slice = (kPass + kPX - 1 + 3) / 4 * 4;
  const int reach = kPX * 31 + (ww - 1) / kPass * kPass + slice;
  const int cols = kTW + ww - 1;
  return ((cols > reach ? cols : reach) + 3) / 4 * 4;
}

// Tile rows [r0, r1) into shared memory as one cp.async group,
// edge-replicated by clamping the source; 4-byte copies, since a row of an
// odd-multiple-of-8-byte width is not 16-byte aligned. RY, RX: the window's
// radii where they are constants (the index arithmetic then divides by a
// constant), else -1 and ry, rx.
template <int RY, int RX>
__device__ __forceinline__ void stage_rows(float* tile, const float* img,
                                           int H, int W, int y0, int x0,
                                           int ry_arg, int rx_arg, int pitch,
                                           int r0, int r1) {
  const int ry = RY >= 0 ? RY : ry_arg;
  const int rx = RX >= 0 ? RX : rx_arg;
  const int cols = kTW + 2 * rx;
  for (int i = threadIdx.x; i < (r1 - r0) * cols; i += kThreads) {
    const int r = r0 + i / cols;
    const int c = i % cols;
    const float* src = img + (size_t)min(max(y0 - ry + r, 0), H - 1) * W +
                       min(max(x0 - rx + c, 0), W - 1);
    const unsigned s = (unsigned)__cvta_generic_to_shared(tile + r * pitch +
                                                           c);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The block's kParts bands of kTH output rows, the second band's rows
// staged while the first band computes: waits for band `part`'s copies.
template <int PART>
__device__ __forceinline__ void wait_band() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kParts - 1 - PART));
  __syncthreads();
}

// A row's NV float4s from shared memory into registers.
template <int NV>
__device__ __forceinline__ void load_slice(float* s, const float* row) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 q = row4[v];
    s[4 * v] = q.x;
    s[4 * v + 1] = q.y;
    s[4 * v + 2] = q.z;
    s[4 * v + 3] = q.w;
  }
}

__device__ __forceinline__ void store_words(int* d, int n_px,
                                            const unsigned* w) {
  if (n_px == kPX) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(d);
    if ((a & 15) == 0) {
      *reinterpret_cast<int4*>(d) =
          make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    } else if ((a & 7) == 0) {
      reinterpret_cast<int2*>(d)[0] = make_int2((int)w[0], (int)w[1]);
      reinterpret_cast<int2*>(d)[1] = make_int2((int)w[2], (int)w[3]);
    } else {
#pragma unroll
      for (int p = 0; p < kPX; ++p) d[p] = (int)w[p];
    }
  } else {
    for (int p = 0; p < n_px; ++p) d[p] = (int)w[p];
  }
}

// A window known at compile time: each bit lands at a constant position.
// One output row's 4 pixels of a lane: `row` is the lane's first pixel's
// window corner in the tile.
template <int WH, int WW>
__device__ __forceinline__ void fixed_row(const float* row, int pitch,
                                          int* dst, size_t plane, int n_px) {
  constexpr int RY = WH / 2;
  constexpr int RX = WW / 2;
  constexpr int NW = (WH * WW - 1 + 31) / 32;
  constexpr int NV = (kPX + WW - 1 + 3) / 4;
  float centre[kPX];
#pragma unroll
  for (int p = 0; p < kPX; ++p) centre[p] = row[RY * pitch + RX + p];
  unsigned words[NW][kPX];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int p = 0; p < kPX; ++p) words[w][p] = 0u;
#pragma unroll
  for (int dy = 0; dy < WH; ++dy) {
    float s[4 * NV];
    load_slice<NV>(s, row + dy * pitch);
#pragma unroll
    for (int dx = 0; dx < WW; ++dx) {
      if (dy == RY && dx == RX) continue;
      const int k = dy * WW + dx - (dy * WW + dx > RY * WW + RX);
#pragma unroll
      for (int p = 0; p < kPX; ++p)
        if (s[p + dx] < centre[p]) words[k / 32][p] |= 1u << (k % 32);
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) store_words(dst + (size_t)w * plane, n_px,
                                           words[w]);
}

template <int WH, int WW>
__global__ void __launch_bounds__(kThreads)
census_words_fixed(const float* __restrict__ imgs, int* __restrict__ out,
                   int H, int W, int pitch) {
  extern __shared__ __align__(16) float tile[];
  constexpr int RY = WH / 2;
  constexpr int RX = WW / 2;
  constexpr int NW = (WH * WW - 1 + 31) / 32;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t plane = (size_t)H * W;
  const float* img = imgs + (size_t)blockIdx.z * plane;
  stage_rows<RY, RX>(tile, img, H, W, y0, x0, RY, RX, pitch, 0,
                     kTH + 2 * RY);
  stage_rows<RY, RX>(tile, img, H, W, y0, x0, RY, RX, pitch, kTH + 2 * RY,
                     kRows + 2 * RY);
  const int x = x0 + kPX * lane;
  int* dst = out + (size_t)blockIdx.z * NW * plane + x;
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    if (part == 0) wait_band<0>(); else wait_band<1>();
    const int r = part * kTH + warp;
    if (y0 + r < H && x < W)
      fixed_row<WH, WW>(tile + r * pitch + kPX * lane, pitch,
                        dst + (size_t)(y0 + r) * W, plane,
                        min(kPX, W - x));
  }
}

// Any odd window: a row in passes of kPass columns through a 64-bit
// accumulator a pixel; a word stored whenever 32 bits have filled.
__device__ __forceinline__ void generic_row(const float* row, int pitch,
                                            int ry, int rx, int* dst,
                                            size_t plane, int n_px) {
  constexpr int NV = (kPass + kPX - 1 + 3) / 4;  // float4s of a pass's slice
  const int wh = 2 * ry + 1;
  const int ww = 2 * rx + 1;
  float centre[kPX];
#pragma unroll
  for (int p = 0; p < kPX; ++p) centre[p] = row[ry * pitch + rx + p];
  unsigned long long acc[kPX] = {};
  int fill = 0;
  int word = 0;
  for (int dy = 0; dy < wh; ++dy) {
    for (int c0 = 0; c0 < ww; c0 += kPass) {
      float s[4 * NV];
      load_slice<NV>(s, row + dy * pitch + c0);
      int n = min(kPass, ww - c0);
      unsigned bits[kPX];
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        unsigned b = 0u;
#pragma unroll
        for (int j = 0; j < kPass; ++j)
          if (s[p + j] < centre[p]) b |= 1u << j;
        bits[p] = b & ((1u << n) - 1u);
      }
      if (dy == ry && rx >= c0 && rx < c0 + n) {   // skip the centre
        const int k = rx - c0;
#pragma unroll
        for (int p = 0; p < kPX; ++p)
          bits[p] = (bits[p] & ((1u << k) - 1u)) | (bits[p] >> (k + 1) << k);
        --n;
      }
#pragma unroll
      for (int p = 0; p < kPX; ++p)
        acc[p] |= (unsigned long long)bits[p] << fill;
      fill += n;
      if (fill >= 32) {                            // a word is full
        unsigned w[kPX];
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
          w[p] = (unsigned)acc[p];
          acc[p] >>= 32;
        }
        store_words(dst + (size_t)word * plane, n_px, w);
        fill -= 32;
        ++word;
      }
    }
  }
  if (fill > 0) {
    unsigned w[kPX];
#pragma unroll
    for (int p = 0; p < kPX; ++p) w[p] = (unsigned)acc[p];
    store_words(dst + (size_t)word * plane, n_px, w);
  }
}

__global__ void __launch_bounds__(kThreads)
census_words_kernel(const float* __restrict__ imgs, int* __restrict__ out,
                    int H, int W, int ry, int rx, int n_words, int pitch) {
  extern __shared__ __align__(16) float tile[];
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t plane = (size_t)H * W;
  const float* img = imgs + (size_t)blockIdx.z * plane;
  stage_rows<-1, -1>(tile, img, H, W, y0, x0, ry, rx, pitch, 0,
                     kTH + 2 * ry);
  stage_rows<-1, -1>(tile, img, H, W, y0, x0, ry, rx, pitch, kTH + 2 * ry,
                     kRows + 2 * ry);
  const int x = x0 + kPX * lane;
  int* dst = out + (size_t)blockIdx.z * n_words * plane + x;
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    if (part == 0) wait_band<0>(); else wait_band<1>();
    const int r = part * kTH + warp;
    if (y0 + r < H && x < W)
      generic_row(tile + r * pitch + kPX * lane, pitch, ry, rx,
                      dst + (size_t)(y0 + r) * W, plane, min(kPX, W - x));
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int n_views, int H, int W, int wh, int ww,
           cudaStream_t stream, Args... args) {
  const int pitch = tile_pitch(ww);
  const size_t smem = (size_t)(kRows + wh - 1) * pitch * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // The attribute belongs to the current device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTW - 1) / kTW, (H + kRows - 1) / kRows, n_views);
  kernel<<<grid, kThreads, smem, stream>>>(args..., pitch);
  return (int)cudaGetLastError();
}

}  // namespace

// imgs: (n_views, H, W) float32; out: (n_views, n_words, H, W) int32 with
// n_words = ceil((wh * ww - 1) / 32). Window (wh, ww) odd with wh * ww >= 2
// (checked by the Python wrapper), its staged tile within a block's shared
// memory: (16 + wh - 1) rows of tile_pitch(ww) floats.
extern "C" int smt_census_words(const float* imgs, int* out, int n_views,
                                int H, int W, int wh, int ww,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (wh < 1 || ww < 1 || wh % 2 == 0 || ww % 2 == 0 || wh * ww < 2)
    return (int)cudaErrorInvalidValue;
#define SMT_CENSUS_FIXED(WH, WW)                                           \
  if (wh == WH && ww == WW)                                                \
    return launch(census_words_fixed<WH, WW>, n_views, H, W, wh, ww, st,   \
                  imgs, out, H, W);
  SMT_CENSUS_FIXED(5, 5) SMT_CENSUS_FIXED(7, 9)
#undef SMT_CENSUS_FIXED
  return launch(census_words_kernel, n_views, H, W, wh, ww, st, imgs, out, H,
                W, wh / 2, ww / 2, (wh * ww - 1 + 31) / 32);
}
