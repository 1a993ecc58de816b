// K8 mccnn_conv3x3 and K9 mccnn_volume: the MC-CNN feature tower and its
// feature-dot cost volume, float32.
//
// K8 replaces, in stereo_match_tpu/ops/pallas_kernels.py, the tower of
// mccnn_tower_pallas (_mccnn_tower_kernel, _tower_body) and the tower half
// of mccnn_fused_volume_pallas (_mccnn_fused_kernel). One launch is one
// layer of the flax tower (models/mccnn.py::MCCNNFeatures): a 3x3
// cross-correlation with SAME zero padding of the layer's own input, plus
// bias, then ReLU (every layer but the last) or, for the last layer, the
// division of each pixel's F-vector by sqrt(sum of squares + 1e-12). The
// TPU kernel kept all layers in VMEM and re-zeroed a margin after every
// layer to rebuild the per-layer padding; here every layer reads its input
// from device memory and the halo outside the image is loaded as zero.
//
// Bound on the H100: FP32 FMAs. A KITTI frame (both 1242x375 views) is
// 2*9*F*C_in*H*W*2 FLOP per layer: 69 GFLOP for a 64->64 layer, 210 GFLOP
// for 112->112, ~1.0 and ~3.1 ms at the 67 TFLOP/s non-tensor peak. Design:
// a block owns an 8x32 tile of output pixels and all F channels of it in
// registers (256 threads, each 4 pixels x F/4 channels, so one input load
// feeds F/4 FMAs and one float4 weight load feeds 16). Input channels are
// staged 8 at a time: the 10x34 halo of each and its 9xF weights, read
// coalesced from the (3, 3, C_in, F) tap-major copy of the weights that
// the module makes once. The four threads of a pixel are neighbouring
// lanes, so the last layer's norm is two shuffles. F is padded to the next
// of 32, 64, 112, 128 with zero weights; padded channels are not stored.
//
// K9 replaces mccnn_volume_pallas (_mccnn_vol_kernel), mccnn_volume_mxu_
// pallas (_mccnn_vol_mxu_kernel), mccnn_volume_flat_pallas
// (_mccnn_vol_flat_kernel, _gram_band_body) and the volume half of
// mccnn_fused_volume_pallas: three layouts of one function,
//   vol[i, y, x] = scale * (1 - sum_f fl[f, y, x] * fr[f, y, x - d]) * 0.5
// with d = min_d + i, and exactly INVALID = 1e4 where x < d, for any D and
// any min_d >= 0 (models/mccnn.py:143-150).
//
// Bound on the H100: the volume write (238 MB at KITTI D=128, ~71 us at
// 3.35 TB/s) and 2*F*D*H*W FLOP (7.6 GFLOP at F=64, ~0.11 ms). Design: a
// block owns one row y, 128 columns and 64 disparities; each warp 8
// disparities, each lane 4 neighbouring columns, so the 32 products of a
// lane and a feature channel need one float4 of left features and three
// float4 of the right row (the 11 values x - d spans). Feature channels
// are staged 32 at a time: the left tile and the right window of 192
// samples, both coalesced row segments.

#include <cuda_runtime.h>

namespace {

constexpr float kInvalid = 1e4f;

// ------------------------------------------------------------------- K8 ----

constexpr int kConvTH = 8;
constexpr int kConvTW = 32;
constexpr int kConvThreads = 256;
constexpr int kConvCC = 8;  // input channels per stage
constexpr int kHaloH = kConvTH + 2;
constexpr int kHaloW = kConvTW + 2;
constexpr int kHaloSize = kHaloH * kHaloW;
static_assert((kConvCC * kHaloSize) % 4 == 0, "weights must stay float4-aligned");

// FG channels per thread (a multiple of 4); the block covers FP = 4 * FG.
template <int FG>
__global__ void __launch_bounds__(kConvThreads, 1)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ bias, float* __restrict__ y,
               int C_in, int F, int H, int W, int relu, int normalize) {
  constexpr int FP = 4 * FG;
  constexpr int KQ = FG / 4;  // float4 channel quads per thread
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [kConvCC][kHaloH][kHaloW]
  float* ws = smem + kConvCC * kHaloSize;  // [kConvCC][9][FP]

  const int t = threadIdx.x;
  const int cg = t & 3;         // channel group: quads cg, cg + 4, ...
  const int pg = t >> 2;        // pixel group 0..63
  const int r = pg >> 3;        // tile row
  const int c = pg & 7;         // first tile column; then c + 8, +16, +24
  const int ty0 = blockIdx.y * kConvTH;
  const int tx0 = blockIdx.x * kConvTW;
  const int view = blockIdx.z;
  const float* xv = x + (size_t)view * C_in * H * W;

  float acc[4][FG];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < FG; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < C_in; c0 += kConvCC) {
    const int cc = min(kConvCC, C_in - c0);
    __syncthreads();  // the previous stage has been consumed
    for (int i = t; i < cc * kHaloSize; i += kConvThreads) {
      const int ci = i / kHaloSize;
      const int rem = i - ci * kHaloSize;
      const int hy = rem / kHaloW;
      const int gy = ty0 + hy - 1;
      const int gx = tx0 + rem - hy * kHaloW - 1;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xv[((size_t)(c0 + ci) * H + gy) * W + gx];
      xs[i] = v;
    }
    for (int i = t; i < cc * 9 * FP; i += kConvThreads) {
      const int f = i % FP;
      const int rest = i / FP;  // ci * 9 + tap
      const int ci = rest / 9;
      const int tap = rest - ci * 9;
      ws[i] = f < F ? taps[((size_t)tap * C_in + c0 + ci) * F + f] : 0.f;
    }
    __syncthreads();
    for (int ci = 0; ci < cc; ++ci) {
      const float* xr = xs + ci * kHaloSize + r * kHaloW + c;
      const float4* wr = reinterpret_cast<const float4*>(ws + ci * 9 * FP);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float in[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) in[j] = xr[ky * kHaloW + kx + 8 * j];
          const float4* wt = wr + (ky * 3 + kx) * (FP / 4);
#pragma unroll
          for (int k = 0; k < KQ; ++k) {
            const float4 w4 = wt[k * 4 + cg];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j][4 * k + 0] = fmaf(in[j], w4.x, acc[j][4 * k + 0]);
              acc[j][4 * k + 1] = fmaf(in[j], w4.y, acc[j][4 * k + 1]);
              acc[j][4 * k + 2] = fmaf(in[j], w4.z, acc[j][4 * k + 2]);
              acc[j][4 * k + 3] = fmaf(in[j], w4.w, acc[j][4 * k + 3]);
            }
          }
        }
      }
    }
  }

  const int gy = ty0 + r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = (k * 4 + cg) * 4 + e;
        float v = acc[j][4 * k + e] + (ch < F ? bias[ch] : 0.f);
        if (relu) v = fmaxf(v, 0.f);
        acc[j][4 * k + e] = v;
        ss = fmaf(v, v, ss);
      }
    }
    float norm = 1.f;
    if (normalize) {  // the pixel's four channel groups are lanes t ^ 1, 2
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      norm = sqrtf(ss + 1e-12f);
    }
    const int gx = tx0 + c + 8 * j;
    if (gy >= H || gx >= W) continue;
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = (k * 4 + cg) * 4 + e;
        if (ch < F) {
          const float v = acc[j][4 * k + e];
          y[(((size_t)view * F + ch) * H + gy) * W + gx] =
              normalize ? v / norm : v;
        }
      }
    }
  }
}

template <int FG>
int launch_conv3x3(const float* x, const float* taps, const float* bias,
                   float* y, int V, int C_in, int F, int H, int W, int relu,
                   int normalize, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kConvCC * kHaloSize + kConvCC * 9 * 4 * FG) * sizeof(float);
  dim3 grid((W + kConvTW - 1) / kConvTW, (H + kConvTH - 1) / kConvTH, V);
  conv3x3_kernel<FG><<<grid, kConvThreads, smem, stream>>>(
      x, taps, bias, y, C_in, F, H, W, relu, normalize);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K9 ----

constexpr int kVolTX = 128;                  // columns per block: 32 x 4
constexpr int kVolDB = 8;                    // disparities per warp
constexpr int kVolWarps = 8;
constexpr int kVolDT = kVolDB * kVolWarps;   // disparities per block
constexpr int kVolFC = 32;                   // feature channels per stage
constexpr int kVolWin = kVolTX + kVolDT;     // right samples per row

__global__ void __launch_bounds__(kVolWarps * 32)
mccnn_volume_kernel(const float* __restrict__ fl,
                    const float* __restrict__ fr, float* __restrict__ out,
                    int F, int H, int W, int D, int min_d, float scale) {
  __shared__ __align__(16) float ls[kVolFC][kVolTX];
  __shared__ __align__(16) float rs[kVolFC][kVolWin];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kVolTX;
  const int y = blockIdx.y;
  const int i0 = blockIdx.z * kVolDT;  // first plane of the block
  const int g0 = x0 - (min_d + i0) - kVolDT;  // x - d held by rs[.][0]
  const int iw = i0 + warp * kVolDB;   // first plane of the warp
  const bool active = iw < D;
  // rs[f][s + m] holds fr at x - d for x = x0 + 4 lane + j,
  // d = min_d + iw + k, m = 8 + j - k in [1, 11]
  const int s = lane * 4 - warp * kVolDB + kVolDT - kVolDB;

  float acc[kVolDB][4];
#pragma unroll
  for (int k = 0; k < kVolDB; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kVolFC) {
    const int fc = min(kVolFC, F - f0);
    __syncthreads();
    for (int i = threadIdx.x; i < fc * kVolTX; i += kVolWarps * 32) {
      const int f = i / kVolTX;
      const int gx = x0 + i - f * kVolTX;
      ls[f][i - f * kVolTX] =
          gx < W ? fl[((size_t)(f0 + f) * H + y) * W + gx] : 0.f;
    }
    for (int i = threadIdx.x; i < fc * kVolWin; i += kVolWarps * 32) {
      const int f = i / kVolWin;
      const int gx = g0 + i - f * kVolWin;
      rs[f][i - f * kVolWin] = gx >= 0 && gx < W
                                   ? fr[((size_t)(f0 + f) * H + y) * W + gx]
                                   : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int f = 0; f < fc; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(&ls[f][lane * 4]);
      const float4 r0 = *reinterpret_cast<const float4*>(&rs[f][s]);
      const float4 r1 = *reinterpret_cast<const float4*>(&rs[f][s + 4]);
      const float4 r2 = *reinterpret_cast<const float4*>(&rs[f][s + 8]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float rv[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                            r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
#pragma unroll
      for (int k = 0; k < kVolDB; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[k][j] = fmaf(av[j], rv[8 + j - k], acc[k][j]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < kVolDB; ++k) {
    const int i = iw + k;
    if (i >= D) break;
    const int d = min_d + i;
    float* row = out + ((size_t)i * H + y) * W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = x0 + lane * 4 + j;
      if (x < W) row[x] = x < d ? kInvalid : scale * (1.f - acc[k][j]) * 0.5f;
    }
  }
}

}  // namespace

// x: (V, C_in, H, W); taps: (3, 3, C_in, F), the flax kernel layout;
// bias: (F,); y: (V, F, H, W). F <= 128.
extern "C" int smt_mccnn_conv3x3(const float* x, const float* taps,
                                 const float* bias, float* y, int V,
                                 int C_in, int F, int H, int W, int relu,
                                 int normalize, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 32)
    return launch_conv3x3<8>(x, taps, bias, y, V, C_in, F, H, W, relu,
                             normalize, st);
  if (F <= 64)
    return launch_conv3x3<16>(x, taps, bias, y, V, C_in, F, H, W, relu,
                              normalize, st);
  if (F <= 112)
    return launch_conv3x3<28>(x, taps, bias, y, V, C_in, F, H, W, relu,
                              normalize, st);
  if (F <= 128)
    return launch_conv3x3<32>(x, taps, bias, y, V, C_in, F, H, W, relu,
                              normalize, st);
  return (int)cudaErrorInvalidValue;
}

// fl, fr: (F, H, W) features of the two views; out: (D, H, W).
extern "C" int smt_mccnn_volume(const float* fl, const float* fr, float* out,
                                int F, int H, int W, int D, int min_d,
                                float scale, void* stream) {
  dim3 grid((W + kVolTX - 1) / kVolTX, H, (D + kVolDT - 1) / kVolDT);
  mccnn_volume_kernel<<<grid, kVolWarps * 32, 0, (cudaStream_t)stream>>>(
      fl, fr, out, F, H, W, D, min_d, scale);
  return (int)cudaGetLastError();
}
