// K8 mccnn_conv3x3 and K9 mccnn_volume: the MC-CNN feature tower and its
// feature-dot cost volume, float32 (K8 also in a bfloat16 mode).
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
// One entry point, two bodies chosen by C_in:
//
// C_in > 1 (every layer but the first): implicit GEMM on the tensor cores
// in 3xTF32. Bound on the H100: a KITTI frame (both 1242x375 views) is
// 2*9*F*C_in*H*W*2 FLOP a layer, 69 GFLOP at F = 64 and 210 GFLOP at
// F = 112; at float32 accuracy that is three TF32 products each, 0.42 and
// 1.27 ms at 495 TFLOP/s (1.03 and 3.14 ms on the 67 TFLOP/s FP32 pipes).
// Design: M = the 8 x 32 output pixels of a block (a warp per tile row, two
// m16 tiles), N = all F channels (F padded to 32, 64, 112 or 128: n8
// tiles; at 112 and 128 two warps share a tile row, half the n8 tiles
// each, so 16 warps fill the SM that one block occupies), K = 9 taps x
// C_in, stepped 8 channels of one tap at a time with mma.sync.m16n8k8
// TF32. Each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna); each k8 step forms lo*hi + hi*lo + hi*hi, small terms first,
// in a zeroed tensor-core accumulator, and adds it to the float32 total on
// the FP32 pipes. (Chaining every step through the tensor-core
// accumulator, which does not round to nearest, biased the sums: their
// error against float64 grew with K, well past cuDNN float32's; a rounded
// add a step keeps the bias to one step's sum.) The weights are split once
// by the module (cuda_kernels.mccnn_pack_weights: (2, 3, 3, C8, F8), hi
// then lo), the activations as their fragments are read, once for all n8
// tiles. Input channels are staged 8 at a time, the 10 x 34 halo and the
// 9 x 8 x F hi/lo weights, by cp.async into two buffers, so the next
// stage's copies overlap this stage's products; out-of-frame halo cells are
// zero-filled by the copy (the SAME padding). Shared-memory pitches (344
// floats a channel, F8 + 8 a weight row) keep the fragment reads free of
// bank conflicts. The epilogue adds the bias, then applies ReLU, or the L2
// norm: a pixel's channels lie in the four lanes of a quad (two shuffles)
// and, where two warps share the row, in shared memory. (TF32 wgmma would
// take A and B K-major from shared memory only; the NCHW halo tile is
// M-major for a tap, so this first tensor-core form is mma.sync fed from
// shared memory.)
//
// C_in = 1 (the first layer): K = 9, so it is bound by the output write
// (238 MB at F = 64), not by arithmetic, and stays on the FP32 pipes: a
// block stages its 10 x 34 halo and the 9 x F taps (the (3, 3, 1, F)
// tap-major copy the module makes once) and owns an 8x32 tile of output
// pixels, a thread one pixel and all F channels of it in registers, so
// each store of a warp is a whole 128-B line of one channel plane. (A map
// of four pixels x F/4 channels a thread makes each warp store four 32-B
// pieces of four planes, which the card writes more slowly.)
//
// The bfloat16 mode (BF16; the flax tower with compute_dtype bfloat16, and
// the Pallas tower's default compute_dtype) computes what
// cuda_kernels.mccnn_conv3x3_plain(..., bf16=True) does: the layer input
// and the weights rounded to bfloat16, their products summed in float32,
// the sum rounded to bfloat16, the bfloat16 bias added and the result
// rounded again, then ReLU or the float32 norm. Activations stay float32
// tensors holding bfloat16 values, so the input path and K9 are the
// float32 ones. A bfloat16 value is exact in TF32 and a product of two is
// exact in float32, so the tensor-core body forms one TF32 product a k8
// step (hi*hi, no split) from a one-part weight layout (1, 3, 3, C8, F8)
// of rounded taps, still into a zeroed accumulator added with an FP32 add;
// the A fragments are rounded as they are read (the input of every layer
// but the first already holds bfloat16 values). The C_in = 1 body rounds
// the image and the taps as it stages them; its 9 products are exact.
// Bound on the H100 for a C_in = F layer at KITTI: 68.7 GFLOP at F = 64
// (210 at F = 112), 0.069 ms at the 989 TFLOP/s of dense bfloat16 but
// 0.139 ms at the 495 TFLOP/s of TF32, which this body's products run at,
// against 477 MB of float32 in and out (834 at F = 112), 0.142 ms at 3.35
// TB/s: bytes bound the function; the TF32 rate comes close to bounding
// this body.
//
// K9 replaces mccnn_volume_pallas (_mccnn_vol_kernel), mccnn_volume_mxu_
// pallas (_mccnn_vol_mxu_kernel), mccnn_volume_flat_pallas
// (_mccnn_vol_flat_kernel, _gram_band_body) and the volume half of
// mccnn_fused_volume_pallas: three layouts of one function,
//   vol[i, y, x] = scale * (1 - sum_f fl[f, y, x] * fr[f, y, x - d]) * 0.5
// with d = min_d + i, and exactly INVALID = 1e4 where x < d, for any F,
// any D and any min_d >= 0 (models/mccnn.py:143-150).
//
// Bound on the H100: the features read once and the volume written once
// (238 + 238 MB at KITTI D=128, F=64: 0.142 ms at 3.35 TB/s) against
// 2*F*D*H*W operations (7.6 GFLOP at F=64; 13.4 at F=112, 0.199 ms on the
// 67 TFLOP/s FP32 pipes, 0.081 ms as three TF32 products at 495 TFLOP/s).
// Design, the Gram band of the TPU kernels on Hopper's tensor cores:
// - A block owns one row y, 128 columns x and all D planes (a chunk of at
//   most 8 * NT - 15 planes at a time; one chunk up to D = 161). Features
//   are staged 16 channels at a time by cp.async into two buffers: the
//   left tile and the right window x0 - d0 - D + 1 ... x0 + 127 - d0 that
//   the planes need, out-of-frame samples and channels past F zero-filled
//   (the k8 padding), so a block reads each feature once.
// - Warp w owns the m16 tile of columns x0 + 16w ... + 15 and forms Gram
//   fragments G[x, j] = <fl(x), fr(j)> over the NT n8 tiles of j that hold
//   the band j = x - d: mma.sync m16n8k8 TF32 in 3xTF32 (lo*hi + hi*lo +
//   hi*hi, each operand split as it is read, by integer rounding), added
//   into each tile's accumulator. Tiles that hold no x >= d in the frame
//   are skipped, so the products are 8 * NT / D of the band (1.125 at
//   D = 128, 1.1 at D = 160) rather than the TPU shear's 2.
// - The epilogue writes scale * (1 - G) * 0.5, or 1e4 where j < 0, into a
//   (planes x 128) shared tile, each plane row shifted by its global
//   misalignment, so that a warp stores a plane row of the tile as aligned
//   16-byte vectors: 512 contiguous bytes (whole 128-B lines but at the
//   row's two ends).
// What holds it on the H100 is not the tensor cores: taking the products
// out of the loop saves little. The time goes to staging the operands
// (4-byte cp.async: rows of an odd-multiple-of-8-byte width are not
// 16-byte aligned), splitting each fragment as it is read, the epilogue,
// and the 238 MB of stores, which the two blocks of an SM, running in
// step, do not hide behind each other's products. Measured no faster:
// two m16 tiles a warp (fewer B splits), 24 warps an SM (64-column
// blocks), a persistent block with store warps, operands pre-split in
// shared memory, a Veltkamp split on the FP32 pipes, and wgmma m64nNk8
// with B pre-split K-major in shared memory (PERF.md, Findings).
// Shared-memory pitches (136 and 8 NT + 120 floats a channel, 132 a plane
// row) keep the fragment reads and the epilogue's writes free of bank
// conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kInvalid = 1e4f;

// float32 -> the nearest bfloat16 (ties to even), as a float32
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The layer's epilogue before ReLU: the sum plus the bias, in float32, or
// in the bfloat16 mode rounded, the rounded bias added and rounded again.
template <bool BF16>
__device__ __forceinline__ float add_bias(float acc, float b) {
  if (BF16) return bf16_round(bf16_round(acc) + bf16_round(b));
  return acc + b;
}

// ------------------------------------------------ K8, C_in = 1: FP32 ----

constexpr int kConvTH = 8;
constexpr int kConvTW = 32;
constexpr int kConvThreads = 256;
constexpr int kHaloH = kConvTH + 2;
constexpr int kHaloW = kConvTW + 2;
constexpr int kHaloSize = kHaloH * kHaloW;

// A thread owns one pixel and all FP >= F channels of it (FP a multiple of
// 4), so a warp writes 32 consecutive pixels of a channel: whole 128-B
// lines.
template <int FP, bool BF16>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ bias, float* __restrict__ y, int F,
               int H, int W, int relu, int normalize) {
  __shared__ float xs[kHaloSize];                // [kHaloH][kHaloW]
  __shared__ __align__(16) float ws[9 * FP];     // [9][FP]

  const int t = threadIdx.x;
  const int c = t & 31;         // tile column
  const int r = t >> 5;         // tile row
  const int ty0 = blockIdx.y * kConvTH;
  const int tx0 = blockIdx.x * kConvTW;
  const int view = blockIdx.z;
  const float* xv = x + (size_t)view * H * W;

  for (int i = t; i < kHaloSize; i += kConvThreads) {
    const int hy = i / kHaloW;
    const int gy = ty0 + hy - 1;
    const int gx = tx0 + i - hy * kHaloW - 1;
    const float v = gy >= 0 && gy < H && gx >= 0 && gx < W
                        ? xv[(size_t)gy * W + gx] : 0.f;
    xs[i] = BF16 ? bf16_round(v) : v;
  }
  for (int i = t; i < 9 * FP; i += kConvThreads) {
    const int f = i % FP;
    const float w = f < F ? taps[(size_t)(i / FP) * F + f] : 0.f;
    ws[i] = BF16 ? bf16_round(w) : w;
  }
  __syncthreads();

  float in[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) in[k] = xs[(r + k / 3) * kHaloW + c + k % 3];
  float acc[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) acc[f] = 0.f;
  const float4* wr = reinterpret_cast<const float4*>(ws);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int q = 0; q < FP / 4; ++q) {
      const float4 w4 = wr[k * (FP / 4) + q];   // the same for every lane
      acc[4 * q + 0] = fmaf(in[k], w4.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(in[k], w4.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(in[k], w4.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(in[k], w4.w, acc[4 * q + 3]);
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    float v = add_bias<BF16>(acc[f], f < F ? bias[f] : 0.f);
    if (relu) v = fmaxf(v, 0.f);
    acc[f] = v;
    ss = fmaf(v, v, ss);
  }
  const float norm = sqrtf(ss + 1e-12f);
  const int gy = ty0 + r;
  const int gx = tx0 + c;
  if (gy >= H || gx >= W) return;
  float* out = y + ((size_t)view * F * H + gy) * W + gx;
#pragma unroll
  for (int f = 0; f < FP; ++f)
    if (f < F) out[(size_t)f * H * W] = normalize ? acc[f] / norm : acc[f];
}

template <int FP, bool BF16>
int launch_conv3x3(const float* x, const float* taps, const float* bias,
                   float* y, int V, int F, int H, int W, int relu,
                   int normalize, cudaStream_t stream) {
  dim3 grid((W + kConvTW - 1) / kConvTW, (H + kConvTH - 1) / kConvTH, V);
  conv3x3_kernel<FP, BF16><<<grid, kConvThreads, 0, stream>>>(
      x, taps, bias, y, F, H, W, relu, normalize);
  return (int)cudaGetLastError();
}

// ---------------------------------------------- K8, C_in > 1: 3xTF32 ----

constexpr int kTcTH = 8;                  // tile rows: one warp each
constexpr int kTcTW = 32;                 // tile columns: two m16 tiles
constexpr int kTcThreads = 32 * kTcTH;
constexpr int kTcCC = 8;                  // input channels a stage (k8)
constexpr int kTcHaloW = kTcTW + 2;
constexpr int kTcHaloH = kTcTH + 2;
constexpr int kTcHaloPitch = 344;         // >= 10 * 34; 24 banks apart

__device__ inline void cp_async4_zfill(float* smem, const float* gmem,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ inline void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ inline void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT n8 tiles: the block covers F8 = 8 * NT output channels; NS warps
// share a tile row, each taking NT / NS of the n8 tiles (more warps an SM
// where one block fills it). BF16: one TF32 product of bfloat16 operands a
// k8 step, from a one-part weight layout.
template <int NT, int NS, bool BF16>
__global__ void __launch_bounds__(kTcThreads * NS)
conv3x3_tf32x3_kernel(const float* __restrict__ x,
                      const float* __restrict__ packed,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int C_in, int C8, int F, int H, int W, int relu,
                      int normalize) {
  constexpr int F8 = 8 * NT;
  constexpr int NW = NT / NS;             // n8 tiles a warp
  constexpr int THREADS = kTcThreads * NS;
  constexpr int FP = F8 + 8;              // weight row pitch: 8 banks apart
  constexpr int PARTS = BF16 ? 1 : 2;     // weight parts: hi (and lo)
  constexpr int XSTAGE = kTcCC * kTcHaloPitch;
  constexpr int STAGE = XSTAGE + PARTS * 9 * kTcCC * FP;
  static_assert(NT % NS == 0, "the warps of a row split the n8 tiles");
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) % kTcTH;   // tile row
  const int nh = (threadIdx.x >> 5) / kTcTH;    // this warp's share of F8
  const int g = lane >> 2;                // mma groupID
  const int t = lane & 3;                 // thread in group
  const int ty0 = blockIdx.y * kTcTH;
  const int tx0 = blockIdx.x * kTcTW;
  const int view = blockIdx.z;
  const float* xv = x + (size_t)view * C_in * H * W;

  auto stage = [&](int chunk, float* buf) {
    const int c0 = chunk * kTcCC;
    for (int i = threadIdx.x; i < kTcCC * kTcHaloH * kTcHaloW; i += THREADS) {
      const int ci = i / (kTcHaloH * kTcHaloW);
      const int rem = i - ci * (kTcHaloH * kTcHaloW);
      const int hy = rem / kTcHaloW;
      const int hx = rem - hy * kTcHaloW;
      const int gy = ty0 + hy - 1;
      const int gx = tx0 + hx - 1;
      const bool ok = c0 + ci < C_in && gy >= 0 && gy < H && gx >= 0 &&
                      gx < W;
      cp_async4_zfill(buf + ci * kTcHaloPitch + hy * kTcHaloW + hx,
                      ok ? xv + ((size_t)(c0 + ci) * H + gy) * W + gx : xv,
                      ok ? 4 : 0);
    }
    // weight rows (part, tap, ci) of F8 floats, 16 B at a time
    float* wb = buf + XSTAGE;
    for (int i = threadIdx.x; i < PARTS * 9 * kTcCC * (F8 / 4);
         i += THREADS) {
      const int r = i / (F8 / 4);
      const int q = i - r * (F8 / 4);
      const int pt = r / kTcCC;           // part * 9 + tap
      const int ci = r - pt * kTcCC;
      cp_async16(wb + r * FP + q * 4,
                 packed + ((size_t)pt * C8 + c0 + ci) * F8 + q * 4);
    }
  };

  float acc[2][NW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  const int chunks = C8 / kTcCC;
  stage(0, smem);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) stage(ch + 1, smem + ((ch + 1) & 1) * STAGE);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();                      // stage ch has landed
    const float* xs = smem + (ch & 1) * STAGE;
    const float* ws = xs + XSTAGE;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
      if (BF16) {
        uint32_t ab[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* a = xs + t * kTcHaloPitch + (row + ky) * kTcHaloW +
                           mt * 16 + g + kx;
          ab[mt][0] = __float_as_uint(bf16_round(a[0]));
          ab[mt][1] = __float_as_uint(bf16_round(a[8]));
          ab[mt][2] = __float_as_uint(bf16_round(a[4 * kTcHaloPitch]));
          ab[mt][3] = __float_as_uint(bf16_round(a[4 * kTcHaloPitch + 8]));
        }
        const float* wb = ws + (tap * kTcCC + t) * FP + nh * NW * 8 + g;
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          const uint32_t b0 = __float_as_uint(wb[n * 8]);
          const uint32_t b1 = __float_as_uint(wb[4 * FP + n * 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, ab[mt], b0, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[e];
          }
        }
        continue;
      }
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = xs + t * kTcHaloPitch + (row + ky) * kTcHaloW +
                         mt * 16 + g + kx;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8], ah[mt][1], al[mt][1]);
        split_tf32(a[4 * kTcHaloPitch], ah[mt][2], al[mt][2]);
        split_tf32(a[4 * kTcHaloPitch + 8], ah[mt][3], al[mt][3]);
      }
      const float* whi = ws + (tap * kTcCC + t) * FP + nh * NW * 8 + g;
      const float* wlo = whi + 9 * kTcCC * FP;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const uint32_t bh0 = __float_as_uint(whi[n * 8]);
        const uint32_t bh1 = __float_as_uint(whi[4 * FP + n * 8]);
        const uint32_t bl0 = __float_as_uint(wlo[n * 8]);
        const uint32_t bl1 = __float_as_uint(wlo[4 * FP + n * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, al[mt], bh0, bh1);
          mma_tf32(part, ah[mt], bl0, bl1);
          mma_tf32(part, ah[mt], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[e];
        }
      }
    }
    __syncthreads();                      // stage ch may be overwritten
  }

  // c0, c1: pixel g, channels 2t, 2t + 1; c2, c3: pixel g + 8. Bias and
  // ReLU, and each pixel's sum of squares over this warp's channels (the
  // four lanes of a quad; across the NS warps of a row in shared memory).
  float ss[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = (nh * NW + n) * 8 + 2 * t + e;
          float v = add_bias<BF16>(acc[mt][n][2 * half + e],
                                   f < F ? bias[f] : 0.f);
          if (relu) v = fmaxf(v, 0.f);
          acc[mt][n][2 * half + e] = v;
          sum = fmaf(v, v, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      ss[mt][half] = sum;
    }
  }
  if (normalize && NS > 1) {
    float* red = smem;                    // [NS][kTcTH][kTcTW], stages done
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (t == 0)
          red[(nh * kTcTH + row) * kTcTW + mt * 16 + g + 8 * half] =
              ss[mt][half];
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float sum = 0.f;
        for (int h = 0; h < NS; ++h)
          sum += red[(h * kTcTH + row) * kTcTW + mt * 16 + g + 8 * half];
        ss[mt][half] = sum;
      }
  }
  const int gy = ty0 + row;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float norm = normalize ? sqrtf(ss[mt][half] + 1e-12f) : 1.f;
      const int gx = tx0 + mt * 16 + g + 8 * half;
      if (gy >= H || gx >= W) continue;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = (nh * NW + n) * 8 + 2 * t + e;
          if (f < F) {
            const float v = acc[mt][n][2 * half + e];
            y[(((size_t)view * F + f) * H + gy) * W + gx] =
                normalize ? v / norm : v;
          }
        }
      }
    }
  }
}

template <int NT, int NS, bool BF16>
int launch_tf32x3(const float* x, const float* packed, const float* bias,
                  float* y, int V, int C_in, int F, int H, int W, int relu,
                  int normalize, cudaStream_t stream) {
  constexpr int FP = 8 * NT + 8;
  constexpr int PARTS = BF16 ? 1 : 2;
  const size_t smem = 2 * (size_t)(kTcCC * kTcHaloPitch +
                                   PARTS * 9 * kTcCC * FP) * sizeof(float);
  // The attribute belongs to the current device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_tf32x3_kernel<NT, NS, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int C8 = (C_in + kTcCC - 1) / kTcCC * kTcCC;
  dim3 grid((W + kTcTW - 1) / kTcTW, (H + kTcTH - 1) / kTcTH, V);
  conv3x3_tf32x3_kernel<NT, NS, BF16>
      <<<grid, kTcThreads * NS, smem, stream>>>(
      x, packed, bias, y, C_in, C8, F, H, W, relu, normalize);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K9 ----

constexpr int kVolTX = 128;                 // columns a block: 8 m16 tiles
constexpr int kVolWarps = 8;                // a warp an m16 tile
constexpr int kVolThreads = 32 * kVolWarps;
constexpr int kVolFC = 16;                  // feature channels a stage
constexpr int kVolPA = kVolTX + 8;          // left pitch: 8 banks a channel
constexpr int kVolPO = kVolTX + 4;          // plane row pitch, 4 banks

// NT n8 tiles a warp: chunks of up to 8 NT - 15 planes; the right window of
// a chunk spans 112 + 8 NT columns (NT even keeps its pitch 8 banks apart).
template <int NT>
struct VolShape {
  static_assert(NT % 2 == 0, "the right pitch must be 8 banks apart");
  static constexpr int kMaxDC = 8 * NT - 15;
  static constexpr int kPB = kVolTX - 16 + 8 * NT + 8;
  static constexpr int kStage = kVolFC * (kVolPA + kPB);
  static constexpr int kFeat = 2 * kStage;
  static constexpr int kOut = kMaxDC * kVolPO;
  static constexpr int kFloats = kFeat > kOut ? kFeat : kOut;
};

// x -> (hi, lo): hi = tf32(x), lo = tf32(x - hi), rounded to nearest, ties
// away from zero: the bits of cvt.rna.tf32.f32 and of
// cuda_kernels.tf32_split, in integer operations (the conversion was
// slower; the tensor core ignores the 13 low bits, so the mask of lo
// compiles away).
__device__ __forceinline__ void tf32_pair(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// One k8 step of a warp's band: the A fragment of its m16 tile against the
// NT n8 tiles of the right window from b, each operand split as it is read
// (tf32_pair), lo*hi + hi*lo + hi*hi added into the tile's accumulator.
// GUARD skips the tiles past ntn, those whose j all lie left of the frame
// (x < d: 1e4 without a product) and those whose j all lie right of it
// (x >= W); without it every tile runs, so the chains of different tiles
// interleave.
template <int NT, bool GUARD>
__device__ __forceinline__ void band_step(float (&acc)[NT][4],
                                          const uint32_t* ah,
                                          const uint32_t* al, const float* b,
                                          int jw, int ntn, int W) {
  constexpr int PB = VolShape<NT>::kPB;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (GUARD && (n >= ntn || jw + 8 * n + 7 < 0 || jw + 8 * n >= W))
      continue;
    uint32_t bh0, bl0, bh1, bl1;
    tf32_pair(b[8 * n], bh0, bl0);
    tf32_pair(b[4 * PB + 8 * n], bh1, bl1);
    mma_tf32(acc[n], al, bh0, bh1);
    mma_tf32(acc[n], ah, bl0, bl1);
    mma_tf32(acc[n], ah, bh0, bh1);
  }
}

template <int NT>
__global__ void __launch_bounds__(kVolThreads, 2)
mccnn_volume_kernel(const float* __restrict__ fl,
                    const float* __restrict__ fr, float* __restrict__ out,
                    int F, int H, int W, int D, int min_d, int DC,
                    float scale) {
  using S = VolShape<NT>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;                  // mma groupID
  const int t = lane & 3;                   // thread in group
  const int x0 = blockIdx.x * kVolTX;
  const int y = blockIdx.y;
  const int xa = x0 + 16 * warp;            // this warp's m16 tile
  const bool busy = xa < W;
  const int ncols = min(kVolTX, W - x0);
  const size_t plane = (size_t)H * W;
  const float* flr = fl + (size_t)y * W;
  const float* frr = fr + (size_t)y * W;
  const int nfc = (F + kVolFC - 1) / kVolFC;

  for (int c0 = 0; c0 < D; c0 += DC) {
    const int dc = min(DC, D - c0);         // planes of this chunk
    const int d0 = min_d + c0;
    const int ntn = (dc + 22) >> 3;         // n8 tiles: dc + 15 columns
    const int js = x0 - d0 - dc + 1;        // window column 0
    const int wcols = kVolTX - 16 + 8 * ntn;
    const int jw = xa - d0 - dc + 1;        // this warp's first j
    // every tile holds products this warp needs: x >= d, x < W
    const bool full = ntn == NT && jw >= 0 && xa + 16 <= W;

    // channel rows f0 .. f0 + 15 of the left tile and the right window
    // (zero outside the frame and past F: the k8 padding)
    auto stage = [&](int fc, float* buf) {
      for (int r = warp; r < kVolFC; r += kVolWarps) {
        const int f = fc * kVolFC + r;
        const bool fok = f < F;
        const float* lrow = flr + (fok ? f : 0) * plane;
        const float* rrow = frr + (fok ? f : 0) * plane;
        float* ls = buf + r * kVolPA;
        float* rs = buf + kVolFC * kVolPA + r * S::kPB;
        for (int c = lane; c < kVolTX; c += 32) {
          const bool ok = fok && c < ncols;
          cp_async4_zfill(ls + c, ok ? lrow + x0 + c : fl, ok ? 4 : 0);
        }
        for (int c = lane; c < wcols; c += 32) {
          const int j = js + c;
          const bool ok = fok && j >= 0 && j < W;
          cp_async4_zfill(rs + c, ok ? rrow + j : fr, ok ? 4 : 0);
        }
      }
    };

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    stage(0, smem);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int fc = 0; fc < nfc; ++fc) {
      if (fc + 1 < nfc) stage(fc + 1, smem + ((fc + 1) & 1) * S::kStage);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();                      // stage fc has landed
      const float* ls = smem + (fc & 1) * S::kStage;
      const float* rs = ls + kVolFC * kVolPA;
      if (busy) {
#pragma unroll
        for (int k = 0; k < kVolFC; k += 8) {
          uint32_t ah[4], al[4];
          const float* a = ls + (k + t) * kVolPA + 16 * warp + g;
          tf32_pair(a[0], ah[0], al[0]);
          tf32_pair(a[8], ah[1], al[1]);
          tf32_pair(a[4 * kVolPA], ah[2], al[2]);
          tf32_pair(a[4 * kVolPA + 8], ah[3], al[3]);
          const float* b = rs + (k + t) * S::kPB + 16 * warp + g;
          if (full)
            band_step<NT, false>(acc, ah, al, b, jw, ntn, W);
          else
            band_step<NT, true>(acc, ah, al, b, jw, ntn, W);
        }
      }
      __syncthreads();                      // stage fc may be overwritten
    }

    // c0, c1: column xa + g, j = jb + 2t, + 1; c2, c3: column xa + g + 8.
    // Plane i = x - j - d0 of the chunk; its row in `st` is shifted by the
    // global row's misalignment, so st[i][4v] meets a 16-B boundary.
    float* st = smem;
    if (busy) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= ntn) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int xl = 16 * warp + g + 8 * (e >> 1);
          const int j = jw + 8 * n + 2 * t + (e & 1);
          const int i = x0 + xl - j - d0;
          if (i >= 0 && i < dc) {
            const unsigned sh =
                (((unsigned)(c0 + i) * (unsigned)H + y) * (unsigned)W) & 3u;
            st[i * kVolPO + xl + sh] =
                j < 0 ? kInvalid : scale * (1.f - acc[n][e]) * 0.5f;
          }
        }
      }
    }
    __syncthreads();
    for (int i = warp; i < dc; i += kVolWarps) {
      const size_t row = ((size_t)(c0 + i) * H + y) * W + x0;
      const int sh = (int)(row & 3);
      float* dst = out + (row - sh);        // 16-B aligned
      const float* src = st + i * kVolPO;
      const int nvec = (ncols + sh + 3) >> 2;
      for (int v = lane; v < nvec; v += 32) {
        const float4 q = *reinterpret_cast<const float4*>(src + 4 * v);
        const int xl = 4 * v - sh;          // tile column of q.x
        if (xl >= 0 && xl + 4 <= ncols) {
          *reinterpret_cast<float4*>(dst + 4 * v) = q;
        } else {
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (xl + k >= 0 && xl + k < ncols) dst[4 * v + k] = qv[k];
        }
      }
    }
    __syncthreads();                        // st is the next chunk's stage
  }
}

template <int NT>
int launch_volume(const float* fl, const float* fr, float* out, int F, int H,
                  int W, int D, int min_d, int DC, float scale,
                  cudaStream_t stream) {
  const size_t smem = (size_t)VolShape<NT>::kFloats * sizeof(float);
  // The attribute belongs to the current device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      mccnn_volume_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kVolTX - 1) / kVolTX, H);
  mccnn_volume_kernel<NT><<<grid, kVolThreads, smem, stream>>>(
      fl, fr, out, F, H, W, D, min_d, DC, scale);
  return (int)cudaGetLastError();
}

// One K8 layer: the body chosen by C_in, the tile of output channels by F.
template <bool BF16>
int conv3x3(const float* x, const float* layout, const float* bias, float* y,
            int V, int C_in, int F, int H, int W, int relu, int normalize,
            cudaStream_t st) {
  if (C_in > 1) {
    if (F <= 32)
      return launch_tf32x3<4, 1, BF16>(x, layout, bias, y, V, C_in, F, H, W,
                                       relu, normalize, st);
    if (F <= 64)
      return launch_tf32x3<8, 1, BF16>(x, layout, bias, y, V, C_in, F, H, W,
                                       relu, normalize, st);
    if (F <= 112)
      return launch_tf32x3<14, 2, BF16>(x, layout, bias, y, V, C_in, F, H,
                                        W, relu, normalize, st);
    return launch_tf32x3<16, 2, BF16>(x, layout, bias, y, V, C_in, F, H, W,
                                      relu, normalize, st);
  }
  if (F <= 32)
    return launch_conv3x3<32, BF16>(x, layout, bias, y, V, F, H, W, relu,
                                    normalize, st);
  if (F <= 64)
    return launch_conv3x3<64, BF16>(x, layout, bias, y, V, F, H, W, relu,
                                    normalize, st);
  if (F <= 112)
    return launch_conv3x3<112, BF16>(x, layout, bias, y, V, F, H, W, relu,
                                     normalize, st);
  return launch_conv3x3<128, BF16>(x, layout, bias, y, V, F, H, W, relu,
                                   normalize, st);
}

}  // namespace

// x: (V, C_in, H, W); layout: K8's copy of the weights, chosen by C_in and
// bf16: for C_in = 1 the (3, 3, 1, F) taps (the flax kernel layout), for
// C_in > 1 the (2, 3, 3, C8, F8) TF32 hi and lo parts of the taps, or with
// bf16 the (1, 3, 3, C8, F8) taps rounded to bfloat16, C_in padded to C8 (a
// multiple of 8) and F to F8 (32, 64, 112 or 128) by zeros; bias: (F,);
// y: (V, F, H, W). F <= 128. bf16: the bfloat16 mode.
extern "C" int smt_mccnn_conv3x3(const float* x, const float* layout,
                                 const float* bias, float* y, int V, int C_in,
                                 int F, int H, int W, int relu, int normalize,
                                 int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F < 1 || F > 128 || C_in < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? conv3x3<true>(x, layout, bias, y, V, C_in, F, H, W, relu,
                              normalize, st)
              : conv3x3<false>(x, layout, bias, y, V, C_in, F, H, W, relu,
                               normalize, st);
}

// fl, fr: (F, H, W) features of the two views; out: (D, H, W). Any F, D,
// H, W >= 1 and min_d >= 0: the smallest even NT whose chunk holds all D
// planes (NT = D / 8 + 2 for a multiple of 16, every tile then needed),
// else NT = 22 and D split into equal chunks of at most 161 planes.
extern "C" int smt_mccnn_volume(const float* fl, const float* fr, float* out,
                                int F, int H, int W, int D, int min_d,
                                float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F < 1 || H < 1 || W < 1 || D < 1 || min_d < 0)
    return (int)cudaErrorInvalidValue;
#define SMT_VOLUME_NT(NT)                                                  \
  if (D <= VolShape<NT>::kMaxDC)                                           \
    return launch_volume<NT>(fl, fr, out, F, H, W, D, min_d, D, scale, st);
  SMT_VOLUME_NT(4) SMT_VOLUME_NT(6) SMT_VOLUME_NT(8) SMT_VOLUME_NT(10)
  SMT_VOLUME_NT(12) SMT_VOLUME_NT(14) SMT_VOLUME_NT(16) SMT_VOLUME_NT(18)
  SMT_VOLUME_NT(20)
#undef SMT_VOLUME_NT
  constexpr int kMax = VolShape<22>::kMaxDC;
  const int chunks = (D + kMax - 1) / kMax;
  return launch_volume<22>(fl, fr, out, F, H, W, D, min_d,
                           (D + chunks - 1) / chunks, scale, st);
}
