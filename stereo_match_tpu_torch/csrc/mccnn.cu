// K8 mccnn_conv3x3 and K9 mccnn_volume: the MC-CNN feature tower and its
// feature-dot cost volume, float32 (K8 also in a bfloat16 mode); K11
// mccnn_fused_volume: the tower's last layer, its norm and the volume in
// one launch.
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
// C_in > 1 (every layer but the first), float32: implicit GEMM on the
// tensor cores in 3xTF32. Bound on the H100: a KITTI frame (both 1242x375
// views) is 2*9*F*C_in*H*W*2 FLOP a layer, 69 GFLOP at F = 64 and 210 GFLOP at
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
// and, where two warps share the row, in shared memory. (TF32 wgmma takes
// B K-major from shared memory and A from registers or K-major shared
// memory; the NCHW halo tile is M-major for a tap, so this body is
// mma.sync fed from shared memory. The layer before K11 writes
// channels-last (out_cl), and K11 reads it K-major, 8 B a lane, and runs
// this arithmetic on wgmma, a zeroed partial a k8 step for F8 in halves of
// at most 64, 1.4 times faster than this form in the same kernel
// (PERF.md, Findings); K8 itself keeps this form.)
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
// The bfloat16 mode (the flax tower with compute_dtype bfloat16, and the
// Pallas tower's default compute_dtype) computes what
// cuda_kernels.mccnn_conv3x3_plain(..., bf16=True) does: the layer input
// and the weights rounded to bfloat16, their products summed in float32,
// the sum rounded to bfloat16, the bfloat16 bias added and the result
// rounded again, then ReLU or the float32 norm. It has its own entry,
// smt_mccnn_conv3x3_bf16, and stores what flax stores: every activation
// but the last layer's is bfloat16 channels-last, (V, H, W, C) (flax's
// NHWC; exact, the values are bfloat16); the last layer writes float32
// (V, F, H, W) for K9. The C_in = 1 body reads the float32 image, rounds
// it and the taps as it stages them (its 9 products are exact) and stores
// a pixel's F channels as 16-byte vectors.
// The C_in > 1 body runs on the bfloat16 tensor cores: the 8 x 32 pixel
// tile of the 3xTF32 body, a warp taking two tile rows (four m16 tiles)
// and F in n8 tiles (two warps splitting them at F > 64), K = 9 taps x C16
// (C_in padded to 16) in steps of 16 channels of one tap,
// mma.sync.m16n8k16 bf16 with float32 accumulators. Each k16 step goes
// into a zeroed accumulator and is added to the total with a rounded
// float32 add: chained over all of K, the tensor core's truncating
// accumulation put outputs near zero, where the sums cancel, past the ulp
// bound of the card checks (two card tests at F = 112 and 128), and three
// taps a partial sum held 48 more registers of A fragments, spilled and
// ran slower (PERF.md, Findings, PR 16). Two tile rows a warp hold 4 x
// NW x 4 accumulators at up to 255 registers; one row a warp at two
// blocks an SM spilled at 128. A stage is 16 channels of
// the 10 x 34 halo, staged channels-last by 16-byte cp.async (zero-filled
// outside the frame and past C_in: the SAME and k16 padding), and of the
// 9 x F8 rows of the (9, F8, C16) K-major bfloat16 weights
// (cuda_kernels.mccnn_pack_weights_bf16), in two buffers (three above
// F = 64, where one block fills the SM); the pitch of a
// staged pixel or weight row is 48 B, an odd number of 16-B units, so the
// 8 rows of an ldmatrix fall in distinct banks. A comes by ldmatrix.x4, a
// lane's row one pixel's 8 channels: a tap (ky, kx) moves it by ky halo
// rows and kx pixels, so all nine taps read one staged halo, with no
// re-layout and no rounding; B by ldmatrix.x4, two n8 tiles at a time.
// The epilogue adds the bias (rounded once), rounds, applies ReLU, writes
// the tile to shared memory as packed bfloat16 pairs and stores each
// pixel's F channels as 16-byte vectors (128 contiguous bytes a pixel at
// F = 64: whole lines), or, for the last layer, takes the float32 norm
// (quad shuffles, shared memory where two warps split F) and stores
// float32 (V, F, H, W). Limits: F <= 128, any C_in, V, H, W >= 1 (an input
// whose C_in is not a multiple of 8 is staged 2 B at a time, an output
// whose F is not stored 2 B at a time).
// Bound on the H100 for a C_in = F layer at KITTI (both views): 68.7 GFLOP
// at F = 64 (210.3 at F = 112), 0.069 (0.213) ms at the 989 TFLOP/s of
// dense bfloat16, against 238.5 MB of bfloat16 in and out (417.3 at
// F = 112), 0.071 (0.125) ms at 3.35 TB/s; the last layer writes float32,
// 357.7 MB (0.107 ms). With float32 storage it read and wrote 477 MB
// (0.142 ms). The wgmma form below (probe only) takes A from a no-swizzle
// K-major layout whose start a kx shift keeps 16-B aligned; it measured no
// faster than this body's chained form (PERF.md, Findings, PR 16).
//
// K9 replaces mccnn_volume_pallas (_mccnn_vol_kernel), mccnn_volume_mxu_
// pallas (_mccnn_vol_mxu_kernel) and mccnn_volume_flat_pallas
// (_mccnn_vol_flat_kernel, _gram_band_body): three layouts of one
// function,
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kInvalid = 1e4f;

// float32 -> the nearest bfloat16 (ties to even), as a float32
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bits of the nearest bfloat16 to v; two of them in one word, lo first
// (the lower address: channel f, then f + 1).
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
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
// 8), so a warp writes 32 consecutive pixels of a channel: whole 128-B
// lines. OUT_BF16 (the bfloat16 mode's layers before the last, no norm):
// y is bfloat16 channels-last, (V, H, W, F), and the thread stores its
// pixel's F contiguous channels, 16 B (8 channels) at a time where vec_out
// (F a multiple of 8, y 16-B aligned), else 2 B at a time. out_cl (float32,
// when K11 reads the output): y is float32 channels-last, (V, H, W, F),
// stored 16 B at a time where vec_out, else 4 B at a time.
template <int FP, bool BF16, bool OUT_BF16>
__global__ void __launch_bounds__(kConvThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ bias, void* __restrict__ y, int F,
               int H, int W, int relu, int normalize, int vec_out,
               int out_cl) {
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
  if (OUT_BF16) {
    uint16_t* out = static_cast<uint16_t*>(y) +
                    (((size_t)view * H + gy) * W + gx) * F;
    if (vec_out) {
#pragma unroll
      for (int q = 0; q < FP / 8; ++q)
        if (8 * q < F)
          *reinterpret_cast<uint4*>(out + 8 * q) = make_uint4(
              pack_bf16x2(acc[8 * q], acc[8 * q + 1]),
              pack_bf16x2(acc[8 * q + 2], acc[8 * q + 3]),
              pack_bf16x2(acc[8 * q + 4], acc[8 * q + 5]),
              pack_bf16x2(acc[8 * q + 6], acc[8 * q + 7]));
    } else {
#pragma unroll
      for (int f = 0; f < FP; ++f)
        if (f < F) out[f] = bf16_bits(acc[f]);
    }
    return;
  }
  if (out_cl) {
    float* out =
        static_cast<float*>(y) + (((size_t)view * H + gy) * W + gx) * F;
#pragma unroll
    for (int q = 0; q < FP / 4; ++q) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = normalize ? acc[4 * q + k] / norm : acc[4 * q + k];
      if (vec_out && 4 * q < F) {
        *reinterpret_cast<float4*>(out + 4 * q) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else if (!vec_out) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * q + k < F) out[4 * q + k] = v[k];
      }
    }
    return;
  }
  float* out = static_cast<float*>(y) + ((size_t)view * F * H + gy) * W + gx;
#pragma unroll
  for (int f = 0; f < FP; ++f)
    if (f < F) out[(size_t)f * H * W] = normalize ? acc[f] / norm : acc[f];
}

template <int FP, bool BF16, bool OUT_BF16>
int launch_conv3x3(const float* x, const float* taps, const float* bias,
                   void* y, int V, int F, int H, int W, int relu,
                   int normalize, int vec_out, int out_cl,
                   cudaStream_t stream) {
  dim3 grid((W + kConvTW - 1) / kConvTW, (H + kConvTH - 1) / kConvTH, V);
  conv3x3_kernel<FP, BF16, OUT_BF16><<<grid, kConvThreads, 0, stream>>>(
      x, taps, bias, y, F, H, W, relu, normalize, vec_out, out_cl);
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
// where one block fills it). CL: y is float32 channels-last, (V, H, W, F),
// a lane's two channels of a pixel stored as one 8-B pair (F even), so a
// warp's store is 32 contiguous bytes of each of 8 pixels, the sectors an
// NCHW store writes; K11 reads it 32 B a pixel. (A template, so that the
// NCHW layers keep their code: a run-time flag slowed them by 6 % at
// F = 64, tools/frame_probe.py.)
template <int NT, int NS, bool CL>
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
  constexpr int XSTAGE = kTcCC * kTcHaloPitch;
  constexpr int STAGE = XSTAGE + 2 * 9 * kTcCC * FP;
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
    for (int i = threadIdx.x; i < 2 * 9 * kTcCC * (F8 / 4);
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
          float v = add_bias<false>(acc[mt][n][2 * half + e],
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
      if (CL) {
        float* ycl = y + (((size_t)view * H + gy) * W + gx) * F;
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          const int f0 = (nh * NW + n) * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc[mt][n][2 * half + e];
            v[e] = normalize ? a / norm : a;
          }
          if (F % 2 == 0) {
            if (f0 < F)
              *reinterpret_cast<float2*>(ycl + f0) = make_float2(v[0], v[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (f0 + e < F) ycl[f0 + e] = v[e];
          }
        }
        continue;
      }
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

template <int NT, int NS>
int launch_tf32x3(const float* x, const float* packed, const float* bias,
                  float* y, int V, int C_in, int F, int H, int W, int relu,
                  int normalize, int out_cl, cudaStream_t stream) {
  constexpr int FP = 8 * NT + 8;
  const size_t smem = 2 * (size_t)(kTcCC * kTcHaloPitch +
                                   2 * 9 * kTcCC * FP) * sizeof(float);
  auto kernel = out_cl ? conv3x3_tf32x3_kernel<NT, NS, true>
                       : conv3x3_tf32x3_kernel<NT, NS, false>;
  // The attribute belongs to the current device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int C8 = (C_in + kTcCC - 1) / kTcCC * kTcCC;
  dim3 grid((W + kTcTW - 1) / kTcTW, (H + kTcTH - 1) / kTcTH, V);
  kernel<<<grid, kTcThreads * NS, smem, stream>>>(
      x, packed, bias, y, C_in, C8, F, H, W, relu, normalize);
  return (int)cudaGetLastError();
}

// ------------------------------------ K8 bfloat16, C_in > 1: bf16 mma ----

constexpr int kTcHalo = kTcHaloH * kTcHaloW;   // 340 halo pixels
constexpr int kBfKC = 16;                // input channels a stage: one k16
constexpr int kBfPitch = kBfKC + 8;      // a staged row: 48 B, an odd count
                                         // of 16-B units (ldmatrix rows in
                                         // distinct banks)

// Ablations of the probe entry (tools/k8_probe.py): each bit takes one part
// of the bfloat16 body out, to split its time.
constexpr int kAblStage = 1;      // no staging copies
constexpr int kAblProducts = 2;   // no ldmatrix, no mma
constexpr int kAblEpilogue = 4;   // no bias, rounding or ReLU
constexpr int kAblStores = 8;     // no stores to device memory

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d = a b (a zero accumulator)
__device__ __forceinline__ void mma_bf16_zero(float* d, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
struct Bf16Stage {                 // bf16 elements of a stage
  static constexpr int kSize = (kTcHalo + 9 * 8 * NT) * kBfPitch;
};

// The block's tile as in the 3xTF32 body (8 x 32 pixels); a warp takes RW
// tile rows, two m16 tiles each, and NT / NS of the n8 tiles (NS warps
// share its rows). Two blocks share an SM where their stages fit.
// x: bfloat16 channels-last (V, H, W, C_in); wl: the bfloat16
// (9, F8, C16) layout; y: bfloat16 channels-last (V, H, W, F) for OUT_BF16,
// else float32 (V, F, H, W). vec_in: C_in a multiple of 8 and x 16-B
// aligned (a pixel's 8-channel groups are 16-B copies), else the halo is
// staged 2 B at a time; vec_out likewise for F and y.
template <int NT, int ST>
struct Bf16Blocks {                // blocks an SM: two where two fit
  static constexpr int kCount =
      2 * ST * Bf16Stage<NT>::kSize <= 114688 ? 2 : 1;
};

template <int NT, int NS, int RW, int ST, int CHAIN, bool OUT_BF16,
          int ABL>
__global__ void __launch_bounds__(kTcThreads * NS / RW,
                                  Bf16Blocks<NT, ST>::kCount)
conv3x3_bf16_kernel(const uint16_t* __restrict__ x,
                    const uint16_t* __restrict__ wl,
                    const float* __restrict__ bias, void* __restrict__ y,
                    int C_in, int C16, int F, int H, int W, int relu,
                    int normalize, int vec_in, int vec_out) {
  constexpr int F8 = 8 * NT;
  constexpr int NW = NT / NS;             // n8 tiles a warp
  constexpr int RWARPS = kTcTH / RW;      // warps down the tile
  constexpr int THREADS = 32 * RWARPS * NS;
  constexpr int XSTAGE = kTcHalo * kBfPitch;
  constexpr int STAGE = Bf16Stage<NT>::kSize;
  static_assert(NT % NS == 0, "the warps of a row split the n8 tiles");
  static_assert(kTcTH % RW == 0, "a warp's rows divide the tile");
  extern __shared__ __align__(16) uint16_t sm16[];
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) % RWARPS * RW;   // first tile row
  const int nh = (threadIdx.x >> 5) / RWARPS;   // this warp's share of F8
  const int g = lane >> 2;                // mma groupID
  const int t = lane & 3;                 // thread in group
  const int ty0 = blockIdx.y * kTcTH;
  const int tx0 = blockIdx.x * kTcTW;
  const int view = blockIdx.z;
  const uint16_t* xv = x + (size_t)view * H * W * C_in;

  // stage `chunk`: channels c0 ... c0 + 15 of the 10 x 34 halo, pixel p's
  // at buf[p * kBfPitch], zero outside the frame and past C_in (the SAME
  // padding and the k16 padding), and of the 9 x F8 weight rows
  auto stage = [&](int chunk, uint16_t* buf) {
    if (ABL & kAblStage) return;
    const int c0 = chunk * kBfKC;
    if (vec_in) {
      for (int i = threadIdx.x; i < kTcHalo * 2; i += THREADS) {
        const int p = i >> 1;
        const int c = c0 + 8 * (i & 1);
        const int hy = p / kTcHaloW;
        const int gy = ty0 + hy - 1;
        const int gx = tx0 + p - hy * kTcHaloW - 1;
        const bool ok = c < C_in && gy >= 0 && gy < H && gx >= 0 && gx < W;
        cp_async16_zfill(buf + p * kBfPitch + 8 * (i & 1),
                         ok ? xv + ((size_t)gy * W + gx) * C_in + c : xv,
                         ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kTcHalo * kBfKC; i += THREADS) {
        const int p = i / kBfKC;
        const int c = c0 + i - p * kBfKC;
        const int hy = p / kTcHaloW;
        const int gy = ty0 + hy - 1;
        const int gx = tx0 + p - hy * kTcHaloW - 1;
        const bool ok = c < C_in && gy >= 0 && gy < H && gx >= 0 && gx < W;
        buf[p * kBfPitch + c - c0] =
            ok ? __ldg(xv + ((size_t)gy * W + gx) * C_in + c) : 0;
      }
    }
    uint16_t* wb = buf + XSTAGE;
    for (int i = threadIdx.x; i < 9 * F8 * 2; i += THREADS)
      cp_async16_zfill(wb + (i >> 1) * kBfPitch + 8 * (i & 1),
                       wl + (size_t)(i >> 1) * C16 + c0 + 8 * (i & 1), 16);
  };

  float acc[2 * RW][NW][4];               // m16 tile 2 r + mt: row0 + r
#pragma unroll
  for (int mt = 0; mt < 2 * RW; ++mt)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  // This lane's ldmatrix rows, in bf16 elements from the stage. A (x4):
  // pixel lane & 15 of an m16 tile, channels 8 (lane >> 4) ... + 7, so
  // a0..a3 = (pixels 0-7 | 8-15) x (channels 0-7 | 8-15). B (x4): output
  // 8 (lane >> 4) + (lane & 7) of an n8 pair, channels 8 ((lane >> 3) & 1)
  // ... + 7, so b0, b1 of the pair's first tile, then of its second. A tap
  // (ky, kx) moves A by ky halo rows and kx pixels, B by tap * F8 rows.
  const unsigned a_lane = (row0 * kTcHaloW + (lane & 15)) * kBfPitch +
                          8 * (lane >> 4);
  const unsigned b_lane = XSTAGE +
                          (nh * NW * 8 + 8 * (lane >> 4) + (lane & 7)) *
                              kBfPitch + 8 * ((lane >> 3) & 1);
  // ST buffers: chunk ch + ST - 1 is copied while chunk ch is multiplied
  const int chunks = C16 / kBfKC;
  const unsigned base = (unsigned)__cvta_generic_to_shared(sm16);
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < chunks) stage(c, sm16 + c * STAGE);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + ST - 1 < chunks)
      stage(ch + ST - 1, sm16 + (ch + ST - 1) % ST * STAGE);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(ST - 1));
    __syncthreads();                      // stage ch has landed
    if (!(ABL & kAblProducts)) {
      const unsigned buf = base + 2u * (ch % ST) * STAGE;
      // taps in groups of G: CHAIN = 0 chains every k16 step through the
      // tensor-core accumulator; else the G = CHAIN taps of a group go
      // into a zeroed one, added to acc with a rounded float32 add
      constexpr int G = CHAIN == 0 ? 1 : CHAIN;
      static_assert(9 % G == 0, "tap groups divide the 9 taps");
#pragma unroll
      for (int t0 = 0; t0 < 9; t0 += G) {
        uint32_t a[G][2 * RW][4];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int ky = (t0 + j) / 3;
          const int kx = t0 + j - 3 * ky;
#pragma unroll
          for (int mt = 0; mt < 2 * RW; ++mt)
            ldmatrix_x4(a[j][mt],
                        buf + 2u * (a_lane + ((ky + mt / 2) * kTcHaloW + kx +
                                              16 * (mt & 1)) * kBfPitch));
        }
#pragma unroll
        for (int n = 0; n < NW; n += 2) {
          uint32_t b[G][4];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const unsigned addr =
                buf + 2u * (b_lane + ((t0 + j) * F8 + 8 * n) * kBfPitch);
            if (n + 1 < NW) ldmatrix_x4(b[j], addr);
            else ldmatrix_x2(b[j], addr);
          }
#pragma unroll
          for (int mt = 0; mt < 2 * RW; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (n + h >= NW) continue;
              if (CHAIN == 0) {
                mma_bf16(acc[mt][n + h], a[0][mt], b[0][2 * h],
                         b[0][2 * h + 1]);
                continue;
              }
              float p[4];
              mma_bf16_zero(p, a[0][mt], b[0][2 * h], b[0][2 * h + 1]);
#pragma unroll
              for (int j = 1; j < G; ++j)
                mma_bf16(p, a[j][mt], b[j][2 * h], b[j][2 * h + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][n + h][e] += p[e];
            }
          }
        }
      }
    }
    __syncthreads();                      // stage ch may be overwritten
  }

  // c0, c1: pixel g, channels 2t, 2t + 1; c2, c3: pixel g + 8 (of m16
  // tile mt: tile row row0 + mt / 2, columns 16 (mt & 1) on). The sum
  // rounded, the bias (rounded once) added and rounded, ReLU; each pixel's
  // sum of squares over this warp's channels for the norm.
  float ss[2 * RW][2];
#pragma unroll
  for (int mt = 0; mt < 2 * RW; ++mt) ss[mt][0] = ss[mt][1] = 0.f;
#pragma unroll
  for (int n = 0; n < NW; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = (nh * NW + n) * 8 + 2 * t + e;
      const float b = bf16_round(f < F ? bias[f] : 0.f);
#pragma unroll
      for (int mt = 0; mt < 2 * RW; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = acc[mt][n][2 * half + e];
          if (!(ABL & kAblEpilogue)) {
            v = bf16_round(bf16_round(v) + b);
            if (relu) v = fmaxf(v, 0.f);
          }
          acc[mt][n][2 * half + e] = v;
          ss[mt][half] = fmaf(v, v, ss[mt][half]);
        }
      }
    }
  }
  if (OUT_BF16) {
    // The tile through shared memory (the stages are done): [256 pixels]
    // [F8 + 8], then each pixel's F channels out as 16-B vectors, a warp
    // covering contiguous pixels of a row: whole lines.
    constexpr int OP = F8 + 8;
    static_assert(kTcTH * kTcTW * OP <= ST * STAGE, "the output tile fits");
#pragma unroll
    for (int mt = 0; mt < 2 * RW; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int n = 0; n < NW; ++n)
          *reinterpret_cast<uint32_t*>(
              sm16 + ((row0 + mt / 2) * kTcTW + 16 * (mt & 1) + g +
                      8 * half) * OP + (nh * NW + n) * 8 + 2 * t) =
              pack_bf16x2(acc[mt][n][2 * half], acc[mt][n][2 * half + 1]);
    __syncthreads();
    if (ABL & kAblStores) return;
    uint16_t* yv = static_cast<uint16_t*>(y) + (size_t)view * H * W * F;
    if (vec_out) {
      const int G = F >> 3;               // 16-B groups a pixel
      for (int i = threadIdx.x; i < kTcTH * kTcTW * G; i += THREADS) {
        const int p = i / G;
        const int q = i - p * G;
        const int py = ty0 + (p >> 5);
        const int px = tx0 + (p & 31);
        if (py < H && px < W)
          *reinterpret_cast<uint4*>(yv + ((size_t)py * W + px) * F + 8 * q) =
              *reinterpret_cast<const uint4*>(sm16 + p * OP + 8 * q);
      }
    } else {
      for (int i = threadIdx.x; i < kTcTH * kTcTW * F; i += THREADS) {
        const int p = i / F;
        const int f = i - p * F;
        const int py = ty0 + (p >> 5);
        const int px = tx0 + (p & 31);
        if (py < H && px < W)
          yv[((size_t)py * W + px) * F + f] = sm16[p * OP + f];
      }
    }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 2 * RW; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      ss[mt][half] += __shfl_xor_sync(0xffffffffu, ss[mt][half], 1);
      ss[mt][half] += __shfl_xor_sync(0xffffffffu, ss[mt][half], 2);
    }
  if (normalize && NS > 1) {
    float* red = reinterpret_cast<float*>(sm16);  // [NS][kTcTH][kTcTW]
#pragma unroll
    for (int mt = 0; mt < 2 * RW; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (t == 0)
          red[(nh * kTcTH + row0 + mt / 2) * kTcTW + 16 * (mt & 1) + g +
              8 * half] = ss[mt][half];
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2 * RW; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float sum = 0.f;
        for (int h = 0; h < NS; ++h)
          sum += red[(h * kTcTH + row0 + mt / 2) * kTcTW + 16 * (mt & 1) +
                     g + 8 * half];
        ss[mt][half] = sum;
      }
  }
  if (ABL & kAblStores) return;
  float* yf = static_cast<float*>(y);
#pragma unroll
  for (int mt = 0; mt < 2 * RW; ++mt) {
    const int gy = ty0 + row0 + mt / 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float norm = normalize ? sqrtf(ss[mt][half] + 1e-12f) : 1.f;
      const int gx = tx0 + 16 * (mt & 1) + g + 8 * half;
      if (gy >= H || gx >= W) continue;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = (nh * NW + n) * 8 + 2 * t + e;
          if (f < F) {
            const float v = acc[mt][n][2 * half + e];
            yf[(((size_t)view * F + f) * H + gy) * W + gx] =
                normalize ? v / norm : v;
          }
        }
      }
    }
  }
}

template <int NT, int NS, int RW, int ST, int CHAIN, bool OUT_BF16,
          int ABL>
int launch_bf16(const void* x, const void* layout, const float* bias,
                void* y, int V, int C_in, int F, int H, int W, int relu,
                int normalize, int vec_in, int vec_out,
                cudaStream_t stream) {
  const size_t smem = ST * (size_t)Bf16Stage<NT>::kSize * sizeof(uint16_t);
  // The attribute belongs to the current device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bf16_kernel<NT, NS, RW, ST, CHAIN, OUT_BF16, ABL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int C16 = (C_in + kBfKC - 1) / kBfKC * kBfKC;
  dim3 grid((W + kTcTW - 1) / kTcTW, (H + kTcTH - 1) / kTcTH, V);
  conv3x3_bf16_kernel<NT, NS, RW, ST, CHAIN, OUT_BF16, ABL>
      <<<grid, kTcThreads * NS / RW, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(layout),
      bias, y, C_in, C16, F, H, W, relu, normalize, vec_in, vec_out);
  return (int)cudaGetLastError();
}

// -------------------- K8 bfloat16, C_in > 1: the wgmma form (probe only) ----
// Measured by tools/k8_probe.py beside the mma.sync body, never launched by
// the layer. A 4 x 64 pixel tile, two warpgroups of two tile rows each,
// m64 = one tile row, N = F8, k16 a tap's 16 channels; every k16 step
// chained through the accumulators (wgmma has no rounded add a step
// without a second set of them). A and B from shared memory by
// descriptors, no swizzle, K-major: a stage holds the halo as [channel
// group g][halo pixel][8 channels], core matrices of 8 pixels x 16 B (SBO
// 128 B between pixel octets, LBO = the 396 halo pixels x 16 B between
// the two groups), so a tap (ky, kx) starts A ky halo rows and kx pixels
// on, still 16-B aligned (a 128-B swizzle could not start one pixel in);
// B as [tap][g][output][8 channels] (SBO 128 B, LBO = F8 x 16 B).

constexpr int kWgTH = 4;                      // tile rows
constexpr int kWgTW = 64;                     // tile columns: m64
constexpr int kWgHaloW = kWgTW + 2;
constexpr int kWgHalo = (kWgTH + 2) * kWgHaloW;   // 396 halo pixels

__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((addr >> 4) & 0x3fffu) |
         ((uint64_t)((lbo >> 4) & 0x3fffu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fffu) << 32);
}

// d (m64n64: 32 floats a thread) = A B, plus d unless scale_d is 0
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n112: 56 floats a thread) = A B, plus d unless scale_d is 0
__device__ __forceinline__ void wgmma_n112(float (&d)[56], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NT>
struct WgStage {                   // bf16 elements of a stage: A, then B
  static constexpr int kA = 2 * kWgHalo * 8;
  static constexpr int kSize = kA + 9 * 2 * 8 * NT * 8;
};

template <int NT>
__device__ __forceinline__ void wgmma_tap(float (&d)[4 * NT], uint64_t da,
                                          uint64_t db) {
  if constexpr (NT == 8) wgmma_n64(d, da, db, 1);
  else wgmma_n112(d, da, db, 1);
}

// A layer before the last (ReLU, bfloat16 channels-last out), F = 8 NT.
template <int NT>
__global__ void __launch_bounds__(256, 1)
conv3x3_wgmma_kernel(const uint16_t* __restrict__ x,
                     const uint16_t* __restrict__ wl,
                     const float* __restrict__ bias,
                     uint16_t* __restrict__ y, int C_in, int C16, int F,
                     int H, int W) {
  constexpr int F8 = 8 * NT;
  constexpr int STAGE = WgStage<NT>::kSize;
  extern __shared__ __align__(128) uint16_t smw[];
  const int wg = threadIdx.x >> 7;        // tile rows 2 wg, 2 wg + 1
  const int w = (threadIdx.x >> 5) & 3;   // rows 16 w ... of the m64
  const int lane = threadIdx.x & 31;
  const int ty0 = blockIdx.y * kWgTH;
  const int tx0 = blockIdx.x * kWgTW;
  const int view = blockIdx.z;
  const uint16_t* xv = x + (size_t)view * H * W * C_in;

  auto stage = [&](int chunk, uint16_t* buf) {
    const int c0 = chunk * kBfKC;
    for (int i = threadIdx.x; i < kWgHalo * 2; i += 256) {
      const int p = i >> 1;
      const int g = i & 1;
      const int c = c0 + 8 * g;
      const int hy = p / kWgHaloW;
      const int gy = ty0 + hy - 1;
      const int gx = tx0 + p - hy * kWgHaloW - 1;
      const bool ok = c < C_in && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16_zfill(buf + (g * kWgHalo + p) * 8,
                       ok ? xv + ((size_t)gy * W + gx) * C_in + c : xv,
                       ok ? 16 : 0);
    }
    uint16_t* wb = buf + WgStage<NT>::kA;
    for (int i = threadIdx.x; i < 9 * F8 * 2; i += 256) {
      const int r = i >> 1;               // tap * F8 + output
      const int g = i & 1;
      const int tap = r / F8;
      cp_async16_zfill(wb + ((tap * 2 + g) * F8 + r - tap * F8) * 8,
                       wl + (size_t)r * C16 + c0 + 8 * g, 16);
    }
  };

  float acc[2][4 * NT];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4 * NT; ++n) acc[r][n] = 0.f;
  const int chunks = C16 / kBfKC;
  const unsigned base = (unsigned)__cvta_generic_to_shared(smw);
  stage(0, smw);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) stage(ch + 1, smw + ((ch + 1) & 1) * STAGE);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    // the copies went through the generic proxy, wgmma reads through the
    // async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned a0 = base + 2u * (ch & 1) * STAGE;
    const unsigned b0 = a0 + 2u * WgStage<NT>::kA;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
      const uint64_t db = wgmma_desc(b0 + 16u * (tap * 2 * F8), 16u * F8,
                                     128u);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        wgmma_tap<NT>(acc[r],
                      wgmma_desc(a0 + 16u * ((2 * wg + r + ky) * kWgHaloW +
                                             kx),
                                 16u * kWgHalo, 128u),
                      db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();                      // stage ch may be overwritten
  }
  // acc[r][4 j + e]: pixel 16 w + lane / 4 (+ 8 for e >= 2) of tile row
  // 2 wg + r, channels 8 j + 2 (lane % 4) + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gy = ty0 + 2 * wg + r;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int f = 8 * j + 2 * (lane & 3);
      const float b0 = bf16_round(f < F ? bias[f] : 0.f);
      const float b1 = bf16_round(f + 1 < F ? bias[f + 1] : 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gx = tx0 + 16 * w + (lane >> 2) + 8 * half;
        const float v0 = fmaxf(
            bf16_round(bf16_round(acc[r][4 * j + 2 * half]) + b0), 0.f);
        const float v1 = fmaxf(
            bf16_round(bf16_round(acc[r][4 * j + 2 * half + 1]) + b1), 0.f);
        if (gy < H && gx < W && f + 1 < F)
          *reinterpret_cast<uint32_t*>(
              y + (((size_t)view * H + gy) * W + gx) * F + f) =
              pack_bf16x2(v0, v1);
      }
    }
  }
}

template <int NT>
int launch_wgmma(const void* x, const void* layout, const float* bias,
                 void* y, int V, int C_in, int F, int H, int W,
                 cudaStream_t stream) {
  const size_t smem = 2 * (size_t)WgStage<NT>::kSize * sizeof(uint16_t);
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int C16 = (C_in + kBfKC - 1) / kBfKC * kBfKC;
  dim3 grid((W + kWgTW - 1) / kWgTW, (H + kWgTH - 1) / kWgTH, V);
  conv3x3_wgmma_kernel<NT><<<grid, 256, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(layout),
      bias, static_cast<uint16_t*>(y), C_in, C16, F, H, W);
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

// ------------------------------------------------------------------ K11 ----

constexpr int kFvTW = 128;                  // columns a step: a tile a view
constexpr int kFvPix = 2 * kFvTW;           // pixels a step: both views
constexpr int kFvHalo = kFvTW + 2;          // staged pixels of a view's row
constexpr int kFvBox = 136;                 // their slots: 4352 B, 256-B apart
constexpr int kFvPixB = 32;                 // bytes of a staged pixel
constexpr int kFvBandNT = 18;               // n8 tiles of an m16 tile's band
constexpr int kFvNS = 2;                    // warps sharing a pixel's channels
constexpr int kFvWarps = 16;
constexpr int kFvThreads = 32 * kFvWarps;
constexpr int kFvSmemMax = 232448;          // dynamic shared memory a block

// Ablations of the probe entry (tools/k11_probe.py): each bit takes one
// part of the kernel out, to split its time.
constexpr int kFvAblStage = 1;    // no staging copies
constexpr int kFvAblConv = 2;     // no products of the layer
constexpr int kFvAblBand = 4;     // no products of the band
constexpr int kFvAblStore = 8;    // no stores of the volume

// Bytes of shared memory, from a 1024-B aligned base: the right ring
// [P][F8][256] floats (P planes: up to F8 = 64 the features' TF32 hi and
// lo, else the features); the pixels' partial sums of squares ([2][256],
// where two warps share a pixel's channels); then a
// region of ST staging buffers. A stage is one kernel row ky of KC input
// channels (16 bfloat16 or 8 float32, 32 B a pixel): both views' 130
// staged pixels, channels-last, each view's box 256-B aligned, and the
// weights of its three taps (bfloat16: tap kx, output n, a 32-B row of 16
// channels; float32: tap kx, part hi or lo, channel group q, output n, a
// 16-B row of 4 channels, wgmma's core matrices). The tail, the left
// tile's features [P][F8][128] and then the volume's tile (128 planes of
// 132), lies from buffer 1 on (kTailAt = kStage) where that fits, so that
// buffer 0 takes the next step's first stage while the band runs; else
// from buffer 0. Then one mbarrier a buffer.
template <int NT, bool BF16, int ST, bool PRE, int P>
struct FvBytes {
  static constexpr int F8 = 8 * NT;
  static constexpr int kWRow = BF16 ? 32 : 64;
  static constexpr int kAct = 2 * kFvBox * kFvPixB;
  static constexpr int kW = 3 * F8 * kWRow;
  static constexpr int kStage = (kAct + kW + 1023) / 1024 * 1024;
  static constexpr int kRing = P * F8 * 2 * kFvTW * 4;
  static constexpr int kRed = kFvNS * kFvPix * 4;
  static constexpr int kLeft = P * F8 * kFvTW * 4;
  static constexpr int kOut = kFvTW * kVolPO * 4;
  static constexpr int kTail = kLeft > kOut ? kLeft : kOut;
  static constexpr int kTailAt = PRE ? kStage : 0;
  static constexpr int kRegionAt = (kRing + kRed + 1023) / 1024 * 1024;
  static constexpr int kRegion =
      ST * kStage > kTailAt + kTail ? ST * kStage : kTailAt + kTail;
  static constexpr int kBarsAt = kRegionAt + kRegion;
  static constexpr int kBytes = kBarsAt + 8 * ST + 1024;   // + alignment
};

// The layout the launch takes: the prefetch of the next step's first
// stage where its bytes fit.
template <int NT, bool BF16, int ST, int P>
struct FvShape
    : FvBytes<NT, BF16, ST,
              (FvBytes<NT, BF16, ST, true, P>::kBytes <= kFvSmemMax), P> {
  static constexpr bool kPre =
      FvBytes<NT, BF16, ST, true, P>::kBytes <= kFvSmemMax;
  static_assert(FvBytes<NT, BF16, ST, kPre, P>::kBytes <= kFvSmemMax,
                "K11's block fits an SM's shared memory");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A box of the tensor map (channels, x, y, view) into shared memory, its
// bytes reported to bar; cells outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             uint64_t* bar, int c, int x,
                                             int y, int v) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(x), "r"(y), "r"(v)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (m64n32k8 TF32: 16 floats a thread) = A B, plus d unless scale_d is
// 0; A from registers (a warp's 16 rows as mma.m16n8k8's A), B K-major
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (m64n56k8 TF32: 28 floats a thread) = A B, plus d unless scale_d is
// 0; A from registers (a warp's 16 rows as mma.m16n8k8's A), B K-major
__device__ __forceinline__ void wgmma_tf32_n56(float (&d)[28],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (m64n64k8 TF32: 32 floats a thread) = A B, plus d unless scale_d is
// 0; A from registers (a warp's 16 rows as mma.m16n8k8's A), B K-major
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (m64n32k16 bf16: 16 floats a thread) = A B, plus d unless scale_d
// is 0; A from registers (mma.m16n8k16's A), B K-major
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (m64n56k16 bf16: 28 floats a thread) = A B, plus d unless scale_d
// is 0; A from registers (mma.m16n8k16's A), B K-major
__device__ __forceinline__ void wgmma_bf16_n56(float (&d)[28],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (m64n64k16 bf16: 32 floats a thread) = A B, plus d unless scale_d
// is 0; A from registers (mma.m16n8k16's A), B K-major
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// a K-major B in TMA's 32-B swizzle (rows of 32 B, 8-row atoms of 256 B)
__device__ __forceinline__ uint64_t wgmma_desc_sw32(unsigned addr) {
  return wgmma_desc(addr, 16u, 256u) | (3ull << 62);
}

template <int NN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[4 * NN],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (NN == 4) wgmma_bf16_n32(d, a, db, scale_d);
  else if constexpr (NN == 7) wgmma_bf16_n56(d, a, db, scale_d);
  else wgmma_bf16_n64(d, a, db, scale_d);
}

template <int NN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * NN],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (NN == 4) wgmma_tf32_n32(d, a, db, scale_d);
  else if constexpr (NN == 7) wgmma_tf32_n56(d, a, db, scale_d);
  else wgmma_tf32_n64(d, a, db, scale_d);
}

// K11 replaces, with K8 for the layers before it, mccnn_fused_volume_pallas
// (stereo_match_tpu/ops/pallas_kernels.py: _mccnn_fused_kernel, its
// _tower_body for the last layer and _gram_band_body), the TPU kernel that
// keeps the features out of HBM. The TPU block (all layers of a 16-row
// band of both views in VMEM) does not fit a Hopper block; the last layer
// does, and it is where the float32 features are made.
// Bound on the H100 (KITTI, both views, D = 128): the input activations
// and the volume moved once (bf16 at F = 64: 119 + 238 MB, 0.107 ms) against
// the layer's products plus the band's 3xTF32 ones, both on the tensor
// cores (0.069 + 0.046 ms): 0.113 ms, operations (F = 112 bf16 0.289,
// float32 0.460 and 1.351). The first form (PERF.md, Findings) walked the
// same steps on mma.sync and staged with every thread: in float32 NCHW
// input rows 4 B at a time and the hi and lo weights 16 B at a time, one
// buffer at F = 112, so staging cost 0.65 / 1.87 ms (F = 64 / 112) and
// its float32 layer products (1.25 / 4.06 ms against a 3xTF32 bound of
// 0.42 / 1.27) ran no faster than K8's; the volume's stores, by every warp
// after the band, cost 0.12 ms in bfloat16. This design:
//  - the input is channels-last in both modes (K8 writes it so when K11
//    follows), a pixel's KC channels 32 B: one thread stages a view's row
//    of a stage as one TMA box (zeros outside the frame and past C_in: the
//    SAME and k padding), and the stage's weights, which K11's own copy
//    (cuda_kernels.mccnn_fused_weight_layout) keeps contiguous a stage, as
//    one bulk copy, both onto the buffer's mbarrier; ST buffers (three to
//    six by F8) keep the next stages in flight, and the next step's first
//    stage lands while the band runs;
//  - the layer runs on wgmma: warpgroup w / 4 takes the m64 of four m16
//    tiles, all of F8 (in halves of at most 64), A from registers (a
//    warp's 16 pixels, as mma.sync's A: bfloat16 by ldmatrix; float32 one
//    8-B read of two channels split as read, the k8 step's logical k = t,
//    t + 4 being channel 2t, 2t + 1), B K-major from the stage by
//    descriptors (bfloat16 rows of 32 B in TMA's 32-B swizzle, float32 hi
//    and lo core matrices of 8 outputs by 16 B); each k step goes into a
//    zeroed partial, waited for and added to the total in float32 (K8's
//    rounded add a step; its k order differs, so the sums may differ from
//    K8's by an ulp). On mma.sync the same layer took 1.2 (bfloat16) and
//    1.4 (float32) times as long (tools/k11_probe.py);
//  - up to F8 = 64 the features stay in shared memory as the band reads
//    them, TF32 hi and lo in two planes, so the band splits nothing;
//  - the volume's 128 planes of a step go to one shared tile and out by
//    bulk stores (one a plane row, its ragged ends by the thread), which
//    drain while the next step's layer runs.
//
// One row y of both views and one chunk of 128 planes (d0 = 128
// blockIdx.x), walking the row's 128-column tiles left to right. A step:
//  1. the last tower layer for the 256 pixels of the left tile x0 ... x0 +
//     127 and the right tile x0 - d0 ... (warp w: m16 tile w, all of F8),
//     bias, each pixel's sum of squares over the quad, the norm, its unit
//     features written to shared memory: the left tile, and the right one
//     into the ring slot of its columns (x & 255), both XOR-swizzled by
//     (f & 3) << 3;
//  2. K9's Gram band on them: the m16 tile x0 + 16 m ... against the 18 n8
//     tiles of the right window x0 - d0 - 127 + 16 m ... read from the ring
//     (the previous step's tile and this one's), two warps an m16 tile,
//     each cell three TF32 products a k8 step, as K9's;
//  3. scale (1 - G) / 2, or 1e4 where x < d, into the tile, each plane row
//     shifted by its global row's misalignment, then stored.
// The probe entry also builds the mma.sync layer (WG false: two warps a
// pixel's channels, m16 tiles 2 (w % 8) and + 1, their sums of squares
// added in shared memory), thread stores (BULK false) and features split
// as the band reads them (SP false).
// xmap: the tensor map of the last layer's input (channels, W, H, 2);
// wl: K11's copy of its weights; nst = 3 CK / KC stages a step.
template <int NT, bool BF16, int ST, int ABL, bool BULK, bool WG, bool SP>
__global__ void __launch_bounds__(kFvThreads, 1)
mccnn_fused_volume_kernel(const __grid_constant__ CUtensorMap xmap,
                          const void* __restrict__ wl,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int nst, int F, int H,
                          int W, float scale) {
  using S = FvShape<NT, BF16, ST, SP ? 2 : 1>;
  constexpr int F8 = S::F8;
  constexpr int kRP = F8 * 2 * kFvTW;      // the ring's lo plane
  constexpr int kLP = F8 * kFvTW;          // the left tile's lo plane
  constexpr int NS = WG ? 1 : kFvNS;        // warps sharing a pixel
  constexpr int NW = NT / NS;               // n8 tiles a warp
  constexpr int RWARPS = kFvWarps / NS;     // warps along the pixels
  constexpr int MT = 16 / RWARPS;           // m16 tiles a warp
  constexpr int BN = kFvBandNT / 2;         // n8 tiles of a band warp
  constexpr int KC = BF16 ? 16 : 8;         // input channels a stage
  static_assert(NT % NS == 0 && MT * RWARPS == 16,
                "the warps tile the step");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* rf = reinterpret_cast<float*>(sm);  // the ring, [P][F8][256]
  float* red = reinterpret_cast<float*>(sm + S::kRing);  // [2][256 pixels]
  unsigned char* region = sm + S::kRegionAt;           // stages | tail
  float* lf = reinterpret_cast<float*>(region + S::kTailAt);  // [P][F8][128]
  float* st = lf;                           // the volume's tile, after
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::kBarsAt);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                  // mma groupID
  const int t = lane & 3;                   // thread in group
  const int nh = warp / RWARPS;             // this warp's share of F8
  const int mw = warp % RWARPS;             // its m16 tiles MT mw, ...
  const int view = mw * MT >> 3;            // all in one view
  const int d0 = blockIdx.x * kFvTW;
  const int y = blockIdx.y;
  const int ntiles = (W + kFvTW - 1) / kFvTW;
  const int nk8 = (F + 7) >> 3;

  if (tid == 0) {
    for (int b = 0; b < ST; ++b) mbar_init(bars + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  // the ring's slot of the tile before the first: cells with j < 0 only
  for (int i = tid; i < (SP ? 2 : 1) * kRP; i += kFvThreads) rf[i] = 0.f;
  __syncthreads();

  // stage s of the step at column x0 into buffer b (thread 0): kernel row
  // ky = s % 3 of the channels KC (s / 3) ..., a box a view, and its
  // three taps' weight rows
  const CUtensorMap* map = &xmap;
  auto issue = [&](int s, int b, int x0) {
    uint64_t* bar = bars + b;
    if (ABL & kFvAblStage) {
      mbar_arrive(bar);
      return;
    }
    unsigned char* buf = region + b * S::kStage;
    mbar_expect_tx(bar, 2 * kFvHalo * kFvPixB + S::kW);
    const int c = s / 3 * KC;
    const int gy = y - 1 + s % 3;
    tma_load_box(buf, map, bar, c, x0 - 1, gy, 0);
    tma_load_box(buf + kFvBox * kFvPixB, map, bar, c, x0 - d0 - 1, gy,
                 1);
    bulk_load(buf + S::kAct, static_cast<const char*>(wl) + (size_t)s * S::kW,
              S::kW, bar);
  };

  unsigned phases = 0;                      // each buffer's next parity
  for (int tl = 0; tl < ntiles; ++tl) {
    const int x0 = tl * kFvTW;
    const int xr0 = x0 - d0;                // this step's right tile

    // the tail held the last step's tile: its stores have read it
    if (BULK && tid < kFvTW)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    fence_proxy_async();
    __syncthreads();
    if (tid == 0)
      for (int s = S::kPre && tl > 0 ? 1 : 0; s < min(ST, nst); ++s)
        issue(s, s, x0);

    float acc[MT][NW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    for (int s = 0; s < nst; ++s) {
      const int b = s % ST;
      if (tid == 0 && s > 0 && s + ST - 1 < nst)
        issue(s + ST - 1, (s + ST - 1) % ST, x0);
      mbar_wait(bars + b, (phases >> b) & 1u);
      phases ^= 1u << b;
      const unsigned char* buf = region + b * S::kStage;
      if (ABL & kFvAblConv) {
      } else if (WG && BF16) {
        // bfloat16 on wgmma (probe only): A by ldmatrix as the mma.sync
        // body's (a warp's 16 pixels), B K-major from the stage's weight
        // rows (32 B, TMA's 32-B swizzle), F8 in NH halves; each k16 step
        // into a zeroed partial accumulator, added with a rounded add
        constexpr int NH = NT > 8 ? 2 : 1;
        constexpr int NN = NT / NH;
        const unsigned base = smem_u32(buf);
#pragma unroll (BF16 ? 3 : 1)
        for (int kx = 0; kx < 3; ++kx) {
          uint32_t a[4];
          const int p = 16 * (warp & 7) + kx + (lane & 15);
          ldmatrix_x4(a, base + (view * kFvBox + p) * kFvPixB +
                             (((lane >> 4) ^ (p >> 2)) & 1) * 16);
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            float part[4 * NN];
            const uint64_t db = wgmma_desc_sw32(
                base + S::kAct + 32u * (kx * F8 + h * 8 * NN));
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            wgmma_bf16<NN>(part, a, db, 0);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
            for (int j = 0; j < NN; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[0][h * NN + j][e] += part[4 * j + e];
          }
        }
      } else if (WG) {
        // 3xTF32 on wgmma (probe only): warpgroup warp / 4 the m64 of its
        // four m16 tiles, A from registers (a warp's 16 pixels, split as
        // read, as the mma.sync body's), B (hi, lo) K-major from the
        // stage, F8 in NH halves; each k8 step into a zeroed partial
        // accumulator, added to the total
        constexpr int NH = NT > 8 ? 2 : 1;
        constexpr int NN = NT / NH;         // n8 tiles a half
        const float* act = reinterpret_cast<const float*>(buf);
        const unsigned wb = smem_u32(buf + S::kAct);
#pragma unroll 1
        for (int kx = 0; kx < 3; ++kx) {
          uint32_t ah[4], al[4];
          const int p = view * kFvBox + 16 * (warp & 7) + kx + g;
          const float2 u = *reinterpret_cast<const float2*>(act + p * 8 +
                                                            2 * t);
          const float2 v = *reinterpret_cast<const float2*>(
              act + (p + 8) * 8 + 2 * t);
          split_tf32(u.x, ah[0], al[0]);
          split_tf32(v.x, ah[1], al[1]);
          split_tf32(u.y, ah[2], al[2]);
          split_tf32(v.y, ah[3], al[3]);
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            float part[4 * NN];
            const unsigned rows = 16u * (h * 8 * NN);
            const uint64_t dh = wgmma_desc(
                wb + 16u * ((kx * 2 + 0) * 2 * F8) + rows, 16u * F8, 128u);
            const uint64_t dl = wgmma_desc(
                wb + 16u * ((kx * 2 + 1) * 2 * F8) + rows, 16u * F8, 128u);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            wgmma_tf32<NN>(part, al, dh, 0);
            wgmma_tf32<NN>(part, ah, dl, 1);
            wgmma_tf32<NN>(part, ah, dh, 1);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
            for (int j = 0; j < NN; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[0][h * NN + j][e] += part[4 * j + e];
          }
        }
      } else if (BF16) {
        // A by ldmatrix.x4: lane row pixel lane & 15 of the m16 tile, its
        // channels 8 (lane >> 4) ...; B two n8 tiles at a time; each k16
        // step into a zeroed accumulator added with a rounded add
        const unsigned base = smem_u32(buf);
#pragma unroll (BF16 ? 3 : 1)
        for (int kx = 0; kx < 3; ++kx) {
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int p = 16 * ((mw * MT + m) & 7) + kx + (lane & 15);
            ldmatrix_x4(a[m], base + (view * kFvBox + p) * kFvPixB +
                                  (((lane >> 4) ^ (p >> 2)) & 1) * 16);
          }
#pragma unroll
          for (int n = 0; n < NW; n += 2) {
            uint32_t bw[4];
            const int r = kx * F8 + (nh * NW + n) * 8 + 8 * (lane >> 4) +
                          (lane & 7);
            const unsigned addr = base + S::kAct + r * 32 +
                                  ((((lane >> 3) ^ (r >> 2)) & 1) * 16);
            if (n + 1 < NW) ldmatrix_x4(bw, addr);
            else ldmatrix_x2(bw, addr);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (n + h >= NW) continue;
                float p[4];
                mma_bf16_zero(p, a[m], bw[2 * h], bw[2 * h + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][n + h][e] += p[e];
              }
            }
          }
        }
      } else {
        // 3xTF32: a lane's A, pixels g and g + 8 at channels 2t, 2t + 1
        // (k = t, t + 4), each split as read; its B, hi and lo of those
        // channels for output g, one 16-B word; lo*hi + hi*lo + hi*hi in
        // a zeroed accumulator, added to the total
        const float* act = reinterpret_cast<const float*>(buf);
        const float4* wt = reinterpret_cast<const float4*>(buf + S::kAct);
#pragma unroll (BF16 ? 3 : 1)
        for (int kx = 0; kx < 3; ++kx) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int p = view * kFvBox + 16 * ((mw * MT + m) & 7) + kx + g;
            const float2 u = *reinterpret_cast<const float2*>(act + p * 8 +
                                                              2 * t);
            const float2 v = *reinterpret_cast<const float2*>(
                act + (p + 8) * 8 + 2 * t);
            split_tf32(u.x, ah[m][0], al[m][0]);
            split_tf32(v.x, ah[m][1], al[m][1]);
            split_tf32(u.y, ah[m][2], al[m][2]);
            split_tf32(v.y, ah[m][3], al[m][3]);
          }
#pragma unroll
          for (int n = 0; n < NW; ++n) {
            const float4 w4 = wt[(kx * F8 + (nh * NW + n) * 8 + g) * 4 + t];
            const uint32_t bh0 = __float_as_uint(w4.x);
            const uint32_t bh1 = __float_as_uint(w4.y);
            const uint32_t bl0 = __float_as_uint(w4.z);
            const uint32_t bl1 = __float_as_uint(w4.w);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(part, al[m], bh0, bh1);
              mma_tf32(part, ah[m], bl0, bl1);
              mma_tf32(part, ah[m], bh0, bh1);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][n][e] += part[e];
            }
          }
        }
      }
      __syncthreads();                      // buffer b may be overwritten
    }
    // the next step's first stage lands while this one's band runs
    if (S::kPre && tid == 0 && tl + 1 < ntiles) issue(0, 0, x0 + kFvTW);

    // K8's epilogue for the last layer: c0, c1 of m16 tile m are pixel
    // g, channels 2t, 2t + 1; c2, c3 pixel g + 8. Bias (in bfloat16 the
    // sum rounded, the rounded bias added and rounded again), then each
    // pixel's sum of squares: this lane's channels n by n, the quad's
    // lanes by two shuffles, the two warps' sums in shared memory; then the
    // division by sqrt(sum + 1e-12).
    float ss[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) ss[m][0] = ss[m][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NW; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = (nh * NW + n) * 8 + 2 * t + e;
        const float b = f < F ? bias[f] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float v = add_bias<BF16>(acc[m][n][2 * half + e], b);
            acc[m][n][2 * half + e] = v;
            ss[m][half] = fmaf(v, v, ss[m][half]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        ss[m][half] += __shfl_xor_sync(0xffffffffu, ss[m][half], 1);
        ss[m][half] += __shfl_xor_sync(0xffffffffu, ss[m][half], 2);
        if (NS > 1 && t == 0)
          red[nh * kFvPix + (mw * MT + m) * 16 + g + 8 * half] = ss[m][half];
      }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = (mw * MT + m) * 16 + g + 8 * half;
        const float norm = sqrtf(
            (NS > 1 ? red[px] + red[kFvPix + px] : ss[m][half]) + 1e-12f);
        const int col = 16 * ((mw * MT + m) & 7) + g + 8 * half;
#pragma unroll
        for (int n = 0; n < NW; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = (nh * NW + n) * 8 + 2 * t + e;
            if (f >= F) continue;
            const float v = acc[m][n][2 * half + e] / norm;
            const int swz = (f & 3) << 3;
            float* dst = view == 0
                             ? lf + f * kFvTW + (col ^ swz)
                             : rf + f * 2 * kFvTW + (((xr0 + col) & 255) ^
                                                     swz);
            if (SP) {                       // the band's TF32 hi and lo
              uint32_t hi, lo;
              tf32_pair(v, hi, lo);
              dst[0] = __uint_as_float(hi);
              dst[view == 0 ? kLP : kRP] = __uint_as_float(lo);
            } else {
              dst[0] = v;
            }
          }
        }
      }
    }
    __syncthreads();                        // the step's features are in

    // K9's Gram band: the left tile against the ring
    const int mb = warp & 7;                // this warp's m16 tile
    const int nb0 = warp / 8 * BN;          // and its first n8 tile
    const int xa = x0 + 16 * mb;
    const bool busy = xa < W;
    const int ncols = min(kFvTW, W - x0);
    const int jw = xa - d0 - kFvTW + 1;     // the m16 tile's first j
    const bool full = jw >= 0 && xa + 16 <= W;
    float band[BN][4];
#pragma unroll
    for (int n = 0; n < BN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) band[n][e] = 0.f;
    if (busy && !(ABL & kFvAblBand)) {
      const int swz = t << 3;               // (k + t) & 3 == t
      const int ca0 = (16 * mb + g) ^ swz;
      const int ca1 = (16 * mb + g + 8) ^ swz;
      for (int k = 0; k < 8 * nk8; k += 8) {
        uint32_t ah[4], al[4];
        const float* a = lf + (k + t) * kFvTW;
        const int ao[4] = {ca0, ca1, 4 * kFvTW + ca0, 4 * kFvTW + ca1};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (SP) {
            ah[r] = __float_as_uint(a[ao[r]]);
            al[r] = __float_as_uint(a[kLP + ao[r]]);
          } else {
            tf32_pair(a[ao[r]], ah[r], al[r]);
          }
        }
        const float* bp = rf + (k + t) * 2 * kFvTW;
#pragma unroll
        for (int n = 0; n < BN; ++n) {
          const int j0 = jw + 8 * (nb0 + n);
          if (!full && (j0 + 7 < 0 || j0 >= W)) continue;
          const int cb = ((j0 + g) & 255) ^ swz;
          uint32_t bh0, bl0, bh1, bl1;
          if (SP) {
            bh0 = __float_as_uint(bp[cb]);
            bl0 = __float_as_uint(bp[kRP + cb]);
            bh1 = __float_as_uint(bp[4 * 2 * kFvTW + cb]);
            bl1 = __float_as_uint(bp[kRP + 4 * 2 * kFvTW + cb]);
          } else {
            tf32_pair(bp[cb], bh0, bl0);
            tf32_pair(bp[4 * 2 * kFvTW + cb], bh1, bl1);
          }
          mma_tf32(band[n], al, bh0, bh1);
          mma_tf32(band[n], ah, bl0, bl1);
          mma_tf32(band[n], ah, bh0, bh1);
        }
      }
    }
    __syncthreads();                        // the left tile is read

    // K9's epilogue: c0, c1 are column xa + g, j = jw + 8 n + 2t, + 1; c2,
    // c3 column xa + g + 8; plane i = x - j - d0, its row in the tile
    // shifted by the global row's misalignment
    if (busy) {
#pragma unroll
      for (int n = 0; n < BN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int xl = 16 * mb + g + 8 * (e >> 1);
          const int j = jw + 8 * (nb0 + n) + 2 * t + (e & 1);
          const int i = x0 + xl - j - d0;
          if (i >= 0 && i < kFvTW) {
            const unsigned sh =
                (((unsigned)(d0 + i) * (unsigned)H + y) * (unsigned)W) & 3u;
            st[i * kVolPO + xl + sh] =
                j < 0 ? kInvalid : scale * (1.f - band[n][e]) * 0.5f;
          }
        }
      }
    }
    fence_proxy_async();                    // the tile, for bulk stores
    __syncthreads();
    if (ABL & kFvAblStore) {
    } else if (BULK) {
      // plane row i by thread i: its 16-B aligned middle by one bulk
      // store, the ends (at most 3 cells each) by the thread
      if (tid < kFvTW) {
        const size_t row = ((size_t)(d0 + tid) * H + y) * W + x0;
        const float* src = st + tid * kVolPO + (int)(row & 3);  // column 0
        const size_t a = (row + 3) & ~(size_t)3;
        const size_t e = (row + ncols) & ~(size_t)3;
        size_t head = row + ncols, tail = head;
        if (e > a) {
          bulk_store(out + a, src + (a - row), (unsigned)(e - a) * 4u);
          head = a;
          tail = e;
        }
        for (size_t q = row; q < head; ++q) out[q] = src[q - row];
        for (size_t q = tail; q < row + ncols; ++q) out[q] = src[q - row];
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      for (int i = warp; i < kFvTW; i += kFvWarps) {
        const size_t row = ((size_t)(d0 + i) * H + y) * W + x0;
        const int sh = (int)(row & 3);
        float* dst = out + (row - sh);      // 16-B aligned
        const float* src = st + i * kVolPO;
        const int nvec = (ncols + sh + 3) >> 2;
        for (int v = lane; v < nvec; v += 32) {
          const float4 q = *reinterpret_cast<const float4*>(src + 4 * v);
          const int xl = 4 * v - sh;        // tile column of q.x
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
    }
  }
  if (BULK && tid < kFvTW)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPoint (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The tensor map of K11's input, channels-last (2, H, W, C): boxes of KC
// channels by 130 pixels of one row of one view; bfloat16 with TMA's 32-B
// swizzle (16-B half h of staged pixel p at h ^ (bit 2 of p)).
int fused_input_map(CUtensorMap* map, const void* x, bool bf16, int C, int H,
                    int W) {
  static EncodeTiledFn encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              2};
  const cuuint64_t strides[3] = {C * es, W * C * es, H * W * C * es};
  const cuuint32_t box[4] = {bf16 ? 16u : 8u, (cuuint32_t)kFvHalo, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      bf16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NT, bool BF16, int ST, int ABL, bool BULK, bool WG, bool SP>
int launch_fused(const void* x, const void* layout, const float* bias,
                 float* out, int C_in, int F, int H, int W, int D,
                 float scale, cudaStream_t stream) {
  CUtensorMap map;
  const int code = fused_input_map(&map, x, BF16, C_in, H, W);
  if (code) return code;
  const size_t smem = FvShape<NT, BF16, ST, SP ? 2 : 1>::kBytes;
  auto kernel =
      mccnn_fused_volume_kernel<NT, BF16, ST, ABL, BULK, WG, SP>;
  // The attribute belongs to the current device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int KC = BF16 ? 16 : 8;
  const int nst = 3 * ((C_in + KC - 1) / KC);
  dim3 grid(D / kFvTW, H);
  kernel<<<grid, kFvThreads, smem, stream>>>(map, layout, bias, out, nst, F,
                                             H, W, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// One K8 layer in float32: the body chosen by C_in, the tile of output
// channels by F; out_cl: y float32 channels-last (V, H, W, F).
int conv3x3(const float* x, const float* layout, const float* bias, float* y,
            int V, int C_in, int F, int H, int W, int relu, int normalize,
            int out_cl, cudaStream_t st) {
#define SMT_TF32X3(NT, NS)                                                 \
  return launch_tf32x3<NT, NS>(x, layout, bias, y, V, C_in, F, H, W, relu, \
                               normalize, out_cl, st);
  if (C_in > 1) {
    if (F <= 32) SMT_TF32X3(4, 1)
    if (F <= 64) SMT_TF32X3(8, 1)
    if (F <= 112) SMT_TF32X3(14, 2)
    SMT_TF32X3(16, 2)
  }
#undef SMT_TF32X3
  const int vec = out_cl && F % 4 == 0 && aligned16(y);
#define SMT_CONV(FP)                                                       \
  return launch_conv3x3<FP, false, false>(x, layout, bias, y, V, F, H, W, \
                                          relu, normalize, vec, out_cl, st);
  if (F <= 32) SMT_CONV(32)
  if (F <= 64) SMT_CONV(64)
  if (F <= 112) SMT_CONV(112)
  SMT_CONV(128)
#undef SMT_CONV
}

// One K8 layer in the bfloat16 mode, the output bfloat16 channels-last
// (OUT_BF16) or float32 (V, F, H, W).
template <bool OUT_BF16>
int conv3x3_bf16(const void* x, const void* layout, const float* bias,
                 void* y, int V, int C_in, int F, int H, int W, int relu,
                 int normalize, int vec_in, int vec_out, cudaStream_t st) {
  // (NT, NS, ST): the n8 tiles, the warps sharing a tile row, the staging
  // buffers (two, so that two blocks share an SM, up to F = 64; three
  // where one block fills it); two rows a warp, a rounded add each k16 step
#define SMT_BF16(NT, NS, ST)                                               \
  return launch_bf16<NT, NS, 2, ST, 1, OUT_BF16, 0>(                       \
      x, layout, bias, y, V, C_in, F, H, W, relu, normalize, vec_in,       \
      vec_out, st);
  if (C_in > 1) {
    if (F <= 32) SMT_BF16(4, 1, 2)
    if (F <= 64) SMT_BF16(8, 1, 2)
    if (F <= 112) SMT_BF16(14, 2, 3)
    SMT_BF16(16, 2, 3)
  }
#undef SMT_BF16
  const float* xf = static_cast<const float*>(x);
  const float* taps = static_cast<const float*>(layout);
  if (F <= 32)
    return launch_conv3x3<32, true, OUT_BF16>(xf, taps, bias, y, V, F, H, W,
                                              relu, normalize, vec_out, 0, st);
  if (F <= 64)
    return launch_conv3x3<64, true, OUT_BF16>(xf, taps, bias, y, V, F, H, W,
                                              relu, normalize, vec_out, 0, st);
  if (F <= 112)
    return launch_conv3x3<112, true, OUT_BF16>(xf, taps, bias, y, V, F, H,
                                               W, relu, normalize, vec_out,
                                               0, st);
  return launch_conv3x3<128, true, OUT_BF16>(xf, taps, bias, y, V, F, H, W,
                                             relu, normalize, vec_out, 0, st);
}

}  // namespace

// The float32 mode. x: (V, C_in, H, W); layout: K8's copy of the weights,
// chosen by C_in: for C_in = 1 the (3, 3, 1, F) taps (the flax kernel
// layout), for C_in > 1 the (2, 3, 3, C8, F8) TF32 hi and lo parts of the
// taps, C_in padded to C8 (a multiple of 8) and F to F8 (32, 64, 112 or 128)
// by zeros; bias: (F,); y: (V, F, H, W), or for out_cl (a layer before K11)
// float32 channels-last (V, H, W, F). F <= 128. The bfloat16 mode has its
// own entry, smt_mccnn_conv3x3_bf16.
extern "C" int smt_mccnn_conv3x3(const float* x, const float* layout,
                                 const float* bias, float* y, int V, int C_in,
                                 int F, int H, int W, int relu, int normalize,
                                 int out_cl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F < 1 || F > 128 || C_in < 1) return (int)cudaErrorInvalidValue;
  return conv3x3(x, layout, bias, y, V, C_in, F, H, W, relu, normalize,
                 out_cl, st);
}

// The bfloat16 mode. x: for C_in = 1 the float32 (V, 1, H, W) images, for
// C_in > 1 bfloat16 channels-last (V, H, W, C_in); layout: for C_in = 1 the
// float32 (3, 3, 1, F) taps rounded to bfloat16, for C_in > 1 the bfloat16
// (9, F8, C16) taps, tap-major, then outputs, then inputs, C_in padded to
// C16 (a multiple of 16) and F to F8 by zeros; bias: float32 (F,); y:
// bfloat16 channels-last (V, H, W, F) for out_bf16 (not with normalize),
// else float32 (V, F, H, W). F <= 128.
extern "C" int smt_mccnn_conv3x3_bf16(const void* x, const void* layout,
                                      const float* bias, void* y, int V,
                                      int C_in, int F, int H, int W, int relu,
                                      int normalize, int out_bf16,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F < 1 || F > 128 || C_in < 1 || (out_bf16 && normalize))
    return (int)cudaErrorInvalidValue;
  const int vec_in = C_in % 8 == 0 && aligned16(x);
  const int vec_out = F % 8 == 0 && aligned16(y);
  return out_bf16 ? conv3x3_bf16<true>(x, layout, bias, y, V, C_in, F, H, W,
                                       relu, normalize, vec_in, vec_out, st)
                  : conv3x3_bf16<false>(x, layout, bias, y, V, C_in, F, H, W,
                                        relu, normalize, vec_in, vec_out, st);
}

// The probe of tools/k8_probe.py: the bfloat16 C_in > 1 body of a layer
// before the last (ReLU, bfloat16 channels-last out) at F = 64 or 112 with
// the parts in ablate & 255 (kAblStage | kAblProducts | kAblEpilogue |
// kAblStores, one at a time, or 0 for none) taken out, in the variant
// ablate >> 8: 0, the one conv3x3_bf16 launches; then, without
// ablations, its k16 steps all chained through the tensor-core
// accumulator (CHAIN 0); the three taps of a kernel row a partial sum
// (CHAIN 3); one tile row a warp (RW 1); at F = 112 two staging buffers;
// and 9, the wgmma form (conv3x3_wgmma_kernel). Arguments as
// smt_mccnn_conv3x3_bf16's.
extern "C" int smt_mccnn_conv3x3_bf16_probe(const void* x,
                                            const void* layout,
                                            const float* bias, void* y,
                                            int V, int C_in, int F, int H,
                                            int W, int ablate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C_in < 2 || (F != 64 && F != 112)) return (int)cudaErrorInvalidValue;
  const int vec_in = C_in % 8 == 0 && aligned16(x);
  const int vec_out = aligned16(y);
#define SMT_PROBE(NT, NS, RW, ST, CHAIN, ABL)                              \
  if ((ablate & 255) == ABL)                                               \
    return launch_bf16<NT, NS, RW, ST, CHAIN, true, ABL>(                  \
        x, layout, bias, y, V, C_in, F, H, W, 1, 0, vec_in, vec_out, st);
#define SMT_PROBE_ALL(NT, NS, ST)                                          \
  SMT_PROBE(NT, NS, 2, ST, 1, 0)                                           \
  SMT_PROBE(NT, NS, 2, ST, 1, kAblStage)                                   \
  SMT_PROBE(NT, NS, 2, ST, 1, kAblProducts)                                \
  SMT_PROBE(NT, NS, 2, ST, 1, kAblEpilogue)                                \
  SMT_PROBE(NT, NS, 2, ST, 1, kAblStores)
  const int variant = ablate >> 8;
  if (variant == 9 && ablate == 9 << 8 && C_in % 8 == 0 && F % 8 == 0)
    return F == 64 ? launch_wgmma<8>(x, layout, bias, y, V, C_in, F, H, W,
                                     st)
                   : launch_wgmma<14>(x, layout, bias, y, V, C_in, F, H,
                                      W, st);
  if (F == 64) {
    if (variant == 0) { SMT_PROBE_ALL(8, 1, 2) }
    if (variant == 1) { SMT_PROBE(8, 1, 2, 2, 0, 0) }
    if (variant == 2) { SMT_PROBE(8, 1, 2, 2, 3, 0) }
    if (variant == 3) { SMT_PROBE(8, 1, 1, 2, 1, 0) }
  } else {
    if (variant == 0) { SMT_PROBE_ALL(14, 2, 3) }
    if (variant == 1) { SMT_PROBE(14, 2, 2, 3, 0, 0) }
    if (variant == 2) { SMT_PROBE(14, 2, 2, 3, 3, 0) }
    if (variant == 3) { SMT_PROBE(14, 2, 1, 3, 1, 0) }
    if (variant == 4) { SMT_PROBE(14, 2, 2, 2, 1, 0) }
  }
#undef SMT_PROBE_ALL
#undef SMT_PROBE
  return (int)cudaErrorInvalidValue;
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

// K11. x: the last layer's input of both views, channels-last (2, H, W,
// C_in): float32 (bf16 = 0) with C_in a multiple of 4, or bfloat16 with
// C_in a multiple of 8, 16-B aligned; layout: K11's copy of the last
// layer's weights (cuda_kernels.mccnn_fused_weight_layout: float32 (C8 / 8,
// 9, 2, 2, F8, 4) TF32 hi and lo core matrices, or bfloat16 (C16 / 16, 9,
// F8, 16)); bias: (F,); out: (D, H, W) float32. F <= 128 and a multiple of
// 8, C_in >= 2, D a multiple of 128. One block of 16 warps an SM, the
// layer on wgmma; ST staging buffers by mode and F8, as many as fit beside
// the ring, the tail and, but for float32 at F8 = 128, the next step's
// first stage; the volume by bulk stores (tools/k11_probe.py, PERF.md).
extern "C" int smt_mccnn_fused_volume(const void* x, const void* layout,
                                      const float* bias, float* out,
                                      int C_in, int F, int H, int W, int D,
                                      float scale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F < 8 || F > 128 || F % 8 || C_in < 2 || H < 1 || W < 1 ||
      D < kFvTW || D % kFvTW || C_in % (bf16 ? 8 : 4) || !aligned16(x) ||
      !aligned16(layout))
    return (int)cudaErrorInvalidValue;
  // (NT, the bfloat16 buffers, the float32 buffers)
#define SMT_FUSED(NT, ST16, ST32)                                          \
  return bf16 ? launch_fused<NT, true, ST16, 0, true, true, (NT <= 8)>(     \
                    x, layout, bias, out, C_in, F, H, W, D, scale, st)     \
              : launch_fused<NT, false, ST32, 0, true, true, (NT <= 8)>(    \
                    x, layout, bias, out, C_in, F, H, W, D, scale, st);
  if (F <= 32) SMT_FUSED(4, 4, 4)
  if (F <= 64) SMT_FUSED(8, 6, 4)
  if (F <= 112) SMT_FUSED(14, 4, 3)
  SMT_FUSED(16, 4, 2)
#undef SMT_FUSED
}

// The probe of tools/k11_probe.py at F = 64 or 112, arguments as
// smt_mccnn_fused_volume's: variant 0 the launch that entry makes, with
// the parts in ablate (kFvAblStage | kFvAblConv | kFvAblBand |
// kFvAblStore, one at a time, or 0 for none) taken out; variants (no
// ablations) 1, its volume stored by every warp's float4 stores, as the
// first form of K11 stored it, in place of bulk stores; 2, two staging
// buffers; 3, the layer on mma.sync in place of wgmma (bfloat16: K8's body,
// two warps a pixel's channels, B by ldmatrix from the same rows; float32:
// 3xTF32 m16n8k8, its weights in that body's copy, tools/k11_probe.py: for
// (chunk, tap, n) the hi and lo words of channels 2t, 2t + 1, t = 0 ... 3,
// so that a lane's B is one 16-B read); 4 (F = 64), the features in shared
// memory as they are, split into TF32 hi and lo as the band reads them, in
// place of the hi and lo planes the epilogue writes.
extern "C" int smt_mccnn_fused_volume_probe(const void* x,
                                            const void* layout,
                                            const float* bias, float* out,
                                            int C_in, int F, int H, int W,
                                            int D, float scale, int bf16,
                                            int variant, int ablate,
                                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((F != 64 && F != 112) || C_in < 2 || D % kFvTW ||
      C_in % (bf16 ? 8 : 4) || !aligned16(x) || !aligned16(layout) ||
      (variant && ablate))
    return (int)cudaErrorInvalidValue;
#define SMT_FPROBE(BF, NT, ST, ABL, BULK, WG, SP)                          \
  return launch_fused<NT, BF, ST, ABL, BULK, WG, SP>(x, layout, bias, out, \
                                                     C_in, F, H, W, D,     \
                                                     scale, st);
#define SMT_FPROBE_ALL(BF, NT, ST)                                         \
  constexpr bool SP = NT <= 8;                                             \
  if (variant == 0 && ablate == 0)                                         \
    SMT_FPROBE(BF, NT, ST, 0, true, true, SP)                              \
  if (ablate == kFvAblStage)                                               \
    SMT_FPROBE(BF, NT, ST, kFvAblStage, true, true, SP)                    \
  if (ablate == kFvAblConv)                                                \
    SMT_FPROBE(BF, NT, ST, kFvAblConv, true, true, SP)                     \
  if (ablate == kFvAblBand)                                                \
    SMT_FPROBE(BF, NT, ST, kFvAblBand, true, true, SP)                     \
  if (ablate == kFvAblStore)                                               \
    SMT_FPROBE(BF, NT, ST, kFvAblStore, true, true, SP)                    \
  if (variant == 1) SMT_FPROBE(BF, NT, ST, 0, false, true, SP)             \
  if (variant == 2) SMT_FPROBE(BF, NT, 2, 0, true, true, SP)               \
  if (variant == 3) SMT_FPROBE(BF, NT, ST, 0, true, false, SP)             \
  if (variant == 4 && SP) SMT_FPROBE(BF, NT, ST, 0, true, true, false)
  if (F == 64) {
    if (bf16) { SMT_FPROBE_ALL(true, 8, 6) }
    { SMT_FPROBE_ALL(false, 8, 4) }
  } else {
    if (bf16) { SMT_FPROBE_ALL(true, 14, 4) }
    { SMT_FPROBE_ALL(false, 14, 3) }
  }
#undef SMT_FPROBE_ALL
#undef SMT_FPROBE
  return (int)cudaErrorInvalidValue;
}
