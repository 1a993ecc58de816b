// K4 wta_lr: winner-take-all, subpixel, uniqueness and the disp12 check;
// with three stand-alone entries, wta_stats and right_wta over a finished
// volume and lr_mask over finished disparity maps.
//
// Replaces, in stereo_match_tpu/ops/pallas_kernels.py, the statistics half
// of sgm_scan3_stats_pallas (_wta_stats_rows: best, first argmin, c(idx-1),
// c(idx+1), best outside idx +- 1, and the right-view argmin), all of
// lr_mask_pallas (_lr_mask_kernel: fused into wta_lr on the main path, and
// the lr_mask entry), wta_stats_pallas (_wta_stats_kernel: the five
// statistics, as the wta_stats entry) and right_wta_pallas
// (_right_wta_kernel: the right-view argmin, as the right_wta entry). With
// the elementwise tail of ops/wta.py::disparity_from_stats the three entries
// give ops/cuda_kernels.py::extract_disparity_fast's output:
//   disp  = idx + clip((c0 - c2) / (2 max(c0 - 2 best + c2, 1e-9)), +-0.5)
//           (offset 0 at the D-range edges or when the denominator <= 1e-9),
//           + min_d;
//   valid = second * 100 > best * (100 + ratio)            (ratio > 0)
//         & |disp - dR(rint(x - disp))| <= tol, rint(x - disp) in frame
//                                                          (tol >= 0),
// where dR(xr) = min_d + argmin over in-frame d of C(d, y, xr + d), ties to
// the smallest d. rintf rounds half to even, as jnp.round does (roundf
// would round half away from zero). The volume is float32 or int16; int16
// costs are widened to float, which is exact for them (|C| < 2^15), so the
// uniqueness products equal the int32 ones of the XLA int16 path. c0, c2
// and second are 3e9 where no such d exists, as in _wta_stats_rows.
//
// Bound on the H100: one read of the aggregated volume (238 MB at KITTI
// D=128 float32, 71 us at 3.35 TB/s; 119 MB, 36 us, in int16) and the (H, W)
// maps written. Each entry reads every cell of the volume from device
// memory once. Design: one block of 512 threads per image row walks the
// row in tiles of kTile = 64 columns by all D planes, staged in shared
// memory by cp.async (8 bytes a copy where the rows allow), the next tile
// arriving while the current one is walked. From a staged tile two groups
// of 256 threads work at once; costs compare as keys (int16 as int, no
// conversion a cell):
//  - the left group, a warp per (32 columns, phase s of S = 4 or 8): a lane
//    walks its column's d = s, s + S, ... once, keeping the phase's first
//    minimum b1 at i1 and b2, the minimum of its other costs. A column's
//    phases combine in shared memory: the (cost, d) lexicographic min of
//    the b1 is the first argmin idx; idx - 1, idx and idx + 1 lie in three
//    distinct phases, so the best cost outside idx +- 1 is the min over the
//    phases of b2 where i1 is one of them, else b1; c(idx -+ 1) are read
//    from the tile. The whole column is in the tile: one pass, exact.
//  - the right group: the D x 64 tile has D + 63 diagonals k = x - d (xr =
//    x0 + k); a lane walks one diagonal of the band whose diagonals all
//    hold min(D, 64) cells, or one of each corner triangle whose lengths
//    add up to that, so every lane takes the same number of steps. A
//    diagonal is walked in increasing d with strict <, from xr's running
//    (minimum, argmin) kept in shared memory from tile to tile (3e9 and 0
//    at the start, as right_wta_plain); a later tile holds larger d of the
//    same xr, so ties go to the smallest d without atomics.
// wta_lr keeps the row's left disparities, uniqueness flags and right-view
// minima in shared memory, so the disp12 check's sampling at x - disp needs
// no gather from device memory; wta_stats runs the left group alone,
// right_wta the right group alone (the other group helps stage). right_wta
// needs no whole column, so its tiles are 32 planes by 256 columns, walked
// column block by column block and, within one, plane block by plane
// block: a diagonal's d and x grow together, so it still meets its cells
// in increasing d. lr_mask stages the row of the right-view map in shared
// memory the same way.
// Measured on the H100: 64-column tiles (256-byte row pieces of float32)
// with two buffers beat 32-column ones with three (more blocks an SM);
// where D planes of 64 columns exceed the card's shared memory, the tile
// narrows (32, 16 or 8 columns).

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr float kBig = 3e9f;
constexpr int kThreads = 256;    // lr_mask
constexpr int kTile = 64;        // columns of a staged tile, at most
constexpr int kRightTile = 256;  // right_wta: columns of a tile, at most,
constexpr int kRightPlanes = 32; // of this many planes
constexpr int kWalkThreads = 512;
constexpr int kGroup = 256;      // threads of the left group, and of the right
constexpr int kLeftWarps = kGroup / 32;

enum Mode { kWtaLr, kStats, kRight };

// Outputs of the three entries; each mode writes its own.
struct Outputs {
  float* disp;          // kWtaLr: (H, W), NaN where invalid
  float* disp_right;    // kWtaLr: (H, W) right-view disparity
  float* best;          // kStats: (H, W) x 5
  int* idx;
  float* c0;
  float* c2;
  float* second;
  int* ridx;            // kRight: (H, W) right-view argmin
};

struct Params {
  int D, H, W, tx, tx_log2, dt, pitch, copy;   // a tile: dt planes x tx
  int min_d, uniqueness_ratio, disp12_max_diff, subpixel;
};

// The walk compares costs as keys: float32 costs as themselves, int16 costs
// as int (the same order, exact; no conversion a cell). A key converts to
// the float32 the plain versions take: int16 widened, 3e9 for "none".
template <typename T>
struct Key;
template <>
struct Key<float> {
  using type = float;
  static __device__ float none() { return kBig; }
  static __device__ float inf() { return __int_as_float(0x7f800000); }
  static __device__ float min(float a, float b) { return fminf(a, b); }
  static __device__ float to_float(float k) { return k; }
};
template <>
struct Key<short> {
  using type = int;
  static __device__ int none() { return INT_MAX; }
  static __device__ int inf() { return INT_MAX; }
  static __device__ int min(int a, int b) { return ::min(a, b); }
  static __device__ float to_float(int k) {
    return k == INT_MAX ? kBig : (float)k;
  }
};

// The tile's pitch in cells, tx + 2: rows stay 8-byte aligned for the
// copies; lanes on consecutive diagonals are at most 2-way bank conflicts.
__host__ __device__ inline int tile_pitch(int tx) { return tx + 2; }

// Bytes of one staged tile (a multiple of 16).
template <typename T>
__host__ __device__ size_t tile_bytes(int D, int tx) {
  return ((size_t)D * tile_pitch(tx) * sizeof(T) + 15) / 16 * 16;
}

// The left group's partial statistics: per phase and column, the phase's
// best cost, its first index and the best of the phase's other costs.
constexpr size_t kPartBytes = 12 * kLeftWarps * 32;

// Shared-memory bytes of a block: two tiles (the one walked, the next one
// arriving), the left partials, then the row arrays (right-view minimum
// and argmin; wta_lr also the left disparities and uniqueness).
template <typename T>
size_t walk_smem(int mode, int D, int W, int tx) {
  const size_t row = mode == kWtaLr ? 13 * (size_t)W
                     : mode == kRight ? 8 * (size_t)W : 0;
  return 2 * tile_bytes<T>(D, tx) + kPartBytes + row;
}

// Copy N = 4 or 8 bytes from device to shared memory without a register;
// cp.async groups complete in order.
template <int N>
__device__ inline void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's copies of a tile: plane rows d0, d0 + rows, ... < D of its
// column; COPY bytes a cp.async, or 0: through a register.
template <typename T, int COPY>
__device__ void stage_rows(T* __restrict__ dst, const T* __restrict__ src,
                           int d0, int D, int rows, int dst_step,
                           size_t src_step) {
  for (int d = d0; d < D; d += rows, dst += dst_step, src += src_step) {
    if constexpr (COPY == 0)
      *dst = *src;
    else
      cp_async<COPY>(dst, src);
  }
}

// Start staging the tile at column x0 of the row's planes from `row` on
// (`planes` of them), p.copy bytes a cp.async (8: two float32 cells, 4: one
// float32 or two int16 cells, as the rows' alignment allows; 0: int16 cells
// of odd rows, copied through registers). Thread t takes cells t * step +
// i * kWalkThreads * step of the tile (rows coalesced). Commits one
// cp.async group, empty past the row's end.
template <typename T>
__device__ void stage_tile(T* __restrict__ tile, const T* __restrict__ row,
                           size_t plane, int x0, int txe, int planes,
                           const Params& p) {
  const int step = p.copy ? p.copy / (int)sizeof(T) : 1;   // cells a copy
  const int e0 = threadIdx.x * step;
  const int j = e0 & (p.tx - 1), d0 = e0 >> p.tx_log2;
  if (txe > 0 && j < txe) {
    const int rows = (kWalkThreads * step) >> p.tx_log2;
    T* dst = tile + d0 * p.pitch + j;
    const T* src = row + d0 * plane + x0 + j;
    if (p.copy == 8)
      stage_rows<T, 8>(dst, src, d0, planes, rows, rows * p.pitch,
                        rows * plane);
    else if (p.copy == 4)
      stage_rows<T, 4>(dst, src, d0, planes, rows, rows * p.pitch,
                        rows * plane);
    else
      stage_rows<T, 0>(dst, src, d0, planes, rows, rows * p.pitch,
                        rows * plane);
  }
  cp_async_commit();
}

// One phase of the left walk: column j's costs at d = s, s + S, ... in
// increasing d: the first minimum b1 at i1, and b2, the minimum of the
// phase's other costs (strict <: the old minimum moves to b2).
template <typename T>
__device__ void phase_walk(const T* __restrict__ tile, int P, int D, int j,
                           int s, int S, typename Key<T>::type& b1, int& i1,
                           typename Key<T>::type& b2) {
  using KT = Key<T>;
  b1 = KT::inf();
  b2 = KT::inf();
  i1 = D;
  if (s >= D) return;
  b1 = tile[s * P + j];
  i1 = s;
#pragma unroll 4
  for (int d = s + S; d < D; d += S) {
    const typename KT::type v = tile[d * P + j];
    const bool lower = v < b1;
    b2 = lower ? b1 : KT::min(b2, v);
    i1 = lower ? d : i1;
    b1 = lower ? v : b1;
  }
}

// Column j's statistics from its S phases: the (cost, d) lexicographic min
// is the first argmin; idx -+ 1 and idx fall in three distinct phases
// (S >= 3), so a phase holding one of them at i1 gives b2, the others b1,
// and their min is the best cost outside idx +- 1.
template <typename T>
__device__ void column_stats(const T* __restrict__ tile, int P, int D, int j,
                             int S, int tx,
                             const typename Key<T>::type* __restrict__ pb1,
                             const int* __restrict__ pi1,
                             const typename Key<T>::type* __restrict__ pb2,
                             float& best, int& idx, float& c0, float& c2,
                             float& second) {
  using KT = Key<T>;
  typename KT::type kb = pb1[j];
  idx = pi1[j];
  for (int s = 1; s < S; ++s) {
    const typename KT::type b = pb1[s * tx + j];
    const int i = pi1[s * tx + j];
    if (b < kb || (b == kb && i < idx)) {
      kb = b;
      idx = i;
    }
  }
  typename KT::type ks = KT::none();
  for (int s = 0; s < S; ++s) {
    const int i = pi1[s * tx + j];
    ks = KT::min(ks, i >= idx - 1 && i <= idx + 1 ? pb2[s * tx + j]
                                                  : pb1[s * tx + j]);
  }
  best = KT::to_float(kb);
  second = KT::to_float(ks);
  c0 = idx > 0 ? KT::to_float(tile[(idx - 1) * P + j]) : kBig;
  c2 = idx < D - 1 ? KT::to_float(tile[(idx + 1) * P + j]) : kBig;
}

// The disp12 check of pixel x: rint(x - dl) in frame and
// |dl - s_right[rint(x - dl)]| <= tol (NaN dl -> false). The tolerance is a
// float, as lr_mask_pallas takes it (ELAS's lr_tol); wta_lr passes its
// integer disp12_max_diff.
__device__ bool disp12_ok(float dl, const float* s_right, int x, int W,
                          float tol) {
  const float xr = rintf((float)x - dl);
  const bool inframe = xr >= 0.f && xr < (float)W;   // NaN -> false
  const float dr = s_right[inframe ? (int)xr : 0];
  return inframe && fabsf(dl - dr) <= tol;
}

// Diagonal k of the staged tile of planes d0 .. d0 + D - 1 by w columns
// from x0 (cells (d0 + i, x0 + i + k), xr = x0 - d0 + k), in increasing d
// with strict <, from xr's running (minimum, argmin).
template <typename T>
__device__ void diagonal_walk(const T* __restrict__ tile, int P, int D,
                              int xr0, int d0, int w, int k,
                              typename Key<T>::type* __restrict__ s_rbest,
                              int* __restrict__ s_ridx) {
  using KT = typename Key<T>::type;
  const int xr = xr0 + k;
  if (xr < 0) return;
  const int lo = max(0, -k), hi = min(D - 1, w - 1 - k);
  KT b = s_rbest[xr];
  int bi = s_ridx[xr];
  const T* cell = tile + lo * (P + 1) + k;
#pragma unroll 4
  for (int i = lo; i <= hi; ++i, cell += P + 1) {
    const KT v = *cell;
    bi = v < b ? d0 + i : bi;
    b = v < b ? v : b;
  }
  s_rbest[xr] = b;
  s_ridx[xr] = bi;
}

// The right-view walk of one staged D x w tile (planes d0 .., columns
// x0 ..), max(D, w) lanes of min(D, w) cells each: a lane walks one
// diagonal of the band where every diagonal has min(D, w) cells, or a
// diagonal of one corner triangle and the one of the other whose lengths
// add up to min(D, w).
template <typename T>
__device__ void right_walk(const T* __restrict__ tile, int P, int D, int x0,
                           int d0, int w, int rt,
                           typename Key<T>::type* __restrict__ s_rbest,
                           int* __restrict__ s_ridx) {
  const int lanes = max(D, w);
  for (int l = rt; l < lanes; l += kGroup) {
    int k1, k2;
    bool two;
    if (w <= D) {                  // band k = 0 .. -(D - w), length w
      two = l > D - w;
      k1 = two ? l - (D - w) : -l;
      k2 = k1 - D;
    } else {                       // band k = 0 .. w - D, length D
      two = l > w - D;
      k1 = l;
      k2 = l - w;
    }
    diagonal_walk(tile, P, D, x0 - d0, d0, w, k1, s_rbest, s_ridx);
    if (two) diagonal_walk(tile, P, D, x0 - d0, d0, w, k2, s_rbest, s_ridx);
  }
}

// One block per image row: the row's tiles staged one after another, each
// read from device memory once (the next tile arriving by cp.async while
// the current one is walked), feeding the left statistics
// (kWtaLr, kStats) and the right-view walk (kWtaLr, kRight); then wta_lr's
// subpixel, uniqueness and disp12 check from the row in shared memory.
template <typename T, int MODE>
__global__ void __launch_bounds__(kWalkThreads, 3)
wta_walk_kernel(const T* __restrict__ tot, Outputs o, Params p) {
  using KT = Key<T>;
  constexpr bool kLeft = MODE != kRight;
  constexpr bool kRightView = MODE != kStats;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, W = p.W, tx = p.tx, P = p.pitch, dt = p.dt;
  const size_t tb = tile_bytes<T>(dt, tx);
  typename KT::type* pb1 =
      reinterpret_cast<typename KT::type*>(smem + 2 * tb);
  int* pi1 = reinterpret_cast<int*>(pb1 + kLeftWarps * 32);
  typename KT::type* pb2 =
      reinterpret_cast<typename KT::type*>(pi1 + kLeftWarps * 32);
  typename KT::type* s_rbest = reinterpret_cast<typename KT::type*>(
      smem + 2 * tb + kPartBytes);
  int* s_ridx = reinterpret_cast<int*>(s_rbest + W);
  float* s_left = reinterpret_cast<float*>(s_ridx + W);
  unsigned char* s_uniq = reinterpret_cast<unsigned char*>(s_left + W);
  const int y = blockIdx.x;
  const size_t plane = (size_t)p.H * W;
  const size_t at = (size_t)y * W;
  const T* row = tot + at;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (kRightView)
    for (int x = tid; x < W; x += kWalkThreads) {
      s_rbest[x] = KT::none();
      s_ridx[x] = 0;
    }

  // tile t (columns x0 = t / nd * tx, planes d0 = t % nd * dt; nd = 1 but
  // for right_wta) in buffer t % 2; the next tile arrives while this one is
  // walked. Along a diagonal both d and x grow, so it meets its tiles in
  // increasing d: strict < keeps the smallest d on ties.
  const int nd = (D + dt - 1) / dt;
  const int tiles = (W + tx - 1) / tx * nd;
  auto buffer = [&](int t) { return reinterpret_cast<T*>(smem + (t & 1) * tb); };
  auto stage = [&](int t) {
    const int x0 = t / nd * tx, d0 = t % nd * dt;
    stage_tile(buffer(t), row + d0 * plane, plane, x0, min(tx, W - x0),
               min(dt, D - d0), p);
  };
  stage(0);
  for (int t = 0; t < tiles; ++t) {
    const int x0 = t / nd * tx, d0 = t % nd * dt;
    const int txe = min(tx, W - x0);
    const T* tile = buffer(t);
    if (t + 1 < tiles)
      stage(t + 1);
    else
      cp_async_commit();                      // an empty group
    cp_async_wait<1>();
    __syncthreads();

    if (kLeft && tid < kGroup) {
      // warp (column group, phase): lanes on 32 columns, S phases of d
      const int groups = (tx + 31) / 32, S = kLeftWarps / groups;
      const int j = (warp % groups) * 32 + lane, s = warp / groups;
      if (j < txe) {
        typename KT::type b1, b2;
        int i1;
        phase_walk(tile, P, D, j, s, S, b1, i1, b2);
        pb1[s * tx + j] = b1;
        pi1[s * tx + j] = i1;
        pb2[s * tx + j] = b2;
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kGroup) : "memory");  // left group
      if (tid < txe) {
        float best, c0, c2, second;
        int idx;
        column_stats(tile, P, D, tid, S, tx, pb1, pi1, pb2, best, idx, c0,
                     c2, second);
        const int x = x0 + tid;
        if (MODE == kStats) {
          o.best[at + x] = best;
          o.idx[at + x] = idx;
          o.c0[at + x] = c0;
          o.c2[at + x] = c2;
          o.second[at + x] = second;
        } else {
          float dv = (float)idx;
          if (p.subpixel && idx > 0 && idx < D - 1) {
            const float denom = c0 - 2.0f * best + c2;
            float offset = 0.f;
            if (denom > 1e-9f)
              offset = (c0 - c2) / (2.0f * fmaxf(denom, 1e-9f));
            dv = dv + fminf(fmaxf(offset, -0.5f), 0.5f);
          }
          s_left[x] = dv + (float)p.min_d;
          s_uniq[x] = p.uniqueness_ratio <= 0 ||
                      second * 100.0f >
                          best * (100.0f + (float)p.uniqueness_ratio);
        }
      }
    }
    if (kRightView && tid >= kGroup)
      right_walk(tile, P, min(dt, D - d0), x0, d0, txe, tid - kGroup,
                 s_rbest, s_ridx);
    __syncthreads();                          // before the buffer is reused
  }

  if (MODE == kRight) {
    for (int x = tid; x < W; x += kWalkThreads) o.ridx[at + x] = s_ridx[x];
  } else if (MODE == kWtaLr) {
    float* s_right = reinterpret_cast<float*>(s_rbest);
    for (int x = tid; x < W; x += kWalkThreads) {
      const float r = (float)(s_ridx[x] + p.min_d);
      s_right[x] = r;                          // now the right-view map
      o.disp_right[at + x] = r;
    }
    __syncthreads();
    for (int x = tid; x < W; x += kWalkThreads) {
      const float dl = s_left[x];
      const bool ok = s_uniq[x] &&
                      (p.disp12_max_diff < 0 ||
                       disp12_ok(dl, s_right, x, W,
                                 (float)p.disp12_max_diff));
      o.disp[at + x] = ok ? dl : __int_as_float(0x7fc00000);
    }
  }
}

__global__ void lr_mask_kernel(const float* __restrict__ disp,
                               const float* __restrict__ disp_right,
                               bool* __restrict__ mask, int W, float tol) {
  extern __shared__ float s_right[];           // [W] the row of disp_right
  const size_t at = (size_t)blockIdx.x * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x)
    s_right[x] = disp_right[at + x];
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x)
    mask[at + x] = tol < 0.f || disp12_ok(disp[at + x], s_right, x, W, tol);
}

// Raise the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB. The attribute is per card, so it is set at every
// launch.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch the row walk of one entry: the widest tile (all D planes by 64,
// 32, 16 or 8 columns; right_wta 32 planes by 256 columns down) whose two
// buffers and row arrays the current card's shared memory holds. Wide
// tiles read longer row pieces of each plane (256 bytes of float32 at 64
// columns, 1 KB at 256), which the device memory serves better than more
// blocks an SM with narrower tiles (two blocks an SM at KITTI float32).
template <typename T, int MODE>
int launch_walk(const void* tot, const Outputs& o, Params p,
                cudaStream_t stream) {
  if (p.D < 1 || p.H < 1 || p.W < 1) return (int)cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  p.dt = MODE == kRight ? std::min(p.D, kRightPlanes) : p.D;
  p.tx = MODE == kRight ? kRightTile : kTile;
  while (p.tx > 8 && walk_smem<T>(MODE, p.dt, p.W, p.tx) > (size_t)optin)
    p.tx >>= 1;
  const size_t smem = walk_smem<T>(MODE, p.dt, p.W, p.tx);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  p.pitch = tile_pitch(p.tx);
  p.tx_log2 = 0;
  while ((1 << p.tx_log2) < p.tx) ++p.tx_log2;
  // 8 bytes a copy where every row's pairs of float32 cells are aligned,
  // 4 bytes where its float32 cells or int16 pairs are, else registers
  const uintptr_t base = reinterpret_cast<uintptr_t>(tot);
  const bool even = p.W % 2 == 0;
  p.copy = sizeof(T) == 4 ? (even && base % 8 == 0 ? 8 : 4)
                          : (even && base % 4 == 0 ? 4 : 0);
  err = allow_smem(wta_walk_kernel<T, MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  wta_walk_kernel<T, MODE><<<p.H, kWalkThreads, smem, stream>>>(
      static_cast<const T*>(tot), o, p);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_walk(const void* tot, int i16, const Outputs& o, const Params& p,
                void* stream) {
  if (i16) return launch_walk<short, MODE>(tot, o, p, (cudaStream_t)stream);
  return launch_walk<float, MODE>(tot, o, p, (cudaStream_t)stream);
}

Params dims(int D, int H, int W) {
  Params p{};
  p.D = D;
  p.H = H;
  p.W = W;
  return p;
}

}  // namespace

// tot: (D, H, W), float32 (i16 = 0) or int16 (i16 = 1); disp: (H, W)
// float32, NaN where invalid; disp_right: (H, W) float32.
extern "C" int smt_wta_lr(const void* tot, float* disp, float* disp_right,
                          int D, int H, int W, int min_d,
                          int uniqueness_ratio, int disp12_max_diff,
                          int subpixel, int i16, void* stream) {
  Outputs o{};
  o.disp = disp;
  o.disp_right = disp_right;
  Params p = dims(D, H, W);
  p.min_d = min_d;
  p.uniqueness_ratio = uniqueness_ratio;
  p.disp12_max_diff = disp12_max_diff;
  p.subpixel = subpixel;
  return launch_walk<kWtaLr>(tot, i16, o, p, stream);
}

// tot: (D, H, W) float32 or int16; best, c0, c2, second: (H, W) float32;
// idx: (H, W) int32.
extern "C" int smt_wta_stats(const void* tot, float* best, int* idx,
                             float* c0, float* c2, float* second, int D,
                             int H, int W, int i16, void* stream) {
  Outputs o{};
  o.best = best;
  o.idx = idx;
  o.c0 = c0;
  o.c2 = c2;
  o.second = second;
  return launch_walk<kStats>(tot, i16, o, dims(D, H, W), stream);
}

// tot: (D, H, W) float32 or int16; ridx: (H, W) int32 right-view argmin
// (without min_d).
extern "C" int smt_right_wta(const void* tot, int* ridx, int D, int H, int W,
                             int i16, void* stream) {
  Outputs o{};
  o.ridx = ridx;
  return launch_walk<kRight>(tot, i16, o, dims(D, H, W), stream);
}

// disp, disp_right: (H, W) float32 (the left map before the check, NaN
// allowed; the right-view map); mask: (H, W) bool, the disp12 check at the
// float tolerance tol (all true for tol < 0).
extern "C" int smt_lr_mask(const float* disp, const float* disp_right,
                           bool* mask, int H, int W, float tol,
                           void* stream) {
  const size_t smem = (size_t)W * sizeof(float);
  const cudaError_t err = allow_smem(lr_mask_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lr_mask_kernel<<<H, kThreads, smem, (cudaStream_t)stream>>>(
      disp, disp_right, mask, W, tol);
  return (int)cudaGetLastError();
}

