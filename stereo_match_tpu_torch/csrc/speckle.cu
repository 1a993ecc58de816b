// K5 speckle_filter: the whole speckle filter in one cooperative launch.
//
// Replaces, in stereo_match_tpu/ops/pallas_speckle.py, speckle_filter_pallas
// (_labels_kernel, _dist_kernel, _deliver_kernel, _keep_kernel). What it
// ports is the XLA path of stereo_match_tpu/ops/speckle.py, which the
// Pallas kernels equal: the BFS distances, spanning-tree parents and count
// delivery of the TPU kernels exist only because Mosaic has no scatter.
// Like _labels_kernel, the sweeps run to their fixpoint inside the kernel.
//
// One persistent grid (two 512-thread blocks an SM, all co-resident under
// cudaLaunchCooperativeKernel) runs the phases, with a grid barrier
// (cooperative_groups' grid sync) between them:
//   0. setup: label words (the label y*W + x, or H*W + 1 for an invalid
//      pixel, with a bit each for "joined to the left neighbour" and
//      "joined to the pixel above": the float test of ops/speckle.py,
//      invalid pixels comparing as inf), zeroed counts and sweep flags;
//   1. row half-sweep: a block stages its rows (blockIdx.x + j * grid, so
//      the rows spread over the SMs) in shared memory by cp.async, a warp
//      scans each, x-forward then x-reverse on the forward result, and
//      writes it back whole if it changed;
//   2. column half-sweep: a block stages a strip of 16 columns, one a warp
//      (bands of up to kBand rows), each warp scans its column, y-forward
//      then y-reverse, and the strip goes back a row piece at a time if it
//      changed;
//   3. a sweep that lowered a label set flags[sweep]; after the barrier
//      every block reads that word and leaves the loop when it is 0 or the
//      sweep was number max_iters. One word a sweep, so no reset race;
//   4. count: valid (finite) pixels add 1 to count[label] by integer
//      atomics, the lanes of a warp that share a label once
//      (__match_any_sync), and a block once for the label each of its warps
//      met first;
//   5. keep: out = d where the pixel is valid and its component holds at
//      least `threshold` pixels (or the sweeps did not converge), else NaN.
// stats = {sweeps run, unconverged}, for the checks; the path never reads
// it.
//
// A scan of a line (a row or a column) by one warp (line_scan) on the staged
// label words, whose join bit for the line (left for a row, up for a
// column) says whether a pixel joins its predecessor. Lane l walks an
// odd-length segment of the line serially (odd, so the 32 lanes' words lie
// in distinct banks), the segments' ends are folded across the lanes by 5
// shuffles (a segment with a break passes on its own end, one without takes
// the minimum with the carry from before it), and each segment's head takes
// the fold until it no longer lowers a label. The reverse scan (pixel i
// joins i + 1 where i + 1's bit is set) does the same from the other end.
// Min is exact, so the order of the min operations inside a scan is free;
// the scans and sweeps are exactly the reference's, which is what makes
// `unconverged` (sweep number max_iters still lowered a label) the
// reference's too.
//
// Bound on the H100: bytes, d read once and out written once (8 bytes a
// pixel). The label words are the kernel's scratch: each sweep reads and
// writes them twice, 16 bytes a pixel, which the 50 MB L2 holds at KITTI
// and 720p, so they need not cross to device memory. What the design keeps
// short is latency: the grid barriers (two a sweep), one
// round trip to device memory a stage (cp.async, no register between), and
// the serial walks, which run in shared memory: W/32 pixels a row lane,
// H/32 a column lane. All threads stage and scan columns, so the
// instructions a pixel count as much as the latency: two blocks of 16
// warps an SM, each on a strip of 16 columns (64-byte row pieces), spread
// the column scans over twice the SMs that one block of 32 warps on 32
// columns would, and ran the KITTI and 720p filters faster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;                // a block: 2 an SM
constexpr int kBlocksPerSM = 1024 / kThreads;  // 1024 threads an SM
constexpr int kWarps = kThreads / 32;        // a strip's columns, a warp each
constexpr int kStage = 8;                    // loads a thread issues at once
constexpr unsigned kFull = 0xffffffffu;
// A label word: the label in bits 0-29, whether the pixel joins its left
// neighbour in bit 31 and the pixel above in bit 30.
constexpr int kLabel = (1 << 30) - 1;        // label mask; above every label
constexpr int kJoinLeft = INT_MIN, kJoinUp = 1 << 30;
constexpr int kJoins = kJoinLeft | kJoinUp;
constexpr int kMaxDevices = 64;
constexpr long long kMaxPixels = 1LL << 29;  // labels below 2^29 + 2
// Dynamic shared memory: the rows of a block's round, or a strip's band of
// kWarps columns at a row stride of kWarps + 1 words (odd: a column's words
// in distinct banks).
constexpr int kSmemBytes = 200 * 1024 / kBlocksPerSM;
constexpr int kStrip = kWarps + 1;
constexpr int kBand = kSmemBytes / (kStrip * 4);   // 1505 rows

// Copy 4 bytes from device to shared memory without a register.
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp's segmented min scan of a line of n staged label words (element
// i at v[i * vs]; JOIN: the bit that joins a pixel to its predecessor on
// the line), in scan order i = 0 .. n-1 (FWD: i joins i - 1 by its own bit)
// or n-1 .. 0 (i joins i + 1 by i + 1's bit), with `carry` from before the
// line in scan order; reverse, `tail_join` says whether element n-1 joins
// it. A lowered label goes to its word; the caller writes the line back to
// device memory.
template <bool FWD, int JOIN>
__device__ bool line_scan(int* v, int vs, int n, int lane, int carry,
                          bool tail_join = false) {
  const int seg = ((n + 31) >> 5) | 1;
  const int a = min(n, lane * seg), len = min(n, a + seg) - a;
  int* const first = v + (FWD ? a : a + len - 1) * vs;
  const int step = FWD ? vs : -vs;
  // reverse: whether the element after the segment's last joins it
  const bool after =
      !FWD && (a + len < n ? (v[(a + len) * vs] & JOIN) != 0 : tail_join);
  bool lowered = false;

  bool nj = after;
  int run = kLabel;
  bool cut = false;
  int* p = first;
  for (int k = 0; k < len; ++k, p += step) {
    const int w = *p;
    const int lab = w & kLabel;
    const bool join = FWD ? (w & JOIN) != 0 : nj;
    nj = (w & JOIN) != 0;
    const int nv = join ? min(lab, run) : lab;
    cut |= !join;
    run = nv;
    if (nv < lab) {
      *p = nv | (w & kJoins);
      lowered = true;
    }
  }

  // inclusive segmented scan of the segment ends over the lanes, in scan
  // order, then the carry into this lane's segment
  int e = run;
  bool f = cut;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int e2 = FWD ? __shfl_up_sync(kFull, e, off)
                       : __shfl_down_sync(kFull, e, off);
    const bool f2 = FWD ? __shfl_up_sync(kFull, f, off)
                        : __shfl_down_sync(kFull, f, off);
    if (FWD ? lane >= off : lane + off < 32) {
      if (!f) e = min(e, e2);
      f = f || f2;
    }
  }
  const int ep = FWD ? __shfl_up_sync(kFull, e, 1)
                     : __shfl_down_sync(kFull, e, 1);
  const bool fp = FWD ? __shfl_up_sync(kFull, f, 1)
                      : __shfl_down_sync(kFull, f, 1);
  const int c = (FWD ? lane == 0 : lane == 31) ? carry
                : fp ? ep : min(carry, ep);

  nj = after;
  p = first;
  for (int k = 0; k < len; ++k, p += step) {   // the head the carry reaches
    const int w = *p;
    const bool join = FWD ? (w & JOIN) != 0 : nj;
    nj = (w & JOIN) != 0;
    if (!join || c >= (w & kLabel)) break;
    *p = c | (w & kJoins);
    lowered = true;
  }
  return lowered;
}

// Stage rows j0 .. j0+n-1 of the block (row blockIdx.x + j * gridDim.x), W
// words a row, by cp.async.
__device__ void stage_rows(const int* lab, int* rv, int j0, int n, int W) {
  for (int q = 0; q < n; ++q) {
    const int* row = lab + (size_t)(blockIdx.x + (j0 + q) * gridDim.x) * W;
    for (int x = threadIdx.x; x < W; x += kThreads)
      cp_async4(rv + q * W + x, row + x);
  }
  cp_async_wait_all();
}

// Stage band rows b0 .. b0+n-1 of the strip's kWarps columns from x0, row
// r at sl[r * kStrip], by cp.async, a row piece of kWarps words at a time;
// columns past W hold a label above all.
__device__ void stage_band(const int* lab, int* sl, int x0, int b0, int n,
                           int W) {
  const int c = threadIdx.x % kWarps, x = x0 + c;
  for (int r = threadIdx.x / kWarps; r < n; r += kThreads / kWarps) {
    if (x < W)
      cp_async4(sl + r * kStrip + c, lab + (size_t)(b0 + r) * W + x);
    else
      sl[r * kStrip + c] = kLabel;
  }
  cp_async_wait_all();
}

// Write the band back to device memory, a row piece at a time.
__device__ void write_band(int* lab, const int* sl, int x0, int b0, int n,
                           int W) {
  const int c = threadIdx.x % kWarps, x = x0 + c;
  if (x < W)
    for (int r = threadIdx.x / kWarps; r < n; r += kThreads / kWarps)
      lab[(size_t)(b0 + r) * W + x] = sl[r * kStrip + c];
}

// y-forward then y-reverse scan of the kWarps columns from x0: warp j scans
// column x0 + j. Bands of kBand rows, the carry passed from band to band:
// forward top band first, then reverse bottom band first.
__device__ bool column_half_sweep(int* lab, int x0, int H, int W, int warp,
                                  int lane, int* sl) {
  const int x = x0 + warp;
  const int bands = (H + kBand - 1) / kBand;
  bool lowered = false;
  for (int pass = 0; pass < (bands > 1 ? 2 : 1); ++pass) {
    int carry = kLabel;
    for (int k = 0; k < bands; ++k) {
      const int b = pass == 0 ? k : bands - 1 - k;
      const int b0 = b * kBand, n = min(kBand, H - b0);
      __syncthreads();
      stage_band(lab, sl, x0, b0, n, W);
      __syncthreads();
      bool changed = false;
      if (x < W) {
        int* col = sl + warp;
        if (pass == 0) {
          changed = line_scan<true, kJoinUp>(col, kStrip, n, lane, carry);
          __syncwarp();
          carry = col[(n - 1) * kStrip] & kLabel;
        }
        if (pass == 1 || bands == 1) {
          const bool tail =
              b0 + n < H && (lab[(size_t)(b0 + n) * W + x] & kJoinUp);
          changed |= line_scan<false, kJoinUp>(
              col, kStrip, n, lane, pass == 1 ? carry : kLabel, tail);
          __syncwarp();
          carry = col[0] & kLabel;
        }
      }
      if (__syncthreads_or(changed)) {         // the band back if it moved
        write_band(lab, sl, x0, b0, n, W);
        lowered = true;
      }
    }
  }
  return lowered;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
speckle_filter_kernel(const float* __restrict__ d, float* __restrict__ out,
                      int* lab, int* count, int* flags, int* stats, int H,
                      int W, int threshold, float tol, int max_iters) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int sh_count[kWarps][2];
  cg::grid_group grid = cg::this_grid();
  const int hw = H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const float inf = __int_as_float(0x7f800000);

  // 0. setup, kStage pixels a thread at once
  for (int i0 = tid; i0 < hw; i0 += kStage * nthreads) {
    float c[kStage], l[kStage], u[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * nthreads;
      const int y = i / W, x = i - y * W;
      c[k] = i < hw ? d[i] : 0.0f;
      l[k] = i < hw && x > 0 ? d[i - 1] : inf;
      u[k] = i < hw && y > 0 ? d[i - W] : inf;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * nthreads;
      if (i >= hw) break;
      const bool ok = isfinite(c[k]);
      const float ci = ok ? c[k] : inf;
      const float li = isfinite(l[k]) ? l[k] : inf;
      const float ui = isfinite(u[k]) ? u[k] : inf;
      lab[i] = ok ? i | (fabsf(li - ci) <= tol ? kJoinLeft : 0) |
                        (fabsf(ui - ci) <= tol ? kJoinUp : 0)
                  : hw + 1;
      count[i] = 0;
    }
  }
  for (int i = tid; i < max(max_iters, 1); i += nthreads) flags[i] = 0;
  grid.sync();

  // the rows a block stages at once
  const int slots = min(kWarps, kSmemBytes / (W * 4));
  const int rows = blockIdx.x < H ? (H - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  int sweeps = 0, unconverged = 1;
  for (int s = 0; s < max_iters; ++s) {
    // 1. rows: row blockIdx.x + j * gridDim.x to block blockIdx.x, across
    // the SMs; a round stages up to `slots` of them, a warp scans each
    bool lowered = false;
    for (int j0 = 0; j0 < rows; j0 += slots) {
      const int n = min(slots, rows - j0);
      __syncthreads();
      stage_rows(lab, smem, j0, n, W);
      __syncthreads();
      if (warp < n) {
        int* sv = smem + warp * W;
        bool changed = line_scan<true, kJoinLeft>(sv, 1, W, lane, kLabel);
        __syncwarp();
        changed |= line_scan<false, kJoinLeft>(sv, 1, W, lane, kLabel);
        if (__any_sync(kFull, changed)) {      // the row back, coalesced
          __syncwarp();
          int* row =
              lab + (size_t)(blockIdx.x + (j0 + warp) * gridDim.x) * W;
          for (int x = lane; x < W; x += 32) row[x] = sv[x];
          lowered = true;
        }
      }
    }
    if (__any_sync(kFull, lowered) && lane == 0) flags[s] = 1;
    grid.sync();
    // 2. columns: a strip of kWarps a block
    lowered = false;
    for (int x0 = blockIdx.x * kWarps; x0 < W; x0 += gridDim.x * kWarps)
      lowered |= column_half_sweep(lab, x0, H, W, warp, lane, smem);
    if (__any_sync(kFull, lowered) && lane == 0) flags[s] = 1;
    grid.sync();
    // 3. the same word in every block after the barrier
    sweeps = s + 1;
    if (*(volatile int*)(flags + s) == 0) {
      unconverged = 0;
      break;
    }
  }

  // 4. count the valid pixels by label. A warp walks a contiguous span of
  // chunks and keeps the count of the first label it meets in registers;
  // the block's warps then add their kept counts once a label, so a
  // component that covers the frame costs an atomic a block, not one a
  // warp a chunk (atomics on one address queue in L2). The lanes of a
  // chunk that share another label add once (__match_any_sync).
  {
    const int chunks = (hw + 31) >> 5;
    const int per = (chunks + gridDim.x * kWarps - 1) / (gridDim.x * kWarps);
    const int c0 = (blockIdx.x * kWarps + warp) * per;
    const int c1 = min(chunks, c0 + per);
    int kept = hw, mine = 0;
    for (int cb = c0; cb < c1; cb += kStage) {
      int l[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = (cb + k) * 32 + lane;
        const bool ok = cb + k < c1 && i < hw;
        const int li = ok ? lab[i] & kLabel : hw;
        l[k] = ok && isfinite(d[i]) ? li : hw;
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        if (kept == hw) {
          const unsigned any = __ballot_sync(kFull, l[k] < hw);
          if (any) kept = __shfl_sync(kFull, l[k], __ffs(any) - 1);
        }
        const unsigned peers = __match_any_sync(kFull, l[k]);
        if (l[k] < hw && lane == __ffs(peers) - 1) {
          if (l[k] == kept)
            mine += __popc(peers);
          else
            atomicAdd(count + l[k], __popc(peers));
        }
      }
    }
    mine = __reduce_add_sync(kFull, mine);
    if (lane == 0) {
      sh_count[warp][0] = kept;
      sh_count[warp][1] = mine;
    }
    __syncthreads();
    if (warp == 0) {
      const int l = lane < kWarps ? sh_count[lane][0] : hw;
      const unsigned peers = __match_any_sync(kFull, l);
      const int n = __reduce_add_sync(peers, lane < kWarps
                                                 ? sh_count[lane][1] : 0);
      if (l < hw && lane == __ffs(peers) - 1) atomicAdd(count + l, n);
    }
  }
  grid.sync();

  // 5. keep
  for (int i0 = tid; i0 < hw; i0 += kStage * nthreads) {
    int l[kStage];
    float v[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * nthreads;
      l[k] = i < hw ? lab[i] & kLabel : 0;
      v[k] = i < hw ? d[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * nthreads;
      if (i >= hw) break;
      const bool keep = isfinite(v[k]) &&
                        (unconverged || count[l[k]] >= threshold);
      out[i] = keep ? v[k] : __int_as_float(0x7fc00000);   // torch's NaN
    }
  }
  if (tid == 0) {
    stats[0] = sweeps;
    stats[1] = unconverged;
  }
}

}  // namespace

// d: (H, W) float32 disparities; out: (H, W) float32. Scratch, uninitialised
// (the kernel sets it): labels (H, W) int32 words, count H*W int32, flags
// max(max_iters, 1) int32; stats: 2 int32 {sweeps run, unconverged}. H*W
// must be below 2^29 and a row must fit the shared memory (W <= 25600).
// Fails when the card cannot run a cooperative launch or hold one block an
// SM; there is no other path.
extern "C" int smt_speckle_filter(const float* d, float* out, int* labels,
                                  int* count, int* flags, int* stats, int H,
                                  int W, int threshold, float max_diff,
                                  int max_iters, void* stream) {
  if (H < 1 || W < 1 || (long long)H * W >= kMaxPixels ||
      W * 4 > kSmemBytes)
    return (int)cudaErrorInvalidValue;
  static int grid_of[kMaxDevices];           // blocks, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  // the shared-memory limit is an attribute of the kernel on each card
  err = cudaFuncSetAttribute(speckle_filter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (grid_of[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, speckle_filter_kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    if (per_sm < 1 || sms < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid_of[dev] = min(per_sm, kBlocksPerSM) * sms;
  }
  void* args[] = {&d, &out,       &labels,   &count,    &flags, &stats,
                  &H, &W,         &threshold, &max_diff, &max_iters};
  err = cudaLaunchCooperativeKernel((const void*)speckle_filter_kernel,
                                    dim3(grid_of[dev]), dim3(kThreads), args,
                                    kSmemBytes, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
