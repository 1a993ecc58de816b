// K3 sgm_path_scan: one SGM path direction, added into the running total.
//
// Replaces, in stereo_match_tpu/ops/pallas_kernels.py, the scans of
// sgm_census_hpair_pallas (directions (0, +1), (0, -1)), sgm_scan3_pallas
// (S, SE, SW, with its init_carry / return_carry and int16 storage),
// sgm_scan_pallas (any one direction, with the same carry and int16
// features) and the scan half of sgm_scan3_stats_pallas (N, NE, NW): one
// kernel parameterised by the direction (dy, dx), launched once per path.
// The recurrence is ops/sgm.py's, operation for operation:
//   m    = min(min(L[d], pmin + P2), min(L[d-1], L[d+1]) + P1)
//   L'   = (C + m) - pmin,   L[-1] = L[D] = big,   pmin = min_k L[k]
// with a zero carry where a path enters the frame, which is what the
// reference's shear (out-of-frame cells: cost 0, carry 0) gives. The
// horizontal directions read the (D, H, W) volume that K2 wrote, whose x < d
// cells hold 1e4 as the census-fused TPU scan's rebuilt rows do, so the
// totals equal sgm_census_hpair_pallas + scan3 bit for bit on census costs.
// `min` is exact and every element's expression is the plain version's, so
// the totals are bit-equal to ops/sgm.py's whatever the order of the work.
//
// Storage: float32 volumes compute in float (big = 1e9). int16 volumes (the
// census volume with INVALID 1024) compute in int32 with P1 and P2 truncated
// to integers and big = 30000, as the XLA int16 path does (ops/sgm.py casts
// P1, P2 to int16); the config bounds num_paths * (1024 + P2) < 2^15, so
// every value and total is exact.
//
// Carries, for row-sharded scans (parallel/tiling.py): the carry is the
// (D, W) L of the scan-order-last row, unshifted, as the TPU scan3 slab is.
// With init_carry, a line that starts on the volume's first row (in scan
// order) at column x starts from init_carry[:, x - dx], zero where x - dx
// leaves the frame; diagonal lines that start on a side edge start from
// zero. carry_out receives L of the last row. Horizontal lines take none.
//
// Bound on the H100: device memory. A launch reads the cost and the total
// and writes the total, 715 MB at KITTI D=128 in float32, 0.21 ms at
// 3.35 TB/s; the walk itself is a chain of dependent steps (375 a line
// vertically, 1242 horizontally). The (D, H, W) layout puts the D values
// of one pixel a whole (H, W) plane apart, so a thread per disparity (the
// first version) fetched a 32-B sector for 4 useful bytes.
//
// Design: one warp per path line, each lane holding the disparities
// d = q * 32 + lane (q < DPL = ceil(D / 32)) in registers; d +- 1 come from
// two rotating shuffles per register, pmin from one redux.sync (floats are
// mapped to order-preserving integers and back, so it is exactly one of the
// values). No block barrier is on the step's chain. Neighbouring lines are
// the warps of one block, so the block moves cost and total as whole row
// segments: 16 (for D > 192, 8) neighbouring columns (vertical), a strip
// of as many diagonal lines that shifts by dx every row (lanes of lines
// outside the frame idle and keep a zero carry until they enter: the
// side-edge start), or 8 (float32) or 16 (int16) consecutive steps of a
// horizontal line's row. Beside its line warps a block has staging warps
// (8 beside 16 lines of a strip, 4 beside 8, 3 beside a horizontal line)
// that move G steps at a time through a ring of R slots in shared memory,
// with 4-byte cp.async copies of the segments' words, R - 1 groups ahead
// of the walk: while the line warps walk group k (each reads its column of
// the slot and writes its result into the slot's total), the staging warps
// write group k - 1 back as row segments and refill its slot with group
// k + R - 1. One block barrier a group (and one among the staging warps),
// none a step. The host picks G (at most 3) and R from D: a strip block
// takes up to the whole shared memory of its SM, a row block 40 KB, so
// that the rows of a 720p frame run in one wave.
// Each (d, y, x) is visited once per direction, so nothing needs atomics
// or an order between blocks.
//
// K10 census_scan is this walk too: it replaces
// stereo_match_tpu/ops/pallas_kernels.py::sgm_census_scan_pallas
// (_census_scan_padded, _sgm_scan_census_kernel), the horizontal scan of
// the streaming pipeline's census-payload stages, whose costs are rebuilt
// from the census words of both views. With CENSUS the row block stages
// the row's words of both views in shared memory at the start, and the
// staging warps fill each group's cost slot from them (the popcounts K2
// would write) where they would copy K2's volume; they still move the
// total. The line warp walks exactly as in K3's horizontal direction, on
// two thirds of its device-memory traffic. The TPU kernel's ring
// of right-view rows, its anti-identity reversal matmul and the <= 24-bit
// word gate that matmul needed are Mosaic mechanics with no counterpart
// here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxD = 1024;
// Line and staging warps of a strip block (dy != 0): 16 columns (64-B
// segments) while a lane holds at most 6 disparities, else 8 (the ring of
// a deep D must fit shared memory, and its registers the threads).
__host__ __device__ constexpr int strip_lines(int dpl) {
  return dpl <= 6 ? 16 : 8;
}
__host__ __device__ constexpr int strip_helpers(int dpl) {
  return dpl <= 6 ? 8 : 4;
}
constexpr int kRowLines = 1;          // line warps a block, dy == 0
constexpr int kRowHelpers = 3;        // staging warps a block, dy == 0
constexpr int kStripGroup = 3;             // steps a group, at most
constexpr int kRowSmemBudget = 40 * 1024;  // a row block: 720 rows at 720p
                                           // fit one wave of 6 an SM
constexpr int kSmemMax = 232448;      // dynamic shared memory a block

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using V = float;
  static constexpr int kRowSteps = 8;     // horizontal steps a 32-B sector
  static __device__ V big() { return 1e9f; }
  static __device__ V vmin(V a, V b) { return fminf(a, b); }
  static __device__ V warp_min(V v) {     // order-preserving int key
    const int b = __float_as_int(v);
    int key = b ^ ((b >> 31) & 0x7fffffff);
    key = __reduce_min_sync(0xffffffffu, key);
    return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
  }
};

template <>
struct Arith<short> {
  using V = int;
  static constexpr int kRowSteps = 16;
  static __device__ V big() { return 30000; }
  static __device__ V vmin(V a, V b) { return min(a, b); }
  static __device__ V warp_min(V v) {
    return __reduce_min_sync(0xffffffffu, v);
  }
};

// Elements of T in one 4-byte word, and the words a staged row segment of
// `seg` elements spans (int16 segments may start mid-word), padded to an
// odd count so that lanes reading rows 1 apart hit distinct banks.
template <typename T>
__host__ __device__ constexpr int per_word() { return 4 / (int)sizeof(T); }

template <typename T>
__host__ __device__ inline int row_words(int seg) {
  return (seg + 2 * per_word<T>() - 2) / per_word<T>();
}

__host__ __device__ inline int row_pitch(int words) { return words | 1; }

__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most n (0..4) of this thread's groups are in flight.
__device__ inline void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// Elements between the last 4-byte boundary and `p` (int16 views may
// start mid-word); offsets are counted from that boundary.
template <typename T>
__device__ inline int lead(const T* p) {
  return per_word<T>() == 2 ? (int)(((uintptr_t)p >> 1) & 1) : 0;
}

// Where a walk is: the strip kind (dy != 0) or the row kind (dy == 0).
// A slot holds rows r = o * D + d: o is the group's step g (strip) or the
// block's line j (rows), each row one segment of `seg` elements along x.
struct Walk {
  int D, H, W, dy, dx;
  int S;          // steps a line
  int G;          // steps a group
  int lines;      // lines (warps) a block
  int seg;        // elements a staged row segment
  int pitch;      // words a staged row, in shared memory
  int base;       // strip: x of line 0 at step 0; rows: y of line 0
  long long hw;   // H * W

  __device__ int outers() const { return dy != 0 ? G : lines; }

  __device__ long long offset(int d, int y, int x) const {
    return (long long)d * hw + (long long)y * W + x;
  }

  // Row y and first x of the segments of outer index o in group k; false
  // when they lie outside the frame (a step past the end, a row past H).
  __device__ bool outer(int k, int o, int& y, int& xs) const {
    if (dy != 0) {
      const int s = k * G + o;
      if (s >= S) return false;
      y = dy > 0 ? s : H - 1 - s;
      xs = base + dx * s;
    } else {
      y = base + o;
      if (y >= H) return false;
      xs = dx > 0 ? k * G : W - k * G - G;
    }
    return true;
  }
};

// Shared-memory element index of element e of staged row r whose segment
// starts at element `ao` counted from a 4-byte boundary (int16 segments
// keep the parity of their first element, so every copy is a whole word).
template <typename T>
__device__ inline int smem_index(const Walk& w, int r, long long ao, int e) {
  const int sh = per_word<T>() == 2 ? (int)(ao & 1) : 0;
  return r * w.pitch * per_word<T>() + sh + e;
}

// Issue the copies of group k of `src` into `slot` (one commit by the
// caller), by the block's n staging threads, t the caller's index among
// them: thread t copies word t % nw of every (n / nw)-th row, walking the
// planes with pointer increments. Words wholly outside the row's frame
// are not copied (their elements are never read), so no copy leaves the
// tensor's words.
template <typename T>
__device__ void stage(const Walk& w, int k, const T* __restrict__ src,
                      T* slot, int t, int n) {
  constexpr int E = per_word<T>();
  const int nw = row_words<T>(w.seg);
  const int step = n / nw;
  const int v = t % nw;
  const int d0 = t / nw;
  if (d0 >= step) return;
  const int pre = lead(src);
  const uint32_t* src_w = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(src - pre));
  const long long plane_step = (long long)step * w.hw;
  for (int o = 0; o < w.outers(); ++o) {
    int y, xs;
    if (!w.outer(k, o, y, xs)) continue;
    long long ao = (long long)d0 * w.hw + (long long)y * w.W + xs + pre;
    uint32_t* dst = reinterpret_cast<uint32_t*>(slot) +
                    (o * w.D + d0) * w.pitch + v;
    for (int d = d0; d < w.D; d += step) {
      const int sh = E == 2 ? (int)(ao & 1) : 0;
      const int x0 = xs - sh + v * E;           // the word's first x
      if (x0 < w.W && x0 + E - 1 >= 0)
        cp_async4(dst, src_w + (ao >> (E - 1)) + v);
      ao += plane_step;
      dst += step * w.pitch;
    }
  }
}

// Write the in-frame elements of `slot` (group k) back to `dst`, by the
// n staging threads: thread t stores element t % seg of every
// (n / seg)-th row.
template <typename T>
__device__ void write_back(const Walk& w, int k, const T* slot,
                           T* __restrict__ dst, int t, int n) {
  constexpr int E = per_word<T>();
  const int step = n / w.seg;
  const int e = t % w.seg;
  const int d0 = t / w.seg;
  if (d0 >= step) return;
  const int pre = lead(dst);
  const long long plane_step = (long long)step * w.hw;
  for (int o = 0; o < w.outers(); ++o) {
    int y, xs;
    if (!w.outer(k, o, y, xs)) continue;
    if (xs + e < 0 || xs + e >= w.W) continue;
    long long off = (long long)d0 * w.hw + (long long)y * w.W + xs;
    int r = o * w.D + d0;
    for (int d = d0; d < w.D; d += step) {
      const int sh = E == 2 ? (int)((off + pre) & 1) : 0;
      dst[off + e] = slot[r * w.pitch * E + sh + e];
      off += plane_step;
      r += step;
    }
  }
}

// K10's costs: the census words of a row of both views, from which a
// horizontal walk rebuilds C(d, y, x) = popc(cl[y, x] ^ cr[y, x - min_d - d])
// as K2 computes it, or `invalid` where x < min_d + d.
struct CensusCost {
  const int* cl;
  const int* cr;
  int min_d;
  float invalid;
};

// Fill the cost slot of group k (a horizontal walk, float) from the row's
// census words staged in shared memory, by the n staging threads, t the
// caller's index among them: the slot then holds what stage() copies from
// K2's volume, and the line warp reads it as it reads a volume's.
__device__ void fill_census(const Walk& w, int k, const CensusCost& census,
                            const int* row_l, const int* row_r, float* slot,
                            int t, int n) {
  int y, xs;
  if (!w.outer(k, 0, y, xs)) return;
  for (int i = t; i < w.D * w.seg; i += n) {
    const int d = i / w.seg, e = i % w.seg;
    const int x = xs + e;
    if (x < 0 || x >= w.W) continue;
    const int xr = x - census.min_d - d;
    slot[d * w.pitch + e] =
        xr >= 0 ? (float)__popc((unsigned)(row_l[x] ^ row_r[xr]))
                : census.invalid;
  }
}

// CENSUS: the costs come from `census` (float, horizontal only; K10), not
// from a volume; the block stages the row's words of both views (2 x 4 x W
// bytes) beside the rings, and the staging warps fill the cost slots from
// them instead of copying a volume's, and move the total.
template <typename T, int DPL, bool CENSUS>
__global__ void __launch_bounds__(CENSUS ? (kRowLines + kRowHelpers) * 32
                                         : (DPL <= 6 ? 1024 : 384))
sgm_path_scan_kernel(const T* __restrict__ cost, T* __restrict__ total,
                     const T* __restrict__ init_carry,
                     T* __restrict__ carry_out, int D, int H, int W, int dy,
                     int dx, typename Arith<T>::V p1,
                     typename Arith<T>::V p2, int accumulate, int G, int R,
                     int lines, CensusCost census) {
  using A = Arith<T>;
  using V = typename A::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x >> 5;           // this warp's line, if j < lines
  const bool helper = j >= lines;           // a staging warp
  const int ht = threadIdx.x - lines * 32;  // index among the staging threads
  const int hn = blockDim.x - lines * 32;
  const V big = A::big();

  Walk w;
  w.D = D; w.H = H; w.W = W; w.dy = dy; w.dx = dx;
  w.hw = (long long)H * W;
  w.G = G;
  w.lines = lines;
  if (dy != 0) {
    w.S = H;
    w.seg = lines;
    w.base = blockIdx.x * lines + (dx > 0 ? -(H - 1) : 0);
  } else {
    w.S = W;
    w.seg = G;
    w.base = blockIdx.x * lines;
  }
  w.pitch = row_pitch(row_words<T>(w.seg));
  const int slot_elems = w.outers() * D * w.pitch * per_word<T>();
  T* cost_ring = reinterpret_cast<T*>(smem_raw);
  T* total_ring = cost_ring + (size_t)R * slot_elems;
  int* row_l = reinterpret_cast<int*>(total_ring + (size_t)R * slot_elems);
  int* row_r = row_l + W;
  if constexpr (CENSUS) {   // read by the staging warps' first fills
    const size_t row = (size_t)w.base * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      row_l[i] = census.cl[row + i];
      row_r[i] = census.cr[row + i];
    }
    __syncthreads();
  }

  // This line's position at step s; `in` when it is inside the frame.
  auto where = [&](int s, int& y, int& x) {
    if (dy != 0) {
      y = dy > 0 ? s : H - 1 - s;
      x = w.base + j + dx * s;
    } else {
      y = w.base + j;
      x = dx > 0 ? s : W - 1 - s;
    }
    return y < H && x >= 0 && x < W;
  };

  // The incoming state: zero, or the previous shard's carry at x - dx;
  // big in the register slots past D.
  V L[DPL];
  {
    int y, x;
    const bool in0 = where(0, y, x);
    const int xs = x - dx;
    const bool from_carry = in0 && dy != 0 && init_carry != nullptr &&
                            xs >= 0 && xs < W;
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      const int d = q * 32 + lane;
      L[q] = d < D ? (from_carry ? (V)init_carry[(size_t)d * W + xs] : V(0))
                   : big;
    }
  }
  V lmin = L[0];
#pragma unroll
  for (int q = 1; q < DPL; ++q) lmin = A::vmin(lmin, L[q]);
  V pmin = A::warp_min(lmin);

  const int pre_c = lead(cost), pre_t = lead(total);
  const int groups = (w.S + G - 1) / G;
  auto stage_group = [&](int k) {
    if (k < groups) {
      const size_t at = (size_t)(k % R) * slot_elems;
      if constexpr (CENSUS)
        fill_census(w, k, census, row_l, row_r, cost_ring + at, ht, hn);
      else
        stage<T>(w, k, cost, cost_ring + at, ht, hn);
      if (accumulate) stage<T>(w, k, total, total_ring + at, ht, hn);
    }
    cp_async_commit();
  };
  if (helper)
    for (int k = 0; k < R - 1; ++k) stage_group(k);   // prologue

  // Group k: the staging warps have waited for its copies; after the
  // barrier the line warps walk it while the staging warps write group
  // k - 1 back and refill its slot with group k + R - 1.
  for (int k = 0; k < groups; ++k) {
    if (helper) cp_async_wait_dyn(R - 2);
    __syncthreads();   // group k has landed; group k - 1 has been walked
    if (helper) {
      if (k > 0)
        write_back<T>(w, k - 1, total_ring + (size_t)((k - 1) % R) * slot_elems,
                      total, ht, hn);
      // the slot is read back before any staging thread refills it
      asm volatile("bar.sync 1, %0;\n" ::"r"(hn));
      stage_group(k + R - 1);
      continue;
    }

    const T* cs = cost_ring + (size_t)(k % R) * slot_elems;
    T* ts = total_ring + (size_t)(k % R) * slot_elems;
    for (int g = 0; g < G; ++g) {
      const int s = k * G + g;
      int y, x;
      if (s >= w.S || !where(s, y, x)) continue;   // warp-uniform
      // the staged row (r0 + d) and element e of this step and line
      int xs, e, r0;
      if (dy != 0) {
        xs = w.base + dx * s;
        e = j;
        r0 = g * D;
      } else {
        xs = dx > 0 ? k * G : W - k * G - G;
        e = dx > 0 ? g : G - 1 - g;
        r0 = j * D;
      }
      const long long off0 = w.offset(0, y, xs);

      V ru[DPL], rd[DPL];
#pragma unroll
      for (int q = 0; q < DPL; ++q) {
        ru[q] = __shfl_sync(0xffffffffu, L[q], (lane + 31) & 31);
        rd[q] = __shfl_sync(0xffffffffu, L[q], (lane + 1) & 31);
      }
      const V pp2 = pmin + p2;
      V nmin = big;
#pragma unroll
      for (int q = 0; q < DPL; ++q) {
        const int d = q * 32 + lane;
        if (d < D) {
          // lane 0 takes d - 1 from lane 31's previous register, lane 31
          // takes d + 1 from lane 0's next one (ru, rd rotate the warp)
          const V up = lane > 0 ? ru[q] : (q > 0 ? ru[q > 0 ? q - 1 : 0] : big);
          const V down = lane < 31 ? rd[q]
                                   : (q + 1 < DPL ? rd[q + 1 < DPL ? q + 1 : q]
                                                  : big);
          const long long off = off0 + (long long)d * w.hw;
          const int ti = smem_index<T>(w, r0 + d, off + pre_t, e);
          const V c = (V)cs[smem_index<T>(w, r0 + d, off + pre_c, e)];
          const V m = A::vmin(A::vmin(L[q], pp2), A::vmin(up, down) + p1);
          const V Ln = (c + m) - pmin;
          ts[ti] = (T)(accumulate ? (V)ts[ti] + Ln : Ln);
          L[q] = Ln;
        }
        nmin = A::vmin(nmin, L[q]);
      }
      pmin = A::warp_min(nmin);
      if (carry_out != nullptr && s == w.S - 1) {
#pragma unroll
        for (int q = 0; q < DPL; ++q) {
          const int d = q * 32 + lane;
          if (d < D) carry_out[(size_t)d * W + x] = (T)L[q];
        }
      }
    }
  }
  __syncthreads();     // the last group has been walked
  if (helper) {
    write_back<T>(w, groups - 1,
                  total_ring + (size_t)((groups - 1) % R) * slot_elems,
                  total, ht, hn);
    cp_async_wait<0>();
  }
}

template <typename T, int DPL, bool CENSUS>
int launch_dpl(const void* cost, void* total, const void* init_carry,
               void* carry_out, int D, int H, int W, int dy, int dx,
               typename Arith<T>::V p1, typename Arith<T>::V p2,
               int accumulate, CensusCost census, cudaStream_t stream) {
  using A = Arith<T>;
  int lines, helpers, blocks, G, R;
  size_t slot_bytes;
  if (dy != 0) {
    lines = strip_lines(DPL);
    helpers = strip_helpers(DPL);
    const int n = dx == 0 ? W : W + H - 1;
    blocks = (n + lines - 1) / lines;
    const size_t step = (size_t)D * row_pitch(row_words<T>(lines)) * 4 * 2;
    R = 3;
    G = (int)(kSmemMax / (R * step));
    G = G < 1 ? 1 : (G > kStripGroup ? kStripGroup : G);
    if (R * G * step > (size_t)kSmemMax) R = 2;
    slot_bytes = G * step;
  } else {
    lines = kRowLines;
    helpers = kRowHelpers;
    blocks = (H + lines - 1) / lines;
    G = A::kRowSteps;
    slot_bytes = (size_t)lines * D * row_pitch(row_words<T>(G)) * 4 * 2;
    R = (int)(kRowSmemBudget / slot_bytes);
    R = R < 2 ? 2 : (R > 6 ? 6 : R);     // at most 4 groups in flight
  }
  const size_t smem = R * slot_bytes + (CENSUS ? 2 * (size_t)W * 4 : 0);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // The attribute belongs to the current device: set it at every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      sgm_path_scan_kernel<T, DPL, CENSUS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return (int)err;
  sgm_path_scan_kernel<T, DPL, CENSUS>
      <<<blocks, (lines + helpers) * 32, smem, stream>>>(
          static_cast<const T*>(cost), static_cast<T*>(total),
          static_cast<const T*>(init_carry), static_cast<T*>(carry_out), D,
          H, W, dy, dx, p1, p2, accumulate, G, R, lines, census);
  return (int)cudaGetLastError();
}

template <typename T, bool CENSUS = false>
int launch(const void* cost, void* total, const void* init_carry,
           void* carry_out, int D, int H, int W, int dy, int dx,
           typename Arith<T>::V p1, typename Arith<T>::V p2, int accumulate,
           cudaStream_t stream, CensusCost census = {}) {
  const int need = (D + 31) / 32;
#define SMT_DPL(N)                                                          \
  if (need <= N)                                                            \
    return launch_dpl<T, N, CENSUS>(cost, total, init_carry, carry_out, D,  \
                                    H, W, dy, dx, p1, p2, accumulate,       \
                                    census, stream);
  SMT_DPL(1) SMT_DPL(2) SMT_DPL(3) SMT_DPL(4) SMT_DPL(5) SMT_DPL(6)
  SMT_DPL(8) SMT_DPL(12) SMT_DPL(16) SMT_DPL(24) SMT_DPL(32)
#undef SMT_DPL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// cost, total: (D, H, W), float32 (i16 = 0) or int16 (i16 = 1). One launch
// aggregates direction (dy, dx), dy, dx in {-1, 0, 1}, not both 0;
// accumulate = 0 writes total = L. init_carry and carry_out are (D, W) of
// the same type, or null; only for dy != 0. For int16, p1 and p2 must be
// integers (the wrapper truncates them).
extern "C" int smt_sgm_path_scan(const void* cost, void* total,
                                 const void* init_carry, void* carry_out,
                                 int D, int H, int W, int dy, int dx,
                                 float p1, float p2, int accumulate, int i16,
                                 void* stream) {
  if (D < 1 || D > kMaxD || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (i16)
    return launch<short>(cost, total, init_carry, carry_out, D, H, W, dy, dx,
                         (int)p1, (int)p2, accumulate, (cudaStream_t)stream);
  return launch<float>(cost, total, init_carry, carry_out, D, H, W, dy, dx,
                       p1, p2, accumulate, (cudaStream_t)stream);
}

// K10: cl, cr: (H, W) int32 single-word census of the left and right views;
// total: (D, H, W) float32. One horizontal walk, dx = +1 or -1, with the
// costs rebuilt from the words (invalid where x < min_d + d); accumulate =
// 0 writes total = L. At invalid = 1e4 the totals equal K2's volume scanned
// by K3 along (0, dx), bit for bit.
extern "C" int smt_census_scan(const int* cl, const int* cr, float* total,
                               int D, int H, int W, int min_d, float p1,
                               float p2, float invalid, int dx,
                               int accumulate, void* stream) {
  if (D < 1 || D > kMaxD || H < 1 || W < 1 || min_d < 0 ||
      (dx != 1 && dx != -1))
    return (int)cudaErrorInvalidValue;
  return launch<float, true>(nullptr, total, nullptr, nullptr, D, H, W, 0,
                             dx, p1, p2, accumulate, (cudaStream_t)stream,
                             CensusCost{cl, cr, min_d, invalid});
}
