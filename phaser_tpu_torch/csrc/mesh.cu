// The sharded step's per-shard counts for Hopper (sm_90a).
//
//   band_counts_kernel  replaces the jnp scatter-adds inside the shard_map
//                       body of sharded_phasing_step
//                       (phaser_tpu/dist/mesh.py:83-102) and of
//                       sharded_allele_counts (:160-166): from a shard's
//                       (N, L) int32 vidx and allele planes it adds
//                         counts[v, a]                += 1 for every hit,
//                         pair[v1, v2 - v1 - 1, a1*3 + a2] += 1
//                       for every ordered position pair (l1, l2) of one row
//                       where both are hits and 1 <= v2 - v1 <= band.
//
// A hit is a base with allele < 3 (non-hits carry vidx = -1, allele = 3).
// Rows need not be sorted, and a variant that appears at two positions of
// one row is counted once for each position pair, as the JAX broadcast over
// (N, L, L) does; nothing is deduplicated.
//
// Design.  The JAX body materializes (N, L, L) tensors: 4.3e9 elements at
// 262,144 rows of 128 bases, which no device holds.  Here a block takes a
// contiguous run of rows and each of its warps one row at a time: the lanes
// read the row's two planes once (coalesced, four 32-base chunks in flight
// a lane, and the next row's first 128 bases loaded while this row is
// taken), compact the row's hits into the warp's slice of shared memory
// (one ballot per 32 bases, so the list keeps position order), add the
// allele counts, then add the row's in-band pairs:
//   - a row whose hit variants do not decrease (one warp vote; every real
//     read, and both of the smoke's dense inputs) takes an exact forward
//     walk: lane i walks j = i+1, ... while v_j - v_i <= band, skipping
//     d = 0, so the work is the in-band pairs plus one stop test a hit,
//     with no division;
//   - any other row walks all ordered hit pairs (i over the lanes, j in a
//     loop), so the result is exact for any input.
// The adds:
//   - a block-private window of the outputs in shared memory, `counts` and
//     `pair` for variants [v0, v0 + W): before its rows the block reads its
//     first and its last rows (one row a warp, all at once); when the last
//     rows' lowest hit is no lower than the first rows' (the rows ascend)
//     and the block's hits span fewer than W variants (position-sorted
//     rows, as a BAM-sorted shard arrives), v0 is the first rows' lowest
//     hit, the block adds in shared memory, and at its end it adds each
//     non-zero window word to device memory once (contiguous words,
//     coalesced).  A hit outside the window goes straight to device
//     memory, so the result is exact in any row order.  The blocks that
//     took the window add one to `window_blocks`;
//   - an add to device memory has its result never read, so it compiles to
//     a reduction (REDG), not a returning atomic (the SASS shows REDG.E.ADD
//     only).  The lanes that add to one word at the same time are not
//     combined (__match_any_sync, the leader adding the count) unless
//     BAND_COUNTS_COMBINE is defined: within a row two lanes meet one word
//     only for a repeated variant, and the match costs time on the dense
//     input (testing/step_kernels_ablation.py builds that variant and
//     times it; PERF.md).
// Every add is an int32 integer add, so the sums are exact and do not depend
// on the order the adds land in: the result is deterministic and equals its
// plain version with tolerance 0.  The launcher zeroes both outputs on the
// kernel's stream.
//
// Bound.  The planes are read once (8 B a base); the outputs are written
// once (12 B a variant and 36 B a variant and band step).  Hits are rare at
// the real density (phase 3's reads: 1 base in 3,000), so the adds are few
// beside the plane bytes and the kernel is bound by bytes.  Where hits are dense and
// the rows in random order, the scattered adds into device memory (one a
// hit and one an in-band pair) are the limit (the ablations: 0.15 ms of
// 0.32 on the dense input): the window takes them off device memory only
// for rows that arrive sorted.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;
#ifndef BAND_COUNTS_BLOCKS_PER_SM
#define BAND_COUNTS_BLOCKS_PER_SM 3
#endif
constexpr int kBlocksPerSm = BAND_COUNTS_BLOCKS_PER_SM;
// dynamic shared memory a block: kBlocksPerSm blocks fit an SM's 228 KB
// (1 KB of it reserved a block, and the block's static words)
constexpr int kSmemBlock = (228 / kBlocksPerSm - 1) * 1024 - 256;
// at most half of it for the warps' hit lists (4 B a base of a row)
constexpr int kHitBytes = kSmemBlock / 2;
constexpr int kMinWindow = 32;       // variants; below this no window
constexpr int kWaves = 2;            // blocks a launch: SMs x 3 x kWaves
constexpr int kChunks = 4;           // 32-base chunks a lane keeps in flight
constexpr int kMaxDevices = 64;

// One add of 1 to a word in device memory (its result unread: a REDG).
__device__ __forceinline__ void red_global(int32_t* p) {
#ifdef BAND_COUNTS_COMBINE
  // the lanes that add to p now: their leader adds their count
  const unsigned peers =
      __match_any_sync(__activemask(), (unsigned long long)p);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(p, __popc(peers));
#else
  atomicAdd(p, 1);
#endif
}

struct Sink {
  int32_t* counts;      // (m, 3) in device memory
  int32_t* pair;        // (m, band, 9)
  int32_t* win_counts;  // (w, 3) in shared memory, variants [v0, v0 + w)
  int32_t* win_pair;    // (w, band, 9)
  int v0, w, band;

  __device__ __forceinline__ void count(int v, int a) const {
    unsigned r = (unsigned)(v - v0);
    if (r < (unsigned)w)
      atomicAdd(win_counts + r * 3 + a, 1);
    else
      red_global(counts + (size_t)v * 3 + a);
  }
  __device__ __forceinline__ void pair_add(int v1, int d, int a1,
                                           int a2) const {
    unsigned r = (unsigned)(v1 - v0);
    int k = (d - 1) * 9 + a1 * 3 + a2;
    if (r < (unsigned)w)
      atomicAdd(win_pair + (size_t)r * band * 9 + k, 1);
    else
      red_global(pair + (size_t)v1 * band * 9 + k);
  }
};

__device__ __forceinline__ bool is_hit(int v, int a, int m) {
  return a >= 0 && a < 3 && v >= 0 && v < m;
}

// The lowest and the highest hit variant of one row (INT_MAX / -1 when the
// row has none), the same in every lane.
__device__ void probe_row(const int32_t* __restrict__ vr,
                          const int32_t* __restrict__ ar, int l, int m,
                          int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = -1;
  for (int i = lane; i < l; i += 32) {
    int v = vr[i], a = ar[i];
    if (is_hit(v, a, m)) {
      lo = min(lo, v);
      hi = max(hi, v);
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
}

__global__ void __launch_bounds__(kMaxWarps * 32, kBlocksPerSm)
band_counts_kernel(const int32_t* __restrict__ vidx,
                   const int32_t* __restrict__ allele, int n_rows, int l,
                   int m, int band, int rows_per_block, int window,
                   int32_t* __restrict__ counts, int32_t* __restrict__ pair,
                   unsigned* __restrict__ window_blocks) {
  extern __shared__ int32_t smem[];
  // the lowest hit of the first rows, the lowest and the highest of the last
  __shared__ int s_lo, s_lo_last, s_hi;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, n_rows);
  if (row0 >= row1) return;  // the whole block
  uint32_t* hits = (uint32_t*)smem + (size_t)warp * l;  // v << 2 | a
  int32_t* win = smem + (size_t)warps * l;
  const int words = 3 + 9 * band;  // window words a variant

  Sink out{counts, pair, win, win, 0, 0, band};
  // a lane's kChunks bases of a row from `base` (non-hits past the row's
  // end or past the block's rows)
  auto load = [&](int row, int base, int* v, int* a) {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = -1;
      a[u] = 3;
      if (row < row1 && i < l) {
        v[u] = vidx[(size_t)row * l + i];
        a[u] = allele[(size_t)row * l + i];
      }
    }
  };
  // compacts those bases' hits onto the warp's list (one ballot per 32
  // bases, position order kept) and adds their allele counts
  auto take = [&](const int* v, const int* a, int base, int& nh) {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const bool hit = is_hit(v[u], a[u], m);
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (hit) {
        hits[nh + __popc(ballot & ((1u << lane) - 1u))] =
            ((uint32_t)v[u] << 2) | (uint32_t)a[u];
        out.count(v[u], a[u]);
      }
      nh += __popc(ballot);
    }
  };
  // the first row's head, in flight while the block probes its rows
  int v[kChunks], a[kChunks];
  load(row0 + warp, 0, v, a);
  if (window > 0) {
    if (threadIdx.x == 0) {
      s_lo = s_lo_last = INT_MAX;
      s_hi = -1;
    }
    __syncthreads();
    // even probes read the first rows, odd ones the last rows; a last row
    // that is also a first row is not read as one (a block of so few rows
    // shows no order, and takes no window)
    const int probes = warps < 2 ? 2 : warps;
    const int first_rows = (probes + 1) / 2;
    for (int p = warp; p < probes; p += warps) {
      int row = (p & 1) ? row1 - 1 - (p >> 1) : row0 + (p >> 1);
      if (row >= row1 || ((p & 1) && row < row0 + first_rows)) continue;
      int lo, hi;
      probe_row(vidx + (size_t)row * l, allele + (size_t)row * l, l, m,
                lane, lo, hi);
      if (lane == 0) {
        if (p & 1) {
          atomicMin(&s_lo_last, lo);
          atomicMax(&s_hi, hi);
        } else {
          atomicMin(&s_lo, lo);
        }
      }
    }
    __syncthreads();
    // the rows ascend (the last rows start no lower than the first) and
    // the block's hits span fewer variants than the window holds
    const int lo = s_lo, hi = s_hi;
    if (lo <= s_lo_last && s_lo_last <= hi && hi - lo < window) {
      out.v0 = lo;
      out.w = window;
      out.win_pair = win + window * 3;
      for (int k = threadIdx.x; k < window * words; k += blockDim.x)
        win[k] = 0;
      __syncthreads();
    }
  }

  for (int row = row0 + warp; row < row1; row += warps) {
    int nh = 0;  // the same in every lane
    take(v, a, 0, nh);
    // the next row's head is in flight while this row is taken
    load(row + warps, 0, v, a);
    for (int base = 32 * kChunks; base < l; base += 32 * kChunks) {
      int vt[kChunks], at[kChunks];
      load(row, base, vt, at);
      take(vt, at, base, nh);
    }
    __syncwarp();
    if (band > 0 && nh > 1) {
      bool up = true;
      for (int i = lane + 1; i < nh; i += 32)
        up &= (hits[i - 1] >> 2) <= (hits[i] >> 2);
      if (__all_sync(kFull, up)) {
        // the forward walk: only j > i can be in band, and it ends at the
        // first j past it
        for (int i = lane; i < nh; i += 32) {
          const uint32_t hi = hits[i];
          const int vi = (int)(hi >> 2), ai = (int)(hi & 3u);
          for (int j = i + 1; j < nh; ++j) {
            const uint32_t hj = hits[j];
            const int d = (int)(hj >> 2) - vi;
            if (d > band) break;
            if (d > 0) out.pair_add(vi, d, ai, (int)(hj & 3u));
          }
        }
      } else {
        for (int i = lane; i < nh; i += 32) {
          const uint32_t hi = hits[i];
          const int vi = (int)(hi >> 2), ai = (int)(hi & 3u);
          for (int j = 0; j < nh; ++j) {
            const uint32_t hj = hits[j];
            const int d = (int)(hj >> 2) - vi;
            if (d >= 1 && d <= band) out.pair_add(vi, d, ai, (int)(hj & 3u));
          }
        }
      }
    }
    __syncwarp();  // the next row overwrites this warp's hits
  }

  if (out.w > 0) {
    __syncthreads();
    // each non-zero window word once into device memory; words past the
    // last variant were never added to
    const int vars = min(out.w, m - out.v0);
    int32_t* gc = counts + (size_t)out.v0 * 3;
    for (int k = threadIdx.x; k < vars * 3; k += blockDim.x) {
      int32_t c = win[k];
      if (c) atomicAdd(gc + k, c);
    }
    int32_t* gp = pair + (size_t)out.v0 * band * 9;
    for (int k = threadIdx.x; k < vars * band * 9; k += blockDim.x) {
      int32_t c = out.win_pair[k];
      if (c) atomicAdd(gp + k, c);
    }
    if (threadIdx.x == 0) atomicAdd(window_blocks, 1u);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 132;
  return sms;
}

}  // namespace

extern "C" {

// Rows in flight a block: 16 warps, fewer where their hit lists (4 B a base
// each) would take more than half of the block's shared memory.  0 when
// one warp cannot hold a row (L > 9,568).
int band_counts_warps(int l) {
  int w = l > 0 ? kHitBytes / (4 * l) : kMaxWarps;
  return w > kMaxWarps ? kMaxWarps : w;
}

// The window a block keeps in shared memory, in variants, beside its warps'
// hit lists at row length l; 0 where fewer than kMinWindow fit.
int band_counts_window(int l, int band) {
  int warps = band_counts_warps(l);
  if (warps < 1) return 0;
  long long left = kSmemBlock - 4LL * warps * l;
  long long w = left / (4LL * (3 + 9LL * band));
  return w < kMinWindow ? 0 : (int)w;
}

// Zeroes counts (m, 3) and pair (m, band, 9), then enqueues the kernel on
// `stream`; the blocks that take the shared-memory window add one each to
// the device word `window_blocks`, and *n_blocks receives the launch's
// block count (0 when nothing is launched).  Returns cudaGetLastError() (0
// on success).
int band_counts_launch(const void* vidx, const void* allele, int n_rows,
                       int l, int m, int band, void* counts, void* pair,
                       void* window_blocks, int* n_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *n_blocks = 0;
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)m * 3 * sizeof(int32_t),
                                  s);
  if (e != cudaSuccess) return (int)e;
  if (band > 0) {
    e = cudaMemsetAsync(pair, 0, (size_t)m * band * 9 * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  if ((long long)n_rows * l == 0 || m == 0) return (int)cudaGetLastError();
  const int warps = band_counts_warps(l);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int window = band_counts_window(l, band);
  const size_t smem = 4 * ((size_t)warps * l +
                           (size_t)window * (3 + 9 * (size_t)band));
  // once a device (any thread may set it: the value is the same)
  static bool attr_set[kMaxDevices];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(band_counts_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBlock);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  // a contiguous run of rows a block, kWaves waves of kBlocksPerSm blocks
  // an SM, and at least two rows a warp (so that a block's first and last
  // rows differ, and its order shows)
  long long target = (long long)sm_count() * kBlocksPerSm * kWaves;
  long long rows = (n_rows + target - 1) / target;
  if (rows < 2 * warps) rows = 2 * warps;
  long long blocks = (n_rows + rows - 1) / rows;
  band_counts_kernel<<<(int)blocks, warps * 32, smem, s>>>(
      (const int32_t*)vidx, (const int32_t*)allele, n_rows, l, m, band,
      (int)rows, window, (int32_t*)counts, (int32_t*)pair,
      (unsigned*)window_blocks);
  *n_blocks = (int)blocks;
  return (int)cudaGetLastError();
}

}  // extern "C"
