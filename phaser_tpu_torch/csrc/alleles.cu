// Allele-assignment kernels for Hopper (sm_90a): per-base hit
// classification against the sorted variant table.
//
// One classifier (lookup / classify) serves every entry point.  The fused
// entries rebuild each base's (masked code, 1-based reference position) from
// their read format and compact hits into the packed-hit stream:
//
//   affine_nibble  replaces phaser_tpu/kernels/alleles.py:975
//                  (_nibble_windowed_impl -> _alleles_pallas_windowed_kernel,
//                  alleles.py:673): refpos = start + (i - lo) on [lo, hi).
//   delta_nibble   replaces alleles.py:424 (_delta_windowed_impl):
//                  refpos = start + i + delta[i] where the nibble != 15.
//   plane          replaces alleles.py:1038 (_plane_windowed_impl):
//                  explicit int32 refpos plane, masked = qual >= baseq ? code : 15.
//   affine_masked  replaces the jnp program assign_compact_affine_masked
//                  (alleles.py:246-259): the affine rebuild from a 1 B/base
//                  masked plane, the dispatcher's path without the nibble
//                  packer.
//
// The unfused kernel-level entries write the (n_rows, l) int32 vidx and
// allele planes of assign_alleles_device instead (vidx = table index or -1,
// allele 0/1/2 = OTHER/3 = NO_HIT):
//
//   planes         replaces _alleles_pallas_windowed_kernel (alleles.py:673)
//                  as reached from assign_alleles_pallas_windowed (:813), and,
//                  with the table resident in shared memory, the whole-table
//                  _alleles_pallas_kernel (:627, via assign_alleles_pallas).
//   planes_cmp     replaces _alleles_pallas_cmp_kernel (alleles.py:757).
//
// Table search, range-join entries (affine_nibble, plane).  The hits of a
// row are the table entries whose position lies in the row's reference
// range, so these two kernels find that range on the card (no host planner,
// no window argument) and visit its entries instead of searching once per
// base.  See the note above each kernel.
//
// Table search, windowed entries (delta_nibble, affine_masked, planes,
// planes_cmp).  Row r belongs to row block b = r / block_rows; the block
// searches table entries [ws[b], min(ws[b] + win, mp)).  The host planners
// pick ws so that every position the block can hit lies in that range; the
// unplanned case passes ws = {0} and win = mp (the whole table).  The table
// stays in global memory (L2-resident: 4 x 4 B x 128k entries = 2 MB) except
// in the planes kernel's resident mode.
//
// Packed output (fused entries): one int32 (2, cap + 1) buffer, filled with
// -1 and with out[0] = 0 (the hit counter) by its launcher.  A hit takes a
// slot with one warp-aggregated atomicAdd on out[0]; row 0 gets the read
// index within the launch, row 1 gets (var << 8) | (masked << 4) | allele.
// Slots >= cap are counted but not written, so the final out[0] is the exact
// hit count and overflow is visible to the caller.  Hit order is arbitrary
// (the caller lexsorts).
//
// Bound.  About one base in 2,000 lies on a variant, so what a launch must
// move depends on its data: the per-row parameters (12 B per affine row) or
// the refpos plane (4 B per base), the table entries under the launch's
// rows (16 B per entry), one 32-byte sector of the code planes per hit, and
// 8 B per hit written.  The range-join kernels read little more than that:
// one search per row (or per block, then in shared memory) instead of one
// per base, and plane bytes only where a position matched.  The windowed
// kernels still read their whole planes (1, 2.5 or 6 B per base) and make a
// dependent chain of ~log2(win) L2 loads per aligned unmasked base, which is
// what bounds them.
//
// Index arithmetic is int32 inside a row plane: the wrappers assert
// n_rows * L < 2^31.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Table entry load: read-only cache for global memory, a plain load for a
// table staged in shared memory.
template <bool kGlobal>
__device__ __forceinline__ int32_t tload(const int32_t* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Lower bound of refpos in vpos[w0, w0 + wn).  Returns the table index of a
// hit and sets *allele, or returns -1.
template <bool kGlobal>
__device__ __forceinline__ int lookup(int masked, int refpos,
                                      const int32_t* __restrict__ vpos,
                                      const int32_t* __restrict__ a0,
                                      const int32_t* __restrict__ a1,
                                      const int32_t* __restrict__ ni, int w0,
                                      int wn, int* allele) {
  if (refpos <= 0 || masked == 15) return -1;
  int lo = w0;
  int n = wn;
  while (n > 0) {
    int half = n >> 1;
    int mid = lo + half;
    if (tload<kGlobal>(vpos + mid) < refpos) {
      lo = mid + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  if (lo >= w0 + wn || tload<kGlobal>(vpos + lo) != refpos) return -1;
  if (masked == tload<kGlobal>(a0 + lo) && tload<kGlobal>(ni + lo) > 0) {
    *allele = 0;
  } else if (masked == tload<kGlobal>(a1 + lo) &&
             tload<kGlobal>(ni + lo) > 1) {
    *allele = 1;
  } else {
    *allele = 2;
  }
  return lo;
}

// The packed hit word of a base, or -1.
__device__ __forceinline__ int classify(int masked, int refpos,
                                        const int32_t* __restrict__ vpos,
                                        const int32_t* __restrict__ a0,
                                        const int32_t* __restrict__ a1,
                                        const int32_t* __restrict__ ni,
                                        int w0, int wn) {
  int allele;
  int v = lookup<true>(masked, refpos, vpos, a0, a1, ni, w0, wn, &allele);
  return v < 0 ? -1 : (v << 8) | (masked << 4) | allele;
}

// Window [w0, w0 + wn) of the row's block.
__device__ __forceinline__ void window(int row, const int32_t* __restrict__ ws,
                                       int win, int block_rows, int mp,
                                       int* w0, int* wn) {
  int b = row / block_rows;
  *w0 = __ldg(ws + b);
  int rest = mp - *w0;
  *wn = win < rest ? win : rest;
}

// Warp-aggregated compaction of up to two hits per thread.  Every lane of
// the warp must call this (lanes without work pass words of -1).
__device__ __forceinline__ void emit2(int row, int word0, int word1,
                                      int32_t* __restrict__ out, int cap) {
  const unsigned full = 0xffffffffu;
  int lane = threadIdx.x & 31;
  int mine = (word0 >= 0) + (word1 >= 0);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += y;
  }
  int total = __shfl_sync(full, incl, 31);
  if (total == 0) return;
  int base = 0;
  if (lane == 31) base = atomicAdd(out, total);
  base = __shfl_sync(full, base, 31);
  int slot = base + incl - mine;
  int32_t* reads = out + 1;
  int32_t* words = out + (cap + 1) + 1;
  if (word0 >= 0) {
    if (slot < cap) {
      reads[slot] = row;
      words[slot] = word0;
    }
    ++slot;
  }
  if (word1 >= 0 && slot < cap) {
    reads[slot] = row;
    words[slot] = word1;
  }
}

constexpr unsigned kFull = 0xffffffffu;

// Warp-aggregated compaction of at most one hit per lane.  Every lane of
// the warp must call this (lanes without a hit pass word = -1).
__device__ __forceinline__ void emit1(int row, int word,
                                      int32_t* __restrict__ out, int cap) {
  unsigned hits = __ballot_sync(kFull, word >= 0);
  if (hits == 0) return;
  int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(out, __popc(hits));
  base = __shfl_sync(kFull, base, 0);
  if (word >= 0) {
    int slot = base + __popc(hits & ((1u << lane) - 1u));
    if (slot < cap) {
      out[1 + slot] = row;
      out[(cap + 1) + 1 + slot] = word;
    }
  }
}

// One step of a 32-ary search by a warp over the sorted range [lo, lo + len):
// lane j probed entry lo + (j + 1) * step - 1 (`before`: it lies before the
// key; false past the range), and the answer lies after the last such probe
// and at or before the next one.  All 32 lanes must call.
__device__ __forceinline__ void narrow32(bool before, int step, int* lo,
                                         int* len) {
  int c = __popc(__ballot_sync(kFull, before));
  int nlo = *lo + c * step;
  int rest = *lo + *len - nlo;
  int nlen = rest < step - 1 ? rest : step - 1;
  *len = nlen < 0 ? 0 : nlen;
  *lo = nlo;
}

// Cooperative 32-ary search by one warp (all 32 lanes must call): the first
// index in [0, n) of the sorted v whose entry is >= key, or n.  Each step
// probes 32 evenly spaced entries and one ballot narrows the range 32-fold:
// 4 steps for 131,072 entries where a binary search takes 17 dependent
// loads.
__device__ __forceinline__ int warp_bound(const int32_t* __restrict__ v, int n,
                                          int key) {
  int lane = threadIdx.x & 31;
  int lo = 0, len = n;
  while (len > 0) {
    int step = (len + 31) >> 5;
    int idx = lo + (lane + 1) * step - 1;
    bool before = false;
    if (idx < lo + len) before = __ldg(v + idx) < key;
    narrow32(before, step, &lo, &len);
  }
  return lo;
}

// Lower bound of key in v[0, n) by one thread.
template <bool kGlobal>
__device__ __forceinline__ int lower_bound(const int32_t* v, int n, int key) {
  int lo = 0;
  while (n > 0) {
    int half = n >> 1;
    if (tload<kGlobal>(v + lo + half) < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

constexpr int kStage = 2048;  // table entries a block stages (4 x 8 KB)

// The rows of one affine block, one row per thread: search the row's start
// in the table slice tv[0, tn_) (staged in shared memory, or the whole table
// in global memory), then walk the entries inside the row's range.  Entry
// indices are reported as tbase + local index.  All 32 lanes of a warp stay
// in the emission loop while any of them still has a candidate.
template <bool kGlobal>
__device__ __forceinline__ void affine_rows(
    const uint8_t* __restrict__ nrow, bool live, int row, int p0, int span,
    int i0, const int32_t* tv, const int32_t* t0, const int32_t* t1,
    const int32_t* tni, int tn_, int tbase, int32_t* __restrict__ out,
    int cap) {
  int k = 0, k_first = 0;
  if (live) {
    k = lower_bound<kGlobal>(tv, tn_, p0);
    k_first = k;
  }
  int prev = 0;
  while (__any_sync(kFull, live)) {
    int word = -1;
    while (live) {
      if (k >= tn_) {
        live = false;
        break;
      }
      int p = tload<kGlobal>(tv + k);
      unsigned off = (unsigned)p - (unsigned)p0;
      if (off >= (unsigned)span) {
        live = false;
        break;
      }
      // of entries at one position only the first is a hit (the lower
      // bound of a per-base search)
      bool first = k == k_first || p != prev;
      prev = p;
      int kk = k++;
      if (!first || p <= 0) continue;
      int i = i0 + (int)off;
      int byte = __ldg(nrow + (i >> 1));
      int nib = (i & 1) ? (byte >> 4) : (byte & 0xF);
      if (nib == 15) continue;
      int n_ind = tload<kGlobal>(tni + kk);
      int allele = 2;
      if (nib == tload<kGlobal>(t0 + kk) && n_ind > 0) {
        allele = 0;
      } else if (nib == tload<kGlobal>(t1 + kk) && n_ind > 1) {
        allele = 1;
      }
      word = ((tbase + kk) << 8) | (nib << 4) | allele;
      break;
    }
    emit1(row, word, out, cap);
  }
}

// Replaces phaser_tpu/kernels/alleles.py:975 (_nibble_windowed_impl over the
// Pallas body at :673, with its host planner plan_windows_affine) as a range
// join.  An affine row covers the reference positions [p0, p0 + span), so its
// hits are exactly the table entries in that range: one search per ROW finds
// the first, and the row walks entries while they stay inside.  The base
// under entry k is i0 + vpos[k] - p0, read from the one byte that holds its
// nibble (even base in the low nibble); a masked nibble (15) emits nothing.
//
// Bound: 12 B of parameters per row, the table entries between the rows'
// lowest and highest position, one 32-byte sector of the nibble plane per
// hit and 8 B per hit written; per row the work is one
// search plus its hits, against rows x L x log2(win) dependent loads for a
// search per base.  What the design does about it: a block takes 256
// consecutive rows (BAM order is position order), reduces their
// [min p0, max p0 + span), finds that table slice with two cooperative
// 32-ary warp searches, and when the slice fits kStage entries stages its
// four columns in shared memory with 16-byte asynchronous copies
// (cp.async), so each row's own search and walk run in shared memory.  A
// block whose slice does not fit (rows in no order, a dense table) searches
// the whole table in global memory; the result is the same.
__global__ void __launch_bounds__(kThreads)
affine_nibble_kernel(const uint8_t* __restrict__ ncodes,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ lo,
                     const int32_t* __restrict__ hi, int n_rows, int lh,
                     const int32_t* __restrict__ vpos,
                     const int32_t* __restrict__ a0,
                     const int32_t* __restrict__ a1,
                     const int32_t* __restrict__ ni, int mp,
                     int32_t* __restrict__ out, int cap) {
  __shared__ __align__(16) int32_t sv[kStage];
  __shared__ __align__(16) int32_t s0[kStage];
  __shared__ __align__(16) int32_t s1[kStage];
  __shared__ __align__(16) int32_t sn[kStage];
  __shared__ int red_min[kThreads / 32], red_max[kThreads / 32];
  __shared__ int slice[2];

  int row = blockIdx.x * kThreads + threadIdx.x;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool live = false;
  int p0 = 0, span = 0, i0 = 0;
  if (row < n_rows) {
    int s = __ldg(start + row), l = __ldg(lo + row), h = __ldg(hi + row);
    i0 = l > 0 ? l : 0;
    int i1 = h < 2 * lh ? h : 2 * lh;
    span = i1 - i0;
    p0 = s + (i0 - l);
    live = span > 0;
  }
  // block range [bmin, bmax) over the live rows
  int mn = live ? p0 : 0x7fffffff;
  int mx = live ? p0 + span : (int)0x80000000;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    int omn = __shfl_xor_sync(kFull, mn, d);
    int omx = __shfl_xor_sync(kFull, mx, d);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
  if (lane == 0) {
    red_min[warp] = mn;
    red_max[warp] = mx;
  }
  __syncthreads();
  mn = red_min[0];
  mx = red_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    mn = red_min[w] < mn ? red_min[w] : mn;
    mx = red_max[w] > mx ? red_max[w] : mx;
  }
  if (mx <= mn) return;  // no live row in this block (uniform)

  // the block's table slice [slice[0], slice[1]): one warp per end
  if (warp == 0) {
    int k = warp_bound(vpos, mp, mn);
    if (lane == 0) slice[0] = k;
  } else if (warp == 1) {
    int k = warp_bound(vpos, mp, mx);
    if (lane == 0) slice[1] = k;
  }
  __syncthreads();
  int k_lo = slice[0] & ~3;  // 16-byte aligned for the copies
  int n_slice = slice[1] - k_lo;
  if (n_slice <= 0) return;  // no table entry under this block (uniform)

  const uint8_t* nrow = ncodes + (size_t)row * lh;
  if (n_slice <= kStage) {
    // mp is a multiple of 4, so every 4-entry chunk from k_lo lies inside
    int chunks = (n_slice + 3) >> 2;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      int g = k_lo + 4 * c;
      __pipeline_memcpy_async(sv + 4 * c, vpos + g, 16);
      __pipeline_memcpy_async(s0 + 4 * c, a0 + g, 16);
      __pipeline_memcpy_async(s1 + 4 * c, a1 + g, 16);
      __pipeline_memcpy_async(sn + 4 * c, ni + g, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    affine_rows<false>(nrow, live, row, p0, span, i0, sv, s0, s1, sn,
                       n_slice, k_lo, out, cap);
  } else {
    affine_rows<true>(nrow, live, row, p0, span, i0, vpos, a0, a1, ni, mp, 0,
                      out, cap);
  }
}

// Replaces alleles.py:424 (_delta_windowed_impl).  One thread per packed
// byte; delta is the (n_rows, 2 * lh) int16 plane.  Reads 2.5 B per base;
// bound like affine_nibble by the search's dependent L2 loads.
__global__ void __launch_bounds__(kThreads)
delta_nibble_kernel(const uint8_t* __restrict__ ncodes,
                    const int32_t* __restrict__ start,
                    const int16_t* __restrict__ delta, int n_rows, int lh,
                    const int32_t* __restrict__ ws, int win, int block_rows,
                    const int32_t* __restrict__ vpos,
                    const int32_t* __restrict__ a0,
                    const int32_t* __restrict__ a1,
                    const int32_t* __restrict__ ni, int mp,
                    int32_t* __restrict__ out, int cap) {
  int idx = blockIdx.x * kThreads + threadIdx.x;
  int row = idx / lh;
  int word0 = -1, word1 = -1;
  if (row < n_rows) {
    int j = idx - row * lh;
    int byte = __ldg(ncodes + idx);
    int m0 = byte & 0xF, m1 = byte >> 4;
    int s = __ldg(start + row);
    int w0, wn;
    window(row, ws, win, block_rows, mp, &w0, &wn);
    int i = 2 * j;
    const int16_t* d = delta + (size_t)row * (2 * lh);
    int rp0 = m0 != 15 ? s + i + __ldg(d + i) : 0;
    int rp1 = m1 != 15 ? s + i + 1 + __ldg(d + i + 1) : 0;
    word0 = classify(m0, rp0, vpos, a0, a1, ni, w0, wn);
    word1 = classify(m1, rp1, vpos, a0, a1, ni, w0, wn);
  }
  emit2(row, word0, word1, out, cap);
}

// Warp-aggregated compaction of up to four hits per lane (words of -1 are
// skipped).  Every lane of the warp must call this.
__device__ __forceinline__ void emit4(int row, const int (&word)[4],
                                      int32_t* __restrict__ out, int cap) {
  int lane = threadIdx.x & 31;
  int mine = (word[0] >= 0) + (word[1] >= 0) + (word[2] >= 0) +
             (word[3] >= 0);
  if (__ballot_sync(kFull, mine > 0) == 0) return;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int total = __shfl_sync(kFull, incl, 31);
  int base = 0;
  if (lane == 31) base = atomicAdd(out, total);
  base = __shfl_sync(kFull, base, 31);
  int slot = base + incl - mine;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (word[t] >= 0) {
      if (slot < cap) {
        out[1 + slot] = row;
        out[(cap + 1) + 1 + slot] = word[t];
      }
      ++slot;
    }
  }
}

constexpr int kPlaneWarps = kThreads / 32;
constexpr int kSkel = 1024;  // table skeleton entries in shared memory

// Sum over the warp: one hardware reduction (redux.sync, sm_80 and later).
__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}

// One warp's table lookup through the block's skeleton.  skel[j] is the last
// entry of table segment j (seg entries each, seg a power of two >= 128).
// Finds the first table index whose entry is >= key (kUpper: > key) with two
// ballot steps in shared memory, one probe step in global memory per factor
// 32 that a segment exceeds 128 entries, and ONE coalesced 16-byte-per-lane
// load of the 128 entries that hold the answer.  That window is returned in
// *win (entries *win_lo + 4 * lane ... + 3, INT32_MAX past the table) with
// *n_also, the number of its entries <= also, so the caller gets the other
// end of a row's range from the same reduction and reads the range's
// entries from registers.  All 32 lanes must call.
template <bool kUpper>
__device__ __forceinline__ int skel_bound(const int32_t* __restrict__ vpos,
                                          int mp, const int32_t* skel,
                                          int n_skel, int seg, int key,
                                          int also, int4* win, int* win_lo,
                                          int* n_also) {
  int lane = threadIdx.x & 31;
  // first segment whose last entry is >= key (> key)
  int lo = 0, len = n_skel;
  while (len > 0) {
    int step = (len + 31) >> 5;
    int idx = lo + (lane + 1) * step - 1;
    bool before = false;
    if (idx < lo + len) {
      before = kUpper ? (skel[idx] <= key) : (skel[idx] < key);
    }
    narrow32(before, step, &lo, &len);
  }
  *win = make_int4(0x7fffffff, 0x7fffffff, 0x7fffffff, 0x7fffffff);
  *n_also = 0;
  if (lo >= n_skel) {  // every entry is before the key
    *win_lo = mp;
    return mp;
  }
  lo *= seg;
  len = mp - lo < seg ? mp - lo : seg;
  while (len > 128) {  // segments above 128 entries: narrow in global memory
    int step = (((len + 31) >> 5) + 3) & ~3;  // keeps lo 16-byte aligned
    int idx = lo + (lane + 1) * step - 1;
    bool before = false;
    if (idx < lo + len) {
      int e = __ldg(vpos + idx);
      before = kUpper ? (e <= key) : (e < key);
    }
    narrow32(before, step, &lo, &len);
  }
  // the 128 entries from lo on: the answer is lo + (entries before the key)
  int4 w = *win;
  if (lo + 4 * lane < mp)  // mp is a multiple of 4
    w = __ldg(reinterpret_cast<const int4*>(vpos + lo) + lane);
  int mine = kUpper ? (w.x <= key) + (w.y <= key) + (w.z <= key) + (w.w <= key)
                    : (w.x < key) + (w.y < key) + (w.z < key) + (w.w < key);
  *win = w;
  // entries of the window at or before `also`, in the high half of the sum
  mine |= ((w.x <= also) + (w.y <= also) + (w.z <= also) + (w.w <= also))
          << 16;
  int sum = warp_sum(mine);
  *win_lo = lo;
  *n_also = sum >> 16;
  return lo + (sum & 0xffff);
}

// Replaces alleles.py:1038 (_plane_windowed_impl over the Pallas body at
// :673, with its host planner plan_windows_plane) as a range join.  One warp
// per row, each warp walking over many rows.  Pass 1: the lanes load the
// row's refpos as int4 (16 B a thread, 128 bases a step; rows wider than 128
// loop; the next row's first load is issued before this row is worked on)
// and the warp reduces the smallest positive and the largest position.  The
// table range [k0, k1) under the row comes from skel_bound: the block keeps
// a skeleton of the table (every seg-th entry, at most 1,024) in shared
// memory, so the search costs two ballot steps there and one 16-byte-per-lane
// load of the 128 entries around k0, from which k1 and the range's entries
// are read too unless the range runs past them.  A row with no position or
// an empty range ends there, having read only its refpos.  Pass 2: each lane
// tests its four positions against the entries of the range, broadcast from
// registers when the range has at most 32 entries inside the loaded window,
// else by a binary search inside [k0, k1); codes and quals are loaded only
// where a position matched.  refpos <= 0 and qual < baseq emit nothing.
//
// Bound: the 4 B per base of the refpos plane (the codes and quals planes
// are touched one 32-byte sector per hit), the table entries under the
// rows and 8 B per hit written.  What the design does about it: 16-byte coalesced loads, one
// dependent global load per row for the search where a binary search per
// base makes 8-17, and no second and third plane read for the 99.95% of
// bases that hit nothing.
__global__ void __launch_bounds__(kThreads)
plane_kernel(const uint8_t* __restrict__ codes,
             const uint8_t* __restrict__ quals,
             const int32_t* __restrict__ refpos, int n_rows, int l,
             int baseq, const int32_t* __restrict__ vpos,
             const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
             const int32_t* __restrict__ ni, int mp, int seg, int n_skel,
             int32_t* __restrict__ out, int cap) {
  __shared__ int32_t skel[kSkel];
  for (int j = threadIdx.x; j < n_skel; j += kThreads) {
    int e = (j + 1) * seg;
    skel[j] = __ldg(vpos + (e < mp ? e : mp) - 1);
  }
  __syncthreads();

  int lane = threadIdx.x & 31;
  int quads = l >> 2;  // l is a multiple of 4
  int row = blockIdx.x * kPlaneWarps + (threadIdx.x >> 5);
  int stride = gridDim.x * kPlaneWarps;
  int4 next = make_int4(0, 0, 0, 0);
  if (row < n_rows && lane < quads)
    next = __ldg(reinterpret_cast<const int4*>(refpos + (size_t)row * l) +
                 lane);
  for (; row < n_rows; row += stride) {  // whole warps share a row
    size_t row_off = (size_t)row * l;
    const int4* rp4 = reinterpret_cast<const int4*>(refpos + row_off);
    int4 first = next;
    if (row + stride < n_rows && lane < quads)
      next = __ldg(reinterpret_cast<const int4*>(
                       refpos + (size_t)(row + stride) * l) + lane);

    // pass 1: the row's smallest positive and largest position
    int mn = 0x7fffffff, mx = 0;
    for (int q = lane; q < quads; q += 32) {
      int4 v = q == lane ? first : __ldg(rp4 + q);
      int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (e[t] > 0) {
          mn = e[t] < mn ? e[t] : mn;
          mx = e[t] > mx ? e[t] : mx;
        }
      }
    }
    mn = __reduce_min_sync(kFull, mn);
    mx = __reduce_max_sync(kFull, mx);
    if (mx <= 0) continue;  // no aligned base
    int4 win;
    int win_lo, n_le;
    int k0 = skel_bound<false>(vpos, mp, skel, n_skel, seg, mn, mx, &win,
                               &win_lo, &n_le);
    if (k0 >= mp) continue;
    // the other end from the same 128 entries, unless the range passes them
    bool in_win = n_le < 128;
    int k1 = win_lo + n_le;
    if (!in_win) {
      int4 w2;
      int lo2, n2;
      k1 = skel_bound<true>(vpos, mp, skel, n_skel, seg, mx, mx, &w2, &lo2,
                            &n2);
    }
    int n_range = k1 - k0;
    if (n_range <= 0) continue;  // no table entry under this row
    bool small = in_win && n_range <= 32;

    // pass 2: match positions against the range, classify the matches
    for (int qb = 0; qb < quads; qb += 32) {
      int q = qb + lane;
      int4 v = make_int4(0, 0, 0, 0);
      if (q < quads) v = qb == 0 ? first : __ldg(rp4 + q);
      int e[4] = {v.x, v.y, v.z, v.w};
      int kk[4] = {-1, -1, -1, -1};
      if (small) {
        for (int j = 0; j < n_range; ++j) {
          int at = k0 - win_lo + j;  // uniform over the warp
          int c = at & 3;
          int mine = c == 0 ? win.x : c == 1 ? win.y : c == 2 ? win.z : win.w;
          int p = __shfl_sync(kFull, mine, at >> 2);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            // the first of equal entries wins, as a lower bound does
            if (e[t] == p && kk[t] < 0) kk[t] = k0 + j;
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (e[t] > 0) {
            int k = k0 + lower_bound<true>(vpos + k0, n_range, e[t]);
            if (k < k1 && __ldg(vpos + k) == e[t]) kk[t] = k;
          }
        }
      }
      int word[4] = {-1, -1, -1, -1};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (kk[t] >= 0 && e[t] > 0) {
          size_t idx = row_off + 4 * (size_t)q + t;
          int masked = __ldg(quals + idx) >= baseq ? __ldg(codes + idx) : 15;
          if (masked != 15) {
            int k = kk[t];
            int n_ind = __ldg(ni + k);
            int allele = 2;
            if (masked == __ldg(a0 + k) && n_ind > 0) {
              allele = 0;
            } else if (masked == __ldg(a1 + k) && n_ind > 1) {
              allele = 1;
            }
            word[t] = (k << 8) | (masked << 4) | allele;
          }
        }
      }
      emit4(row, word, out, cap);
    }
  }
}

// Replaces the jnp program assign_compact_affine_masked
// (phaser_tpu/kernels/alleles.py:246-259), which phaser_tpu runs when the
// nibble packer is missing.  One thread per two bases of the (n_rows, l)
// masked plane (BASEQ already applied, 15 = masked): 1 B per base read, then
// the same dependent L2 loads as affine_nibble.
__global__ void __launch_bounds__(kThreads)
affine_masked_kernel(const uint8_t* __restrict__ mcodes,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ lo,
                     const int32_t* __restrict__ hi, int n_rows, int l,
                     const int32_t* __restrict__ ws, int win, int block_rows,
                     const int32_t* __restrict__ vpos,
                     const int32_t* __restrict__ a0,
                     const int32_t* __restrict__ a1,
                     const int32_t* __restrict__ ni, int mp,
                     int32_t* __restrict__ out, int cap) {
  int lh = l >> 1;
  int idx = blockIdx.x * kThreads + threadIdx.x;
  int row = idx / lh;
  int word0 = -1, word1 = -1;
  if (row < n_rows) {
    int i = 2 * (idx - row * lh);
    const uint8_t* m = mcodes + (size_t)row * l;
    int s = __ldg(start + row), lw = __ldg(lo + row), h = __ldg(hi + row);
    int w0, wn;
    window(row, ws, win, block_rows, mp, &w0, &wn);
    int rp0 = (i >= lw && i < h) ? s + (i - lw) : 0;
    int rp1 = (i + 1 >= lw && i + 1 < h) ? s + (i + 1 - lw) : 0;
    word0 = classify(__ldg(m + i), rp0, vpos, a0, a1, ni, w0, wn);
    word1 = classify(__ldg(m + i + 1), rp1, vpos, a0, a1, ni, w0, wn);
  }
  emit2(row, word0, word1, out, cap);
}

// Unfused planes: replaces _alleles_pallas_windowed_kernel as reached from
// assign_alleles_pallas_windowed (alleles.py:813, windowed table) and the
// jnp assign_alleles_device (:33, whole table, win = mp); with kResident it
// replaces _alleles_pallas_kernel (:627, via assign_alleles_pallas), whose
// table (mp <= L entries) every block reads in full: the block stages it in
// shared memory once (16 B per entry, 16 KB at L = 1024) and searches it
// there.  Grid-stride over the bases, one base per thread per step.  Reads
// 6 B and writes 8 B per base: bound by the plane traffic once the table
// sits in L2 or shared memory.
template <bool kResident>
__global__ void __launch_bounds__(kThreads)
planes_kernel(const uint8_t* __restrict__ codes,
              const uint8_t* __restrict__ quals,
              const int32_t* __restrict__ refpos, int n_rows, int l,
              int baseq, const int32_t* __restrict__ ws, int win,
              int block_rows, const int32_t* __restrict__ vpos,
              const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
              const int32_t* __restrict__ ni, int mp,
              int32_t* __restrict__ vidx_out,
              int32_t* __restrict__ allele_out) {
  extern __shared__ int32_t staged[];
  const int32_t* tv = vpos;
  const int32_t* t0 = a0;
  const int32_t* t1 = a1;
  const int32_t* tn = ni;
  if constexpr (kResident) {
    for (int k = threadIdx.x; k < mp; k += kThreads) {
      staged[k] = vpos[k];
      staged[mp + k] = a0[k];
      staged[2 * mp + k] = a1[k];
      staged[3 * mp + k] = ni[k];
    }
    __syncthreads();
    tv = staged;
    t0 = staged + mp;
    t1 = staged + 2 * mp;
    tn = staged + 3 * mp;
  }
  long long total = (long long)n_rows * l;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    int row = (int)(idx / l);
    int masked = __ldg(quals + idx) >= baseq ? __ldg(codes + idx) : 15;
    int w0, wn;
    window(row, ws, win, block_rows, mp, &w0, &wn);
    int allele = 3;
    int v = lookup<!kResident>(masked, __ldg(refpos + idx), tv, t0, t1, tn,
                               w0, wn, &allele);
    vidx_out[idx] = v;
    allele_out[idx] = v < 0 ? 3 : allele;
  }
}

constexpr int kWin = 256;            // table window entries per row block
constexpr int kCmpThreads = 1024;

// Replaces _alleles_pallas_cmp_kernel (alleles.py:757): the gather-free
// windowed body.  One CUDA block per row block: its threads load the four
// 256-entry window slices into shared memory together (4 KB, INT32_MAX past
// the table's end), then each base is compared with all 256 entries
// (broadcast shared reads, no search) and the last match wins, which equals
// the lower bound on unique positions.  Bound by the ~256 compare-selects per
// base; kept as the TPU's recorded alternative to the search.
__global__ void __launch_bounds__(kCmpThreads)
planes_cmp_kernel(const uint8_t* __restrict__ codes,
                  const uint8_t* __restrict__ quals,
                  const int32_t* __restrict__ refpos, int n_rows, int l,
                  int baseq, const int32_t* __restrict__ ws, int block_rows,
                  const int32_t* __restrict__ vpos,
                  const int32_t* __restrict__ a0,
                  const int32_t* __restrict__ a1,
                  const int32_t* __restrict__ ni, int mp,
                  int32_t* __restrict__ vidx_out,
                  int32_t* __restrict__ allele_out) {
  __shared__ int32_t sv[kWin], s0[kWin], s1[kWin], sn[kWin];
  int b = blockIdx.x;
  int w0 = __ldg(ws + b);
  for (int k = threadIdx.x; k < kWin; k += kCmpThreads) {
    int g = w0 + k;
    bool in = g < mp;
    sv[k] = in ? __ldg(vpos + g) : 0x7fffffff;
    s0[k] = in ? __ldg(a0 + g) : 0;
    s1[k] = in ? __ldg(a1 + g) : 0;
    sn[k] = in ? __ldg(ni + g) : 0;
  }
  __syncthreads();
  int row0 = b * block_rows;
  int rows = min(block_rows, n_rows - row0);
  size_t base = (size_t)row0 * l;
  int n = rows * l;
  for (int e = threadIdx.x; e < n; e += kCmpThreads) {
    size_t idx = base + e;
    int rp = __ldg(refpos + idx);
    int masked = __ldg(quals + idx) >= baseq ? __ldg(codes + idx) : 15;
    int k_hit = -1;
#pragma unroll 16
    for (int k = 0; k < kWin; ++k) k_hit = sv[k] == rp ? k : k_hit;
    int v = -1, allele = 3;
    if (rp > 0 && k_hit >= 0 && masked != 15) {
      v = w0 + k_hit;
      if (masked == s0[k_hit] && sn[k_hit] > 0) {
        allele = 0;
      } else if (masked == s1[k_hit] && sn[k_hit] > 1) {
        allele = 1;
      } else {
        allele = 2;
      }
    }
    vidx_out[idx] = v;
    allele_out[idx] = allele;
  }
}

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// The packed-hit buffer before a fused kernel: every word -1, the hit counter
// out[0] = 0.  Two memsets on the kernel's stream.
inline cudaError_t init_packed(void* out, int cap, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(out, 0xff, (size_t)2 * ((size_t)cap + 1) *
                                                 sizeof(int32_t), stream);
  if (e != cudaSuccess) return e;
  return cudaMemsetAsync(out, 0, sizeof(int32_t), stream);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers.

int affine_nibble_launch(const void* ncodes, const void* start, const void* lo,
                         const void* hi, int n_rows, int lh, const void* vpos,
                         const void* a0, const void* a1, const void* ni,
                         int mp, void* out, int cap, void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    // one row per thread
    affine_nibble_kernel<<<grid_for(n_rows), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)ncodes, (const int32_t*)start, (const int32_t*)lo,
        (const int32_t*)hi, n_rows, lh, (const int32_t*)vpos,
        (const int32_t*)a0, (const int32_t*)a1, (const int32_t*)ni, mp,
        (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

int delta_nibble_launch(const void* ncodes, const void* start,
                        const void* delta, int n_rows, int lh, const void* ws,
                        int win, int block_rows, const void* vpos,
                        const void* a0, const void* a1, const void* ni, int mp,
                        void* out, int cap, void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    delta_nibble_kernel<<<grid_for((long long)n_rows * lh), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)ncodes, (const int32_t*)start, (const int16_t*)delta,
        n_rows, lh, (const int32_t*)ws, win, block_rows, (const int32_t*)vpos,
        (const int32_t*)a0, (const int32_t*)a1, (const int32_t*)ni, mp,
        (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

int plane_launch(const void* codes, const void* quals, const void* refpos,
                 int n_rows, int l, int baseq, const void* vpos,
                 const void* a0, const void* a1, const void* ni, int mp,
                 void* out, int cap, void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    // one warp per row at a time; exactly the blocks the card holds at once
    // (one wave), each loading the table skeleton once and walking over its
    // share of rows
    // The one-wave size is asked of the runtime once per device (the launch
    // goes to the current device, so that is the one asked); threads that
    // race here store the same value.
    static int wave[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int fill = dev < 64 ? wave[dev] : 0;
    if (fill == 0) {
      int sms = 132, per_sm = 0;  // blocks of this kernel resident on one SM
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, plane_kernel, kThreads, 0);
      if (e != cudaSuccess) return (int)e;
      fill = sms * (per_sm > 0 ? per_sm : 1);
      if (dev < 64) wave[dev] = fill;
    }
    long long want = ((long long)n_rows + kPlaneWarps - 1) / kPlaneWarps;
    unsigned grid = (unsigned)(want < fill ? want : fill);
    int seg = 128;
    while ((long long)seg * kSkel < mp) seg <<= 1;
    int n_skel = (mp + seg - 1) / seg;
    plane_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)refpos,
        n_rows, l, baseq, (const int32_t*)vpos, (const int32_t*)a0,
        (const int32_t*)a1, (const int32_t*)ni, mp, seg, n_skel,
        (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

int affine_masked_launch(const void* mcodes, const void* start, const void* lo,
                         const void* hi, int n_rows, int l, const void* ws,
                         int win, int block_rows, const void* vpos,
                         const void* a0, const void* a1, const void* ni,
                         int mp, void* out, int cap, void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    affine_masked_kernel<<<grid_for((long long)n_rows * (l / 2)), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)mcodes, (const int32_t*)start, (const int32_t*)lo,
        (const int32_t*)hi, n_rows, l, (const int32_t*)ws, win, block_rows,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

// resident != 0 stages the whole table (win must be mp) in shared memory.
int planes_launch(const void* codes, const void* quals, const void* refpos,
                  int n_rows, int l, int baseq, const void* ws, int win,
                  int block_rows, const void* vpos, const void* a0,
                  const void* a1, const void* ni, int mp, int resident,
                  void* vidx, void* allele, void* stream) {
  long long total = (long long)n_rows * l;
  if (total == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // grid-stride: enough blocks to fill the card, each staging the resident
  // table once
  long long want = grid_for(total);
  long long cap = (long long)sms * (2048 / kThreads);
  unsigned grid = (unsigned)(want < cap ? want : cap);
  if (resident) {
    size_t smem = (size_t)4 * mp * sizeof(int32_t);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          planes_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    planes_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)refpos,
        n_rows, l, baseq, (const int32_t*)ws, win, block_rows,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)vidx, (int32_t*)allele);
  } else {
    planes_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)refpos,
        n_rows, l, baseq, (const int32_t*)ws, win, block_rows,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)vidx, (int32_t*)allele);
  }
  return (int)cudaGetLastError();
}

int planes_cmp_launch(const void* codes, const void* quals, const void* refpos,
                      int n_rows, int l, int baseq, const void* ws,
                      int block_rows, const void* vpos, const void* a0,
                      const void* a1, const void* ni, int mp, void* vidx,
                      void* allele, void* stream) {
  if (n_rows > 0) {
    unsigned grid = (unsigned)((n_rows + block_rows - 1) / block_rows);
    planes_cmp_kernel<<<grid, kCmpThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)refpos,
        n_rows, l, baseq, (const int32_t*)ws, block_rows,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)vidx, (int32_t*)allele);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
