// Allele-assignment kernels for Hopper (sm_90a): per-base hit
// classification against the sorted variant table.
//
// The fused entries rebuild each base's (masked code, 1-based reference
// position) from their read format and compact hits into the packed-hit
// stream.  All four are range joins (below):
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
//                  packer.  One body with affine_nibble, over the code fetch.
//   affine_planes  replaces the jnp program assign_compact_affine
//                  (alleles.py:217-226): the affine rebuild from the unmasked
//                  codes and quals planes, BASEQ applied in the kernel.  The
//                  same body again, over a third code fetch.
//   read_spans     the dispatcher's span pass (host code in phaser_tpu): a
//                  flag byte a read (I op, N op, a table position under its
//                  conservative span), written, not compacted.  Bound by
//                  bytes: a streaming pass of warps over 128-read tiles.
//   ragged_join    replaces the dispatcher's three packed routes (the same
//                  Pallas body, fed the host packers' padded planes): each
//                  read's reference positions from its pos and CIGAR, its
//                  bases read where BAM decode put them.  The allele
//                  dispatcher's one route for every non-insertion read.
//                  Bound by bytes, held back by a chain of dependent
//                  latencies: 256-read tiles.
//   The two tile kernels share their pieces (the position skeleton and
//   skel_bound) and their shape: a tile of consecutive reads whose CIGAR
//   words are one run, the residency the card's thread limit or registers
//   allow, and only the table each needs (the join stages a four-column
//   slice in shared memory, the span pass holds the 32 positions under a
//   warp's tile in registers).
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
// Table search, range-join entries (affine_nibble, affine_masked,
// affine_planes, delta_nibble, plane, ragged_join: every fused entry).  The
// hits of a row are the table entries whose position lies in the row's
// reference range, so these kernels find that range on the card (no host
// planner, no window argument) and visit its entries instead of searching
// once per base.  The
// affine kernels compute the range from (start, lo, hi), the delta kernel
// takes it from the packer's per-row [rp_min, rp_max], the plane kernel
// reduces it from the refpos plane, the ragged join walks the row's CIGAR.
// See the note above each kernel.
//
// Table search, windowed entries (planes, planes_cmp).  Row r belongs to row
// block b = r / block_rows; the block searches table entries
// [ws[b], min(ws[b] + win, mp)).  The host planner picks ws so that every
// position the block can hit lies in that range; the unplanned case passes
// ws = {0} and win = mp (the whole table).  A CUDA block works inside one
// row block and stages that block's window (or the resident table) in
// shared memory with 16-byte asynchronous copies; only the whole-table mode
// leaves the table in global memory (L2-resident: 4 x 4 B x 128k entries =
// 2 MB) and keeps a skeleton of it in shared memory.  A warp takes 512
// consecutive bases at a time, a thread 16 of them as four runs of 4, and
// the thread searches once for the whole range of its 16 positions.
//
// Packed output (fused entries): one int32 (2, cap + 1) buffer, filled with
// -1 and with out[0] = 0 (the hit counter) by its launcher.  A hit takes a
// slot with one warp-aggregated atomicAdd on out[0]; row 0 gets the read
// index within the launch, row 1 gets (var << 8) | (masked << 4) | allele.
// Slots >= cap are counted but not written, so the final out[0] is the exact
// hit count and overflow is visible to the caller.  Hit order is arbitrary
// (the caller lexsorts).
//
// Bound.  About one base in 2,000 lies on a variant and about one row in
// twenty has any table entry under it, so what a fused launch must move
// depends on its data: the per-row parameters (12 B per affine row, the
// 8 B of [rp_min, rp_max] per delta row) or the refpos plane (4 B per base),
// the table entries under the launch's rows (16 B per entry), `start` and
// the delta row (2 B per base) of a row with an entry under it, one
// 32-byte sector of the code planes per hit, and 8 B per hit written.  The
// range joins read little more than that: one search per row
// (or per block, then in shared memory) instead of one per base, and plane
// bytes only where a position matched.  What is left is latency (parameter
// loads, block barriers, the search's dependent loads), not bytes.  The
// unfused planes kernels read 6 B and write 8 B per base whatever the data.
//
// Index arithmetic is int32 inside a row plane: the wrappers assert
// n_rows * L < 2^31.

#include <climits>
#include <cstddef>
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
// index in [0, n) of the sorted v whose entry is >= key (kUpper: > key), or
// n.  Each step probes 32 evenly spaced entries and one ballot narrows the
// range 32-fold: 4 steps for 131,072 entries where a binary search takes 17
// dependent loads.
template <bool kUpper = false>
__device__ __forceinline__ int warp_bound(const int32_t* __restrict__ v, int n,
                                          int key) {
  int lane = threadIdx.x & 31;
  int lo = 0, len = n;
  while (len > 0) {
    int step = (len + 31) >> 5;
    int idx = lo + (lane + 1) * step - 1;
    bool before = false;
    if (idx < lo + len) {
      int e = __ldg(v + idx);
      before = kUpper ? e <= key : e < key;
    }
    narrow32(before, step, &lo, &len);
  }
  return lo;
}

// Lower bound (kUpper: upper bound) of key in v[0, n) by one thread.
template <bool kGlobal, bool kUpper = false>
__device__ __forceinline__ int lower_bound(const int32_t* v, int n, int key) {
  int lo = 0;
  while (n > 0) {
    int half = n >> 1;
    int e = tload<kGlobal>(v + lo + half);
    if (kUpper ? e <= key : e < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

constexpr int kStage = 2048;  // table entries a block stages (4 x 8 KB)

// The code layouts the affine join reads.  A layout's row(r, l) gives the
// accessor of row r of an l-base plane, whose code(i) is the masked code of
// base i (15 = masked, N or pad), read only where a table entry lies.
//
// NibblePlane: (n_rows, l / 2), two masked codes a byte, even base low.
struct NibbleRow {
  const uint8_t* c;
  __device__ __forceinline__ int code(int i) const {
    int byte = __ldg(c + (i >> 1));
    return (i & 1) ? (byte >> 4) : (byte & 0xF);
  }
};
struct NibblePlane {
  const uint8_t* ncodes;
  __device__ __forceinline__ NibbleRow row(int r, int l) const {
    return {ncodes + (size_t)r * (l >> 1)};
  }
};

// MaskedPlane: (n_rows, l), one masked code a byte (BASEQ applied).
struct MaskedRow {
  const uint8_t* c;
  __device__ __forceinline__ int code(int i) const { return __ldg(c + i); }
};
struct MaskedPlane {
  const uint8_t* mcodes;
  __device__ __forceinline__ MaskedRow row(int r, int l) const {
    return {mcodes + (size_t)r * l};
  }
};

// CodesQualsPlanes: the unmasked (n_rows, l) codes and quals planes; a base
// whose qual is under baseq reads as 15, as phaser_tpu masks it.
struct CodesQualsRow {
  const uint8_t* c;
  const uint8_t* q;
  int baseq;
  __device__ __forceinline__ int code(int i) const {
    return __ldg(q + i) >= baseq ? __ldg(c + i) : 15;
  }
};
struct CodesQualsPlanes {
  const uint8_t* codes;
  const uint8_t* quals;
  int baseq;
  __device__ __forceinline__ CodesQualsRow row(int r, int l) const {
    size_t off = (size_t)r * l;
    return {codes + off, quals + off, baseq};
  }
};

// Packed hit word of observed code `masked` (not 15) on table entry k of the
// slice tv/t0/t1/tni, whose first entry has table index tbase.
template <bool kGlobal>
__device__ __forceinline__ int hit_word(int masked, int k, const int32_t* t0,
                                        const int32_t* t1, const int32_t* tni,
                                        int tbase) {
  int n_ind = tload<kGlobal>(tni + k);
  int allele = 2;
  if (masked == tload<kGlobal>(t0 + k) && n_ind > 0) {
    allele = 0;
  } else if (masked == tload<kGlobal>(t1 + k) && n_ind > 1) {
    allele = 1;
  }
  return ((tbase + k) << 8) | (masked << 4) | allele;
}

// The rows of one affine block, one row per thread: search the row's start
// in the table slice tv[0, tn_) (staged in shared memory, or the whole table
// in global memory), then walk the entries inside the row's range.  Entry
// indices are reported as tbase + local index.  All 32 lanes of a warp stay
// in the emission loop while any of them still has a candidate.
template <bool kGlobal, class Row>
__device__ __forceinline__ void affine_rows(
    const Row& crow, bool live, int row, int p0, int span,
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
      int code = crow.code(i0 + (int)off);
      if (code == 15) continue;
      word = hit_word<kGlobal>(code, kk, t0, t1, tni, tbase);
      break;
    }
    emit1(row, word, out, cap);
  }
}

// Per-block state of the kernels that stage a table slice in shared memory.
struct BlockTable {
  int32_t sv[kStage], s0[kStage], s1[kStage], sn[kStage];
  int red_min[kThreads / 32], red_max[kThreads / 32];
  int slice[2];
};

// The table slice under a block whose live rows cover the positions
// [mn, mx] (mn = INT32_MAX and mx = INT32_MIN from a thread without a live
// row): reduces the range over the block, finds the slice with two
// cooperative 32-ary warp searches and, when it holds at most kStage
// entries, stages its four columns in bt with 16-byte asynchronous copies
// (cp.async).  Returns false, uniformly, when no table entry lies under the
// block.  Sets *k_lo (the slice's first table index, rounded down to 4
// entries for the copies), *n_slice and *staged.  Every thread of the block
// must call; mp is a multiple of 4.
__device__ __forceinline__ bool block_slice(
    BlockTable& bt, int mn, int mx, const int32_t* __restrict__ vpos,
    const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
    const int32_t* __restrict__ ni, int mp, int* k_lo, int* n_slice,
    bool* staged) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    int omn = __shfl_xor_sync(kFull, mn, d);
    int omx = __shfl_xor_sync(kFull, mx, d);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
  if (lane == 0) {
    bt.red_min[warp] = mn;
    bt.red_max[warp] = mx;
  }
  __syncthreads();
  mn = bt.red_min[0];
  mx = bt.red_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    mn = bt.red_min[w] < mn ? bt.red_min[w] : mn;
    mx = bt.red_max[w] > mx ? bt.red_max[w] : mx;
  }
  if (mx < mn) return false;  // no live row in this block

  // the block's table slice [slice[0], slice[1]): one warp per end
  if (warp == 0) {
    int k = warp_bound(vpos, mp, mn);
    if (lane == 0) bt.slice[0] = k;
  } else if (warp == 1) {
    int k = warp_bound<true>(vpos, mp, mx);
    if (lane == 0) bt.slice[1] = k;
  }
  __syncthreads();
  *k_lo = bt.slice[0] & ~3;  // 16-byte aligned for the copies
  *n_slice = bt.slice[1] - *k_lo;
  if (*n_slice <= 0) return false;  // no table entry under this block
  *staged = *n_slice <= kStage;
  if (*staged) {
    // mp is a multiple of 4, so every 4-entry chunk from k_lo lies inside
    int chunks = (*n_slice + 3) >> 2;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      int g = *k_lo + 4 * c;
      __pipeline_memcpy_async(bt.sv + 4 * c, vpos + g, 16);
      __pipeline_memcpy_async(bt.s0 + 4 * c, a0 + g, 16);
      __pipeline_memcpy_async(bt.s1 + 4 * c, a1 + g, 16);
      __pipeline_memcpy_async(bt.sn + 4 * c, ni + g, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  return true;
}

// The affine range join, one body for the three code layouts (Plane: the
// (n_rows, l / 2) nibble plane, the (n_rows, l) masked byte plane, or the
// codes and quals planes with BASEQ).
// An affine row covers the reference positions [p0, p0 + span), so its hits
// are exactly the table entries in that range: one search per ROW finds the
// first, and the row walks entries while they stay inside.  The base under
// entry k is i0 + vpos[k] - p0, read from the byte (or the code and qual
// bytes) that hold its code; a masked code (15) emits nothing.
//
// Bound: 12 B of parameters per row, the table entries between the rows'
// lowest and highest position, one 32-byte sector of the code plane (of
// each of the codes and quals planes) per hit and 8 B per hit written; per
// row the work is one search plus its hits, against rows x L x log2(win)
// dependent loads for a search per base.
// What the design does about it: a block takes 256 consecutive rows (BAM
// order is position order), finds the table slice under them (block_slice)
// and, when the slice fits kStage entries, runs each row's own search and
// walk in shared memory.  A block whose slice does not fit (rows in no
// order, a dense table) searches the whole table in global memory; the
// result is the same.
template <class Plane>
__device__ __forceinline__ void affine_body(
    const Plane& plane, const int32_t* __restrict__ start,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int n_rows, int l, const int32_t* __restrict__ vpos,
    const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
    const int32_t* __restrict__ ni, int mp, int32_t* __restrict__ out,
    int cap) {
  __shared__ __align__(16) BlockTable bt;

  int row = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  int p0 = 0, span = 0, i0 = 0;
  if (row < n_rows) {
    int s = __ldg(start + row), w = __ldg(lo + row), h = __ldg(hi + row);
    i0 = w > 0 ? w : 0;
    int i1 = h < l ? h : l;
    span = i1 - i0;
    p0 = s + (i0 - w);
    live = span > 0;
  }
  int k_lo, n_slice;
  bool staged;
  if (!block_slice(bt, live ? p0 : 0x7fffffff,
                   live ? p0 + span - 1 : (int)0x80000000, vpos, a0, a1, ni,
                   mp, &k_lo, &n_slice, &staged))
    return;
  const auto crow = plane.row(row, l);
  if (staged) {
    affine_rows<false>(crow, live, row, p0, span, i0, bt.sv, bt.s0, bt.s1,
                       bt.sn, n_slice, k_lo, out, cap);
  } else {
    affine_rows<true>(crow, live, row, p0, span, i0, vpos, a0, a1, ni, mp, 0,
                      out, cap);
  }
}

// Replaces phaser_tpu/kernels/alleles.py:975 (_nibble_windowed_impl over the
// Pallas body at :673, with its host planner plan_windows_affine): the
// affine range join (affine_body) on the nibble plane, 2 * lh bases a row.
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
  affine_body(NibblePlane{ncodes}, start, lo, hi, n_rows, 2 * lh, vpos, a0,
              a1, ni, mp, out, cap);
}

// Replaces the jnp program assign_compact_affine_masked
// (phaser_tpu/kernels/alleles.py:246-259), which phaser_tpu runs when the
// nibble packer is missing: the affine range join (affine_body) on the
// (n_rows, l) masked plane (BASEQ already applied, 15 = masked).  A search
// per base read the whole plane (1 B per base) and made 17 dependent L2
// loads for every aligned base; the join reads 12 B per row and one byte of
// the plane per table entry under the row, and is bound like affine_nibble
// by latency (parameter load, two block barriers, the search), not bytes.
__global__ void __launch_bounds__(kThreads)
affine_masked_kernel(const uint8_t* __restrict__ mcodes,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ lo,
                     const int32_t* __restrict__ hi, int n_rows, int l,
                     const int32_t* __restrict__ vpos,
                     const int32_t* __restrict__ a0,
                     const int32_t* __restrict__ a1,
                     const int32_t* __restrict__ ni, int mp,
                     int32_t* __restrict__ out, int cap) {
  affine_body(MaskedPlane{mcodes}, start, lo, hi, n_rows, l, vpos, a0, a1,
              ni, mp, out, cap);
}

// Replaces the jnp program assign_compact_affine
// (phaser_tpu/kernels/alleles.py:217-226: assign_alleles_affine_device fused
// with _pack_hits), whose only output is the packed-hit buffer: the affine
// range join (affine_body) on the unmasked (n_rows, l) codes and quals
// planes, masked = qual >= baseq ? code : 15 for the one base under each
// table entry.  Neither the masked plane nor the refpos plane reaches
// device memory.  Bound like affine_masked by latency, not bytes: a hit
// reads a sector of each plane where affine_masked reads one.
__global__ void __launch_bounds__(kThreads)
affine_planes_kernel(const uint8_t* __restrict__ codes,
                     const uint8_t* __restrict__ quals,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ lo,
                     const int32_t* __restrict__ hi, int n_rows, int l,
                     int baseq, const int32_t* __restrict__ vpos,
                     const int32_t* __restrict__ a0,
                     const int32_t* __restrict__ a1,
                     const int32_t* __restrict__ ni, int mp,
                     int32_t* __restrict__ out, int cap) {
  affine_body(CodesQualsPlanes{codes, quals, baseq}, start, lo, hi, n_rows, l,
              vpos, a0, a1, ni, mp, out, cap);
}

// CIGAR op classes of the ragged join, as bit masks over the op code (bit op
// set: the op is of the class).  The launcher gets them from the caller,
// which reads them off mapper/host.py's _ALIGNED, _REF_CONSUME and
// _READ_CONSUME tables, so the kernel walks a CIGAR as expand_refpos does.
struct OpClasses {
  unsigned aligned, ref, query;
};

__device__ __forceinline__ bool in_class(unsigned mask, unsigned op) {
  return (mask >> op) & 1u;
}

// Row tiles of the ragged join and the span pass.  A block (the join) or
// a warp (the span pass) takes a tile of consecutive rows (BAM order is
// position order), whose CIGAR words are one contiguous run
// cigar[c_lo, c_hi): the join copies that run into shared memory once,
// coalesced (stage_run), and every row reads its ops from there; the span
// pass's lanes read neighbouring words of it.  The sizes are what each
// kernel needs (the fixture's kept reads hold about 1.7 ops a read and,
// under 256 of them, about 80 table entries; all its reads hold 1.2 ops a
// read and, under 128 of them, one or two entries):
constexpr int kJoinOps = 1024;   // CIGAR words a ragged_join tile stages
constexpr int kJoinStage = 512;  // table entries it stages, four columns
constexpr int kJoinHits = 1024;  // hits it gathers before one atomic
constexpr int kSpanTile = 128;   // reads a read_spans warp takes
constexpr int kSpanStage = 32;   // positions it holds, one a lane
constexpr int kSpanRowsPerLane = kSpanTile / 32;
// Every block of either kernel keeps a skeleton of the positions,
// sk[i] = vpos[i * seg] for at most kSliceSkel entries (seg a power of two
// from 1,024, set by the launcher: 128 entries for a table of 131,072),
// from which a tile's slice bounds take one search in shared memory and
// two levels of a warp's search in the table (three from 2^20 entries).
constexpr int kSliceSkel = 512;
// Blocks of 256 threads an SM: the join at the thread limit (8, 32
// registers a thread); the span pass at 6 (40 registers), where 8 spill
constexpr int kJoinBlocksPerSm = 8, kSpanBlocksPerSm = 6;

// Starts 16-byte asynchronous copies (cp.async) of the elements
// [src, src + n) of type T into dst (room for cap_bytes, a multiple of 16)
// from the 16-byte boundary at or before src, as many as fit; the `lanes`
// threads that copy call it (this one `lane` of them), and the caller
// commits, waits and syncs.  A 16-byte
// chunk that holds one element of the run lies in the run's page, so the
// bytes around the run that the copies also read are never out of bounds.
// Returns the index in dst of element src[0] and sets *n_staged: the
// elements [0, n_staged) of src are staged.
template <class T>
__device__ __forceinline__ int stage_run(T* dst, int cap_bytes,
                                         const T* __restrict__ src,
                                         long long n, int* n_staged,
                                         int lane, int lanes) {
  *n_staged = 0;
  if (n <= 0) return 0;
  int shift = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const T* base = src - shift;
  long long want = (shift + n) * (long long)sizeof(T);
  int bytes = want < cap_bytes ? (int)want : cap_bytes;
  int chunks = (bytes + 15) >> 4;
  for (int c = lane; c < chunks; c += lanes)
    __pipeline_memcpy_async(reinterpret_cast<char*>(dst) + 16 * c,
                            reinterpret_cast<const char*>(base) + 16 * c, 16);
  long long whole = bytes / (long long)sizeof(T) - shift;
  *n_staged = (int)(whole < n ? whole : n);
  return shift;
}

// The ops [c0, c1) of a row of a tile whose CIGAR words from c_lo are
// staged at sops (n_staged of them): in shared memory when all of them are
// staged, else (a CIGAR past the stage) in global memory.  The same words
// either way.
__device__ __forceinline__ const uint32_t* row_ops(
    const uint32_t* sops, int n_staged, const uint32_t* __restrict__ cigar,
    long long c_lo, long long c0, long long c1) {
  return c1 - c_lo <= n_staged ? sops + (c0 - c_lo) : cigar + c0;
}

// Starts the copy of the position skeleton sk[i] = vpos[i * seg], i <
// n_sk, into shared memory (4-byte asynchronous copies; the caller
// commits, waits and syncs).
__device__ __forceinline__ void stage_skeleton(int32_t* sk,
                                               const int32_t* __restrict__ v,
                                               int n_sk, int seg) {
  for (int i = threadIdx.x; i < n_sk; i += kThreads)
    __pipeline_memcpy_async(sk + i, v + (long long)i * seg, 4);
}

// The first index in [0, mp) of the sorted v whose entry is >= key (kUpper:
// > key), or mp, by one warp (all 32 lanes must call): the skeleton's
// bound i in shared memory leaves the answer in ((i - 1) seg, i seg] (in
// ((n_sk - 1) seg, mp] past the skeleton), which a cooperative 32-ary
// search of that range finds in two levels at seg 1,024 (three for a
// table of 2^22 entries, seg 8,192).
template <bool kUpper>
__device__ __forceinline__ int skel_bound(const int32_t* __restrict__ v,
                                          int mp, const int32_t* sk,
                                          int n_sk, int seg, int key) {
  int i = lower_bound<false, kUpper>(sk, n_sk, key);
  int lo = i > 0 ? (i - 1) * seg + 1 : 0;
  int hi = i < n_sk ? i * seg : mp;
  return lo + warp_bound<kUpper>(v + lo, hi - lo, key);
}

// The table slice under a join tile whose live rows cover the positions
// [mn, mx] (mn = INT32_MAX and mx = INT32_MIN from a thread without a live
// row): reduces the range over the block (red: 2 * kThreads / 32 + 2 ints
// of shared memory), finds the slice's two ends by skel_bound, one warp an
// end, and, when it holds at most `cap` entries, stages the four columns
// in `stage` with 16-byte asynchronous copies.  Returns false, uniformly,
// when no table entry lies under the tile.  Sets *k_lo (the slice's first
// table index, rounded down to 4 entries for the copies), *n_slice and
// *staged.  Every thread of the block must call; mp is a multiple of 4 and
// the columns are 16-byte aligned.
__device__ __forceinline__ bool tile_slice(
    int* red, int mn, int mx, const int32_t* const (&col)[4],
    int32_t* const (&stage)[4], int cap, int mp, const int32_t* sk,
    int n_sk, int seg, int* k_lo, int* n_slice, bool* staged) {
  constexpr int kWarps = kThreads / 32;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    int omn = __shfl_xor_sync(kFull, mn, d);
    int omx = __shfl_xor_sync(kFull, mx, d);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
  if (lane == 0) {
    red[warp] = mn;
    red[kWarps + warp] = mx;
  }
  __syncthreads();
  mn = red[0];
  mx = red[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    mn = red[w] < mn ? red[w] : mn;
    mx = red[kWarps + w] > mx ? red[kWarps + w] : mx;
  }
  if (mx < mn) return false;  // no live row in this tile
  // the tile's table slice [red[2 kWarps], red[2 kWarps + 1]): one warp an
  // end
  if (warp == 0) {
    int k = skel_bound<false>(col[0], mp, sk, n_sk, seg, mn);
    if (lane == 0) red[2 * kWarps] = k;
  } else if (warp == 1) {
    int k = skel_bound<true>(col[0], mp, sk, n_sk, seg, mx);
    if (lane == 0) red[2 * kWarps + 1] = k;
  }
  __syncthreads();
  *k_lo = red[2 * kWarps] & ~3;  // 16-byte aligned for the copies
  *n_slice = red[2 * kWarps + 1] - *k_lo;
  if (*n_slice <= 0) return false;  // no table entry under this tile
  *staged = *n_slice <= cap;
  if (*staged) {
    // mp is a multiple of 4, so every 4-entry chunk from k_lo lies inside
    int chunks = (*n_slice + 3) >> 2;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        __pipeline_memcpy_async(stage[j] + 4 * c, col[j] + *k_lo + 4 * c, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  return true;
}

// Shared memory of a ragged_join block (dynamic, 22.1 KB).
struct JoinTile {
  uint32_t ops[kJoinOps + 4];
  int32_t sv[kJoinStage], s0[kJoinStage], s1[kJoinStage], sn[kJoinStage];
  int32_t sk[kSliceSkel];
  int32_t hit_row[kJoinHits], hit_word[kJoinHits];
  int red[2 * (kThreads / 32) + 2];
  int n_hits, base;
};

// One hit of a ragged tile into the tile's gather (a shared-memory atomic);
// past kJoinHits straight into the packed stream with its own atomic.
__device__ __forceinline__ void gather_hit(JoinTile& sm, int row, int word,
                                           int32_t* __restrict__ out,
                                           int cap) {
  int slot = atomicAdd(&sm.n_hits, 1);
  if (slot < kJoinHits) {
    sm.hit_row[slot] = row;
    sm.hit_word[slot] = word;
    return;
  }
  slot = atomicAdd(out, 1);
  if (slot < cap) {
    out[1 + slot] = row;
    out[(cap + 1) + 1 + slot] = word;
  }
}

// The row of one thread of a ragged tile: search the row's first aligned
// position in the table slice tv[0, tn_) (staged in shared memory, or the
// same slice in global memory), then walk the entries up to its last
// aligned position.  An entry's position p maps to a query offset through
// a cursor over the row's n_ops ops (op c starts at reference position r
// and query offset q): the cursor passes every op that ends at or before p,
// ops of no reference length (I, S, H, P) included, and stops at the op
// under p.  Entries ascend, so the cursor only moves forward: a row's ops
// are read once however many entries it has, and an affine row (clips
// around one aligned run) maps each entry with one subtraction.  An entry
// under a D or N op, or whose query offset lies past the row's bases (a
// CIGAR longer than the sequence, or a sequence of `*`), emits nothing.
// Hits go to the tile's gather, so no lane waits on a device atomic.
template <bool kGlobal>
__device__ __forceinline__ void ragged_row(
    int row, int first, int last, const uint32_t* ops, int n_ops,
    long long r, const uint8_t* __restrict__ seq,
    const uint8_t* __restrict__ qual, int n_bases, int baseq, OpClasses cls,
    const int32_t* tv, const int32_t* t0, const int32_t* t1,
    const int32_t* tni, int tn_, int tbase, JoinTile& sm,
    int32_t* __restrict__ out, int cap) {
  const int k_first = lower_bound<kGlobal>(tv, tn_, first);
  int prev = 0, c = 0;
  long long q = 0;
  for (int k = k_first; k < tn_; ++k) {
    int p = tload<kGlobal>(tv + k);
    if (p > last) break;
    // of entries at one position only the first is a hit (the lower bound
    // of a per-base search)
    bool is_first = k == k_first || p != prev;
    prev = p;
    if (!is_first) continue;
    unsigned op = 0;
    while (c < n_ops) {
      uint32_t w = ops[c];
      op = w & 0xF;
      long long len = w >> 4;
      long long ref_len = in_class(cls.ref, op) ? len : 0;
      if (p < r + ref_len) break;  // the op under p
      r += ref_len;
      if (in_class(cls.query, op)) q += len;
      ++c;
    }
    if (c >= n_ops || !in_class(cls.aligned, op)) continue;
    long long at = q + (p - r);
    if (at >= n_bases) continue;
    int code = __ldg(qual + at) >= baseq ? (__ldg(seq + at) & 0xF) : 15;
    if (code == 15) continue;
    gather_hit(sm, row, hit_word<kGlobal>(code, k, t0, t1, tni, tbase), out,
               cap);
  }
}

// Replaces the dispatcher's packed routes of phaser_tpu (the Pallas body at
// alleles.py:673 through _nibble_windowed_impl :975, _delta_windowed_impl
// :424 and _plane_windowed_impl :1038, with the host packers that build
// their padded planes): one range join over the reads as BAM decode stores
// them.  Row r is read r of the launch: its 0-based `pos`, its ops
// cigar[cig_off[r], cig_off[r + 1]) (uint32, length << 4 | op) and its
// bases seq / qual[seq_off[r], seq_off[r + 1]) (1 B each, the nibble code
// and the phred score); masked = qual >= baseq ? code : 15.
//
// Bound: what the data needs is the row's pos and two offsets (12 B), its
// ops (4 B each), the table entries between the rows' lowest and highest
// aligned position (16 B each), one 32-byte sector of seq and one of qual
// per entry under an aligned base, and 8 B per hit written: bytes, a
// sixth of the card time of the earlier one-row-a-thread kernel (the
// ablation's `earlier` variant), whose chain of dependent latencies
// (offsets, then ops, the block's range, the slice search, the slice copy,
// the row's search, the walk, the bases, a device atomic a warp and hit)
// ran in 1.3 waves.  The padded planes of the TPU's routes (1-4 B per base
// and row, built on the host) never exist: the bases reach the card as
// decoded, and the kernel reads them only under a table entry.  What the
// design does about the chain: a block takes a tile of 256 consecutive
// rows; every load of the tile's offsets is issued at once, and the tile's
// ops arrive in one coalesced run (stage_run), from which each row reduces
// its aligned range [first, last] and later walks its cursor, so no row
// reads its ops from device memory twice (a row past the stage reads them
// there); the slice bounds come from the skeleton in shared memory and two
// levels of warp search (tile_slice), and the slice is staged when it fits
// kJoinStage entries (four columns, 8 KB; searched in device memory
// otherwise); hits gather in shared memory and take one device atomic a
// tile.  At 32 registers a thread and 22 KB a block the card holds 8
// blocks an SM (its thread limit), 1,056 of them: the 1,024 tiles of a
// 262,144-read launch run in one wave.
__global__ void __launch_bounds__(kThreads, kJoinBlocksPerSm)
ragged_join_kernel(const int32_t* __restrict__ pos,
                   const int32_t* __restrict__ cig_off,
                   const uint32_t* __restrict__ cigar,
                   const int32_t* __restrict__ seq_off,
                   const uint8_t* __restrict__ seq,
                   const uint8_t* __restrict__ qual, int n_rows, int baseq,
                   OpClasses cls, const int32_t* __restrict__ vpos,
                   const int32_t* __restrict__ a0,
                   const int32_t* __restrict__ a1,
                   const int32_t* __restrict__ ni, int mp, int seg, int n_sk,
                   int32_t* __restrict__ out, int cap) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  JoinTile& sm = *reinterpret_cast<JoinTile*>(tile_smem);
  stage_skeleton(sm.sk, vpos, n_sk, seg);
  const int r0 = blockIdx.x * kThreads, row = r0 + threadIdx.x;
  const int r1 = n_rows - r0 < kThreads ? n_rows : r0 + kThreads;
  // every load of the tile's offsets at once: the ends of its op run (the
  // same two words for every thread) and the row's own
  const int c_lo = __ldg(cig_off + r0), c_hi = __ldg(cig_off + r1);
  int c0 = 0, c1 = 0, s0 = 0, n_bases = 0;
  long long r_start = 0;  // the 1-based reference position of op 0
  if (row < n_rows) {
    c0 = __ldg(cig_off + row);
    c1 = __ldg(cig_off + row + 1);
    s0 = __ldg(seq_off + row);
    n_bases = __ldg(seq_off + row + 1) - s0;
    r_start = (long long)__ldg(pos + row) + 1;
  }
  if (threadIdx.x == 0) sm.n_hits = 0;
  int n_staged;
  const int shift = stage_run(sm.ops, sizeof(sm.ops), cigar + c_lo,
                              c_hi - c_lo, &n_staged, threadIdx.x, kThreads);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const uint32_t* ops = row_ops(sm.ops + shift, n_staged, cigar, c_lo, c0, c1);
  const int n_ops = c1 - c0;
  // the row's aligned range: the first base of its first aligned op to the
  // last base of its last one
  long long r = r_start, lo = LLONG_MAX, hi = LLONG_MIN;
  for (int c = 0; c < n_ops; ++c) {
    uint32_t w = ops[c];
    unsigned op = w & 0xF;
    long long len = w >> 4;
    if (in_class(cls.aligned, op) && len > 0) {
      lo = lo < r ? lo : r;
      hi = r + len - 1;
    }
    if (in_class(cls.ref, op)) r += len;
  }
  // table positions lie in [1, INT32_MAX - 1]: INT32_MAX pads the table
  lo = lo > 1 ? lo : 1;
  hi = hi < 0x7ffffffe ? hi : 0x7ffffffe;
  const bool live = row < n_rows && lo <= hi;
  const int first = live ? (int)lo : 0x7fffffff;
  const int last = live ? (int)hi : (int)0x80000000;
  int k_lo, n_slice;
  bool staged;
  const int32_t* const cols[4] = {vpos, a0, a1, ni};
  int32_t* const stage[4] = {sm.sv, sm.s0, sm.s1, sm.sn};
  if (!tile_slice(sm.red, first, last, cols, stage, kJoinStage, mp, sm.sk,
                  n_sk, seg, &k_lo, &n_slice, &staged))
    return;
  if (live && staged) {
    ragged_row<false>(row, first, last, ops, n_ops, r_start, seq + s0,
                      qual + s0, n_bases, baseq, cls, sm.sv, sm.s0, sm.s1,
                      sm.sn, n_slice, k_lo, sm, out, cap);
  } else if (live) {
    ragged_row<true>(row, first, last, ops, n_ops, r_start, seq + s0,
                     qual + s0, n_bases, baseq, cls, vpos + k_lo, a0 + k_lo,
                     a1 + k_lo, ni + k_lo, n_slice, k_lo, sm, out, cap);
  }
  // the tile's gathered hits: one device atomic for their slots, then
  // coalesced stores (slots >= cap are counted, not written)
  __syncthreads();
  const int n_hits = sm.n_hits < kJoinHits ? sm.n_hits : kJoinHits;
  if (threadIdx.x == 0) sm.base = n_hits > 0 ? atomicAdd(out, n_hits) : 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n_hits; i += kThreads) {
    int slot = sm.base + i;
    if (slot < cap) {
      out[1 + slot] = sm.hit_row[i];
      out[(cap + 1) + 1 + slot] = sm.hit_word[i];
    }
  }
}

// Shared memory of a read_spans block (dynamic): the block's position
// skeleton (2 KB).
struct SpanTile {
  int32_t sk[kSliceSkel];
};

// The allele dispatcher's span pass on the card (no TPU kernel: phaser_tpu's
// dispatcher, like mapper/dispatch.py _read_spans, runs it on the host).
// Per read one flag byte: bit 0 the read holds an op of ins_ops (I), bit 1
// one of skip_ops (N), bit 2 `near`: a position of the padded, sorted table
// vpos[0, mp) lies in [pos + 1, pos + total], total the sum of ALL the
// read's op lengths (an end that can only be too large, so a read that is
// not near has no aligned base on a table position).
//
// Bound: bytes, 4 B of pos, 8 B of offsets and 4 B per op read, 1 B
// written, per read; the table entries under the reads once.  What the
// design does about it: a streaming pass of warps that never wait on each
// other, so that one warp's chain of latencies overlaps the others' loads.
// A warp takes a tile of 128 consecutive reads, four consecutive reads a
// lane: it loads their offsets and positions at once (coalesced), and each
// lane sums its reads' lengths and gathers their op sets from the tile's
// one contiguous op run, the warp's lanes on neighbouring words of it (a
// copy of the run into shared memory first made the pass a third slower on
// the H100: step_kernels_ablation's `ragged` section, variant `ops`); the
// warp's range [mn, mx] takes one skeleton bound (skel_bound: shared
// memory and two levels of the table in device memory), and the 32
// positions from there arrive in one coalesced load, a lane each, which
// every lane tests against its reads by shuffles: the table is staged in
// registers, its positions alone.  A warp whose tile holds 32 entries or
// more (a dense table) finds the slice's end and searches it in device
// memory instead.  The grid holds a block for every eight tiles, a warp a
// tile.
__global__ void __launch_bounds__(kThreads, kSpanBlocksPerSm)
read_spans_kernel(const int32_t* __restrict__ pos,
                  const int64_t* __restrict__ cig_off,
                  const uint32_t* __restrict__ cigar, int n, unsigned ins_ops,
                  unsigned skip_ops, const int32_t* __restrict__ vpos, int mp,
                  int seg, int n_sk, uint8_t* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  SpanTile& sm = *reinterpret_cast<SpanTile*>(tile_smem);
  stage_skeleton(sm.sk, vpos, n_sk, seg);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (int)(((long long)n + kSpanTile - 1) / kSpanTile);
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= n_tiles) return;  // no block barrier follows
  const int mine = tile * kSpanTile + kSpanRowsPerLane * lane;  // lane's 1st
  // every load at once: the lane's reads' offsets and positions
  long long off[kSpanRowsPerLane + 1];
  int p[kSpanRowsPerLane];
#pragma unroll
  for (int j = 0; j <= kSpanRowsPerLane; ++j)
    off[j] = mine + j <= n ? __ldg(cig_off + mine + j) : 0;
#pragma unroll
  for (int j = 0; j < kSpanRowsPerLane; ++j)
    p[j] = mine + j < n ? __ldg(pos + mine + j) : 0;
  // the first op of each of the lane's reads at once (most reads have one
  // op: one latency for the four), the rest in each read's walk
  uint32_t op0[kSpanRowsPerLane];
#pragma unroll
  for (int j = 0; j < kSpanRowsPerLane; ++j)
    op0[j] = mine + j < n && off[j + 1] > off[j] ? __ldg(cigar + off[j]) : 0;
  int first[kSpanRowsPerLane], last[kSpanRowsPerLane];
  unsigned f = 0;  // a byte of flags a read
  int mn = 0x7fffffff, mx = (int)0x80000000;
#pragma unroll
  for (int j = 0; j < kSpanRowsPerLane; ++j) {
    first[j] = 0x7fffffff;
    last[j] = (int)0x80000000;
    if (mine + j >= n) continue;
    const long long n_ops = off[j + 1] - off[j];
    long long total = op0[j] >> 4;
    unsigned seen = n_ops > 0 ? 1u << (op0[j] & 0xF) : 0u;
    for (long long c = 1; c < n_ops; ++c) {
      uint32_t w = __ldg(cigar + off[j] + c);
      total += w >> 4;
      seen |= 1u << (w & 0xF);
    }
    f |= (((seen & ins_ops) ? 1u : 0u) | ((seen & skip_ops) ? 2u : 0u))
         << (8 * j);
    long long lo = (long long)p[j] + 1, hi = lo - 1 + total;
    // table positions lie in [1, INT32_MAX - 1]: INT32_MAX pads the table
    lo = lo > 1 ? lo : 1;
    hi = hi < 0x7ffffffe ? hi : 0x7ffffffe;
    if (lo <= hi) {
      first[j] = (int)lo;
      last[j] = (int)hi;
      mn = first[j] < mn ? first[j] : mn;
      mx = last[j] > mx ? last[j] : mx;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    int omn = __shfl_xor_sync(kFull, mn, d);
    int omx = __shfl_xor_sync(kFull, mx, d);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
  if (mn <= mx) {  // a live read in the tile
    const int k0 = skel_bound<false>(vpos, mp, sm.sk, n_sk, seg, mn);
    // the positions from k0, one a lane (INT32_MAX past the table)
    const int e = k0 + lane < mp ? __ldg(vpos + k0 + lane) : 0x7fffffff;
    const int under = __popc(__ballot_sync(kFull, e <= mx));
    if (under < kSpanStage) {
      for (int s = 0; s < under; ++s) {
        int v = __shfl_sync(kFull, e, s);
#pragma unroll
        for (int j = 0; j < kSpanRowsPerLane; ++j)
          if (v >= first[j] && v <= last[j]) f |= 4u << (8 * j);
      }
    } else {
      // a dense table: the slice [k0, k1) in device memory
      const int k1 = skel_bound<true>(vpos, mp, sm.sk, n_sk, seg, mx);
#pragma unroll
      for (int j = 0; j < kSpanRowsPerLane; ++j) {
        if (first[j] > last[j]) continue;
        int k = k0 + lower_bound<true>(vpos + k0, k1 - k0, first[j]);
        if (k < k1 && __ldg(vpos + k) <= last[j]) f |= 4u << (8 * j);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSpanRowsPerLane; ++j)
    if (mine + j < n) flags[mine + j] = (uint8_t)(f >> (8 * j));
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

// One live row of the delta join, by one warp: each lane rebuilds four
// positions at a time from 8 bytes of the delta row (128 bases a step) and
// matches them against the row's table range tv[k0, k1): every entry of a
// range of at most 32 is broadcast to the lanes, a longer range is searched
// per base.  The nibble is read only where a position matched, and decides:
// a soft-clipped or low-quality base (nibble 15) emits nothing, whatever its
// position equals.  All 32 lanes must call.
template <bool kGlobal>
__device__ __forceinline__ void delta_row(
    const uint8_t* __restrict__ nrow, const int16_t* __restrict__ drow,
    int row, int s, int l, const int32_t* tv, const int32_t* t0,
    const int32_t* t1, const int32_t* tni, int k0, int k1, int tbase,
    int32_t* __restrict__ out, int cap) {
  int lane = threadIdx.x & 31;
  int quads = l >> 2;  // l is a multiple of 4
  int n_range = k1 - k0;
  const int2* d2 = reinterpret_cast<const int2*>(drow);
  for (int qb = 0; qb < quads; qb += 32) {
    int q = qb + lane;
    int e[4] = {0, 0, 0, 0};
    if (q < quads) {
      int2 v = __ldg(d2 + q);  // delta[4q .. 4q + 3], little-endian int16
      int p = s + 4 * q;
      e[0] = p + (int)(int16_t)v.x;
      e[1] = p + 1 + (v.x >> 16);
      e[2] = p + 2 + (int)(int16_t)v.y;
      e[3] = p + 3 + (v.y >> 16);
    }
    int kk[4] = {-1, -1, -1, -1};
    if (n_range <= 32) {
      for (int j = 0; j < n_range; ++j) {
        int p = tload<kGlobal>(tv + k0 + j);
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
          int k = k0 + lower_bound<kGlobal>(tv + k0, n_range, e[t]);
          if (k < k1 && tload<kGlobal>(tv + k) == e[t]) kk[t] = k;
        }
      }
    }
    int word[4] = {-1, -1, -1, -1};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (kk[t] >= 0 && e[t] > 0) {
        int nib = NibbleRow{nrow}.code(4 * q + t);
        if (nib != 15)
          word[t] = hit_word<kGlobal>(nib, kk[t], t0, t1, tni, tbase);
      }
    }
    emit4(row, word, out, cap);
  }
}

// The live rows of one delta block (rows with a table entry in their range),
// compacted so that the block's warps share them evenly.
struct LiveRows {
  int n;
  int row[kThreads], start[kThreads], k0[kThreads], k1[kThreads];
};

// One delta block on the table slice tv[0, tn_): each thread finds its row's
// table range, rows with an entry join the live list, then each warp takes
// live rows in turn.  lr.n is 0 on entry (set before a block barrier).
template <bool kGlobal>
__device__ __forceinline__ void delta_rows(
    LiveRows& lr, const uint8_t* __restrict__ ncodes,
    const int32_t* __restrict__ start, const int16_t* __restrict__ delta,
    int lh, bool live, int pmin, int pmax, const int32_t* tv,
    const int32_t* t0, const int32_t* t1, const int32_t* tni, int tn_,
    int tbase, int32_t* __restrict__ out, int cap) {
  if (live) {
    int k0 = lower_bound<kGlobal>(tv, tn_, pmin);
    // most rows end here: the first entry at or after rp_min lies past rp_max
    if (k0 < tn_ && tload<kGlobal>(tv + k0) <= pmax) {
      int row = blockIdx.x * kThreads + threadIdx.x;
      int s = __ldg(start + row);  // all live rows' loads in flight at once
      int k1 = k0 + 1 +
               lower_bound<kGlobal, true>(tv + k0 + 1, tn_ - k0 - 1, pmax);
      int at = atomicAdd(&lr.n, 1);
      lr.row[at] = row;
      lr.start[at] = s;
      lr.k0[at] = k0;
      lr.k1[at] = k1;
    }
  }
  __syncthreads();
  int n_live = lr.n;
  for (int w = threadIdx.x >> 5; w < n_live; w += kThreads / 32) {
    int row = lr.row[w];
    delta_row<kGlobal>(ncodes + (size_t)row * lh,
                       delta + (size_t)row * (2 * lh), row, lr.start[w],
                       2 * lh, tv, t0, t1, tni, lr.k0[w], lr.k1[w], tbase, out,
                       cap);
  }
}

// Replaces alleles.py:424 (_delta_windowed_impl over the Pallas body at
// :673, with its host planner plan_windows_minmax) as a range join.  delta
// is the (n_rows, 2 * lh) int16 plane, refpos = start + i + delta[i] where
// the nibble is not 15; rp_min / rp_max are the packer's per-row bounds of
// the aligned positions (rp_max <= 0: no aligned base).
//
// Bound: a search per base read both planes whole (2.5 B per base) and made
// 8-17 dependent L2 loads for every unmasked base.  What the data needs is
// the 8 B of [rp_min, rp_max] per row, the table entries under the rows,
// `start` and the 2 B per base of delta only for rows with an entry in
// [rp_min, rp_max] (about one in twenty), one sector of the nibble plane
// per matched base and 8 B per hit.  What the design does about it: a
// block takes 256 consecutive rows, one row per thread, and stages the table slice under them in shared
// memory (block_slice, as the affine kernels); each thread finds its row's
// [k0, k1) there and a row with no entry ends, having read 8 B.  The live
// rows are compacted into a shared list and each WARP takes one at a time
// (delta_row): 8-byte coalesced loads of the delta row, the range's entries
// broadcast from shared memory.  Thread-per-row for the search and
// warp-per-row for the match keeps both halves busy: a warp per row for
// all 262,144 rows would spend its time on the 95% of rows that end after
// the search, a thread per live row would read its delta row uncoalesced.
// Matching is per base, never per entry: a clipped base (delta 0, nibble
// 15) can sit at the position of an aligned base of the same row, so each
// base looks up its own entry and is dropped by its own nibble.
__global__ void __launch_bounds__(kThreads)
delta_nibble_kernel(const uint8_t* __restrict__ ncodes,
                    const int32_t* __restrict__ start,
                    const int16_t* __restrict__ delta,
                    const int32_t* __restrict__ rp_min,
                    const int32_t* __restrict__ rp_max, int n_rows, int lh,
                    const int32_t* __restrict__ vpos,
                    const int32_t* __restrict__ a0,
                    const int32_t* __restrict__ a1,
                    const int32_t* __restrict__ ni, int mp,
                    int32_t* __restrict__ out, int cap) {
  __shared__ __align__(16) BlockTable bt;
  __shared__ LiveRows lr;

  int row = blockIdx.x * kThreads + threadIdx.x;
  if (threadIdx.x == 0) lr.n = 0;  // block_slice's first barrier orders this
  bool live = false;
  int pmin = 0, pmax = 0;
  if (row < n_rows) {
    pmin = __ldg(rp_min + row);
    pmax = __ldg(rp_max + row);
    if (pmin < 1) pmin = 1;  // refpos <= 0 never hits
    live = pmax >= pmin;
  }
  int k_lo, n_slice;
  bool staged;
  if (!block_slice(bt, live ? pmin : 0x7fffffff,
                   live ? pmax : (int)0x80000000, vpos, a0, a1, ni, mp, &k_lo,
                   &n_slice, &staged))
    return;
  if (staged) {
    delta_rows<false>(lr, ncodes, start, delta, lh, live, pmin, pmax, bt.sv,
                      bt.s0, bt.s1, bt.sn, n_slice, k_lo, out, cap);
  } else {
    delta_rows<true>(lr, ncodes, start, delta, lh, live, pmin, pmax, vpos, a0,
                     a1, ni, mp, 0, out, cap);
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
// rows and 8 B per hit written.  What the design does about it: 16-byte
// coalesced loads, one dependent global load per row for the search where a binary search per
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
          if (masked != 15)
            word[t] = hit_word<true>(masked, kk[t], a0, a1, ni, 0);
        }
      }
      emit4(row, word, out, cap);
    }
  }
}

// ---------------------------------------------------------------------------
// Unfused planes kernels: (n_rows, l) int32 vidx / allele planes
// ---------------------------------------------------------------------------

constexpr int kWin = 256;     // table window entries per row block
constexpr int kQuads = 4;     // runs of 4 consecutive bases per thread
constexpr int kOwn = 4 * kQuads;       // bases a thread owns in a tile
constexpr int kTile = 32 * kOwn;       // consecutive bases a warp takes
constexpr int kIntMax = 0x7fffffff;

// How a warp takes a tile of 512 consecutive bases of a plane (planes are
// row-major, so a block's rows are one run of bases): lane k owns the four
// bases from 4 k of each 128-base quarter, so every warp-wide load or
// store is one contiguous 512-byte run of 16-byte vectors.  (A thread that
// owns 16 consecutive bases instead, 64 bytes apart from its neighbour's,
// fills only half of each 32-byte sector an instruction touches: measured
// at twice the time for the same bytes.)  `first` is the thread's first
// base (tile + 4 * lane), `end` the end of the block's bases.  kVec: the
// plane is 16-byte aligned and its width a multiple of 4, so every run of 4
// is whole and aligned; else each base is loaded on its own.  Bases past
// `end` read as 0, which never hits.
template <bool kVec>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ p,
                                          int first, int end,
                                          int (&rp)[kOwn]) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    int i = first + 128 * q;
    if constexpr (kVec) {
      int4 v = make_int4(0, 0, 0, 0);
      if (i < end) v = __ldg(reinterpret_cast<const int4*>(p + i));
      rp[4 * q] = v.x;
      rp[4 * q + 1] = v.y;
      rp[4 * q + 2] = v.z;
      rp[4 * q + 3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        rp[4 * q + t] = i + t < end ? __ldg(p + i + t) : 0;
    }
  }
}

// The thread's bases of a tile of an output plane, streaming
// (st.global.cs): the planes are not read again by the kernel, so they
// should not displace the table in L2.
template <bool kVec>
__device__ __forceinline__ void store_tile(int32_t* __restrict__ p, int first,
                                           int end, const int (&v)[kOwn]) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    int i = first + 128 * q;
    if constexpr (kVec) {
      if (i < end)
        __stcs(reinterpret_cast<int4*>(p + i),
               make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (i + t < end) __stcs(p + i + t, v[4 * q + t]);
    }
  }
}

// The base of the plane under the thread's j-th position of the tile whose
// first base for this thread is `first`.
__device__ __forceinline__ int base_of(int first, int j) {
  return first + 128 * (j >> 2) + (j & 3);
}

// Stages table entries [w0, w0 + n_slots) in shared memory (n_slots a
// multiple of 4): 16-byte cp.async where the four entries lie inside the
// table and the source is 16-byte aligned, else entry by entry with
// INT32_MAX positions and zero codes past the table's end.  The caller
// commits, waits (__pipeline_wait_prior) and synchronises the block.
__device__ __forceinline__ void stage_window(
    int32_t* sv, int32_t* s0, int32_t* s1, int32_t* sn, int n_slots,
    const int32_t* __restrict__ vpos, const int32_t* __restrict__ a0,
    const int32_t* __restrict__ a1, const int32_t* __restrict__ ni, int w0,
    int mp) {
  bool vec = (w0 & 3) == 0 &&
             ((reinterpret_cast<uintptr_t>(vpos) |
               reinterpret_cast<uintptr_t>(a0) |
               reinterpret_cast<uintptr_t>(a1) |
               reinterpret_cast<uintptr_t>(ni)) & 15) == 0;
  for (int c = threadIdx.x; c < (n_slots >> 2); c += blockDim.x) {
    int g = w0 + 4 * c;
    if (vec && g + 4 <= mp) {
      __pipeline_memcpy_async(sv + 4 * c, vpos + g, 16);
      __pipeline_memcpy_async(s0 + 4 * c, a0 + g, 16);
      __pipeline_memcpy_async(s1 + 4 * c, a1 + g, 16);
      __pipeline_memcpy_async(sn + 4 * c, ni + g, 16);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        bool in = g + t < mp;
        sv[4 * c + t] = in ? __ldg(vpos + g + t) : kIntMax;
        s0[4 * c + t] = in ? __ldg(a0 + g + t) : 0;
        s1[4 * c + t] = in ? __ldg(a1 + g + t) : 0;
        sn[4 * c + t] = in ? __ldg(ni + g + t) : 0;
      }
    }
  }
  __pipeline_commit();
}

// The rows [*row0, *row_end) of this CUDA block: row block b = blockIdx.x /
// ctas_per_block, and inside it the part-th run of rows_per_cta rows.
__device__ __forceinline__ int cta_rows(int n_rows, int block_rows,
                                        int rows_per_cta, int ctas_per_block,
                                        int* row0, int* row_end) {
  int b = blockIdx.x / ctas_per_block;
  int first = (blockIdx.x - b * ctas_per_block) * rows_per_cta;
  int here = block_rows - first;
  here = here < rows_per_cta ? here : rows_per_cta;
  *row0 = b * block_rows + first;
  int end = *row0 + (here > 0 ? here : 0);
  *row_end = end < n_rows ? end : n_rows;
  return b;
}

// Allele class of observed code `masked` on table entry k.
template <bool kGlobal>
__device__ __forceinline__ int allele_of(int masked, int k, const int32_t* t0,
                                         const int32_t* t1,
                                         const int32_t* tni) {
  int n_ind = tload<kGlobal>(tni + k);
  if (masked == tload<kGlobal>(t0 + k) && n_ind > 0) return 0;
  if (masked == tload<kGlobal>(t1 + k) && n_ind > 1) return 1;
  return 2;
}

enum PlanesMode { kWindowed = 0, kResident = 1, kWholeTable = 2 };

// The planes body.  kWindowed replaces _alleles_pallas_windowed_kernel as
// reached from assign_alleles_pallas_windowed (alleles.py:813): the row
// block's window [ws[b], ws[b] + win), win <= kWin, staged in shared memory.
// kResident replaces _alleles_pallas_kernel (:627, via
// assign_alleles_pallas): the whole table (mp <= L entries) staged in
// shared memory by every block.  kWholeTable is the jnp
// assign_alleles_device (:33) and the planners' fall-back: the table stays
// in global memory and the block keeps a skeleton of it (the last entry of
// each of at most kSkel segments) in shared memory, so a search costs
// log2(n_skel) shared loads and log2(seg) global ones.
//
// Bound: the planes (the refpos plane read, 4 B per base; codes and quals,
// 2 B per base, read only under a base that matched; 8 B per base
// written) whatever the data; the table sits in shared memory or L2.  What
// the design does about it: a warp takes 512 consecutive bases at a time
// and a thread 16 of them as four runs of 4 (load_tile), so positions
// arrive and results leave as 16-byte vectors in fully coalesced warp
// accesses (streaming stores), and the thread searches ONCE for all 16: a
// lower bound of their smallest positive position decides whether any
// table entry lies in [smallest positive, largest].  Few threads have one;
// all others store constant -1 / 3 vectors without having touched codes,
// quals or the allele columns.  A thread with an entry matches each of its
// bases inside the entry range [k0, k1) (the first of equal entries wins,
// as a lower bound does).  Positions need not ascend or lie in one row: the
// range is the min and max over the 16.  The window arrives by cp.async
// while the thread's first positions are in flight, and the next tile's
// positions are loaded before this tile's results are stored.
template <int kMode, bool kVec>
__device__ __forceinline__ void planes_body(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ quals,
    const int32_t* __restrict__ refpos, int n_rows, int l, int baseq,
    const int32_t* __restrict__ ws, int win, int block_rows,
    const int32_t* __restrict__ vpos, const int32_t* __restrict__ a0,
    const int32_t* __restrict__ a1, const int32_t* __restrict__ ni, int mp,
    int rows_per_cta, int ctas_per_block, int seg, int n_skel,
    int32_t* __restrict__ vidx_out, int32_t* __restrict__ allele_out) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr bool kStaged = kMode != kWholeTable;

  int row0, row_end;
  int b = cta_rows(n_rows, block_rows, rows_per_cta, ctas_per_block, &row0,
                   &row_end);
  if (row0 >= row_end) return;  // uniform over the block

  // the table as this block searches it: tv[0, wn), entry k has table
  // index tbase + k
  int tbase = 0, wn = mp;
  const int32_t *tv = vpos, *t0 = a0, *t1 = a1, *tn = ni;
  if constexpr (kStaged) {
    if constexpr (kMode == kWindowed) {
      tbase = __ldg(ws + b);
      int rest = mp - tbase;
      wn = win < rest ? win : rest;
      wn = wn > 0 ? wn : 0;
    }
    int n_slots = (wn + 3) & ~3;
    int32_t* sv = smem;
    stage_window(sv, sv + n_slots, sv + 2 * n_slots, sv + 3 * n_slots,
                 n_slots, vpos, a0, a1, ni, tbase, mp);
    tv = sv;
    t0 = sv + n_slots;
    t1 = sv + 2 * n_slots;
    tn = sv + 3 * n_slots;
  } else {
    for (int j = threadIdx.x; j < n_skel; j += kThreads) {
      int e = (j + 1) * seg;
      smem[j] = __ldg(vpos + (e < mp ? e : mp) - 1);
    }
  }

  // the block's rows are the bases [first, end) of the planes; a warp
  // takes every (kThreads / 32)-th tile of them
  int end = row_end * l;
  int first = row0 * l + (threadIdx.x >> 5) * kTile + 4 * (threadIdx.x & 31);
  int rp[kOwn];
  // the first positions fly while the table arrives
  if (first < end) load_tile<kVec>(refpos, first, end, rp);
  if constexpr (kStaged) __pipeline_wait_prior(0);
  __syncthreads();

  while (first < end) {
    int mn = kIntMax, mx = 0;
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      if (rp[j] > 0) {
        mn = rp[j] < mn ? rp[j] : mn;
        mx = rp[j] > mx ? rp[j] : mx;
      }
    }
    int vi[kOwn], al[kOwn];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      vi[j] = -1;
      al[j] = 3;
    }
    if (mx > 0) {
      // first entry at or after the thread's smallest position
      int k0;
      if constexpr (kStaged) {
        k0 = lower_bound<false>(tv, wn, mn);
      } else {
        int s = lower_bound<false>(smem, n_skel, mn);
        k0 = mp;
        if (s < n_skel) {
          int lo = s * seg;
          int len = mp - lo < seg ? mp - lo : seg;
          k0 = lo + lower_bound<true>(vpos + lo, len, mn);
        }
      }
      // most threads end here: that entry lies past their largest position
      if (k0 < wn && tload<!kStaged>(tv + k0) <= mx) {
        int k1 = k0 + 1 +
                 lower_bound<!kStaged, true>(tv + k0 + 1, wn - k0 - 1, mx);
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          if (rp[j] <= 0) continue;
          int k = k0 + lower_bound<!kStaged>(tv + k0, k1 - k0, rp[j]);
          if (k >= k1 || tload<!kStaged>(tv + k) != rp[j]) continue;
          int at = base_of(first, j);
          int masked = __ldg(quals + at) >= baseq ? __ldg(codes + at) : 15;
          if (masked == 15) continue;
          vi[j] = tbase + k;
          al[j] = allele_of<!kStaged>(masked, k, t0, t1, tn);
        }
      }
    }
    int here = first;
    first += (kThreads / 32) * kTile;
    // the next positions fly while this tile stores
    if (first < end) load_tile<kVec>(refpos, first, end, rp);
    store_tile<kVec>(vidx_out, here, end, vi);
    store_tile<kVec>(allele_out, here, end, al);
  }
}

#define PLANES_PARAMS                                                        \
  const uint8_t *__restrict__ codes, const uint8_t *__restrict__ quals,      \
      const int32_t *__restrict__ refpos, int n_rows, int l, int baseq,      \
      const int32_t *__restrict__ ws, int win, int block_rows,               \
      const int32_t *__restrict__ vpos, const int32_t *__restrict__ a0,      \
      const int32_t *__restrict__ a1, const int32_t *__restrict__ ni,        \
      int mp, int rows_per_cta, int ctas_per_block, int seg, int n_skel,     \
      int32_t *__restrict__ vidx_out, int32_t *__restrict__ allele_out
#define PLANES_ARGS                                                          \
  codes, quals, refpos, n_rows, l, baseq, ws, win, block_rows, vpos, a0, a1, \
      ni, mp, rows_per_cta, ctas_per_block, seg, n_skel, vidx_out, allele_out

// One __global__ function per mode, so that a profile names the mode.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
planes_windowed_kernel(PLANES_PARAMS) {
  planes_body<kWindowed, kVec>(PLANES_ARGS);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
planes_resident_kernel(PLANES_PARAMS) {
  planes_body<kResident, kVec>(PLANES_ARGS);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
planes_table_kernel(PLANES_PARAMS) {
  planes_body<kWholeTable, kVec>(PLANES_ARGS);
}

// Replaces _alleles_pallas_cmp_kernel (alleles.py:757): the gather-free
// windowed body.  Every base is compared with all 256 entries of its row
// block's window (INT32_MAX past the table's end), no search, and the last
// match wins, which equals the lower bound on unique positions.  Kept as
// the TPU's recorded alternative to the search; it never replaces it.
//
// Bound: operations, 256 compare-selects per base.  With one 4-byte
// broadcast shared-memory load per compare the kernel was bound by
// shared-memory issue (one load, one compare, one select: three issue
// slots a compare).  What the design does about it: register blocking.  A
// thread keeps its 16 positions of a tile in registers and walks the
// window with 16-byte shared loads, so one load feeds 64 tests and the
// inner loop is integer arithmetic alone.  Integer compares issue at half
// rate on Hopper, on one pipe (ALU); integer multiply-adds issue on the
// other (FMA).  So the window is staged a second time as pairs (e0 + e1,
// e0 e1), and a position r is tested against both entries of a pair by one
// multiply-add and one compare, (e0 - r)(e1 - r) == 0 modulo 2^32: both
// pipes work, one issue slot an entry.  The tests of 8 entries fold into
// one predicate and one select; which entry it was is found again, exactly,
// only under a base that matched (a product that vanishes modulo 2^32 with
// neither factor zero only costs that rescan).  Positions arrive and
// results leave as 16-byte vectors (streaming stores), the window by
// cp.async, and codes, quals and the allele columns are read only for a
// base that matched.
constexpr int kGroup = 8;  // window entries folded into one predicate
static_assert(kGroup == 8, "pass 1 of planes_cmp_kernel is written out for 8");

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
planes_cmp_kernel(const uint8_t* __restrict__ codes,
                  const uint8_t* __restrict__ quals,
                  const int32_t* __restrict__ refpos, int n_rows, int l,
                  int baseq, const int32_t* __restrict__ ws, int block_rows,
                  const int32_t* __restrict__ vpos,
                  const int32_t* __restrict__ a0,
                  const int32_t* __restrict__ a1,
                  const int32_t* __restrict__ ni, int mp, int rows_per_cta,
                  int ctas_per_block, int32_t* __restrict__ vidx_out,
                  int32_t* __restrict__ allele_out) {
  __shared__ __align__(16) int32_t sv[kWin], s0[kWin], s1[kWin], sn[kWin];
  __shared__ __align__(16) uint2 pairs[kWin / 2];
  int row0, row_end;
  int b = cta_rows(n_rows, block_rows, rows_per_cta, ctas_per_block, &row0,
                   &row_end);
  if (row0 >= row_end) return;  // uniform over the block
  int w0 = __ldg(ws + b);
  stage_window(sv, s0, s1, sn, kWin, vpos, a0, a1, ni, w0, mp);

  int end = row_end * l;
  int first = row0 * l + (threadIdx.x >> 5) * kTile + 4 * (threadIdx.x & 31);
  int rp[kOwn];
  if (first < end) load_tile<kVec>(refpos, first, end, rp);
  __pipeline_wait_prior(0);
  __syncthreads();
  // entries in pairs: (e0 - r)(e1 - r) = e0 e1 - r (e0 + e1) + r^2, so with
  // the pair's sum and product staged, one multiply-add and one compare
  // test a position against two entries (all arithmetic modulo 2^32)
  for (int i = threadIdx.x; i < kWin / 2; i += kThreads) {
    unsigned e0 = (unsigned)sv[2 * i], e1 = (unsigned)sv[2 * i + 1];
    pairs[i] = make_uint2(e0 + e1, e0 * e1);
  }
  __syncthreads();

  const uint4* pairs4 = reinterpret_cast<const uint4*>(pairs);
  while (first < end) {
    // pass 1: the last group of kGroup window entries that may hold each
    // position.  The tests of a group fold into one predicate.
    unsigned nr[kOwn], nq[kOwn];
    int grp[kOwn];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      nr[j] = 0u - (unsigned)rp[j];
      nq[j] = 0u - (unsigned)rp[j] * (unsigned)rp[j];
      grp[j] = -1;
    }
    // (written out for a group of 8: folded in a loop over a group's loads
    // the same arithmetic compiled to a schedule 10-40% slower)
#pragma unroll 4
    for (int g = 0; g < kWin / kGroup; ++g) {
      uint4 p = pairs4[2 * g];  // two broadcast loads, 64 tests of 2 entries
      uint4 q = pairs4[2 * g + 1];
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        bool any = (nr[j] * p.x + p.y == nq[j]) | (nr[j] * p.z + p.w == nq[j]) |
                   (nr[j] * q.x + q.y == nq[j]) | (nr[j] * q.z + q.w == nq[j]);
        grp[j] = any ? g : grp[j];
      }
    }
    // pass 2, only under a base whose position may have matched: the last
    // equal entry at or before the end of that group, exactly (a product
    // of two differences can vanish modulo 2^32 with neither zero: then the
    // scan goes on to earlier entries), its code and the allele columns
    int vi[kOwn], al[kOwn];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      vi[j] = -1;
      al[j] = 3;
      if (rp[j] > 0 && grp[j] >= 0) {
        int hit = kGroup * grp[j] + kGroup - 1;
        while (hit >= 0 && sv[hit] != rp[j]) --hit;
        if (hit < 0) continue;
        int at = base_of(first, j);
        int masked = __ldg(quals + at) >= baseq ? __ldg(codes + at) : 15;
        if (masked != 15) {
          vi[j] = w0 + hit;
          al[j] = allele_of<false>(masked, hit, s0, s1, sn);
        }
      }
    }
    int here = first;
    first += (kThreads / 32) * kTile;
    if (first < end) load_tile<kVec>(refpos, first, end, rp);
    store_tile<kVec>(vidx_out, here, end, vi);
    store_tile<kVec>(allele_out, here, end, al);
  }
}

// How the planes kernels cut the rows into CUDA blocks: a block works
// inside one row block (it stages that block's window) and takes about
// `target` bases, a tile or two a warp, so that the card holds many blocks
// and the staging stays small beside the planes.
struct CtaShape {
  int rows_per_cta, ctas_per_block;
  unsigned grid;
};

inline CtaShape cta_shape(int n_rows, int l, int block_rows, int target) {
  CtaShape s;
  s.rows_per_cta = target / l;
  if (s.rows_per_cta < 1) s.rows_per_cta = 1;
  if (s.rows_per_cta > block_rows) s.rows_per_cta = block_rows;
  s.ctas_per_block = (block_rows + s.rows_per_cta - 1) / s.rows_per_cta;
  long long row_blocks = ((long long)n_rows + block_rows - 1) / block_rows;
  s.grid = (unsigned)(row_blocks * s.ctas_per_block);
  return s;
}

constexpr int kCtaBases = (kThreads / 32) * kTile;  // one tile a warp

// The vector path: a width that is a multiple of 4 and 16-byte aligned
// int32 planes, so every run of 4 bases from a block's first is an aligned
// int4 (a block starts at a row).
inline bool planes_vec(int l, const void* refpos, const void* vidx,
                       const void* allele) {
  return l % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(refpos) |
           reinterpret_cast<uintptr_t>(vidx) |
           reinterpret_cast<uintptr_t>(allele)) & 15) == 0;
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

// The tile kernels' residency on the current device: the blocks of one
// (which) that an SM holds at once, and the SMs.
constexpr int kJoinShape = 0, kSpanShape = 1;

inline cudaError_t tile_residency(int which, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  return which == kJoinShape
             ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   per_sm, ragged_join_kernel, kThreads, sizeof(JoinTile))
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   per_sm, read_spans_kernel, kThreads, sizeof(SpanTile));
}

// The skeleton's stride for a table of mp entries: a power of two from 1,024
// that leaves at most kSliceSkel skeleton entries.
inline int slice_seg(int mp) {
  int seg = 1024;
  while ((long long)seg * kSliceSkel < mp) seg <<= 1;
  return seg;
}

// The grid of a tile kernel over n rows: a block a join tile, a block for
// every kThreads / 32 span tiles (a warp a tile).  A grid of one wave whose
// blocks walk the tiles measured slower past one wave (the ablation's
// `grid` variant).
inline unsigned tile_grid(int which, int n) {
  long long rows = which == kJoinShape ? kThreads
                                       : (long long)kSpanTile * (kThreads / 32);
  return (unsigned)(((long long)n + rows - 1) / rows);
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
                        const void* delta, const void* rp_min,
                        const void* rp_max, int n_rows, int lh,
                        const void* vpos, const void* a0, const void* a1,
                        const void* ni, int mp, void* out, int cap,
                        void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    // one row per thread for the range search
    delta_nibble_kernel<<<grid_for(n_rows), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)ncodes, (const int32_t*)start, (const int16_t*)delta,
        (const int32_t*)rp_min, (const int32_t*)rp_max, n_rows, lh,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)out, cap);
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
                         const void* hi, int n_rows, int l, const void* vpos,
                         const void* a0, const void* a1, const void* ni,
                         int mp, void* out, int cap, void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    // one row per thread
    affine_masked_kernel<<<grid_for(n_rows), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)mcodes, (const int32_t*)start, (const int32_t*)lo,
        (const int32_t*)hi, n_rows, l, (const int32_t*)vpos,
        (const int32_t*)a0, (const int32_t*)a1, (const int32_t*)ni, mp,
        (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

int affine_planes_launch(const void* codes, const void* quals,
                         const void* start, const void* lo, const void* hi,
                         int n_rows, int l, int baseq, const void* vpos,
                         const void* a0, const void* a1, const void* ni,
                         int mp, void* out, int cap, void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    // one row per thread
    affine_planes_kernel<<<grid_for(n_rows), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)start,
        (const int32_t*)lo, (const int32_t*)hi, n_rows, l, baseq,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

int ragged_join_launch(const void* pos, const void* cig_off, const void* cigar,
                       const void* seq_off, const void* seq, const void* qual,
                       int n_rows, int baseq, int aligned_ops, int ref_ops,
                       int query_ops, const void* vpos, const void* a0,
                       const void* a1, const void* ni, int mp, void* out,
                       int cap, void* stream) {
  cudaError_t init = init_packed(out, cap, (cudaStream_t)stream);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    // a block a 256-read tile
    unsigned grid = tile_grid(kJoinShape, n_rows);
    OpClasses cls{(unsigned)aligned_ops, (unsigned)ref_ops,
                  (unsigned)query_ops};
    int seg = slice_seg(mp);
    ragged_join_kernel<<<grid, kThreads, sizeof(JoinTile),
                         (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int32_t*)cig_off, (const uint32_t*)cigar,
        (const int32_t*)seq_off, (const uint8_t*)seq, (const uint8_t*)qual,
        n_rows, baseq, cls, (const int32_t*)vpos, (const int32_t*)a0,
        (const int32_t*)a1, (const int32_t*)ni, mp, seg, (mp + seg - 1) / seg,
        (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

int read_spans_launch(const void* pos, const void* cig_off, const void* cigar,
                      int n, int ins_ops, int skip_ops, const void* vpos,
                      int mp, void* flags, void* stream) {
  if (n > 0) {
    // a block for every eight 128-read tiles, a warp a tile
    unsigned grid = tile_grid(kSpanShape, n);
    int seg = slice_seg(mp);
    read_spans_kernel<<<grid, kThreads, sizeof(SpanTile),
                        (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const int64_t*)cig_off, (const uint32_t*)cigar,
        n, (unsigned)ins_ops, (unsigned)skip_ops, (const int32_t*)vpos, mp,
        seg, (mp + seg - 1) / seg, (uint8_t*)flags);
  }
  return (int)cudaGetLastError();
}

// The tile shape of the ragged join (which 0) or the span pass (which 1)
// on the current device, for the smoke's record: out[0] blocks resident on
// an SM, out[1] SMs, out[2] rows a tile, out[3] CIGAR words a tile stages,
// out[4] table entries a tile stages, out[5] shared memory bytes a block,
// out[6] tiles a block works on at once (one; the span pass one a warp).
int tile_shape(int which, int* out) {
  if (which != kJoinShape && which != kSpanShape)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = tile_residency(which, &out[0], &out[1]);
  if (e != cudaSuccess) return (int)e;
  bool join = which == kJoinShape;
  out[2] = join ? kThreads : kSpanTile;
  out[3] = join ? kJoinOps : 0;
  out[4] = join ? kJoinStage : kSpanStage;
  out[5] = (int)(join ? sizeof(JoinTile) : sizeof(SpanTile));
  out[6] = join ? 1 : kThreads / 32;
  return 0;
}

// resident != 0 stages the whole table (win must be mp) in shared memory;
// else a window of at most kWin entries is staged per row block, and a wider
// one (the whole-table call: ws = {0}, win = mp) is searched in global
// memory.  block_rows >= 1.
int planes_launch(const void* codes, const void* quals, const void* refpos,
                  int n_rows, int l, int baseq, const void* ws, int win,
                  int block_rows, const void* vpos, const void* a0,
                  const void* a1, const void* ni, int mp, int resident,
                  void* vidx, void* allele, void* stream) {
  if ((long long)n_rows * l == 0) return (int)cudaGetLastError();
  // a window wider than kWin is the whole table or nothing this kernel has
  if (block_rows < 1 || (!resident && win > kWin && win < mp) ||
      (resident && win != mp))
    return (int)cudaErrorInvalidValue;
  bool vec = planes_vec(l, refpos, vidx, allele);
  int seg = 0, n_skel = 0;
  size_t smem;
  int target = kCtaBases;
  void (*kernel)(PLANES_PARAMS);
  if (resident) {
    smem = (size_t)4 * ((mp + 3) & ~3) * sizeof(int32_t);
    // a block stages the whole table (16 B an entry): give it planes to
    // match
    if (4 * mp > target) target = 4 * mp;
    kernel = vec ? planes_resident_kernel<true> : planes_resident_kernel<false>;
  } else if (win <= kWin) {
    smem = (size_t)4 * kWin * sizeof(int32_t);
    kernel = vec ? planes_windowed_kernel<true> : planes_windowed_kernel<false>;
  } else {
    seg = 128;
    while ((long long)seg * kSkel < mp) seg <<= 1;
    n_skel = (mp + seg - 1) / seg;
    smem = (size_t)n_skel * sizeof(int32_t);
    kernel = vec ? planes_table_kernel<true> : planes_table_kernel<false>;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  CtaShape s = cta_shape(n_rows, l, block_rows, target);
  kernel<<<s.grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)refpos,
      n_rows, l, baseq, (const int32_t*)ws, win, block_rows,
      (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
      (const int32_t*)ni, mp, s.rows_per_cta, s.ctas_per_block, seg, n_skel,
      (int32_t*)vidx, (int32_t*)allele);
  return (int)cudaGetLastError();
}

int planes_cmp_launch(const void* codes, const void* quals, const void* refpos,
                      int n_rows, int l, int baseq, const void* ws,
                      int block_rows, const void* vpos, const void* a0,
                      const void* a1, const void* ni, int mp, void* vidx,
                      void* allele, void* stream) {
  if ((long long)n_rows * l == 0) return (int)cudaGetLastError();
  if (block_rows < 1) return (int)cudaErrorInvalidValue;
  bool vec = planes_vec(l, refpos, vidx, allele);
  CtaShape s = cta_shape(n_rows, l, block_rows, kCtaBases);
  auto kernel = vec ? planes_cmp_kernel<true> : planes_cmp_kernel<false>;
  kernel<<<s.grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)refpos,
      n_rows, l, baseq, (const int32_t*)ws, block_rows, (const int32_t*)vpos,
      (const int32_t*)a0, (const int32_t*)a1, (const int32_t*)ni, mp,
      s.rows_per_cta, s.ctas_per_block, (int32_t*)vidx, (int32_t*)allele);
  return (int)cudaGetLastError();
}

}  // extern "C"
