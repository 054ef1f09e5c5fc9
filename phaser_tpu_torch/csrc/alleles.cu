// Allele-assignment kernels for Hopper (sm_90a): per-base hit
// classification against the sorted variant table, fused with the nibble
// unpack / refpos reconstruction of each read format and with the packed-hit
// stream compaction.
//
// One classifier (classify) serves all three entry points; they differ only
// in how a base's (masked code, 1-based reference position) is rebuilt:
//
//   affine_nibble  replaces phaser_tpu/kernels/alleles.py:975
//                  (_nibble_windowed_impl -> _alleles_pallas_windowed_kernel,
//                  alleles.py:673): refpos = start + (i - lo) on [lo, hi).
//   delta_nibble   replaces alleles.py:424 (_delta_windowed_impl):
//                  refpos = start + i + delta[i] where the nibble != 15.
//   plane          replaces alleles.py:1038 (_plane_windowed_impl):
//                  explicit int32 refpos plane, masked = qual >= baseq ? code : 15.
//
// Table search.  Row r belongs to row block b = r / block_rows; the block
// searches table entries [ws[b], min(ws[b] + win, mp)).  The host planners
// pick ws so that every position the block can hit lies in that range; the
// unplanned case passes ws = {0} and win = mp (the whole table).  The table
// stays in global memory (L2-resident: 4 x 4 B x 128k entries = 2 MB).
//
// Output: one int32 (2, cap + 1) buffer, pre-filled with -1 and with
// out[0] = 0 (the hit counter).  A hit takes a slot with one warp-aggregated
// atomicAdd on out[0]; row 0 gets the read index within the launch, row 1
// gets (var << 8) | (masked << 4) | allele.  Slots >= cap are counted but not
// written, so the final out[0] is the exact hit count and overflow is visible
// to the caller.  Hit order is arbitrary (the caller lexsorts).
//
// Bound: each kernel reads its plane bytes once (0.5, 2.5 or 6 B per base),
// and per aligned unmasked base makes a dependent chain of ~log2(win) L2 loads
// for the binary search.  Masked (15) and unaligned bases skip the search.
//
// Index arithmetic is int32: the wrappers assert n_rows * L < 2^31 (a launch
// holds at most 262144 rows).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Lower bound of refpos in vpos[w0, w0 + wn); returns the hit word, or -1.
__device__ __forceinline__ int classify(int masked, int refpos,
                                        const int32_t* __restrict__ vpos,
                                        const int32_t* __restrict__ a0,
                                        const int32_t* __restrict__ a1,
                                        const int32_t* __restrict__ ni,
                                        int w0, int wn) {
  if (refpos <= 0 || masked == 15) return -1;
  int lo = w0;
  int n = wn;
  while (n > 0) {
    int half = n >> 1;
    int mid = lo + half;
    if (__ldg(vpos + mid) < refpos) {
      lo = mid + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  if (lo >= w0 + wn || __ldg(vpos + lo) != refpos) return -1;
  int allele;
  if (masked == __ldg(a0 + lo) && __ldg(ni + lo) > 0) {
    allele = 0;
  } else if (masked == __ldg(a1 + lo) && __ldg(ni + lo) > 1) {
    allele = 1;
  } else {
    allele = 2;
  }
  return (lo << 8) | (masked << 4) | allele;
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

// Replaces phaser_tpu/kernels/alleles.py:975 (_nibble_windowed_impl, the
// Pallas body at :673).  One thread per packed byte: two bases (even base in
// the low nibble).  Reads 1 B per 2 bases plus 12 B per row; the search's
// dependent L2 loads dominate.
__global__ void __launch_bounds__(kThreads)
affine_nibble_kernel(const uint8_t* __restrict__ ncodes,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ lo,
                     const int32_t* __restrict__ hi, int n_rows, int lh,
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
    int s = __ldg(start + row), l = __ldg(lo + row), h = __ldg(hi + row);
    int w0, wn;
    window(row, ws, win, block_rows, mp, &w0, &wn);
    int i = 2 * j;
    int rp0 = (i >= l && i < h) ? s + (i - l) : 0;
    int rp1 = (i + 1 >= l && i + 1 < h) ? s + (i + 1 - l) : 0;
    word0 = classify(byte & 0xF, rp0, vpos, a0, a1, ni, w0, wn);
    word1 = classify(byte >> 4, rp1, vpos, a0, a1, ni, w0, wn);
  }
  emit2(row, word0, word1, out, cap);
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

// Replaces alleles.py:1038 (_plane_windowed_impl).  One thread per base of
// the (n_rows, l) codes / quals / refpos planes: 6 B per base read, then the
// same dependent L2 loads.
__global__ void __launch_bounds__(kThreads)
plane_kernel(const uint8_t* __restrict__ codes,
             const uint8_t* __restrict__ quals,
             const int32_t* __restrict__ refpos, int n_rows, int l,
             int baseq, const int32_t* __restrict__ ws, int win,
             int block_rows, const int32_t* __restrict__ vpos,
             const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
             const int32_t* __restrict__ ni, int mp,
             int32_t* __restrict__ out, int cap) {
  int idx = blockIdx.x * kThreads + threadIdx.x;
  int row = idx / l;
  int word = -1;
  if (row < n_rows) {
    int masked = __ldg(quals + idx) >= baseq ? __ldg(codes + idx) : 15;
    int w0, wn;
    window(row, ws, win, block_rows, mp, &w0, &wn);
    word = classify(masked, __ldg(refpos + idx), vpos, a0, a1, ni, w0, wn);
  }
  emit2(row, word, -1, out, cap);
}

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers.

int affine_nibble_launch(const void* ncodes, const void* start, const void* lo,
                         const void* hi, int n_rows, int lh, const void* ws,
                         int win, int block_rows, const void* vpos,
                         const void* a0, const void* a1, const void* ni,
                         int mp, void* out, int cap, void* stream) {
  if (n_rows > 0) {
    affine_nibble_kernel<<<grid_for((long long)n_rows * lh), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)ncodes, (const int32_t*)start, (const int32_t*)lo,
        (const int32_t*)hi, n_rows, lh, (const int32_t*)ws, win, block_rows,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

int delta_nibble_launch(const void* ncodes, const void* start,
                        const void* delta, int n_rows, int lh, const void* ws,
                        int win, int block_rows, const void* vpos,
                        const void* a0, const void* a1, const void* ni, int mp,
                        void* out, int cap, void* stream) {
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
                 int n_rows, int l, int baseq, const void* ws, int win,
                 int block_rows, const void* vpos, const void* a0,
                 const void* a1, const void* ni, int mp, void* out, int cap,
                 void* stream) {
  if (n_rows > 0) {
    plane_kernel<<<grid_for((long long)n_rows * l), kThreads, 0,
                   (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)quals, (const int32_t*)refpos,
        n_rows, l, baseq, (const int32_t*)ws, win, block_rows,
        (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
        (const int32_t*)ni, mp, (int32_t*)out, cap);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
