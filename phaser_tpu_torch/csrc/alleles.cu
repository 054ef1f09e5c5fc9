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
// Table search.  Row r belongs to row block b = r / block_rows; the block
// searches table entries [ws[b], min(ws[b] + win, mp)).  The host planners
// pick ws so that every position the block can hit lies in that range; the
// unplanned case passes ws = {0} and win = mp (the whole table).  The table
// stays in global memory (L2-resident: 4 x 4 B x 128k entries = 2 MB) except
// in the planes kernel's resident mode.
//
// Packed output (fused entries): one int32 (2, cap + 1) buffer, pre-filled
// with -1 and with out[0] = 0 (the hit counter).  A hit takes a slot with one
// warp-aggregated atomicAdd on out[0]; row 0 gets the read index within the
// launch, row 1 gets (var << 8) | (masked << 4) | allele.  Slots >= cap are
// counted but not written, so the final out[0] is the exact hit count and
// overflow is visible to the caller.  Hit order is arbitrary (the caller
// lexsorts).
//
// Bound: each kernel reads its plane bytes once (0.5, 1, 2.5 or 6 B per
// base), and per aligned unmasked base makes a dependent chain of
// ~log2(win) L2 loads for the binary search.  Masked (15) and unaligned bases
// skip the search.
//
// Index arithmetic is int32 inside a row plane: the wrappers assert
// n_rows * L < 2^31.

#include <cstdint>
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

int affine_masked_launch(const void* mcodes, const void* start, const void* lo,
                         const void* hi, int n_rows, int l, const void* ws,
                         int win, int block_rows, const void* vpos,
                         const void* a0, const void* a1, const void* ni,
                         int mp, void* out, int cap, void* stream) {
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
