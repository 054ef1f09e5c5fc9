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
// 262,144 rows of 128 bases, which no device holds.  Here a warp owns a row
// at a time: its lanes read the row's two planes once (coalesced), compact
// the row's hits into the warp's slice of shared memory with one ballot per
// 32 bases, add the allele counts, then walk the hits' ordered pairs
// (q = i * h + j over the lanes) in shared memory and add the pairs that
// fall in the band.  The pair grid is never written.  Both outputs are
// int32 and every add is an integer atomicAdd, so the sums are exact and do
// not depend on the order the adds land in: the result is deterministic and
// equals its plain version with tolerance 0.  The launcher zeroes both
// outputs on the kernel's stream.
//
// Bound.  The planes are read once (8 B a base); the outputs are written
// once (12 B a variant and 36 B a variant and band step).  Hits are rare at
// the real density (about 1 base in 10), so the atomics are few beside the
// plane bytes: the kernel is bound by bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void band_counts_kernel(const int32_t* __restrict__ vidx,
                                   const int32_t* __restrict__ allele,
                                   int n_rows, int l, int m, int band,
                                   int32_t* __restrict__ counts,
                                   int32_t* __restrict__ pair) {
  extern __shared__ int2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int2* hits = smem + (size_t)warp * l;
  for (int row = blockIdx.x * warps + warp; row < n_rows;
       row += gridDim.x * warps) {
    const int32_t* vr = vidx + (size_t)row * l;
    const int32_t* ar = allele + (size_t)row * l;
    int nh = 0;  // the same in every lane
    for (int base = 0; base < l; base += 32) {
      int i = base + lane;
      int v = -1, a = 3;
      if (i < l) {
        v = vr[i];
        a = ar[i];
      }
      bool hit = a >= 0 && a < 3 && v >= 0 && v < m;
      unsigned ballot = __ballot_sync(kFull, hit);
      if (hit) {
        hits[nh + __popc(ballot & ((1u << lane) - 1u))] = make_int2(v, a);
        atomicAdd(counts + (size_t)v * 3 + a, 1);
      }
      nh += __popc(ballot);
    }
    __syncwarp();
    if (band > 0) {
      const int n_pairs = nh * nh;
      for (int q = lane; q < n_pairs; q += 32) {
        int i = q / nh;
        int2 hi = hits[i], hj = hits[q - i * nh];
        int d = hj.x - hi.x;
        if (d >= 1 && d <= band) {
          atomicAdd(pair + ((size_t)hi.x * band + (d - 1)) * 9 + hi.y * 3 +
                        hj.y,
                    1);
        }
      }
    }
    __syncwarp();  // the next row overwrites this warp's hits
  }
}

}  // namespace

extern "C" {

// Rows per block in flight: 8 warps, fewer where a warp's L hits (8 B
// each) would take the block past 48 KB of shared memory.  0 when one warp
// cannot hold a row (L > 6144).
int band_counts_warps(int l) {
  int w = l > 0 ? (48 * 1024) / (8 * l) : kMaxWarps;
  return w > kMaxWarps ? kMaxWarps : w;
}

// Zeroes counts (m, 3) and pair (m, band, 9), then enqueues the kernel on
// `stream`; returns cudaGetLastError() (0 on success).
int band_counts_launch(const void* vidx, const void* allele, int n_rows,
                       int l, int m, int band, void* counts, void* pair,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)m * 3 * sizeof(int32_t),
                                  s);
  if (e != cudaSuccess) return (int)e;
  if (band > 0) {
    e = cudaMemsetAsync(pair, 0, (size_t)m * band * 9 * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  if ((long long)n_rows * l == 0 || m == 0) return (int)cudaGetLastError();
  int warps = band_counts_warps(l);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  int threads = warps * 32;
  long long blocks = (n_rows + warps - 1) / warps;
  // a few waves of 132 SMs; the warps stride over the remaining rows
  if (blocks > 132 * 16) blocks = 132 * 16;
  band_counts_kernel<<<(int)blocks, threads,
                       (size_t)warps * l * sizeof(int2), s>>>(
      (const int32_t*)vidx, (const int32_t*)allele, n_rows, l, m, band,
      (int32_t*)counts, (int32_t*)pair);
  return (int)cudaGetLastError();
}

}  // extern "C"
