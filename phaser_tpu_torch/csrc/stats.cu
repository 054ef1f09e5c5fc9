// The connection test's statistics for Hopper (sm_90a), in float64.
//
//   binom_cdf_kernel      replaces the jnp program binom_cdf
//                         (phaser_tpu/kernels/stats.py:32-43): elementwise
//                         P(X <= k), X ~ Binomial(n, p), as the regularized
//                         incomplete beta I_{1-p}(n - k, k + 1).
//   conflict_test_kernel  replaces conflicting_config_p and prune_mask
//                         (stats.py:46-72), fused: from a pair's int32 cis,
//                         trans and other counts and the noise rate (read
//                         from device memory, so the host never syncs) it
//                         writes p (float64), prune = p < threshold and
//                         uncertain = |p - threshold| < band in one pass.
//                         One body, templated on where the counts come from:
//                         three (count,) arrays (prune_mask), or the merged
//                         (M, band, 9) band itself (band_prune, which also
//                         replaces band_configs, phaser_tpu/dist/mesh.py:
//                         111-114), and on where the noise rate comes from.
//   noise_partials_kernel with the test, the sharded step's whole
//                         connection-test tail (band_prune) in two launches:
//                         the int64 sums of noise_from_counts (stats.py:
//                         75-86) a block, which the test's blocks add up and
//                         divide in float64 in the plain version's order.
//                         The sums are of integers, so they are exact in any
//                         order and the noise rate equals the plain
//                         version's to the bit.  (The tail took about twenty
//                         launches as band_configs' adds, noise_from_counts'
//                         float64 ops and the test; one cooperative launch
//                         with a grid-wide sync between the two phases is
//                         the other design, timed beside this one by
//                         testing/step_kernels_ablation.py.)
//
// The JAX package computes in float32 (a max abs error of 6.9e-5 against
// scipy for n < 200); these kernels compute in float64 and are held against
// scipy.stats.binom.cdf at 1e-10.  The edge rules are the JAX ones: k >= n
// gives 1, k < 0 gives 0, a = max(n - k, 1e-30); in the conflict test
// total - supporting == 0 gives p = 1 and supporting == 0 gives p = 0.
//
// The incomplete beta is the continued fraction evaluated by the modified
// Lentz method (Numerical Recipes' betacf), with the symmetry switch
// I_x(a, b) = 1 - I_{1-x}(b, a) at x > (a + 1) / (a + b + 2), where the
// fraction converges in O(sqrt(max(a, b))) terms; the prefactor
// x^a (1-x)^b / (a B(a, b)) comes from lgamma.  The plain PyTorch version
// (kernels/stats.py) runs the same recurrence with the same constants.
//
// Bound.  One thread per element.  The loop length depends on the data (no
// iteration at all for the pairs that the edge rules decide), so a warp
// runs as long as its slowest lane; at the connection test's sizes
// (n < 100, x near 0.02) a fraction takes a handful of terms.  Each term is
// about 30 float64 operations with two divisions; the inputs are 12-24 B
// and the outputs 8-10 B an element.  The bound is the larger of those bytes
// over the memory rate and the iterations actually taken over the float64
// rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIter = 1000;      // stats.py BETACF_MAX_ITER
constexpr double kEps = 1e-15;      // stats.py BETACF_EPS
constexpr double kTiny = 1e-300;    // stats.py BETACF_TINY

__device__ __forceinline__ double not_tiny(double v) {
  return fabs(v) < kTiny ? kTiny : v;
}

// The continued fraction of I_x(a, b), x below the switch point.
__device__ double betacf(double a, double b, double x) {
  double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0;
  double d = 1.0 / not_tiny(1.0 - qab * x / qap);
  double h = d;
  for (int m = 1; m <= kMaxIter; ++m) {
    double m2 = 2.0 * m;
    double aa = m * (b - m) * x / ((qam + m2) * (a + m2));
    d = 1.0 / not_tiny(1.0 + aa * d);
    c = not_tiny(1.0 + aa / c);
    h *= d * c;
    aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2));
    d = 1.0 / not_tiny(1.0 + aa * d);
    c = not_tiny(1.0 + aa / c);
    double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < kEps) break;
  }
  return h;
}

// The regularized incomplete beta I_x(a, b), a, b > 0.
__device__ double betainc_reg(double a, double b, double x) {
  if (x <= 0.0) return 0.0;
  if (x >= 1.0) return 1.0;
  // each product and sum rounded on its own (no fused multiply-add), in
  // the plain version's order: the terms reach 1e5 at n = 10,000, where one
  // contraction would move the result by 1e-11
  double s = __dsub_rn(__dsub_rn(lgamma(a + b), lgamma(a)), lgamma(b));
  s = __dadd_rn(s, __dmul_rn(a, log(x)));
  s = __dadd_rn(s, __dmul_rn(b, log1p(-x)));
  double front = exp(s);
  if (x < (a + 1.0) / (a + b + 2.0)) return front * betacf(a, b, x) / a;
  return 1.0 - front * betacf(b, a, 1.0 - x) / b;
}

__device__ double binom_cdf_d(double k, double n, double p) {
  double kk = floor(k);
  if (kk >= n) return 1.0;
  if (kk < 0.0) return 0.0;
  double x = fmin(fmax(1.0 - p, 0.0), 1.0);
  return betainc_reg(fmax(n - kk, 1e-30), kk + 1.0, x);
}

__global__ void binom_cdf_kernel(const double* __restrict__ k,
                                 const double* __restrict__ n,
                                 const double* __restrict__ p, int count,
                                 double* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  out[i] = binom_cdf_d(k[i], n[i], p[i]);
}

// The noise rate's two sums (kernels/stats.py noise_from_counts): over the
// variants under 5% mismatch, matches = c0 + c1 and mismatches = c2.  Each
// block writes its int64 partial sums; integer sums are exact in any order.
// The test is taken in float64 exactly as the plain version takes it.
__global__ void noise_partials_kernel(const int32_t* __restrict__ counts,
                                      int m,
                                      long long* __restrict__ partials) {
  __shared__ long long s_sum[2][kThreads / 32];
  long long bm = 0, bmm = 0;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < m;
       v += gridDim.x * blockDim.x) {
    const int32_t c0 = counts[3 * v], c1 = counts[3 * v + 1],
                  c2 = counts[3 * v + 2];
    const double matches = (double)c0 + (double)c1, mis = (double)c2;
    const double tot = fmax(matches + mis, 1.0);
    if (matches > 0.0 && mis / tot < 0.05) {
      bm += (long long)c0 + c1;
      bmm += c2;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    bm += __shfl_down_sync(0xffffffffu, bm, o);
    bmm += __shfl_down_sync(0xffffffffu, bmm, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[0][warp] = bm;
    s_sum[1][warp] = bmm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      bm += s_sum[0][w];
      bmm += s_sum[1][w];
    }
    partials[2 * blockIdx.x] = bm;
    partials[2 * blockIdx.x + 1] = bmm;
  }
}

// The noise rate as a float64 already on the card (prune_mask's argument).
struct NoiseValue {
  const double* e;
  __device__ double get(int) const { return *e; }
};

// The noise rate from noise_partials_kernel's partial sums, in
// noise_from_counts' order: bmm / max((bm + bmm) * 2, 1), the sums exact
// (integers below 2^53), so the result is the plain version's to the bit.
// Called by the 32 lanes of one warp.
struct NoisePartials {
  const long long* partials;
  int n;
  __device__ double get(int lane) const {
    long long bm = 0, bmm = 0;
    for (int b = lane; b < n; b += 32) {
      bm += partials[2 * b];
      bmm += partials[2 * b + 1];
    }
    for (int o = 16; o > 0; o >>= 1) {
      bm += __shfl_xor_sync(0xffffffffu, bm, o);
      bmm += __shfl_xor_sync(0xffffffffu, bmm, o);
    }
    const double dm = (double)bm, dmm = (double)bmm;
    return dmm / fmax((dm + dmm) * 2.0, 1.0);
  }
};

// A pair's cis, trans and other counts from three (count,) int32 arrays
// (prune_mask's layout).
struct ThreeArrays {
  static constexpr bool kBand = false;
  const int32_t* a;
  const int32_t* b;
  const int32_t* o;
};

// ... or from the merged (M, band, 9) int32 band: cis = configurations
// 0 + 4, trans = 1 + 3, other the remaining five, in int32 as band_configs
// forms them.
struct Band9 {
  static constexpr bool kBand = true;
  const int32_t* pair;
};

// The connection test of one pair from its three counts (stats.py:50-56
// and the reference's test_variant_connection), with its edge rules.
__device__ __forceinline__ double conflict_p(int32_t ca, int32_t cb,
                                             int32_t co, double p_success) {
  double sup = (double)(ca > cb ? ca : cb);
  double total = (double)ca + (double)cb + (double)co;
  if (sup == 0.0) return 0.0;
  if (!(total - sup > 0.0)) return 1.0;
  return binom_cdf_d(sup, total, p_success);
}

// One thread a pair: p, prune = p < threshold and uncertain = |p -
// threshold| < refine_band.  The noise rate comes first, from one warp of
// each block.  On the band, a block stages its pairs' 9 words (one
// contiguous run) in shared memory with coalesced loads; a thread then
// reads its 9 words there (a stride of 9 words: no bank conflict).
template <class In, class Noise>
__global__ void conflict_test_kernel(In in, Noise noise, double threshold,
                                     double refine_band, int count,
                                     double* __restrict__ p,
                                     uint8_t* __restrict__ prune,
                                     uint8_t* __restrict__ uncertain) {
  __shared__ double s_e;
  __shared__ int32_t s_words[In::kBand ? kThreads * 9 : 1];
  const int i0 = blockIdx.x * blockDim.x;
  const int i = i0 + threadIdx.x;
  if (threadIdx.x < 32) {
    double e = noise.get(threadIdx.x);
    if (threadIdx.x == 0) s_e = e;
  }
  int32_t ca = 0, cb = 0, co = 0;
  if constexpr (In::kBand) {
    const long long w0 = (long long)i0 * 9;
    const int n_words = (int)min((long long)blockDim.x * 9,
                                 (long long)count * 9 - w0);
    for (int k = threadIdx.x; k < n_words; k += blockDim.x)
      s_words[k] = in.pair[w0 + k];
    __syncthreads();
    if (i < count) {
      const int32_t* w = s_words + threadIdx.x * 9;
      ca = w[0] + w[4];
      cb = w[1] + w[3];
      co = w[2] + w[5] + w[6] + w[7] + w[8];
    }
  } else {
    __syncthreads();
    if (i < count) {
      ca = in.a[i];
      cb = in.b[i];
      co = in.o[i];
    }
  }
  if (i >= count) return;
  const double e = s_e;
  const double p_success = 1.0 - (6.0 * e + 10.0 * (e * e));
  const double pv = conflict_p(ca, cb, co, p_success);
  p[i] = pv;
  prune[i] = pv < threshold;
  uncertain[i] = fabs(pv - threshold) < refine_band;
}

int grid_for(int count) { return (count + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers.

int binom_cdf_launch(const void* k, const void* n, const void* p, int count,
                     void* out, void* stream) {
  if (count > 0) {
    binom_cdf_kernel<<<grid_for(count), kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)k, (const double*)n, (const double*)p, count,
        (double*)out);
  }
  return (int)cudaGetLastError();
}

int conflict_prune_launch(const void* cfg_a, const void* cfg_b,
                          const void* other, const void* noise_e,
                          double threshold, double refine_band, int count,
                          void* p, void* prune, void* uncertain,
                          void* stream) {
  if (count > 0) {
    conflict_test_kernel<<<grid_for(count), kThreads, 0,
                           (cudaStream_t)stream>>>(
        ThreeArrays{(const int32_t*)cfg_a, (const int32_t*)cfg_b,
                    (const int32_t*)other},
        NoiseValue{(const double*)noise_e}, threshold, refine_band, count,
        (double*)p, (uint8_t*)prune, (uint8_t*)uncertain);
  }
  return (int)cudaGetLastError();
}

// The connection-test tail of the sharded step in two launches: the noise
// rate's partial sums over counts (m, 3), then the test of every (v, d) of
// pair (m, band, 9).  `partials` holds 2 * max_partials int64; returns the
// launches enqueued in *launches.
int band_prune_launch(const void* counts, const void* pair, int m, int band,
                      double threshold, double refine_band, void* partials,
                      int max_partials, void* p, void* prune,
                      void* uncertain, int* launches, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *launches = 0;
  const long long count = (long long)m * band;
  if (count == 0) return (int)cudaGetLastError();
  // a few variants a thread, at most max_partials blocks
  int nb = (int)((m + kThreads * 4 - 1) / (kThreads * 4));
  if (nb > max_partials) nb = max_partials;
  noise_partials_kernel<<<nb, kThreads, 0, s>>>(
      (const int32_t*)counts, m, (long long*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launches = 1;
  conflict_test_kernel<<<grid_for((int)count), kThreads, 0, s>>>(
      Band9{(const int32_t*)pair},
      NoisePartials{(const long long*)partials, nb}, threshold, refine_band,
      (int)count, (double*)p, (uint8_t*)prune, (uint8_t*)uncertain);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launches = 2;
  return (int)e;
}

}  // extern "C"
