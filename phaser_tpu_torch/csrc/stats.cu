// The connection test's statistics for Hopper (sm_90a), in float64.
//
//   binom_cdf_kernel      replaces the jnp program binom_cdf
//                         (phaser_tpu/kernels/stats.py:32-43): elementwise
//                         P(X <= k), X ~ Binomial(n, p), as the regularized
//                         incomplete beta I_{1-p}(n - k, k + 1).
//   conflict_prune_kernel replaces conflicting_config_p and prune_mask
//                         (stats.py:46-72), fused: from the int32 cis, trans
//                         and other counts of a pair and the noise rate (read
//                         from device memory, so the host never syncs) it
//                         writes p (float64), prune = p < threshold and
//                         uncertain = |p - threshold| < band in one pass.
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

__global__ void conflict_prune_kernel(
    const int32_t* __restrict__ cfg_a, const int32_t* __restrict__ cfg_b,
    const int32_t* __restrict__ other, const double* __restrict__ noise_e,
    double threshold, double refine_band, int count, double* __restrict__ p,
    uint8_t* __restrict__ prune, uint8_t* __restrict__ uncertain) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  double e = *noise_e;
  double p_success = 1.0 - (6.0 * e + 10.0 * (e * e));
  int32_t ca = cfg_a[i], cb = cfg_b[i];
  double sup = (double)(ca > cb ? ca : cb);
  double total = (double)ca + (double)cb + (double)other[i];
  double pv;
  if (sup == 0.0) {
    pv = 0.0;
  } else if (!(total - sup > 0.0)) {
    pv = 1.0;
  } else {
    pv = binom_cdf_d(sup, total, p_success);
  }
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
    conflict_prune_kernel<<<grid_for(count), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const int32_t*)cfg_a, (const int32_t*)cfg_b, (const int32_t*)other,
        (const double*)noise_e, threshold, refine_band, count, (double*)p,
        (uint8_t*)prune, (uint8_t*)uncertain);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
