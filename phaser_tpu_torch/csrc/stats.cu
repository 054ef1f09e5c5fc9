// The connection test's statistics for Hopper (sm_90a), in float64.
//
//   binom_cdf_kernel      replaces the jnp program binom_cdf
//                         (phaser_tpu/kernels/stats.py:32-43): elementwise
//                         P(X <= k), X ~ Binomial(n, p), as the regularized
//                         incomplete beta I_{1-p}(n - k, k + 1).  Templated
//                         on where its elements come from: k, n and p read
//                         where they lie (int32 or float64, contiguous,
//                         through their broadcast strides, one element on
//                         the card, or a value: nothing is copied or
//                         broadcast before the launch), or a pair's three
//                         int32 counts and the noise rate on the card, with
//                         the connection test's rules first
//                         (conflicting_config_p, stats.py:46-56: one launch,
//                         nothing formed before it and no pass after it).
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
//                         version's to the bit.
//   lgamma_table_kernel   makes the log-factorial table the prefactor reads
//                         equal to this file's lgamma, bit for bit (once a
//                         device; see below).
//
// The JAX package computes in float32 (a max abs error of 6.9e-5 against
// scipy for n < 200); these kernels compute in float64 and are held against
// scipy.stats.binom.cdf at 1e-10 and against the plain PyTorch version
// (kernels/stats.py: Lentz's method, torch.lgamma) at 1e-12.  The edge
// rules are the JAX ones: k >= n gives 1, k < 0 gives 0, a = max(n - k,
// 1e-30); in the conflict test total - supporting == 0 gives p = 1 and
// supporting == 0 gives p = 0.
//
// The incomplete beta: I_x(a, b) = x^a (1-x)^b / (a B(a, b)) times the
// continued fraction f = 1 / (1 + d_1 / (1 + d_2 / (1 + ...))) (Numerical
// Recipes' betacf), with the symmetry switch I_x(a, b) = 1 - I_{1-x}(b, a)
// at x > (a + 1) / (a + b + 2), where the fraction converges in
// O(sqrt(max(a, b))) terms.
//
// What bounds it on this card, and what the design does about it.  Each
// element is one dependent float64 chain, and a warp runs as long as its
// slowest live lane; at the connection test's sizes most elements are
// decided by the edge rules, so a launch lasts its launch plus its longest
// chain.  Lentz's method takes two dependent float64 divisions a half-step
// (d = 1 / (1 + aa d), c = 1 + aa / c), each a MUFU.RCP64H seed, Newton
// DFMAs and a branch to a slow path.  Here:
//   * the fraction by the three-term recurrence of its convergents f_j =
//     A_j / B_j: A_j = A_{j-1} + d_{j-1} A_{j-2}, B likewise, with every
//     level multiplied through by the coefficients' denominators (d_j =
//     N_j / D_j: A_j = D_{j-1} A_{j-1} + N_{j-1} D_{j-2} A_{j-2}), so the
//     loop holds no division at all and stays one basic block a term.
//     (A, B) are rescaled every term by the power of two of B's exponent,
//     exactly.  The stop test takes no division either: f_j - f_{j-1} =
//     D_j / (B_j B_{j-1}) with the determinant D_j = A_j B_{j-1} - A_{j-1}
//     B_j a running product (D_j = -c D_{j-1}, c the half-step's second
//     coefficient), so Lentz's |f_j / f_{j-1} - 1| < kEps is |D_j| <
//     kEps |B_j A_{j-1}|.  It is taken at half of kEps, so that the
//     product's rounding (about an ulp a term) never stops it before the
//     exact ratio is within kEps; where Lentz's rounded ratio lingers above
//     kEps past that point, this stops first, on the same converged value.
//     Lentz's kTiny guard is kept where a convergent's denominator can
//     vanish.  tests/test_torch_stats.py holds this arithmetic, emulated
//     in float64 torch, to the plain version's Lentz evaluation at 1e-12.
//   * one fraction a lane: (a, b, x) below the switch point, (b, a, 1 - x)
//     above it, through one call, so that a warp whose lanes lie on both
//     sides runs the loop once and not twice in turn.
//   * the prefactor lgamma(a+b) - lgamma(a) - lgamma(b) + a log x +
//     b log1p(-x): where a and b are integers (always, in the connection
//     test: a = n - k, b = k + 1) the three lgamma are read from a
//     log-factorial table (kernels/stats.py builds it once a device with
//     torch.lgamma and lgamma_table_kernel makes every entry this file's
//     lgamma) through the read-only path.  The sum is rounded term by term
//     (no fused multiply-add), in the plain version's order: the terms
//     reach 1e5 at n = 10,000, where one contraction would move p by 1e-11.
//   * the band's words are staged in 16-byte loads.
// testing/step_kernels_ablation.py holds the earlier design (Lentz's
// fraction, lgamma computed, two fraction calls, the band staged word by
// word) and two parts that were measured and lost (the block's live
// elements gathered into a shared-memory queue; the table's head staged in
// shared memory), and times them against this file (PERF.md §6).
//
// Bound.  The inputs are 4-8 B an operand and element (none for a value)
// and the outputs 8-10 B; the operations are the fraction terms these
// inputs take (kernels/stats.py BETACF_TERM_FLOPS a term, the function's
// count, not this body's) and a prefactor a live element.  The bound is
// the larger of those bytes over the memory rate and those operations over
// the float64 rate.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIter = 1000;      // stats.py BETACF_MAX_ITER
constexpr double kEps = 1e-15;      // stats.py BETACF_EPS
constexpr double kTiny = 1e-300;    // stats.py BETACF_TINY
constexpr double kStopEps = 0.5 * kEps;   // the recurrence's stop test
constexpr int kMaxDims = 6;         // kernels/stats.py _MAX_DIMS

// One half-step of the division-free recurrence: (A0, B0), (A1, B1) ->
// (A1, B1), (A2, B2) with A2 = c1 A1 + c2 A0 (c1 the half-step's
// denominator, c2 its numerator times the last denominator), and the
// determinant D *= -c2.  Where the new denominator vanishes against the
// last one, Lentz's guard (its ratio becomes kTiny) and D taken anew from
// its definition, by selects.
__device__ __forceinline__ void half_step(double c1, double c2, double& A0,
                                          double& B0, double& A1,
                                          double& B1, double& det) {
  const double A2 = fma(c2, A0, c1 * A1);
  double B2 = fma(c2, B0, c1 * B1);
  det *= -c2;
  const bool guard = fabs(B2) < kTiny * fabs(B1);
  B2 = guard ? kTiny * B1 : B2;
  det = guard ? A2 * B1 - A1 * B2 : det;
  A0 = A1;
  B0 = B1;
  A1 = A2;
  B1 = B2;
}

// The continued fraction of I_x(a, b), x below the switch point, by the
// three-term recurrence of its convergents with every level multiplied
// through by its denominators (an equivalence transformation: A_j and B_j
// scaled alike by D_1 ... D_{j-1}, so f_j = A_j / B_j is unchanged): no
// division at all.  f_1 = A_1 / B_1 = 1 / 1, f_2 = 1 / (1 + d_1); a term m
// adds d_2m and d_2m+1 and tests the last two convergents, as an iteration
// of Lentz's loop does.  A_j grows by about (a + 2m)^4 a term, so (A, B)
// are rescaled every term by the power of two of B's exponent.
__device__ double betacf(double a, double b, double x) {
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double A0 = 1.0, B0 = 1.0;                  // f_1 = 1 / 1
  double A1 = qap, B1 = qap - qab * x;        // f_2, times D_1 = a + 1
  B1 = fabs(B1) < kTiny * qap ? kTiny * qap : B1;
  double det = qap - B1;                      // A_2 B_1 - A_1 B_2
  double dn = qap;                            // the last odd denominator
  double dm = 0.0;                            // m, counted in float64
  for (int m = 1; m <= kMaxIter; ++m) {
    dm += 1.0;
    const double m2 = dm + dm;
    const double ne = dm * (b - dm) * x, de = (qam + m2) * (a + m2);
    const double no = -(a + dm) * (qab + dm) * x;
    half_step(de, ne * dn, A0, B0, A1, B1, det);
    dn = (a + m2) * (qap + m2);
    half_step(dn, no * de, A0, B0, A1, B1, det);
    if (fabs(det) < kStopEps * fabs(B1 * A0)) break;
    const int e = (int)((__double_as_longlong(B1) >> 52) & 0x7ff) - 1023;
    const double s = __longlong_as_double((long long)(1023 - e) << 52);
    A0 *= s;
    B0 *= s;
    A1 *= s;
    B1 *= s;
    det *= s * s;
  }
  return A1 / B1;
}

// The log-factorial table: t[i] = lgamma(i) for 0 <= i < size.
struct LgTable {
  const double* t;
  int size;
};

__device__ __forceinline__ double lg(double v, const LgTable& tab) {
  if (v >= 1.0 && v < (double)tab.size && v == floor(v))
    return __ldg(tab.t + (int)v);
  return lgamma(v);
}

// The regularized incomplete beta I_x(a, b) of one element whose edge rules
// left a fraction: a, b > 0, 0 < x < 1.
struct Job {
  double a, b, x;
};

__device__ double betainc(const Job& j, const LgTable& tab) {
  const double a = j.a, b = j.b, x = j.x;
  // each product and sum rounded on its own, in the plain version's order
  double s = __dsub_rn(__dsub_rn(lg(a + b, tab), lg(a, tab)), lg(b, tab));
  s = __dadd_rn(s, __dmul_rn(a, log(x)));
  s = __dadd_rn(s, __dmul_rn(b, log1p(-x)));
  const double front = exp(s);
  const bool lower = x < (a + 1.0) / (a + b + 2.0);
  // one fraction a lane: (a, b, x) below the switch, else (b, a, 1 - x),
  // so that a warp whose lanes lie on both sides runs one loop, not two
  // in turn
  const double cf = betacf(lower ? a : b, lower ? b : a,
                           lower ? x : 1.0 - x);
  return lower ? front * cf / a : 1.0 - front * cf / b;
}

// The binomial cdf's edge rules: true and a job where a fraction is left,
// else false and the value.
__device__ __forceinline__ bool binom_job(double k, double n, double p,
                                          double& v, Job& job) {
  const double kk = floor(k);
  if (kk >= n) {
    v = 1.0;
    return false;
  }
  if (kk < 0.0) {
    v = 0.0;
    return false;
  }
  const double x = fmin(fmax(1.0 - p, 0.0), 1.0);
  if (x <= 0.0 || x >= 1.0) {
    v = x <= 0.0 ? 0.0 : 1.0;
    return false;
  }
  job = Job{fmax(n - kk, 1e-30), kk + 1.0, x};
  return true;
}

// The binomial's success rate from the noise rate e (stats.py:52), each
// product and sum rounded on its own as the plain version rounds them.
__device__ __forceinline__ double p_success_of(double e) {
  return __dsub_rn(1.0, __dadd_rn(__dmul_rn(6.0, e),
                                  __dmul_rn(10.0, __dmul_rn(e, e))));
}

// The connection test of a pair's cis, trans and other counts (stats.py:
// 50-56 and the reference's test_variant_connection): supporting =
// max(cis, trans), total = the three; supporting == 0 gives 0, total -
// supporting <= 0 gives 1, else the binomial's rules.
__device__ __forceinline__ bool conflict_job(int32_t ca, int32_t cb,
                                             int32_t co, double p_success,
                                             double& v, Job& job) {
  const double sup = (double)(ca > cb ? ca : cb);
  const double total = (double)ca + (double)cb + (double)co;
  if (sup == 0.0) {
    v = 0.0;
    return false;
  }
  if (!(total - sup > 0.0)) {
    v = 1.0;
    return false;
  }
  return binom_job(sup, total, p_success, v, job);
}

// Where an operand of binom_cdf lies (kernels/stats.py _operand builds the
// descriptor): a value, one element on the card, the full shape
// contiguous, or a view read through its strides (0 where broadcast).
enum Kind { kValue = 0, kOne = 1, kLinear = 2, kStrided = 3 };

struct Shape {
  int ndim;
  int size[kMaxDims];
};

template <class T>
struct Operand {
  const T* ptr;
  double value;
  int kind;
  long long stride[kMaxDims];

  __device__ __forceinline__ double at(int i, const Shape& s) const {
    if (kind == kValue) return value;
    if (kind == kOne) return (double)__ldg(ptr);
    if (kind == kLinear) return (double)__ldg(ptr + i);
    long long off = 0;
    int r = i;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      if (d < s.ndim) {
        const int q = r / s.size[d];
        off += (long long)(r - q * s.size[d]) * stride[d];
        r = q;
      }
    }
    return (double)__ldg(ptr + off);
  }
};

// A pair's cis, trans and other counts from three (count,) int32 arrays
// (prune_mask's and conflicting_config_p's layout).
struct ThreeArrays {
  static constexpr bool kBand = false;
  const int32_t* a;
  const int32_t* b;
  const int32_t* o;
};

// binom_cdf_kernel's elements: k, n and p through their descriptors
// (binom_cdf) ...
template <class TK, class TN>
struct BinomOperands {
  Operand<TK> k;
  Operand<TN> n;
  Operand<double> p;
  Shape shape;
  __device__ __forceinline__ bool job(int i, double& v, Job& j) const {
    return binom_job(k.at(i, shape), n.at(i, shape), p.at(i, shape), v, j);
  }
};

// ... or a pair's three counts and the noise rate on the card, the
// connection test's rules first (conflicting_config_p).
struct ConflictCounts {
  ThreeArrays in;
  const double* e;
  __device__ __forceinline__ bool job(int i, double& v, Job& j) const {
    return conflict_job(__ldg(in.a + i), __ldg(in.b + i), __ldg(in.o + i),
                        p_success_of(__ldg(e)), v, j);
  }
};

// One thread an element: its edge rules, then its fraction where one is
// left.
template <class Src>
__global__ void __launch_bounds__(kThreads)
    binom_cdf_kernel(Src src, int count, LgTable tab,
                     double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  double v;
  Job job;
  if (src.job(i, v, job)) v = betainc(job, tab);
  out[i] = v;
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

// The merged (M, band, 9) int32 band: cis = configurations 0 + 4, trans =
// 1 + 3, other the remaining five, in int32 as band_configs forms them.
struct Band9 {
  static constexpr bool kBand = true;
  const int32_t* pair;
};

// One thread a pair: p, prune = p < threshold and uncertain = |p -
// threshold| < refine_band.  The noise rate comes first, from one warp of
// each block.  On the band, a block stages its pairs' 9 words (one
// contiguous run) in shared memory with coalesced 16-byte loads; a thread
// then reads its 9 words there (a stride of 9 words: no bank conflict).
template <class In, class Noise>
__global__ void conflict_test_kernel(In in, Noise noise, double threshold,
                                     double refine_band, int count,
                                     LgTable tab, double* __restrict__ p,
                                     uint8_t* __restrict__ prune,
                                     uint8_t* __restrict__ uncertain) {
  __shared__ double s_e;
  __shared__ __align__(16) int32_t s_words[In::kBand ? kThreads * 9 : 4];
  const int i0 = blockIdx.x * blockDim.x;
  const int i = i0 + threadIdx.x;
  if (threadIdx.x < 32) {
    double e = noise.get(threadIdx.x);
    if (threadIdx.x == 0) s_e = e;
  }
  int32_t ca = 0, cb = 0, co = 0;
  if constexpr (In::kBand) {
    const int32_t* src = in.pair + (long long)i0 * 9;
    const int n_words = (int)min((long long)blockDim.x * 9,
                                 (long long)(count - i0) * 9);
    int k0 = 0;
    // a block's 9 x 256 words (9,216 bytes, a multiple of 16 from the
    // band's start) in 16-byte loads, two or three a thread, all in
    // flight before the first store
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n4 = n_words >> 2;
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(s_words);
#pragma unroll 3
      for (int k = threadIdx.x; k < n4; k += blockDim.x) d4[k] = __ldg(s4 + k);
      k0 = n4 << 2;
    }
    for (int k = k0 + threadIdx.x; k < n_words; k += blockDim.x)
      s_words[k] = src[k];
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
  double v;
  Job job;
  if (conflict_job(ca, cb, co, p_success_of(s_e), v, job))
    v = betainc(job, tab);
  p[i] = v;
  prune[i] = v < threshold;
  uncertain[i] = fabs(v - threshold) < refine_band;
}

__global__ void lgamma_table_kernel(double* __restrict__ table, int size,
                                    int* __restrict__ mismatches) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const double v = lgamma((double)i);
  if (__double_as_longlong(v) != __double_as_longlong(table[i])) {
    table[i] = v;
    atomicAdd(mismatches, 1);
  }
}

__global__ void empty_grid_kernel() {}

int grid_for(int count) { return (count + kThreads - 1) / kThreads; }

LgTable table_of(const void* table, int size) {
  return LgTable{(const double*)table, size};
}

// binom_cdf's descriptor (kernels/stats.py _binom_descriptor), int64 words:
// ndim, kMaxDims sizes, then for k, n and p in turn: kind, type (0 float64,
// 1 int32), pointer, the value's bits, kMaxDims strides in elements.
constexpr int kOperandWords = 4 + kMaxDims;

double bits_to_double(long long v) {
  double d;
  memcpy(&d, &v, sizeof d);
  return d;
}

template <class T>
Operand<T> operand_of(const long long* w) {
  Operand<T> o;
  o.kind = (int)w[0];
  o.ptr = (const T*)(uintptr_t)w[2];
  o.value = bits_to_double(w[3]);
  for (int d = 0; d < kMaxDims; ++d) o.stride[d] = w[4 + d];
  return o;
}

template <class TK, class TN>
void launch_binom(const long long* desc, int count, LgTable tab, double* out,
                  cudaStream_t s) {
  BinomOperands<TK, TN> src;
  src.shape.ndim = (int)desc[0];
  for (int d = 0; d < kMaxDims; ++d) src.shape.size[d] = (int)desc[1 + d];
  const long long* w = desc + 1 + kMaxDims;
  src.k = operand_of<TK>(w);
  src.n = operand_of<TN>(w + kOperandWords);
  src.p = operand_of<double>(w + 2 * kOperandWords);
  binom_cdf_kernel<<<grid_for(count), kThreads, 0, s>>>(src, count, tab,
                                                         out);
}

}  // namespace

extern "C" {

// Each launcher enqueues its kernels on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers but for
// the descriptor, which is host memory.  `table` holds `table_size`
// float64 log-factorials on the card.

// P(X <= k) of every element of the broadcast shape.
int binom_cdf_launch(const long long* desc, int count, const void* table,
                     int table_size, void* out, void* stream) {
  if (count > 0) {
    const int tk = (int)desc[1 + kMaxDims + 1];
    const int tn = (int)desc[1 + kMaxDims + kOperandWords + 1];
    const LgTable tab = table_of(table, table_size);
    cudaStream_t s = (cudaStream_t)stream;
    double* o = (double*)out;
    if (tk == 1 && tn == 1)
      launch_binom<int32_t, int32_t>(desc, count, tab, o, s);
    else if (tk == 1)
      launch_binom<int32_t, double>(desc, count, tab, o, s);
    else if (tn == 1)
      launch_binom<double, int32_t>(desc, count, tab, o, s);
    else
      launch_binom<double, double>(desc, count, tab, o, s);
  }
  return (int)cudaGetLastError();
}

// The connection test's p of `count` pairs from their int32 cis, trans and
// other counts and the float64 noise rate on the card (conflicting_config_p).
int conflict_p_launch(const void* cfg_a, const void* cfg_b,
                      const void* other, const void* noise_e, int count,
                      const void* table, int table_size, void* out,
                      void* stream) {
  if (count > 0) {
    const ConflictCounts src{
        ThreeArrays{(const int32_t*)cfg_a, (const int32_t*)cfg_b,
                    (const int32_t*)other},
        (const double*)noise_e};
    binom_cdf_kernel<<<grid_for(count), kThreads, 0, (cudaStream_t)stream>>>(
        src, count, table_of(table, table_size), (double*)out);
  }
  return (int)cudaGetLastError();
}

int conflict_prune_launch(const void* cfg_a, const void* cfg_b,
                          const void* other, const void* noise_e,
                          double threshold, double refine_band, int count,
                          const void* table, int table_size, void* p,
                          void* prune, void* uncertain, void* stream) {
  if (count > 0) {
    conflict_test_kernel<<<grid_for(count), kThreads, 0,
                           (cudaStream_t)stream>>>(
        ThreeArrays{(const int32_t*)cfg_a, (const int32_t*)cfg_b,
                    (const int32_t*)other},
        NoiseValue{(const double*)noise_e}, threshold, refine_band, count,
        table_of(table, table_size), (double*)p, (uint8_t*)prune,
        (uint8_t*)uncertain);
  }
  return (int)cudaGetLastError();
}

// The connection-test tail of the sharded step in two launches: the noise
// rate's partial sums over counts (m, 3), then the test of every (v, d) of
// pair (m, band, 9).  `partials` holds 2 * max_partials int64; returns the
// launches enqueued in *launches.
int band_prune_launch(const void* counts, const void* pair, int m, int band,
                      double threshold, double refine_band, void* partials,
                      int max_partials, const void* table, int table_size,
                      void* p, void* prune, void* uncertain, int* launches,
                      void* stream) {
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
      (int)count, table_of(table, table_size), (double*)p, (uint8_t*)prune,
      (uint8_t*)uncertain);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launches = 2;
  return (int)e;
}

// Makes table[i] (float64 lgamma(i) from torch) equal to this file's
// lgamma(i) for 0 <= i < size, counting the entries it had to replace.
int lgamma_table_launch(void* table, int size, void* mismatches,
                        void* stream) {
  if (size > 0)
    lgamma_table_kernel<<<grid_for(size), kThreads, 0,
                          (cudaStream_t)stream>>>((double*)table, size,
                                                  (int*)mismatches);
  return (int)cudaGetLastError();
}

// An empty kernel on binom_cdf_kernel's grid for `count` elements: the
// launch floor, for measurement (chip_smoke.py, the ablation script).
int empty_grid_launch(int count, void* stream) {
  if (count > 0)
    empty_grid_kernel<<<grid_for(count), kThreads, 0,
                        (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
