"""What limits the sharded step's kernels on the card, by ablation: the
band_counts kernel of the first port (one warp a row, every ordered hit pair
walked as q = i * nh + j with a division, one device-memory atomic an
in-band pair) with one part taken out at a time, beside the current
band_counts kernel and builds of csrc/mesh.cu with its compile-time
switches; the connection-test tail three ways (the three calls,
band_prune's two launches, one cooperative launch); and binom_cdf and the
tail's test body part by part (csrc/stats.cu beside builds of this
script's STATS_SOURCE, its variants: the earlier design, and the current
one with one part swapped, STATS_VARIANTS).

    python -m phaser_tpu_torch.testing.step_kernels_ablation [--rows 262144]
        [--vars 100000] [--reads 5000000] [--iters 20]
        [--sections band_counts,tail,binom]
        [--binom-inputs e2e,chromosome,long,one_live,live_873]
        [--sass-out FILE]

Inputs, smoke phase 9's three band_counts inputs at one shard's width:
phase 3's reads ("chromosome": testing/benchdata.py's 5M reads of 100 bp,
the first `--rows` as planes of its 100,000-het table: the real density),
and scaling_bench._gen's dense layout (a variant about every 8 bp) with its
rows in random order ("dense") and sorted by start ("dense_sorted"); for
the tail, counts and a band drawn from a seed at 7,120 and 100,000
variants (testing/layouts.band_tail: a noise rate near 0.5%, so the tests
take fractions).  The binom section takes the connection tests of the
step's merged band on phase 6's first contig ("e2e", regenerated alone by
testing/datagen.py at chip_smoke.py's shape, about 90 s) and on phase 3's
reads, the long fractions of testing/layouts.py (binom_long for binom_cdf,
band_long for the tail), and the live elements of phase 6's contig alone
(the one with the most terms; 873 of them in four blocks); beside each an
empty kernel on the same grid (the launch floor), and on the step's inputs
conflicting_config_p's route as the earlier design built it (float64
copies of the counts and of p, then two passes) and as it is (one
launch on the counts).  The first port's kernel and its ablations are
built here from the source below, csrc/mesh.cu once a VARIANTS entry with
its defines, and csrc/stats.cu and STATS_SOURCE once a STATS_VARIANTS
entry, one nvcc each, all started together, into a temporary directory
that is removed at the end.  Every exact variant is held against its plain
version (band_counts_plain; binom_cdf_plain and band_prune_plain: p within
1e-12, prune equal wherever |p - threshold| > 1e-12).  Each function is
timed as a wrapper call with CUDA events in turns (every function, then
again in reverse order) and on the card by torch.profiler over a whole
window (utils/trace.device_activity: every device activity a call,
summed, and their count).  The SASS of the current kernel library is
searched for the reductions (RED) and returning atomics (ATOM / ATOMG) of
band_counts_kernel, and that of every STATS_VARIANTS build for the float64
instructions, divisions and branches of its binom_cdf kernel on float64
operands (`--sass-out` writes csrc/stats.cu's whole function).  Needs a
CUDA GPU; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ABLATIONS = {   # mode -> what the first port's kernel does without it
    0: "first port's kernel as it was",
    1: "adds into a register sum written once (no atomics)",
    2: "division replaced by a nested loop (i over lanes, j over hits)",
    3: "pair walk removed (allele counts only)",
    4: "exact forward walk, atomics as they were",
}
EXACT = (0, 2, 4)

SOURCE = r'''
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include "%(stats)s"

namespace cg = cooperative_groups;

template <int Mode>
__global__ void pr8_band_counts(const int32_t* __restrict__ vidx,
                                const int32_t* __restrict__ allele,
                                int n_rows, int l, int m, int band,
                                int32_t* __restrict__ counts,
                                int32_t* __restrict__ pair,
                                int32_t* __restrict__ sink) {
  extern __shared__ int2 smem2[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int2* hits = smem2 + (size_t)warp * l;
  int acc = 0;
  for (int row = blockIdx.x * warps + warp; row < n_rows;
       row += gridDim.x * warps) {
    const int32_t* vr = vidx + (size_t)row * l;
    const int32_t* ar = allele + (size_t)row * l;
    int nh = 0;
    for (int base = 0; base < l; base += 32) {
      int i = base + lane;
      int v = -1, a = 3;
      if (i < l) { v = vr[i]; a = ar[i]; }
      bool hit = a >= 0 && a < 3 && v >= 0 && v < m;
      unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        hits[nh + __popc(ballot & ((1u << lane) - 1u))] = make_int2(v, a);
        if (Mode == 1) acc += v * 3 + a; else atomicAdd(counts + (size_t)v * 3 + a, 1);
      }
      nh += __popc(ballot);
    }
    __syncwarp();
    if (band > 0 && Mode != 3) {
      if (Mode == 2) {
        for (int i = lane; i < nh; i += 32) {
          int2 hi = hits[i];
          for (int j = 0; j < nh; ++j) {
            int2 hj = hits[j];
            int d = hj.x - hi.x;
            if (d >= 1 && d <= band)
              atomicAdd(pair + ((size_t)hi.x * band + (d - 1)) * 9 + hi.y * 3 + hj.y, 1);
          }
        }
      } else if (Mode == 4) {
        for (int i = lane; i < nh; i += 32) {
          int2 hi = hits[i];
          for (int j = i + 1; j < nh; ++j) {
            int2 hj = hits[j];
            int d = hj.x - hi.x;
            if (d > band) break;
            if (d > 0)
              atomicAdd(pair + ((size_t)hi.x * band + (d - 1)) * 9 + hi.y * 3 + hj.y, 1);
          }
        }
      } else {
        const int n_pairs = nh * nh;
        for (int q = lane; q < n_pairs; q += 32) {
          int i = q / nh;
          int2 hi = hits[i], hj = hits[q - i * nh];
          int d = hj.x - hi.x;
          if (d >= 1 && d <= band) {
            size_t w = ((size_t)hi.x * band + (d - 1)) * 9 + hi.y * 3 + hj.y;
            if (Mode == 1) acc += (int)w; else atomicAdd(pair + w, 1);
          }
        }
      }
    }
    __syncwarp();
  }
  if (Mode == 1) sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <int Mode>
int launch_mode(const void* vidx, const void* allele, int n_rows, int l,
                int m, int band, void* counts, void* pair, void* sink,
                cudaStream_t s) {
  cudaMemsetAsync(counts, 0, (size_t)m * 3 * 4, s);
  if (band > 0) cudaMemsetAsync(pair, 0, (size_t)m * band * 9 * 4, s);
  int warps = (48 * 1024) / (8 * l);
  if (warps > 8) warps = 8;
  long long blocks = (n_rows + warps - 1) / warps;
  if (blocks > 132 * 16) blocks = 132 * 16;
  pr8_band_counts<Mode><<<(int)blocks, warps * 32, (size_t)warps * l * 8, s>>>(
      (const int32_t*)vidx, (const int32_t*)allele, n_rows, l, m, band,
      (int32_t*)counts, (int32_t*)pair, (int32_t*)sink);
  return (int)cudaGetLastError();
}

// The tail as one cooperative launch: the noise sums, a grid-wide sync, the
// tests (the same noise arithmetic and test body as band_prune).
__global__ void band_prune_coop(const int32_t* __restrict__ counts, int m,
                                const int32_t* __restrict__ pair, int count,
                                double threshold, double refine_band,
                                long long* __restrict__ partials,
                                LgTable tab, double* __restrict__ p,
                                uint8_t* __restrict__ prune,
                                uint8_t* __restrict__ uncertain) {
  __shared__ long long s_sum[2][kThreads / 32];
  __shared__ double s_e;
  __shared__ int32_t s_words[kThreads * 9];
  long long bm = 0, bmm = 0;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < m;
       v += gridDim.x * blockDim.x) {
    const int32_t c0 = counts[3 * v], c1 = counts[3 * v + 1],
                  c2 = counts[3 * v + 2];
    const double matches = (double)c0 + (double)c1, mis = (double)c2;
    const double tot = fmax(matches + mis, 1.0);
    if (matches > 0.0 && mis / tot < 0.05) { bm += (long long)c0 + c1; bmm += c2; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    bm += __shfl_down_sync(0xffffffffu, bm, o);
    bmm += __shfl_down_sync(0xffffffffu, bmm, o);
  }
  if ((threadIdx.x & 31) == 0) {
    s_sum[0][threadIdx.x >> 5] = bm;
    s_sum[1][threadIdx.x >> 5] = bmm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) { bm += s_sum[0][w]; bmm += s_sum[1][w]; }
    partials[2 * blockIdx.x] = bm;
    partials[2 * blockIdx.x + 1] = bmm;
  }
  cg::this_grid().sync();
  if (threadIdx.x < 32) {
    double e = NoisePartials{partials, (int)gridDim.x}.get(threadIdx.x);
    if (threadIdx.x == 0) s_e = e;
  }
  __syncthreads();
  const double p_success = p_success_of(s_e);
  for (long long i0 = (long long)blockIdx.x * blockDim.x; i0 < count;
       i0 += (long long)gridDim.x * blockDim.x) {
    const long long w0 = i0 * 9;
    const int n_words = (int)min((long long)blockDim.x * 9, (long long)count * 9 - w0);
    __syncthreads();
    for (int k = threadIdx.x; k < n_words; k += blockDim.x) s_words[k] = pair[w0 + k];
    __syncthreads();
    const long long i = i0 + threadIdx.x;
    if (i < count) {
      const int32_t* w = s_words + threadIdx.x * 9;
      double pv;
      Job job;
      if (conflict_job(w[0] + w[4], w[1] + w[3],
                       w[2] + w[5] + w[6] + w[7] + w[8], p_success, pv, job))
        pv = betainc(job, tab);
      p[i] = pv;
      prune[i] = pv < threshold;
      uncertain[i] = fabs(pv - threshold) < refine_band;
    }
  }
}

extern "C" {
int ablation_launch(int mode, const void* vidx, const void* allele,
                    int n_rows, int l, int m, int band, void* counts,
                    void* pair, void* sink, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch_mode<0>(vidx, allele, n_rows, l, m, band, counts, pair, sink, s);
    case 1: return launch_mode<1>(vidx, allele, n_rows, l, m, band, counts, pair, sink, s);
    case 2: return launch_mode<2>(vidx, allele, n_rows, l, m, band, counts, pair, sink, s);
    case 3: return launch_mode<3>(vidx, allele, n_rows, l, m, band, counts, pair, sink, s);
    default: return launch_mode<4>(vidx, allele, n_rows, l, m, band, counts, pair, sink, s);
  }
}

int coop_blocks(int count) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_prune_coop, kThreads, 0);
  long long need = (count + kThreads - 1) / kThreads;
  long long most = (long long)sms * per_sm;
  return (int)(need < most ? need : most);
}

int coop_launch(const void* counts, const void* pair, int m, int band,
                double threshold, double refine_band, void* partials,
                int blocks, const void* table, int table_size, void* p,
                void* prune, void* uncertain, void* stream) {
  int count = m * band;
  LgTable tab = table_of(table, table_size);
  void* args[] = {(void*)&counts, (void*)&m, (void*)&pair, (void*)&count,
                  (void*)&threshold, (void*)&refine_band, (void*)&partials,
                  (void*)&tab, (void*)&p, (void*)&prune, (void*)&uncertain};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)band_prune_coop, blocks,
                                              kThreads, args, 0,
                                              (cudaStream_t)stream);
  return (int)e;
}
}
'''


# builds of csrc/mesh.cu as it is, with its compile-time switches
VARIANTS = {
    "combine": ["-DBAND_COUNTS_COMBINE"],
    "2_blocks_an_sm": ["-DBAND_COUNTS_BLOCKS_PER_SM=2"],
    "1_block_an_sm": ["-DBAND_COUNTS_BLOCKS_PER_SM=1"],
}
# The binom_cdf kernel and the tail's test body as variants of csrc/stats.cu
# (which this source includes for everything the variants do not swap): the
# earlier design (the first port's: Lentz's fraction, lgamma computed, two
# call sites of the fraction, the band staged word by word) and the current
# design with one part swapped at a time, by the defines of STATS_VARIANTS:
#   V_FRACTION=0   Lentz's fraction (two dependent divisions a half-step)
#   V_FRACTION=1   the recurrence with one reciprocal a term, rescaled only
#                  past 2^+-64
#   V_NO_TABLE     the prefactor's three lgamma computed, no table
#   V_TWO_CALLS    the fraction called at two sites, one each side of the
#                  switch point
#   V_BAND_SCALAR  the band's words staged one by one
#   V_QUEUE        the block's live elements gathered (warp ballot, one
#                  shared counter) so that fractions run in full warps
#   V_TABLE_SMEM=n the table's first n entries staged in shared memory
# With no define a variant is csrc/stats.cu's design, built here beside it
# ("control").  Exported: variant_binom_launch and variant_band_prune_launch,
# with csrc/stats.cu's binom_cdf_launch and band_prune_launch arguments.
STATS_SOURCE = r'''
#include "%(stats)s"

namespace {

#ifndef V_FRACTION
#define V_FRACTION 2
#endif

__device__ __forceinline__ double v_not_tiny(double v) {
  return fabs(v) < kTiny ? kTiny : v;
}

#if V_FRACTION == 0
__device__ double v_betacf(double a, double b, double x) {
  double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0;
  double d = 1.0 / v_not_tiny(1.0 - qab * x / qap);
  double h = d;
  for (int m = 1; m <= kMaxIter; ++m) {
    double m2 = 2.0 * m;
    double aa = m * (b - m) * x / ((qam + m2) * (a + m2));
    d = 1.0 / v_not_tiny(1.0 + aa * d);
    c = v_not_tiny(1.0 + aa / c);
    h *= d * c;
    aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2));
    d = 1.0 / v_not_tiny(1.0 + aa * d);
    c = v_not_tiny(1.0 + aa / c);
    double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < kEps) break;
  }
  return h;
}
#elif V_FRACTION == 1
__device__ __forceinline__ void v_half_step(double al, double& A0,
                                            double& B0, double& A1,
                                            double& B1, double& det) {
  const double A2 = fma(al, A0, A1);
  double B2 = fma(al, B0, B1);
  det *= -al;
  if (fabs(B2) < kTiny * fabs(B1)) {
    B2 = kTiny * B1;
    det = A2 * B1 - A1 * B2;
  }
  A0 = A1;
  B0 = B1;
  A1 = A2;
  B1 = B2;
}

__device__ double v_betacf(double a, double b, double x) {
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double A0 = 1.0, B0 = 1.0;
  double A1 = 1.0, B1 = v_not_tiny(1.0 - qab * x / qap);
  double det = 1.0 - B1;
  for (int m = 1; m <= kMaxIter; ++m) {
    const double m2 = 2.0 * m;
    const double ne = m * (b - m) * x, de = (qam + m2) * (a + m2);
    const double no = -(a + m) * (qab + m) * x, dn = (a + m2) * (qap + m2);
    const double r = 1.0 / (de * dn);
    v_half_step(ne * dn * r, A0, B0, A1, B1, det);
    v_half_step(no * de * r, A0, B0, A1, B1, det);
    if (fabs(det) < kStopEps * fabs(B1 * A0)) break;
    const int e = (int)((__double_as_longlong(B1) >> 52) & 0x7ff) - 1023;
    if (e > 64 || e < -64) {
      const double s = __longlong_as_double((long long)(1023 - e) << 52);
      A0 *= s;
      B0 *= s;
      A1 *= s;
      B1 *= s;
      det *= s * s;
    }
  }
  return A1 / B1;
}
#else
__device__ double v_betacf(double a, double b, double x) {
  return betacf(a, b, x);
}
#endif

struct VTable {
  const double* t;
  int size;
  const double* s;
  int s_size;
};

__device__ __forceinline__ double v_lg(double v, const VTable& tab) {
#ifndef V_NO_TABLE
  if (v >= 1.0 && v < (double)tab.size && v == floor(v)) {
    const int i = (int)v;
#ifdef V_TABLE_SMEM
    if (i < tab.s_size) return tab.s[i];
#endif
    return __ldg(tab.t + i);
  }
#endif
  return lgamma(v);
}

__device__ double v_betainc(const Job& j, const VTable& tab) {
  const double a = j.a, b = j.b, x = j.x;
  double s = __dsub_rn(__dsub_rn(v_lg(a + b, tab), v_lg(a, tab)),
                       v_lg(b, tab));
  s = __dadd_rn(s, __dmul_rn(a, log(x)));
  s = __dadd_rn(s, __dmul_rn(b, log1p(-x)));
  const double front = exp(s);
  const bool lower = x < (a + 1.0) / (a + b + 2.0);
#ifdef V_TWO_CALLS
  if (lower) return front * v_betacf(a, b, x) / a;
  return 1.0 - front * v_betacf(b, a, 1.0 - x) / b;
#else
  const double cf = v_betacf(lower ? a : b, lower ? b : a,
                             lower ? x : 1.0 - x);
  return lower ? front * cf / a : 1.0 - front * cf / b;
#endif
}

// Every thread of the block calls this once, with its element's edge
// rules taken; write(t, v) stores the value of thread t's element.
template <class Write>
__device__ __forceinline__ void v_run_jobs(bool live, const Job& job,
                                           VTable tab, Write write) {
#ifdef V_TABLE_SMEM
  __shared__ double s_tab[V_TABLE_SMEM];
  if (__syncthreads_or(live)) {
    const int n = min(V_TABLE_SMEM, tab.size);
    for (int j = threadIdx.x; j < n; j += blockDim.x) s_tab[j] = tab.t[j];
    tab.s = s_tab;
    tab.s_size = n;
    __syncthreads();
  }
#endif
#ifdef V_QUEUE
  __shared__ Job s_job[kThreads];
  __shared__ int s_thread[kThreads];
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  int base = 0;
  if (lane == 0 && ballot) base = atomicAdd(&s_n, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) {
    const int slot = base + __popc(ballot & ((1u << lane) - 1u));
    s_job[slot] = job;
    s_thread[slot] = threadIdx.x;
  }
  __syncthreads();
  if ((int)threadIdx.x < s_n)
    write(s_thread[threadIdx.x], v_betainc(s_job[threadIdx.x], tab));
#else
  if (live) write(threadIdx.x, v_betainc(job, tab));
#endif
}

template <class TK, class TN>
__global__ void __launch_bounds__(kThreads)
    v_binom_cdf_kernel(BinomOperands<TK, TN> src, int count, VTable tab,
                       double* __restrict__ out) {
  const int i0 = blockIdx.x * blockDim.x;
  const int i = i0 + threadIdx.x;
  bool live = false;
  Job job{};
  if (i < count) {
    double v;
    live = src.job(i, v, job);
    if (!live) out[i] = v;
  }
  v_run_jobs(live, job, tab, [&](int t, double v) { out[i0 + t] = v; });
}

__global__ void v_conflict_test_kernel(Band9 in, NoisePartials noise,
                                       double threshold, double refine_band,
                                       int count, VTable tab,
                                       double* __restrict__ p,
                                       uint8_t* __restrict__ prune,
                                       uint8_t* __restrict__ uncertain) {
  __shared__ double s_e;
  __shared__ __align__(16) int32_t s_words[kThreads * 9];
  const int i0 = blockIdx.x * blockDim.x;
  const int i = i0 + threadIdx.x;
  if (threadIdx.x < 32) {
    double e = noise.get(threadIdx.x);
    if (threadIdx.x == 0) s_e = e;
  }
  const int32_t* src = in.pair + (long long)i0 * 9;
  const int n_words = (int)min((long long)blockDim.x * 9,
                               (long long)(count - i0) * 9);
  int k0 = 0;
#ifndef V_BAND_SCALAR
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n_words >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(s_words);
#pragma unroll 3
    for (int k = threadIdx.x; k < n4; k += blockDim.x) d4[k] = __ldg(s4 + k);
    k0 = n4 << 2;
  }
#endif
  for (int k = k0 + threadIdx.x; k < n_words; k += blockDim.x)
    s_words[k] = src[k];
  __syncthreads();
  auto write = [&](int t, double pv) {
    p[i0 + t] = pv;
    prune[i0 + t] = pv < threshold;
    uncertain[i0 + t] = fabs(pv - threshold) < refine_band;
  };
  bool live = false;
  Job job{};
  if (i < count) {
    const int32_t* w = s_words + threadIdx.x * 9;
    double v;
    live = conflict_job(w[0] + w[4], w[1] + w[3],
                        w[2] + w[5] + w[6] + w[7] + w[8], p_success_of(s_e),
                        v, job);
    if (!live) write(threadIdx.x, v);
  }
  v_run_jobs(live, job, tab, write);
}

template <class TK, class TN>
void v_launch_binom(const long long* desc, int count, VTable tab,
                    double* out, cudaStream_t s) {
  BinomOperands<TK, TN> src;
  src.shape.ndim = (int)desc[0];
  for (int d = 0; d < kMaxDims; ++d) src.shape.size[d] = (int)desc[1 + d];
  const long long* w = desc + 1 + kMaxDims;
  src.k = operand_of<TK>(w);
  src.n = operand_of<TN>(w + kOperandWords);
  src.p = operand_of<double>(w + 2 * kOperandWords);
  v_binom_cdf_kernel<<<grid_for(count), kThreads, 0, s>>>(src, count, tab,
                                                           out);
}

}  // namespace

extern "C" {
int variant_binom_launch(const long long* desc, int count, const void* table,
                         int table_size, void* out, void* stream) {
  if (count > 0) {
    const int tk = (int)desc[1 + kMaxDims + 1];
    const int tn = (int)desc[1 + kMaxDims + kOperandWords + 1];
    const VTable tab{(const double*)table, table_size, nullptr, 0};
    cudaStream_t s = (cudaStream_t)stream;
    double* o = (double*)out;
    if (tk == 1 && tn == 1)
      v_launch_binom<int32_t, int32_t>(desc, count, tab, o, s);
    else if (tk == 1)
      v_launch_binom<int32_t, double>(desc, count, tab, o, s);
    else if (tn == 1)
      v_launch_binom<double, int32_t>(desc, count, tab, o, s);
    else
      v_launch_binom<double, double>(desc, count, tab, o, s);
  }
  return (int)cudaGetLastError();
}

int variant_band_prune_launch(const void* counts, const void* pair, int m,
                              int band, double threshold, double refine_band,
                              void* partials, int max_partials,
                              const void* table, int table_size, void* p,
                              void* prune, void* uncertain, int* launches,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *launches = 0;
  const long long count = (long long)m * band;
  if (count == 0) return (int)cudaGetLastError();
  int nb = (int)((m + kThreads * 4 - 1) / (kThreads * 4));
  if (nb > max_partials) nb = max_partials;
  noise_partials_kernel<<<nb, kThreads, 0, s>>>(
      (const int32_t*)counts, m, (long long*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launches = 1;
  v_conflict_test_kernel<<<grid_for((int)count), kThreads, 0, s>>>(
      Band9{(const int32_t*)pair},
      NoisePartials{(const long long*)partials, nb}, threshold, refine_band,
      (int)count, VTable{(const double*)table, table_size, nullptr, 0},
      (double*)p, (uint8_t*)prune, (uint8_t*)uncertain);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launches = 2;
  return (int)e;
}
}
'''
EARLIER = ["-DV_FRACTION=0", "-DV_NO_TABLE", "-DV_TWO_CALLS",
           "-DV_BAND_SCALAR"]
# name -> defines of STATS_SOURCE; "default" is csrc/stats.cu itself
STATS_VARIANTS = {
    "earlier": EARLIER,
    "default": None,
    "control": [],
    "lentz": ["-DV_FRACTION=0"],
    "reciprocal": ["-DV_FRACTION=1"],
    "lgamma": ["-DV_NO_TABLE"],
    "two_calls": ["-DV_TWO_CALLS"],
    "band_scalar": ["-DV_BAND_SCALAR"],
    "queue": ["-DV_QUEUE"],
    "table_smem": ["-DV_TABLE_SMEM=1024"],
}
# the binom_cdf instantiation every build is timed on (float64 k and n),
# whose SASS the binom section counts: csrc/stats.cu's, a variant's
SASS_BINOM = {"default": "binom_cdf_kernelINS_13BinomOperandsIdd",
              "variant": "v_binom_cdf_kernelIdd"}
SASS_OPS = ("DFMA", "DMUL", "DADD", "MUFU.RCP64H", "CALL", "BRA", "BSSY")

# The ragged join and the span pass beside their earlier designs.  This source
# includes csrc/alleles.cu (every helper the variants share) and adds:
#   earlier  the first designs as they were: one row a thread, every row's
#            CIGAR walked from device memory (twice for the join), the
#            32 KB four-column BlockTable stage (the span pass stages the
#            positions four times), a grid of one block a 256-row tile
#   ops      the other op path: the join with every row's ops read from
#            device memory (no staged run), the span pass with each warp's
#            op run staged in shared memory first
#   grid     one wave of blocks that walk their tiles in a loop, where the
#            kernels take a block for each tile (the span pass: for each
#            eight, a warp a tile)
#   bounds   the other register bound: the join without its minimum of
#            8 blocks an SM, the span pass with a minimum of 8 (at most 32
#            registers a thread) for its 6
# ops, grid and bounds run copies of the current bodies (templated on the
# op path, their tiles walked in a loop that the tile grid runs once), so
# that csrc/alleles.cu holds the chosen design alone.
# Exported: v_ragged_join_launch(variant, ...ragged_join_launch's
# arguments) and v_read_spans_launch(variant, ...read_spans_launch's),
# variant an index of RAGGED_VARIANTS; v_blocks_per_sm(variant, which).
RAGGED_SOURCE = r'''
#include "%(alleles)s"

namespace {

// The rows of one ragged block, one row per thread: search the row's first
// aligned position in the table slice tv[0, tn_), then walk the entries up
// to its last aligned position.  An entry's position p maps to a query
// offset through a cursor over the row's ops (op c starts at reference
// position r and query offset q): the cursor passes every op that ends at
// or before p, ops of no reference length (I, S, H, P) included, and stops
// at the op under p.  Entries ascend, so the cursor only moves forward: a
// row's ops are read once however many entries it has, and an affine row
// (clips around one aligned run) maps each entry with one subtraction.  An
// entry under a D or N op, or whose query offset lies past the row's bases
// (a CIGAR longer than the sequence, or a sequence of `*`), emits nothing.
// All 32 lanes of a warp stay in the emission loop while any of them still
// has a candidate.
template <bool kGlobal>
__device__ __forceinline__ void earlier_ragged_rows(
    bool live, int row, int first, int last, const uint32_t* __restrict__ cig,
    int c, int c1, long long r, const uint8_t* __restrict__ seq,
    const uint8_t* __restrict__ qual, int n_bases, int baseq, OpClasses cls,
    const int32_t* tv, const int32_t* t0, const int32_t* t1,
    const int32_t* tni, int tn_, int tbase, int32_t* __restrict__ out,
    int cap) {
  int k = 0, k_first = 0;
  if (live) {
    k = lower_bound<kGlobal>(tv, tn_, first);
    k_first = k;
  }
  int prev = 0;
  long long q = 0;
  while (__any_sync(kFull, live)) {
    int word = -1;
    while (live) {
      if (k >= tn_) {
        live = false;
        break;
      }
      int p = tload<kGlobal>(tv + k);
      if (p > last) {
        live = false;
        break;
      }
      // of entries at one position only the first is a hit (the lower
      // bound of a per-base search)
      bool is_first = k == k_first || p != prev;
      prev = p;
      int kk = k++;
      if (!is_first) continue;
      unsigned op = 0;
      while (c < c1) {
        uint32_t w = __ldg(cig + c);
        op = w & 0xF;
        long long len = w >> 4;
        long long ref_len = in_class(cls.ref, op) ? len : 0;
        if (p < r + ref_len) break;  // the op under p
        r += ref_len;
        if (in_class(cls.query, op)) q += len;
        ++c;
      }
      if (c >= c1 || !in_class(cls.aligned, op)) continue;
      long long at = q + (p - r);
      if (at >= n_bases) continue;
      int code = __ldg(qual + at) >= baseq ? (__ldg(seq + at) & 0xF) : 15;
      if (code == 15) continue;
      word = hit_word<kGlobal>(code, kk, t0, t1, tni, tbase);
      break;
    }
    emit1(row, word, out, cap);
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
// per entry under an aligned base, and 8 B per hit written.  The padded
// planes of the TPU's routes (1-4 B per base and row, built on the host)
// never exist: the bases reach the card as decoded, and the kernel reads
// them only under a table entry.  What is left is latency, as in
// affine_body: the ops walk, two block barriers, the search's dependent
// loads.  What the design does about it: a block takes 256 consecutive rows
// (BAM order is position order), first walks each row's ops for its aligned
// range [first, last], finds the table slice under the block (block_slice)
// and, when it fits kStage entries, searches and walks in shared memory;
// rows whose slice does not fit search the whole table in global memory.
__global__ void __launch_bounds__(kThreads)
earlier_ragged_join_kernel(const int32_t* __restrict__ pos,
                   const int32_t* __restrict__ cig_off,
                   const uint32_t* __restrict__ cigar,
                   const int32_t* __restrict__ seq_off,
                   const uint8_t* __restrict__ seq,
                   const uint8_t* __restrict__ qual, int n_rows, int baseq,
                   OpClasses cls, const int32_t* __restrict__ vpos,
                   const int32_t* __restrict__ a0,
                   const int32_t* __restrict__ a1,
                   const int32_t* __restrict__ ni, int mp,
                   int32_t* __restrict__ out, int cap) {
  __shared__ __align__(16) BlockTable bt;

  int row = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  int c0 = 0, c1 = 0, s0 = 0, n_bases = 0;
  int first = 0x7fffffff, last = (int)0x80000000;
  long long r0 = 0;  // the 1-based reference position of the row's first op
  if (row < n_rows) {
    c0 = __ldg(cig_off + row);
    c1 = __ldg(cig_off + row + 1);
    s0 = __ldg(seq_off + row);
    n_bases = __ldg(seq_off + row + 1) - s0;
    r0 = (long long)__ldg(pos + row) + 1;
    // the row's aligned range: the first base of its first aligned op to the
    // last base of its last one
    long long r = r0, lo = LLONG_MAX, hi = LLONG_MIN;
    for (int c = c0; c < c1; ++c) {
      uint32_t w = __ldg(cigar + c);
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
    live = lo <= hi;
    if (live) {
      first = (int)lo;
      last = (int)hi;
    }
  }
  int k_lo, n_slice;
  bool staged;
  if (!block_slice(bt, first, last, vpos, a0, a1, ni, mp, &k_lo, &n_slice,
                   &staged))
    return;
  const uint8_t* rseq = seq + s0;
  const uint8_t* rqual = qual + s0;
  if (staged) {
    earlier_ragged_rows<false>(live, row, first, last, cigar, c0, c1, r0, rseq, rqual,
                       n_bases, baseq, cls, bt.sv, bt.s0, bt.s1, bt.sn,
                       n_slice, k_lo, out, cap);
  } else {
    earlier_ragged_rows<true>(live, row, first, last, cigar, c0, c1, r0, rseq, rqual,
                      n_bases, baseq, cls, vpos, a0, a1, ni, mp, 0, out, cap);
  }
}

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
// design does about it: one read per thread, so a warp's loads of pos and
// the offsets are coalesced and its ops (consecutive rows) nearly so; a
// block takes 256 consecutive reads (position order), stages the table
// slice under them (block_slice) and searches there, so a search costs
// shared-memory loads instead of 17 dependent L2 loads.
__global__ void __launch_bounds__(kThreads)
earlier_read_spans_kernel(const int32_t* __restrict__ pos,
                  const int64_t* __restrict__ cig_off,
                  const uint32_t* __restrict__ cigar, int n, unsigned ins_ops,
                  unsigned skip_ops, const int32_t* __restrict__ vpos, int mp,
                  uint8_t* __restrict__ flags) {
  __shared__ __align__(16) BlockTable bt;
  int i = blockIdx.x * kThreads + threadIdx.x;
  int f = 0, first = 0x7fffffff, last = (int)0x80000000;
  bool live = false;
  if (i < n) {
    long long total = 0;
    unsigned seen = 0;
    for (long long c = __ldg(cig_off + i); c < __ldg(cig_off + i + 1); ++c) {
      uint32_t w = __ldg(cigar + c);
      total += w >> 4;
      seen |= 1u << (w & 0xF);
    }
    f = ((seen & ins_ops) ? 1 : 0) | ((seen & skip_ops) ? 2 : 0);
    long long lo = (long long)__ldg(pos + i) + 1, hi = lo - 1 + total;
    // table positions lie in [1, INT32_MAX - 1]: INT32_MAX pads the table
    lo = lo > 1 ? lo : 1;
    hi = hi < 0x7ffffffe ? hi : 0x7ffffffe;
    live = lo <= hi;
    if (live) {
      first = (int)lo;
      last = (int)hi;
    }
  }
  int k_lo, n_slice;
  bool staged;
  // block_slice stages four columns; the span pass needs the positions
  // alone, so all four are vpos
  if (block_slice(bt, first, last, vpos, vpos, vpos, vpos, mp, &k_lo,
                  &n_slice, &staged) && live) {
    int k = staged ? lower_bound<false>(bt.sv, n_slice, first)
                   : lower_bound<true>(vpos, mp, first);
    int at = staged ? (k < n_slice ? bt.sv[k] : 0x7fffffff)
                    : (k < mp ? __ldg(vpos + k) : 0x7fffffff);
    if (at <= last) f |= 4;
  }
  if (i < n) flags[i] = (uint8_t)f;
}

// Copies of the two tile kernels' bodies (csrc/alleles.cu ragged_join_kernel
// and read_spans_kernel) with the parts that the ops, grid and bounds
// variants change: kStageOps picks where a row's ops come from (false: the
// join reads them from device memory; true: the span pass stages its
// warp's op run in shared memory, VSpanTile's ops), and the tiles are
// walked in a loop, so that a grid of one wave serves (a grid of one block
// a tile runs the loop once, as the kernels run).
constexpr int kVSpanOps = 256;  // words a span warp stages

struct VSpanTile {
  int32_t sk[kSliceSkel];
  uint32_t ops[kThreads / 32][kVSpanOps];
};
constexpr size_t kVSpanSmem = offsetof(VSpanTile, ops);

template <bool kStageOps>
__device__ __forceinline__ void v_ragged_join_body(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ cig_off,
    const uint32_t* __restrict__ cigar, const int32_t* __restrict__ seq_off,
    const uint8_t* __restrict__ seq, const uint8_t* __restrict__ qual,
    int n_rows, int baseq, OpClasses cls, const int32_t* __restrict__ vpos,
    const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
    const int32_t* __restrict__ ni, int mp, int seg, int n_sk,
    int32_t* __restrict__ out, int cap) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  JoinTile& sm = *reinterpret_cast<JoinTile*>(tile_smem);
  stage_skeleton(sm.sk, vpos, n_sk, seg);
  const int n_tiles = (n_rows + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kThreads, row = r0 + threadIdx.x;
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
    __syncthreads();  // the last tile's rows are done with the stage
    if (threadIdx.x == 0) sm.n_hits = 0;
    int n_staged = 0, shift = 0;
    if (kStageOps)
      shift = stage_run(sm.ops, sizeof(sm.ops), cigar + c_lo, c_hi - c_lo,
                        &n_staged, threadIdx.x, kThreads);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const uint32_t* ops =
        row_ops(sm.ops + shift, n_staged, cigar, c_lo, c0, c1);
    const int n_ops = c1 - c0;
    // the row's aligned range: the first base of its first aligned op to
    // the last base of its last one
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
      continue;
    if (live && staged) {
      ragged_row<false>(row, first, last, ops, n_ops, r_start, seq + s0,
                        qual + s0, n_bases, baseq, cls, sm.sv, sm.s0, sm.s1,
                        sm.sn, n_slice, k_lo, sm, out, cap);
    } else if (live) {
      ragged_row<true>(row, first, last, ops, n_ops, r_start, seq + s0,
                       qual + s0, n_bases, baseq, cls, vpos + k_lo,
                       a0 + k_lo, a1 + k_lo, ni + k_lo, n_slice, k_lo, sm,
                       out, cap);
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
}

#define RAGGED_JOIN_PARAMS                                                   \
  const int32_t *__restrict__ pos, const int32_t *__restrict__ cig_off,      \
      const uint32_t *__restrict__ cigar,                                    \
      const int32_t *__restrict__ seq_off, const uint8_t *__restrict__ seq,  \
      const uint8_t *__restrict__ qual, int n_rows, int baseq,               \
      OpClasses cls, const int32_t *__restrict__ vpos,                       \
      const int32_t *__restrict__ a0, const int32_t *__restrict__ a1,        \
      const int32_t *__restrict__ ni, int mp, int seg, int n_sk,             \
      int32_t *__restrict__ out, int cap
#define RAGGED_JOIN_ARGS                                                     \
  pos, cig_off, cigar, seq_off, seq, qual, n_rows, baseq, cls, vpos, a0, a1, \
      ni, mp, seg, n_sk, out, cap

template <bool kStageOps>
__device__ __forceinline__ void v_read_spans_body(
    const int32_t* __restrict__ pos, const int64_t* __restrict__ cig_off,
    const uint32_t* __restrict__ cigar, int n, unsigned ins_ops,
    unsigned skip_ops, const int32_t* __restrict__ vpos, int mp, int seg,
    int n_sk, uint8_t* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  VSpanTile& sm = *reinterpret_cast<VSpanTile*>(tile_smem);
  stage_skeleton(sm.sk, vpos, n_sk, seg);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* wops = sm.ops[warp];
  const int n_tiles = (int)(((long long)n + kSpanTile - 1) / kSpanTile);
  for (int tile = blockIdx.x * kWarps + warp; tile < n_tiles;
       tile += gridDim.x * kWarps) {
    const int r0 = tile * kSpanTile;
    const int rows = n - r0 < kSpanTile ? n - r0 : kSpanTile;
    const int mine = r0 + kSpanRowsPerLane * lane;  // the lane's first read
    // every load at once: the lane's reads' offsets and positions (and, to
    // stage the op run, its two ends: the same two words for every lane)
    const long long c_lo = kStageOps ? __ldg(cig_off + r0) : 0,
                    c_hi = kStageOps ? __ldg(cig_off + r0 + rows) : 0;
    long long off[kSpanRowsPerLane + 1];
    int p[kSpanRowsPerLane];
#pragma unroll
    for (int j = 0; j <= kSpanRowsPerLane; ++j)
      off[j] = mine + j <= n ? __ldg(cig_off + mine + j) : 0;
#pragma unroll
    for (int j = 0; j < kSpanRowsPerLane; ++j)
      p[j] = mine + j < n ? __ldg(pos + mine + j) : 0;
    int n_staged = 0, ops_at = 0;
    if (kStageOps) {
      __syncwarp();  // the warp's last tile is done with its stage
      ops_at = stage_run(wops, sizeof(sm.ops[0]), cigar + c_lo, c_hi - c_lo,
                         &n_staged, lane, 32);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
    }
    // the first op of each of the lane's reads at once (most reads have
    // one op: one latency for the four), the rest in each read's walk
    uint32_t op0[kSpanRowsPerLane];
#pragma unroll
    for (int j = 0; j < kSpanRowsPerLane; ++j)
      op0[j] = mine + j < n && off[j + 1] > off[j]
                   ? (kStageOps ? *row_ops(wops + ops_at, n_staged, cigar,
                                           c_lo, off[j], off[j + 1])
                                : __ldg(cigar + off[j]))
                   : 0;
    int first[kSpanRowsPerLane], last[kSpanRowsPerLane];
    unsigned f = 0;  // a byte of flags a read
    int mn = 0x7fffffff, mx = (int)0x80000000;
#pragma unroll
    for (int j = 0; j < kSpanRowsPerLane; ++j) {
      first[j] = 0x7fffffff;
      last[j] = (int)0x80000000;
      if (mine + j >= n) continue;
      const uint32_t* ops =
          kStageOps ? row_ops(wops + ops_at, n_staged, cigar, c_lo, off[j],
                              off[j + 1])
                    : cigar + off[j];
      const long long n_ops = off[j + 1] - off[j];
      long long total = op0[j] >> 4;
      unsigned seen = n_ops > 0 ? 1u << (op0[j] & 0xF) : 0u;
      for (long long c = 1; c < n_ops; ++c) {
        uint32_t w = ops[c];
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
}

#define READ_SPANS_PARAMS                                                  \
  const int32_t *__restrict__ pos, const int64_t *__restrict__ cig_off,    \
      const uint32_t *__restrict__ cigar, int n, unsigned ins_ops,         \
      unsigned skip_ops, const int32_t *__restrict__ vpos, int mp,         \
      int seg, int n_sk, uint8_t *__restrict__ flags
#define READ_SPANS_ARGS \
  pos, cig_off, cigar, n, ins_ops, skip_ops, vpos, mp, seg, n_sk, flags

__global__ void __launch_bounds__(kThreads, kJoinBlocksPerSm)
v_global_ops_join(RAGGED_JOIN_PARAMS) {
  v_ragged_join_body<false>(RAGGED_JOIN_ARGS);
}
__global__ void __launch_bounds__(kThreads, kJoinBlocksPerSm)
v_grid_join(RAGGED_JOIN_PARAMS) {
  v_ragged_join_body<true>(RAGGED_JOIN_ARGS);
}
__global__ void __launch_bounds__(kThreads)
v_bounds_join(RAGGED_JOIN_PARAMS) {
  v_ragged_join_body<true>(RAGGED_JOIN_ARGS);
}
__global__ void __launch_bounds__(kThreads, kSpanBlocksPerSm)
v_staged_ops_spans(READ_SPANS_PARAMS) {
  v_read_spans_body<true>(READ_SPANS_ARGS);
}
__global__ void __launch_bounds__(kThreads, kSpanBlocksPerSm)
v_grid_spans(READ_SPANS_PARAMS) {
  v_read_spans_body<false>(READ_SPANS_ARGS);
}
__global__ void __launch_bounds__(kThreads, 8)
v_bounds_spans(READ_SPANS_PARAMS) {
  v_read_spans_body<false>(READ_SPANS_ARGS);
}

template <class Kernel>
int per_sm_of(Kernel kernel, size_t smem) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return n > 0 ? n : 1;
}

int sms_of() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// blocks an SM of each variant's kernel (0-3), for the join (which 0) and
// the span pass (which 1); asked once
int v_per_sm(int variant, int which) {
  static int cache[2][4];
  int& c = cache[which][variant];
  if (c == 0) {
    if (which == 0) {
      c = variant == 0   ? per_sm_of(earlier_ragged_join_kernel, 0)
          : variant == 1 ? per_sm_of(v_global_ops_join, sizeof(JoinTile))
          : variant == 2 ? per_sm_of(v_grid_join, sizeof(JoinTile))
                         : per_sm_of(v_bounds_join, sizeof(JoinTile));
    } else {
      c = variant == 0   ? per_sm_of(earlier_read_spans_kernel, 0)
          : variant == 1 ? per_sm_of(v_staged_ops_spans, sizeof(VSpanTile))
          : variant == 2 ? per_sm_of(v_grid_spans, kVSpanSmem)
                         : per_sm_of(v_bounds_spans, kVSpanSmem);
    }
  }
  return c;
}

// the grid each variant runs over `blocks` blocks of work: every block,
// but variant 2's one wave of them (whose blocks walk the tiles)
unsigned v_grid(long long blocks, int variant, int which) {
  static int sms = 0;
  if (sms == 0) sms = sms_of();
  if (variant != 2) return (unsigned)blocks;
  long long w = (long long)v_per_sm(variant, which) * sms;
  return (unsigned)(blocks < w ? blocks : w);
}

}  // namespace

extern "C" {

int v_blocks_per_sm(int variant, int which) {
  if (variant < 0 || variant > 3 || which < 0 || which > 1) return -1;
  return v_per_sm(variant, which);
}

int v_ragged_join_launch(int variant, const void* pos, const void* cig_off,
                         const void* cigar, const void* seq_off,
                         const void* seq, const void* qual, int n_rows,
                         int baseq, int aligned_ops, int ref_ops,
                         int query_ops, const void* vpos, const void* a0,
                         const void* a1, const void* ni, int mp, void* out,
                         int cap, void* stream) {
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t init = init_packed(out, cap, s);
  if (init != cudaSuccess) return (int)init;
  if (n_rows > 0) {
    OpClasses cls{(unsigned)aligned_ops, (unsigned)ref_ops,
                  (unsigned)query_ops};
    long long tiles = ((long long)n_rows + kThreads - 1) / kThreads;
    unsigned grid = v_grid(tiles, variant, 0);
    if (variant == 0) {
      earlier_ragged_join_kernel<<<grid, kThreads, 0, s>>>(
          (const int32_t*)pos, (const int32_t*)cig_off,
          (const uint32_t*)cigar, (const int32_t*)seq_off,
          (const uint8_t*)seq, (const uint8_t*)qual, n_rows, baseq, cls,
          (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
          (const int32_t*)ni, mp, (int32_t*)out, cap);
    } else {
      int seg = slice_seg(mp);
      auto kernel = variant == 1   ? v_global_ops_join
                    : variant == 2 ? v_grid_join
                                   : v_bounds_join;
      kernel<<<grid, kThreads, sizeof(JoinTile), s>>>(
          (const int32_t*)pos, (const int32_t*)cig_off,
          (const uint32_t*)cigar, (const int32_t*)seq_off,
          (const uint8_t*)seq, (const uint8_t*)qual, n_rows, baseq, cls,
          (const int32_t*)vpos, (const int32_t*)a0, (const int32_t*)a1,
          (const int32_t*)ni, mp, seg, (mp + seg - 1) / seg, (int32_t*)out,
          cap);
    }
  }
  return (int)cudaGetLastError();
}

int v_read_spans_launch(int variant, const void* pos, const void* cig_off,
                        const void* cigar, int n, int ins_ops, int skip_ops,
                        const void* vpos, int mp, void* flags,
                        void* stream) {
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    // earlier: a block a 256-read tile; now: a warp a 128-read tile
    long long rows = variant == 0 ? kThreads : kSpanTile * (kThreads / 32);
    unsigned grid = v_grid(((long long)n + rows - 1) / rows, variant, 1);
    cudaStream_t s = (cudaStream_t)stream;
    if (variant == 0) {
      earlier_read_spans_kernel<<<grid, kThreads, 0, s>>>(
          (const int32_t*)pos, (const int64_t*)cig_off,
          (const uint32_t*)cigar, n, (unsigned)ins_ops, (unsigned)skip_ops,
          (const int32_t*)vpos, mp, (uint8_t*)flags);
    } else {
      int seg = slice_seg(mp);
      auto kernel = variant == 1   ? v_staged_ops_spans
                    : variant == 2 ? v_grid_spans
                                   : v_bounds_spans;
      kernel<<<grid, kThreads, variant == 1 ? sizeof(VSpanTile) : kVSpanSmem,
               s>>>(
          (const int32_t*)pos, (const int64_t*)cig_off,
          (const uint32_t*)cigar, n, (unsigned)ins_ops, (unsigned)skip_ops,
          (const int32_t*)vpos, mp, seg, (mp + seg - 1) / seg,
          (uint8_t*)flags);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
'''
RAGGED_VARIANTS = ("earlier", "ops", "grid", "bounds")
SECTIONS = ("band_counts", "tail", "binom", "ragged")
BINOM_INPUTS = ("e2e", "chromosome", "long", "one_live", "live_%d" % 873)
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
TAIL_ARGTYPES = [_P, _P, _I, _I, _D, _D, _P, _I, _P, _I] + [_P] * 5
E2E_CONTIG = dict(seed=77, contigs=("chr1",), contig_len=[3_600_000],
                  n_variants_per_contig=[7_500],
                  n_reads_per_contig=[300_000], error_rate=0.01)
LIVE_PACKED = 873        # live elements packed into four blocks


def _build(work: str, sections) -> dict:
    """{name: CDLL}: the ablation source (the first port's kernel, the
    cooperative tail, an empty kernel), csrc/mesh.cu once a VARIANTS entry,
    and csrc/stats.cu and STATS_SOURCE once a STATS_VARIANTS entry (the
    sections that need them), one nvcc each, all started together;
    registers and spills printed."""
    from ..utils import build
    stats = os.path.join(build.CSRC, "stats.cu")
    src = os.path.join(work, "ablation.cu")
    with open(src, "w") as fh:
        fh.write(SOURCE % {"stats": stats})
    jobs = {"ablation": (src, [])}
    if "band_counts" in sections:
        for name, defines in VARIANTS.items():
            jobs[name] = (os.path.join(build.CSRC, "mesh.cu"), defines)
    if "ragged" in sections:
        rsrc = os.path.join(work, "ragged_variants.cu")
        with open(rsrc, "w") as fh:
            fh.write(RAGGED_SOURCE % {
                "alleles": os.path.join(build.CSRC, "alleles.cu")})
        jobs["ragged"] = (rsrc, [])
    if "binom" in sections:
        vsrc = os.path.join(work, "stats_variants.cu")
        with open(vsrc, "w") as fh:
            fh.write(STATS_SOURCE % {"stats": stats})
        for name, defines in STATS_VARIANTS.items():
            jobs[name] = (stats, []) if defines is None else (vsrc, defines)
    procs = {}
    for name, (path, defines) in jobs.items():
        cmd = [build.find_nvcc()] + build.NVCC_FLAGS + defines + [
            "-Xptxas", "-v", "-shared", path, "-o",
            os.path.join(work, "lib%s.so" % name)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, out))
        kernel = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            if "registers" in line or "spill" in line and " 0 bytes spill" \
                    not in line:
                print("   ptxas [%s] %s: %s" % (name, (kernel or "")[:60],
                                              line.strip()))
        libs[name] = ctypes.CDLL(os.path.join(work, "lib%s.so" % name))
    return libs


def _sass_counts(lib_path: str, fn_part: str, ops) -> dict:
    """Counts of the instructions `ops` in the SASS of the functions whose
    names hold fn_part."""
    from ..utils import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True)
    if res.returncode != 0:
        return {"error": res.stderr[-500:]}
    out, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and fn_part in fn:
            for op in ops:
                if re.search(r"\b" + re.escape(op) + r"\b", line):
                    key = op.rstrip(".")
                    out[key] = out.get(key, 0) + 1
    return out


def _sass_atomics(lib_path: str) -> dict:
    """RED / ATOM instruction counts in band_counts_kernel's SASS."""
    return _sass_counts(lib_path, "band_counts_kernel",
                        ("REDG", "RED.", "ATOMG", "ATOMS", "ATOM."))


def _time(fn, iters):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _in_turns(fns: dict, iters: int) -> dict:
    """Every function timed, then again in reverse order; the mean."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(_time(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def _on_card(fns: dict, iters: int) -> dict:
    """{name: (card ms, device activities, whole)} a call, by the profiler
    (utils/trace.device_activity), in two passes (the second in reverse
    order): the mean card ms, whole only if both windows were."""
    from ..utils.trace import device_activity
    passes = [{}, {}]
    for seen, order in zip(passes, (list(fns), list(fns)[::-1])):
        for k in order:
            seen[k] = device_activity(fns[k], iters, log=lambda line, k=k:
                                      print("   %s: %s" % (k, line),
                                            flush=True))
    out = {}
    for k in fns:
        a, b = passes[0][k], passes[1][k]
        out[k] = a or b if a is None or b is None else \
            ((a[0] + b[0]) / 2, a[1], a[2] and b[2])
    return out


_fixtures: dict = {}


def _chromosome_reads(n_reads: int, n_vars: int, work: str):
    """Smoke phase 3's fixture: benchdata's n_reads reads (BamData) and
    its n_vars-het table, generated once a process."""
    key = (n_reads, n_vars)
    if key not in _fixtures:
        from ..engine.varmap import build_variant_table
        from ..io import bam as bamio
        from . import benchdata
        contig_len = 200_000_000
        bam = os.path.join(work, "chrscale.bam")
        benchdata.generate_bam(bam, n_reads=n_reads, contig_len=contig_len)
        vt = build_variant_table("chr1", benchdata.generate_variants(
            n_vars, contig_len))
        bd = bamio.read_bam(bam)
        os.remove(bam)
        _fixtures[key] = (bd, vt)
    return _fixtures[key]


def _chromosome_input(n_reads: int, n_rows: int, n_vars: int, work: str):
    """Smoke phase 3's step input: the first n_rows of benchdata's n_reads
    reads as (codes, quals, refpos) planes, and its het table."""
    from ..dist.multihost import table_arrays
    from ..kernels.alleles import pack_reads
    bd, vt = _chromosome_reads(n_reads, n_vars, work)
    return pack_reads(bd, rows=np.arange(min(n_rows, len(bd)))) + \
        table_arrays(vt)


def _e2e_input(work: str):
    """Smoke phase 6's first contig as the step's input: datagen's chr1 at
    chip_smoke.e2e_phase's shape (seed 77, 300,000 read pairs over 3.6 Mbp,
    7,500 variants; generated alone, so the same genome and variants with
    other reads), its first 262,144 rows and its het table."""
    from ..dist import multihost
    from ..io import bam as bamio
    from ..kernels.alleles import pack_reads
    from . import datagen
    d = os.path.join(work, "e2e")
    os.makedirs(d)
    vcf, bam, data = datagen.write_fixture_dir(d, **E2E_CONTIG)
    bd = bamio.read_bam(bam)
    return pack_reads(bd, rows=np.flatnonzero(bd.refid == 0)[:1 << 18]) + \
        multihost.device_table(vcf, data.sample, "")


def _binom_section(args, libs, work: str, smi: str, chromosome) -> dict:
    """binom_cdf and the tail's test body, part by part (STATS_VARIANTS),
    on three inputs: phase 6's first contig (_e2e_input) and phase 3's
    reads (the connection tests of the step's merged band, 56,960 and
    800,000 of them; for binom_cdf the float64 operands the earlier wrapper
    made), and the long fractions of layouts.binom_long (binom_cdf) and
    layouts.band_long (the tail); then the live elements of phase 6's
    contig alone (the one with the most terms; LIVE_PACKED of them in
    four blocks).  Beside them an empty kernel on each grid (the launch
    floor) and, on the step's inputs, conflicting_config_p's route as the
    earlier design built it and as it is.  Every variant is held against
    the plain version (p within 1e-12; the tail's prune equal wherever |p
    - threshold| > 1e-12); calls timed by CUDA events in turns, card times
    from whole profiler windows."""
    import torch
    from ..dist import mesh as TM
    from ..kernels import alleles as K
    from ..kernels import stats as S
    from ..utils import build
    from . import layouts

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    main_lib = build.get_lib()
    main_lib.empty_grid_launch.argtypes = [_I, _P]
    cdf_fn, tail_fn = {}, {}     # each build's two launchers
    for v, defines in STATS_VARIANTS.items():
        names = ("binom_cdf_launch", "band_prune_launch") if defines is None \
            else ("variant_binom_launch", "variant_band_prune_launch")
        cdf_fn[v], tail_fn[v] = (getattr(libs[v], f) for f in names)
        cdf_fn[v].argtypes = S.BINOM_ARGTYPES
        tail_fn[v].argtypes = TAIL_ARGTYPES
    table = S.lgamma_table(dev)
    out = {"lgamma_table_mismatches": S.lgamma_table_mismatches(dev),
           "inputs": {}, "sass": {}}
    if args.sass_out:
        from ..utils import build as B
        tool = os.path.join(os.path.dirname(B.find_nvcc()), "cuobjdump")
        res = subprocess.run([tool, "-sass", os.path.join(
            work, "libdefault.so")], capture_output=True, text=True)
        keep = False
        with open(args.sass_out, "w") as fh:
            for line in res.stdout.splitlines():
                if "Function :" in line:
                    keep = SASS_BINOM["default"] in line
                if keep:
                    fh.write(line + "\n")
    for v, defines in STATS_VARIANTS.items():
        fn = SASS_BINOM["default" if defines is None else "variant"]
        out["sass"][v] = _sass_counts(os.path.join(work, "lib%s.so" % v),
                                      fn, SASS_OPS)
        print("   SASS of %s in %s: %s" % (fn, v, out["sass"][v]),
              flush=True)
    print("   lgamma table: %d entries, %d replaced by the kernels' lgamma"
          % (table.numel(), out["lgamma_table_mismatches"]), flush=True)
    thr, band = 0.01, 8

    def step_band(arrs):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
        vidx, allele = K.assign_alleles_device(*t, 10)
        return TM.band_counts(vidx, allele, len(arrs[3]), band)

    want_in = set(args.binom_inputs)
    bands = {}
    if want_in & {"e2e", "one_live", "live_%d" % LIVE_PACKED}:
        bands["e2e"] = step_band(_e2e_input(work))
    if "chromosome" in want_in:
        bands["chromosome"] = step_band(chromosome)
    if "long" in want_in:
        lc, lp = layouts.band_long(8192, band, seed=0)
        bands["long"] = (torch.from_numpy(lc).to(dev),
                         torch.from_numpy(lp).to(dev))
    cdf_in = {}
    for name in set(bands) - {"long"}:
        cfg = S.band_configs(bands[name][1])
        noise = S.noise_from_counts(bands[name][0])
        sup, total, ps = S._conflict_args(*cfg, noise)
        cdf_in[name] = tuple(t.contiguous() for t in torch.broadcast_tensors(
            sup, total, ps)) + ((cfg, noise),)
    if "long" in want_in:
        k, n, p = (torch.from_numpy(x).to(dev) for x in layouts.binom_long(
            65_536, seed=0))
        cdf_in["long"] = (k.double(), n.double(), p, None)
    if "e2e" in bands:
        kf, nf, pf = (t.reshape(-1) for t in cdf_in["e2e"][:3])
        terms = S.binom_cdf_terms(kf, nf, pf)
        live = torch.nonzero(terms > 0).flatten()
        one = int(torch.argmax(terms))
        packed = live.repeat(LIVE_PACKED // max(len(live), 1) +
                             1)[:LIVE_PACKED]
        cdf_in["one_live"] = (kf[one:one + 1], nf[one:one + 1],
                              pf[one:one + 1], None)
        cdf_in["live_%d" % LIVE_PACKED] = (kf[packed], nf[packed],
                                           pf[packed], None)

    for name in [x for x in BINOM_INPUTS if x in want_in]:
        kf, nf, pf, route = cdf_in[name]
        want = S.binom_cdf_plain(kf, nf, pf)
        terms = S.binom_cdf_terms(kf, nf, pf)
        count = want.numel()
        fns, outs = {}, {}
        for v in STATS_VARIANTS:
            a, o, keep = S.binom_launch_args(kf, nf, pf, dev)

            def fn(v=v, a=a, keep=keep):
                err = cdf_fn[v](*a)
                if err:
                    raise RuntimeError("%s binom_cdf: CUDA error %d"
                                       % (v, err))
            fns["binom/" + v], outs[v] = fn, o
        fns["empty_grid"] = lambda count=count: main_lib.empty_grid_launch(
            count, stream)
        if route is not None:
            cfg, noise = route

            def earlier_route(cfg=cfg, noise=noise):
                sup, total, ps = S._conflict_args(*cfg, noise)
                ops = [t.contiguous() for t in torch.broadcast_tensors(
                    sup, total, ps)]
                args_, o, keep = S.binom_launch_args(*ops, dev)
                cdf_fn["earlier"](*args_)
                o = torch.where(total - sup > 0, o, 1.0)
                return torch.where(sup == 0, 0.0, o)
            fns["route_earlier"] = earlier_route
            fns["route_now"] = lambda cfg=cfg, noise=noise: \
                S.conflicting_config_p(*cfg, noise)
            route_want = S.conflict_terms(*cfg, noise)[0]
            for r in ("route_earlier", "route_now"):
                gap = float((fns[r]() - route_want).abs().max())
                if gap > 1e-12:
                    raise RuntimeError("%s differs from the plain conflict "
                                       "test on %s by %g" % (r, name, gap))
        for v in STATS_VARIANTS:
            fns["binom/" + v]()
        torch.cuda.synchronize()
        gaps = {v: float((outs[v] - want).abs().max()) for v in outs}
        if max(gaps.values()) > 1e-12:
            raise RuntimeError("a binom_cdf variant differs from the plain "
                               "version on %s: %s" % (name, gaps))
        if name in bands:
            counts, pair = bands[name]
            twant = S.band_prune_plain(counts, pair, thr)
            c_terms = S.conflict_terms(*S.band_configs(pair),
                                       S.noise_from_counts(counts))[1]
            M = counts.shape[0]
            partials = torch.empty(2 * S.NOISE_PARTIALS, dtype=torch.int64,
                                   device=dev)
            nl = ctypes.c_int(0)
            for v in STATS_VARIANTS:
                res = [torch.empty((M, band), dtype=dt, device=dev)
                       for dt in (torch.float64, torch.bool, torch.bool)]

                def tail(v=v, res=res):
                    err = tail_fn[v](
                        counts.data_ptr(), pair.data_ptr(), M, band, thr,
                        1e-3, partials.data_ptr(), S.NOISE_PARTIALS,
                        table.data_ptr(), table.numel(), res[0].data_ptr(),
                        res[1].data_ptr(), res[2].data_ptr(),
                        ctypes.addressof(nl), stream)
                    if err:
                        raise RuntimeError("%s band_prune: CUDA error %d"
                                           % (v, err))
                tail()
                torch.cuda.synchronize()
                sure = (twant[0] - thr).abs() > 1e-12
                gap = float((res[0] - twant[0]).abs().max())
                if gap > 1e-12 or not torch.equal(res[1][sure],
                                                  twant[1][sure]):
                    raise RuntimeError("%s band_prune differs from the plain "
                                       "tail on %s (p gap %g)" % (v, name,
                                                                  gap))
                fns["tail/" + v] = tail
            fns["tail_empty_grid"] = lambda count=M * band: \
                main_lib.empty_grid_launch(count, stream)
        ms = _in_turns(fns, args.iters)
        card = _on_card(fns, args.iters)
        res = {"elements": count, "live": int((terms > 0).sum()),
               "terms": int(terms.sum()), "max_terms": int(terms.max()),
               "ms": ms, "card_ms_activities_whole": card,
               "gaps": gaps}
        if name in bands:
            res.update(tail_pairs=int(c_terms.numel()),
                       tail_live=int((c_terms > 0).sum()),
                       tail_terms=int(c_terms.sum()))
        out["inputs"][name] = res
        print("[binom %s] %d elements, %d live, %d fraction terms (max %d)%s"
              % (name, count, res["live"], res["terms"], res["max_terms"],
                 "; the tail: %d pairs, %d live, %d terms"
                 % (res["tail_pairs"], res["tail_live"], res["tail_terms"])
                 if name in bands else ""), flush=True)
        for f in fns:
            c = card[f]
            print("[binom %s] %-34s call %.4f ms (CUDA events); on the card "
                  "%s; on %s" % (name, f, ms[f], c and "%.5f ms in %g device "
                                 "activities a call (%s)" % (
                                     c[0], c[1],
                                     "whole" if c[2] else "not whole"), smi),
                  flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--vars", type=int, default=100_000)
    ap.add_argument("--reads", type=int, default=5_000_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated, of %s" % ", ".join(SECTIONS))
    ap.add_argument("--binom-inputs", default=",".join(BINOM_INPUTS),
                    help="comma-separated, of %s" % ", ".join(BINOM_INPUTS))
    ap.add_argument("--sass-out", default=None,
                    help="write the default build's binom_cdf SASS here")
    args = ap.parse_args(argv)
    args.binom_inputs = [x for x in args.binom_inputs.split(",") if x]
    args.sections = [x for x in args.sections.split(",") if x]
    if not set(args.sections) <= set(SECTIONS):
        ap.error("--sections takes %s" % ", ".join(SECTIONS))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step_kernels_ablation needs a CUDA GPU")
    from ..utils import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card: %s" % smi, flush=True)
    with tempfile.TemporaryDirectory(prefix="ablation_",
                                     dir=build.build_dir()) as work:
        record = _run(args, work, smi)
    print(json.dumps(record))
    return 0


def _run(args, work: str, smi: str) -> dict:
    import torch
    from ..dist import mesh as TM
    from ..dist.scaling_bench import _gen
    from ..kernels import alleles as K
    from ..kernels import stats as S
    from ..utils import build
    from . import layouts

    dev = torch.device("cuda")
    build.get_lib()
    record = {"card": smi}
    if "band_counts" in args.sections:
        sass = _sass_atomics(build.LIB_PATH)
        print("band_counts_kernel SASS atomics: %s" % sass, flush=True)
        record["sass_band_counts_kernel"] = sass
    libs = _build(work, args.sections)
    lib = libs["ablation"]
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ablation_launch.argtypes = [I, P, P, I, I, I, I, P, P, P, P]
    lib.coop_launch.argtypes = [P, P, I, I, D, D, P, I, P, I, P, P, P, P]
    lib.coop_blocks.argtypes = [I]
    lib.band_prune_launch.argtypes = TAIL_ARGTYPES
    for name in VARIANTS:
        if name in libs:
            libs[name].band_counts_launch.argtypes = [P] * 2 + [I] * 4 + \
                [P] * 5
    stream = torch.cuda.current_stream(dev).cuda_stream
    band = 8
    wb = torch.zeros(1, dtype=torch.int32, device=dev)
    nb = ctypes.c_int(0)

    chromosome = None
    if "band_counts" in args.sections or "binom" in args.sections and \
            "chromosome" in args.binom_inputs:
        chromosome = _chromosome_input(args.reads, args.rows, args.vars,
                                       work)
    inputs = {}
    if "band_counts" in args.sections:
        gen = _gen(args.rows, 128, args.vars)
        order = np.argsort(gen[2][:, 0], kind="stable")
        inputs = {"chromosome": chromosome, "dense": gen,
                  "dense_sorted": tuple(a[order] for a in gen[:3]) + gen[3:]}
        record["band_counts"] = {}
    for name, arrs in inputs.items():
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
        vidx, allele = K.assign_alleles_device(*t, 10)
        N, L = vidx.shape
        M = len(arrs[3])
        want = TM.band_counts_plain(vidx, allele, M, band)
        counts = torch.empty((M, 3), dtype=torch.int32, device=dev)
        pair = torch.empty((M, band, 9), dtype=torch.int32, device=dev)
        sink = torch.empty(132 * 16 * 256, dtype=torch.int32, device=dev)

        def mode_fn(mode):
            def fn():
                err = lib.ablation_launch(mode, vidx.data_ptr(),
                                          allele.data_ptr(), N, L, M, band,
                                          counts.data_ptr(), pair.data_ptr(),
                                          sink.data_ptr(), stream)
                if err:
                    raise RuntimeError("ablation mode %d: CUDA error %d"
                                       % (mode, err))
            return fn

        def variant_fn(name):
            def fn():
                err = libs[name].band_counts_launch(
                    vidx.data_ptr(), allele.data_ptr(), N, L, M, band,
                    counts.data_ptr(), pair.data_ptr(), wb.data_ptr(),
                    ctypes.addressof(nb), stream)
                if err:
                    raise RuntimeError("%s: CUDA error %d" % (name, err))
            return fn
        fns = {"pr8_mode%d" % m: mode_fn(m) for m in ABLATIONS}
        fns["current"] = lambda: TM.band_counts(vidx, allele, M, band)
        fns.update({v: variant_fn(v) for v in VARIANTS})
        for k in ["pr8_mode%d" % m for m in EXACT] + list(VARIANTS):
            fns[k]()
            torch.cuda.synchronize()
            if not (torch.equal(counts, want[0]) and
                    torch.equal(pair, want[1])):
                raise RuntimeError("%s differs from the plain version on %s"
                                   % (k, name))
        TM.reset_launches()
        got = TM.band_counts(vidx, allele, M, band)
        st = TM.read_stats()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise RuntimeError("band_counts differs from the plain version "
                               "on %s" % name)
        ms = _in_turns(fns, args.iters)
        card = _on_card(fns, args.iters)
        hits = int((allele < 3).sum())
        res = {"ms": ms, "card_ms_activities_whole": card, "hits": hits,
               "band_pairs": int(want[1].sum()), "rows": N, "variants": M,
               "blocks": st["blocks"], "window_blocks": st["window_blocks"]}
        record["band_counts"][name] = res
        for k, v in ms.items():
            what = ABLATIONS[int(k[-1])] if k.startswith("pr8") else \
                "current band_counts kernel" if k == "current" else \
                "current kernel, variant %s" % k
            print("[%s] %-14s call %.4f ms; on the card %s   %s   on %s"
                  % (name, k, v, card[k] and "%.4f ms (%s)" % (
                      card[k][0], "whole" if card[k][2] else "not whole"),
                     what, smi), flush=True)
        print("[%s] %d x %d, M %d: %d hits, %d band pairs; current kernel: "
              "%d blocks, %d in the shared-memory window"
              % (name, N, L, M, hits, res["band_pairs"], st["blocks"],
                 st["window_blocks"]), flush=True)
        del vidx, allele, want, counts, pair, got, t

    if "tail" in args.sections:
        record["tail"] = {}
    for m in ((7120, args.vars) if "tail" in args.sections else ()):
        c_np, p_np = layouts.band_tail(m, band, seed=m)
        counts = torch.from_numpy(c_np).to(dev)
        pair = torch.from_numpy(p_np).to(dev)
        thr = 0.01
        want = S.band_prune_plain(counts, pair, thr)
        got = S.band_prune(counts, pair, thr)
        partials = torch.empty(2 * 4096, dtype=torch.int64, device=dev)
        pc = torch.empty((m, band), dtype=torch.float64, device=dev)
        prc = torch.empty((m, band), dtype=torch.bool, device=dev)
        unc = torch.empty((m, band), dtype=torch.bool, device=dev)
        table = S.lgamma_table(dev)
        blocks = lib.coop_blocks(m * band)
        if 2 * blocks > partials.numel():
            raise RuntimeError("%d cooperative blocks" % blocks)

        def coop():
            err = lib.coop_launch(counts.data_ptr(), pair.data_ptr(), m, band,
                                  thr, 1e-3, partials.data_ptr(), blocks,
                                  table.data_ptr(), table.numel(),
                                  pc.data_ptr(), prc.data_ptr(),
                                  unc.data_ptr(), stream)
            if err:
                raise RuntimeError("cooperative launch: CUDA error %d" % err)
        coop()
        torch.cuda.synchronize()
        for name, out in (("band_prune", got), ("cooperative",
                                                (pc, prc, unc))):
            gap = float((out[0] - want[0]).abs().max())
            if gap > 1e-12 or not (torch.equal(out[1], want[1]) and
                                   torch.equal(out[2], want[2])):
                raise RuntimeError("%s differs from the three-call tail at "
                                   "M %d (p gap %g)" % (name, m, gap))
        launches = ctypes.c_int(0)

        def two_launches():
            err = lib.band_prune_launch(
                counts.data_ptr(), pair.data_ptr(), m, band, thr, 1e-3,
                partials.data_ptr(), S.NOISE_PARTIALS, table.data_ptr(),
                table.numel(), pc.data_ptr(), prc.data_ptr(), unc.data_ptr(),
                ctypes.addressof(launches), stream)
            if err:
                raise RuntimeError("band_prune_launch: CUDA error %d" % err)
        fns = {"three_calls": lambda: S.prune_mask(
                   *S.band_configs(pair), S.noise_from_counts(counts), thr),
               "band_prune": lambda: S.band_prune(counts, pair, thr),
               "two_launches_preallocated": two_launches,
               "cooperative_preallocated": coop}
        ms = _in_turns(fns, args.iters)
        card = _on_card(fns, args.iters)
        record["tail"][str(m)] = {"ms": ms, "card_ms_activities_whole": card,
                                  "cooperative_blocks": blocks,
                                  "pruned": int(want[1].sum())}
        for k in fns:
            print("[tail M %d x band %d] %-26s call %.4f ms (CUDA events); "
                  "on the card %s; on %s"
                  % (m, band, k, ms[k], card[k] and "%.5f ms in %g device "
                     "activities a call (%s)" % (
                         card[k][0], card[k][1],
                         "whole" if card[k][2] else "not whole"), smi),
                  flush=True)
        print("[tail M %d] cooperative grid %d blocks; %d pruned"
              % (m, blocks, int(want[1].sum())), flush=True)
    if "binom" in args.sections:
        record["binom"] = _binom_section(args, libs, work, smi, chromosome)
    if "ragged" in args.sections:
        record["ragged"] = _ragged_section(args, libs["ragged"], work, smi)
    return record


def _sorted_hits(packed) -> tuple:
    """(hit count, (read, var, allele, code) rows sorted) of a packed-hit
    buffer: the kernels compact in no order."""
    from ..kernels.alleles import decode_packed_hits
    r, v, a, mc, nh = decode_packed_hits(packed.cpu().numpy())
    order = np.lexsort((v, r))
    return nh, np.stack([r[order], v[order], a[order], mc[order]])


def _ragged_section(args, lib, work: str, smi: str) -> dict:
    """ragged_join and read_spans as they are ("current", through their
    wrappers) beside RAGGED_VARIANTS (the earlier kernels and the current
    design with one part taken out), on smoke phase 3's inputs (the join on
    the first `--rows` reads the dispatcher keeps, staged as it stages
    them, against the 100,000-het table; the span pass on all `--reads`
    reads) and, before them, on testing/layouts.py's NAMES and big_table
    at 20,000 rows (many_rows: 320,000).  Every variant's hits (flags) equal the plain
    version's; each is timed in turns by CUDA events (the join's packed
    buffer's fill included) and on the card by the profiler; the blocks an
    SM holds of each, as the runtime reports them."""
    import torch
    from ..io.bam import OP_I, OP_N
    from ..kernels import alleles as K
    from ..mapper import dispatch as D
    from ..utils.trace import DeviceClock
    from . import layouts
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    I = ctypes.c_int
    lib.v_ragged_join_launch.argtypes = [I] + \
        K._ARGTYPES["ragged_join_launch"]
    lib.v_read_spans_launch.argtypes = [I] + K._ARGTYPES["read_spans_launch"]
    lib.v_blocks_per_sm.argtypes = [I, I]
    classes = [K._class_mask(c) for c in K._op_classes()]
    cap = 1 << 20

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def join_fns(r_in, table):
        vpos, a0, a1, ni = table

        def variant(i):
            def fn():
                out = torch.empty((2, cap + 1), dtype=torch.int32,
                                  device=dev)
                err = lib.v_ragged_join_launch(
                    i, *[x.data_ptr() for x in r_in], r_in[0].shape[0], 10,
                    *classes, vpos.data_ptr(), a0.data_ptr(), a1.data_ptr(),
                    ni.data_ptr(), vpos.shape[0], out.data_ptr(), cap,
                    stream)
                if err:
                    raise RuntimeError("ragged variant %s: CUDA error %d"
                                       % (RAGGED_VARIANTS[i], err))
                return out
            return fn
        fns = {"current": lambda: K.assign_compact_ragged(*r_in, 10, table,
                                                          cap)}
        fns.update({v: variant(i) for i, v in enumerate(RAGGED_VARIANTS)})
        return fns

    def span_fns(s_in):
        def variant(i):
            def fn():
                flags = torch.empty(s_in[0].shape[0], dtype=torch.uint8,
                                    device=dev)
                err = lib.v_read_spans_launch(
                    i, *[x.data_ptr() for x in s_in[:3]], s_in[0].shape[0],
                    1 << OP_I, 1 << OP_N, s_in[3].data_ptr(),
                    s_in[3].shape[0], flags.data_ptr(), stream)
                if err:
                    raise RuntimeError("span variant %s: CUDA error %d"
                                       % (RAGGED_VARIANTS[i], err))
                return flags
            return fn
        fns = {"current": lambda: K.read_spans(*s_in, OP_I, OP_N)}
        fns.update({v: variant(i) for i, v in enumerate(RAGGED_VARIANTS)})
        return fns

    shapes = {k: K.tile_shape(k) for k in ("ragged_join", "read_spans")}
    per_sm = {k: {v: lib.v_blocks_per_sm(i, w)
                  for i, v in enumerate(RAGGED_VARIANTS)}
              for w, k in enumerate(("ragged_join", "read_spans"))}
    print("[ragged] tile shapes %s; blocks an SM by variant %s; on %s"
          % (shapes, per_sm, smi), flush=True)
    out = {"tile_shape": shapes, "variant_blocks_per_sm": per_sm}

    def make_inputs(name):
        if name == "chromosome":
            bd, vt = _chromosome_reads(args.reads, args.vars, work)
            table = K.device_table(vt, np.arange(len(vt)), dev)
            has_ins, _, near = D._read_spans(bd, vt.pos)
            rows = np.flatnonzero(near & ~has_ins)[:args.rows]
            return (D._stage_reads(bd, rows, dev, DeviceClock(dev)), table,
                    [T(x) for x in (bd.pos, bd.cigar_off,
                                    bd.cigar_flat.view(np.int32))] +
                    [table[0]])
        d = layouts.make(name, n_rows=20_000, n_vars=16_000,
                         contig=4_000_000)
        r_np = layouts.ragged_inputs(d)
        tab = tuple(T(x) for x in layouts.padded_table(d))
        return ([T(x) for x in r_np], tab,
                [T(r_np[0]), T(r_np[1].astype(np.int64)), T(r_np[2]),
                 tab[0]])

    for name in layouts.NAMES + ["big_table", "chromosome"]:
        r_in, tab, s_in = make_inputs(name)
        res = {"rows": int(r_in[0].shape[0]), "ops": int(r_in[2].shape[0]),
               "span_reads": int(s_in[0].shape[0]),
               "span_ops": int(s_in[2].shape[0]),
               "table": int(tab[0].shape[0])}
        for kernel, fns in (("ragged_join", join_fns(r_in, tab)),
                            ("read_spans", span_fns(s_in))):
            if kernel == "ragged_join":
                want = _sorted_hits(K.ragged_join_plain(*r_in, 10, tab,
                                                        cap))
            else:
                want = K.read_spans_plain(*s_in, OP_I, OP_N)
            for k, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                same = (lambda g: g[0] == want[0] and
                        np.array_equal(g[1], want[1]))(_sorted_hits(got)) \
                    if kernel == "ragged_join" else torch.equal(got, want)
                if not same:
                    raise RuntimeError("%s %s differs from the plain "
                                       "version on %s" % (kernel, k, name))
            ms = _in_turns(fns, args.iters)
            card = _on_card(fns, args.iters)
            sh = shapes[kernel]
            tiles = -(-res["rows" if kernel == "ragged_join" else
                           "span_reads"] // sh["tile_rows"])
            wave = sh["blocks_per_sm"] * sh["sms"] * sh["tiles_per_block"]
            res[kernel] = {"ms": ms, "card_ms_activities_whole": card,
                           "tiles": tiles, "waves": tiles / wave}
            if kernel == "ragged_join":
                res[kernel]["hits"] = int(want[0])
            for k in fns:
                c = card[k]
                print("[ragged %s] %-11s %-10s call %.4f ms (CUDA events); "
                      "on the card %s; %d tiles, %.3f waves; on %s"
                      % (name, kernel, k, ms[k], c and "%.5f ms in %g "
                         "device activities a call (%s)" % (
                             c[0], c[1], "whole" if c[2] else "not whole"),
                         tiles, tiles / wave, smi), flush=True)
        out[name] = res
    return out


if __name__ == "__main__":
    sys.exit(main())
