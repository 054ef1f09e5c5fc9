"""What limits the sharded step's kernels on the card, by ablation: the
band_counts kernel of the first port (one warp a row, every ordered hit pair
walked as q = i * nh + j with a division, one device-memory atomic an
in-band pair) with one part taken out at a time, beside the current
band_counts kernel and builds of csrc/mesh.cu with its compile-time
switches; and the connection-test tail three ways (the three calls,
band_prune's two launches, one cooperative launch).

    python -m phaser_tpu_torch.testing.step_kernels_ablation [--rows 262144]
        [--vars 100000] [--reads 5000000] [--iters 20]

Inputs, smoke phase 9's three band_counts inputs at one shard's width:
phase 3's reads ("chromosome": testing/benchdata.py's 5M reads of 100 bp,
the first `--rows` as planes of its 100,000-het table: the real density),
and scaling_bench._gen's dense layout (a variant about every 8 bp) with its
rows in random order ("dense") and sorted by start ("dense_sorted"); for
the tail, counts and a band drawn from a seed at 7,120 and 100,000
variants (testing/layouts.band_tail: a noise rate near 0.5%, so the tests
take fractions).  The first port's kernel and its ablations are built here
from the source below, and csrc/mesh.cu once a VARIANTS entry with its
defines, one nvcc each, all started together, into a temporary directory
that is removed at the end.  Every exact variant is held against
band_counts_plain.  Each function is timed as a wrapper call with CUDA
events in turns (every function, then again in reverse order) and on the
card by torch.profiler over a whole window (utils/trace.device_activity:
every device activity a call, summed, and their count).  The SASS of the
current kernel library is searched for the reductions (RED) and returning
atomics (ATOM / ATOMG) of band_counts_kernel.  Needs a CUDA GPU; prints
one JSON line last.
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
                                double* __restrict__ p,
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
  const double e = s_e;
  const double p_success = 1.0 - (6.0 * e + 10.0 * (e * e));
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
      double pv = conflict_p(w[0] + w[4], w[1] + w[3],
                             w[2] + w[5] + w[6] + w[7] + w[8], p_success);
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
                int blocks, void* p, void* prune, void* uncertain,
                void* stream) {
  int count = m * band;
  void* args[] = {(void*)&counts, (void*)&m, (void*)&pair, (void*)&count,
                  (void*)&threshold, (void*)&refine_band, (void*)&partials,
                  (void*)&p, (void*)&prune, (void*)&uncertain};
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


def _build(work: str) -> dict:
    """{name: CDLL}: the ablation source (the first port's kernel, the
    cooperative tail) and csrc/mesh.cu once a VARIANTS entry, one nvcc
    each, all started together; registers and spills printed."""
    from ..utils import build
    src = os.path.join(work, "ablation.cu")
    with open(src, "w") as fh:
        fh.write(SOURCE % {"stats": os.path.join(build.CSRC, "stats.cu")})
    jobs = {"ablation": (src, [])}
    for name, defines in VARIANTS.items():
        jobs[name] = (os.path.join(build.CSRC, "mesh.cu"), defines)
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
        for line in out.splitlines():
            if "registers" in line or "spill" in line and " 0 bytes spill" \
                    not in line:
                print("   ptxas [%s]: %s" % (name, line.strip()))
        libs[name] = ctypes.CDLL(os.path.join(work, "lib%s.so" % name))
    return libs


def _sass_atomics(lib_path: str) -> dict:
    """RED / ATOM instruction counts in band_counts_kernel's SASS."""
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
        if fn and "band_counts_kernel" in fn:
            for op in ("REDG", "RED.", "ATOMG", "ATOMS", "ATOM."):
                if re.search(r"\b" + re.escape(op), line):
                    out[op.rstrip(".")] = out.get(op.rstrip("."), 0) + 1
    return out


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
    (utils/trace.device_activity)."""
    from ..utils.trace import device_activity
    return {k: device_activity(f, iters, log=lambda line, k=k: print(
        "   %s: %s" % (k, line), flush=True)) for k, f in fns.items()}


def _chromosome_input(n_reads: int, n_rows: int, n_vars: int, work: str):
    """Smoke phase 3's step input: the first n_rows of benchdata's n_reads
    reads as (codes, quals, refpos) planes, and its het table."""
    from ..dist.multihost import table_arrays
    from ..engine.varmap import build_variant_table
    from ..io import bam as bamio
    from ..kernels.alleles import pack_reads
    from . import benchdata
    contig_len = 200_000_000
    bam = os.path.join(work, "chrscale.bam")
    benchdata.generate_bam(bam, n_reads=n_reads, contig_len=contig_len)
    vt = build_variant_table("chr1", benchdata.generate_variants(
        n_vars, contig_len))
    bd = bamio.read_bam(bam)
    os.remove(bam)
    return pack_reads(bd, rows=np.arange(min(n_rows, len(bd)))) + \
        table_arrays(vt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--vars", type=int, default=100_000)
    ap.add_argument("--reads", type=int, default=5_000_000)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

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
    sass = _sass_atomics(build.LIB_PATH)
    print("band_counts_kernel SASS atomics: %s" % sass, flush=True)
    libs = _build(work)
    lib = libs["ablation"]
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ablation_launch.argtypes = [I, P, P, I, I, I, I, P, P, P, P]
    lib.coop_launch.argtypes = [P, P, I, I, D, D, P, I, P, P, P, P]
    lib.coop_blocks.argtypes = [I]
    lib.band_prune_launch.argtypes = [P, P, I, I, D, D, P, I, P, P, P, P, P]
    for name in VARIANTS:
        libs[name].band_counts_launch.argtypes = [P] * 2 + [I] * 4 + [P] * 5
    stream = torch.cuda.current_stream(dev).cuda_stream
    band = 8
    wb = torch.zeros(1, dtype=torch.int32, device=dev)
    nb = ctypes.c_int(0)

    gen = _gen(args.rows, 128, args.vars)
    order = np.argsort(gen[2][:, 0], kind="stable")
    inputs = {
        "chromosome": _chromosome_input(args.reads, args.rows, args.vars,
                                        work),
        "dense": gen,
        "dense_sorted": tuple(a[order] for a in gen[:3]) + gen[3:]}
    record = {"card": smi, "sass_band_counts_kernel": sass, "band_counts": {},
              "tail": {}}
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

    for m in (7120, args.vars):
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
        blocks = lib.coop_blocks(m * band)
        if 2 * blocks > partials.numel():
            raise RuntimeError("%d cooperative blocks" % blocks)

        def coop():
            err = lib.coop_launch(counts.data_ptr(), pair.data_ptr(), m, band,
                                  thr, 1e-3, partials.data_ptr(), blocks,
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
                partials.data_ptr(), S.NOISE_PARTIALS, pc.data_ptr(),
                prc.data_ptr(), unc.data_ptr(), ctypes.addressof(launches),
                stream)
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
    return record


if __name__ == "__main__":
    sys.exit(main())
