#!/usr/bin/env python3
"""Smoke run of phaser_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing here imports jax):
  1. environment: torch / CUDA versions, the card, nvidia-smi's name and
     power limit;
  2. build: compiles phaser_tpu_torch/csrc/*.cu with nvcc and
     csrc/phaser_io.cc (the native IO library) with g++, both started
     together and timed, into phaser_tpu_torch/_build/;
  3. kernel parity at chromosome scale (testing/benchdata.py: 5M reads, 100k
     hets, 200 Mbp, 10% N-spliced): assign_alleles_auto on the GPU == the
     exact host mapper, also with every launch's hit capacity forced to
     overflow (the chunk must be relaunched on the card, never rerun on the
     host) and without the native nibble packer (the masked-affine path);
     the dispatcher's counters after each such call (its pre-filter dropped
     the reads whose span holds no variant, only the filled columns of the
     packed-hit buffers were fetched, every upload left pinned memory), and
     the pre-filter's two ends: reads of which none reaches a variant
     (nothing uploaded, nothing launched) and reads that all do (none
     dropped);
     the dispatcher's wall with its host items (cProfile) and its device
     share (torch.profiler); then one 262,144-row launch of each fused
     kernel against its plain PyTorch version on the card (all four are
     range joins that take no window; the delta kernel gets per-row
     [rp_min, rp_max]; hits compared after a (read, var) sort; timed with
     CUDA events); then the four range-join kernels on the layouts of
     testing/layouts.py that reach every branch (rows in random order, a
     table too dense for the shared-memory slice, L of 256 and 384, lo > 0,
     empty rows, variants on first and last bases, a one-entry table, the
     second and the first (2^22 entries) slice of a table above the
     dispatcher's slice size, duplicate positions, a masked trailing clip
     at the position of an aligned base on a variant), each also with a
     capacity of 4 (exact count past capacity); then a small
     testing/datagen.py fixture with deletion reads;
  4. the kernel-level entries (assign_alleles_pallas_windowed with gather
     and cmp, assign_alleles_pallas with a resident table) on
     tests/test_tpu_hw.py's layout (M = 100k, N = 2^15, narrow regions, the
     plan asserted), each against its plain version, max_abs_err 0 on both
     planes, and the whole-table mode at that table; then every mode
     (windowed search, cmp, whole table, resident table) on the layouts of
     testing/layouts.py PLANES_NAMES: an L that is no multiple of 4 (the
     scalar instantiation) and one that is none of 16, spliced and
     descending rows, duplicate table positions (the search takes the
     first, cmp the last), a window past the end of a table whose length is
     no multiple of 4, pairs of entries whose product of differences
     vanishes modulo 2^32, 20,077 rows each (no multiple of the row block);
  5. engine stages #3 pair counting, #4 components and #5 the 2^n scorer at
     and above their size gates, cuda against host: equal results, both
     times printed;
  6. end to end: the CLI's entry point (phaser_main.main, what `python -m
     phaser_tpu_torch.cli.phaser_main` runs) with --device cuda, --device
     host, and --device cuda with the stage gates forced down, on a
     testing/datagen.py fixture shaped like bench_engine.py (3 contigs,
     60/25/15% of 1M input reads); the six output files must be
     byte-identical, and every fused kernel (default run) and every stage's
     device hook (gates-down run) must have run (counts zeroed just before
     each run, read just after);
  7. sharded runners on phase 6's fixture, each through its entry point and
     against a single-process --device host reference: --threads 4 (four
     position-shard engine threads sharing the card; every fused kernel
     launched), the same with the stage gates forced down (every device
     stage called), --threads 2 --device host (two processes over Gloo), two
     `python -m phaser_tpu_torch.dist.engine_multihost --device cuda`
     processes sharing the card (each reports device time), and
     --process_slow 1 without and with --threads 2 against the host's
     --process_slow 1 run.  Each run's wall is printed beside the card's
     name and power limit;
  8. the downstream tools, each through its CLI's `main` in this process,
     at the shape of the repo's pop benchmark (BENCH_pop_r05.json,
     testing/popdata.py: 300 samples x 2,000 genes, 5,000 pairs, bs
     10,000): gene_ae on a 6,000-row haplotypic_counts file, expr_matrix
     over 300 gene-AE files (both .bed.gz written, indexed and read back
     through TabixFile), cis_var --engine torch --device cuda on all 5,000
     pairs (the bootstrap's card time by CUDA events, its share of the
     wall, its peak memory; then the same bootstrap twice more, warm and
     equal, and a few of its cohorts on the CPU against the card),
     cis_var --engine numpy and --engine torch
     (twice) on the first 30 pairs (deterministic columns byte-equal
     between the engines, CI bounds within 2.0, lower <= point <= upper,
     the two torch files byte-equal), the auto gate's choice at 30 and
     5,000 pairs, annotate on phase 6's phased VCF and the read -> variant
     mapper CLI on a SAM of phase 6's first 100,000 reads (well-formed
     outputs; byte-equality with phaser_tpu is held in the CPU tests, since
     this machine need not have jax or pandas).  Each wall is printed
     beside the card's name and power limit, and at the end neither jax,
     phaser_tpu nor pandas may have been imported;
  9. the sharded step and the multi-process scaffolding (dist/): (a)
     dist.mesh.sharded_phasing_step on a one-shard mesh on the card, with
     the connection tests' p-values of its merged band
     (connection_p_values), at one shard's full width: 262,144 rows x 128
     bases on three inputs, phase 3's reads with its 100,000-het table,
     scaling_bench._gen's dense layout (a variant about every 8 bp) over
     100,000 variants, and phase 6's first contig; counts zeroed just
     before each run and read just after, every step kernel launched; the
     first 4,096 rows of each against dist/dryrun.py's numpy and scipy
     recomputations (counts, band, scores equal, p-values within 1e-10,
     prune equal); each step kernel (planes_table, band_counts,
     conflict_prune, binom_cdf) against its plain version on the step's
     own tensors (max_abs_err 0 for the integer kernels, <= 1e-12 for the
     float64 ones, prune equal) and timed; (b) dryrun.dryrun_multichip(4,
     "cuda"); (c) two `python -m phaser_tpu_torch.dist.multihost --device
     cuda` ranks over Gloo on phase 6's fixture, their counts equal to one
     process's; (d) `python -m phaser_tpu_torch.dist.scaling_bench
     --devices 1,2 --device cuda --reads-per-device 262144`, its JSON line
     printed.

Each kernel's `launches` comes from the run of its own path: the e2e cuda
run for the three nibble/plane kernels, the no-nibble-packer dispatcher run
for affine_masked, phase 4's entry calls for the planes kernels, and phase
9's step runs (with their p-values) for the four step kernels.

Each kernel's `ms` is the wrapper call timed with CUDA events over 20 calls
(the packed buffer's fill included, and host overhead where the host cannot
enqueue as fast as the card runs), as in every earlier record.  `device_ms`
is what one call keeps the card busy (torch.profiler's device time of the
__global__ function plus the launcher's buffer fills), `kernel_ms` the
__global__ function alone, `profiles` how many profiler windows it took to
see the function (1 unless a window came back without device records; one
discarded window with a launch in it precedes the first measured one).
`plain_ms` is event-timed.  The share of bound
is taken against `ms`.

Each kernel's `bound_ms` is the larger of the bytes this run's inputs need
moved over 3.35 TB/s and its integer operations over 67 T/s (the card's
non-tensor rate); for the four range joins the bytes are what the data
needs (row parameters or the refpos plane, the table entries between the
lowest and the highest position of the launch's rows, for delta_nibble 8 B
of [rp_min, rp_max] per row and `start` and the delta row only of the rows
with a table entry in their range, one 32-byte sector of a code plane per
hit, 8 B per hit written; for the planes kernels 4 B of refpos read and 8 B
written per base, 2 B of codes and quals per hit, the table entries under
the launch's windows), and the line printed before the record also gives
the "every input byte once" figure.  The step kernels' bounds: for
band_counts the planes read once (8 B a base) and the counts and band
written once, or a test per base and per ordered hit pair; for
conflict_prune and binom_cdf their inputs and outputs once, or the float64
operations of the fraction terms these inputs actually take over 34 T/s
(the card's float64 rate outside the tensor cores).  `library_ms` is
null throughout: no single PyTorch call classifies bases against the table
and compacts the hits (`torch.searchsorted` is only the lookup), forms the
within-row pairs, or has an incomplete beta.

The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REPLACES = {  # the TPU program each kernel (or kernel mode) replaces
    "affine_nibble": "phaser_tpu/kernels/alleles.py:975",
    "delta_nibble": "phaser_tpu/kernels/alleles.py:424",
    "plane": "phaser_tpu/kernels/alleles.py:1038",
    "affine_masked": "phaser_tpu/kernels/alleles.py:246",
    "planes": "phaser_tpu/kernels/alleles.py:673",
    "planes_resident": "phaser_tpu/kernels/alleles.py:627",
    "planes_cmp": "phaser_tpu/kernels/alleles.py:757",
    # the sharded step's programs (jnp inside phaser_tpu's shard_map step)
    "planes_table": "phaser_tpu/kernels/alleles.py:33",
    "band_counts": "phaser_tpu/dist/mesh.py:83",
    "conflict_prune": "phaser_tpu/kernels/stats.py:46",
    "binom_cdf": "phaser_tpu/kernels/stats.py:32",
}
SOURCES = dict.fromkeys(REPLACES, "phaser_tpu_torch/csrc/alleles.cu")
SOURCES.update(band_counts="phaser_tpu_torch/csrc/mesh.cu",
               conflict_prune="phaser_tpu_torch/csrc/stats.cu",
               binom_cdf="phaser_tpu_torch/csrc/stats.cu")
STEP_KERNELS = ("planes_table", "band_counts", "conflict_prune", "binom_cdf")
STEP_ROWS = 1 << 18          # phase 9: rows of one shard's step
STEP_CHECK_ROWS = 4096       # rows held against dist/dryrun.py's host code
STEP_BAND, STEP_THRESHOLD = 8, 0.01
# the input of phase 9 whose numbers go into the kernels' record, the one
# where the kernel's work is real: the chromosome's reads for the allele
# planes; the dense layout (a variant about every 8 bp, scaling_bench._gen)
# for the pair band; phase 6's reads for the connection tests (the dense
# layout's random codes mismatch 3 bases in 4, so no variant passes the
# noise estimate's 5% rule, the noise rate is 0 and the edge rules decide
# every test without a fraction)
STEP_RECORD = {"planes_table": "chromosome", "band_counts": "dense",
               "conflict_prune": "e2e", "binom_cdf": "e2e"}
STEP_TOL = {"planes_table": 0, "band_counts": 0, "conflict_prune": 1e-12,
            "binom_cdf": 1e-12}
SUFFIXES = (".allelic_counts.txt", ".variant_connections.txt",
            ".allele_config.txt", ".haplotypes.txt",
            ".haplotypic_counts.txt", ".vcf.gz")
SUB_ROWS = 1 << 18
CHROM_READS = 5_000_000      # testing/benchdata.py chromosome-scale workload
CHROM_HETS = 100_000
E2E_READS = 1_000_000        # bench_engine.py's input-read count
POP_SAMPLES, POP_GENES = 300, 2000   # BENCH_pop_r05.json, BASELINE config 5
POP_PAIRS, POP_BS, POP_SUBSET = 5000, 10000, 30
POP_DET = ["gene", "var_id", "var_chr", "var_pos", "var_het_n", "var_hom_n",
           "het_hom_pvalue", "var_het_afc", "var_het_abs_afc", "var_hom_afc",
           "var_hom_abs_afc", "var_het_afcs", "var_hom_afcs",
           "var_het_ref_counts", "var_het_alt_counts",
           "var_hom_hap1_counts", "var_hom_hap2_counts",
           "var_het_sample_ids", "var_hom_sample_ids"]
MAPPER_READS = 100_000
MAIN_PATH = ("affine_nibble", "delta_nibble", "plane")  # the dispatcher's


HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
INT_OPS_PER_S = 67e12        # non-tensor rate (compares, index arithmetic)
FP64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
TABLE_ROW_BYTES = 16         # vpos, a0, a1, n_ind: 4 x int32 per entry
# float64 operations of the incomplete beta (csrc/stats.cu): a term of
# the continued fraction (two Lentz half-steps, two divisions each
# counted as one), and the prefactor (three lgamma, log, log1p, exp)
BETACF_TERM_FLOPS = 30
BETACF_SETUP_FLOPS = 100


class SmokeError(Exception):
    pass


def bound_of(n_bytes, n_ops):
    """(bound ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the non-tensor rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / INT_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def fp64_bound(n_bytes, n_flops):
    """bound_of for float64 arithmetic: the operations over the float64
    rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_flops / FP64_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def phase(n, title):
    print("== phase %d: %s" % (n, title), flush=True)


def same_hits(a, b, what):
    import numpy as np
    for f in ("read_idx", "var_idx", "allele_code"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              "%s: ContigHits.%s differ" % (what, f))
    check(a.allele_strs == b.allele_strs,
          "%s: ContigHits.allele_strs differ" % what)


def sorted_hits(packed):
    import numpy as np
    from phaser_tpu_torch.kernels.alleles import decode_packed_hits
    r, v, a, mc, nh = decode_packed_hits(packed.cpu().numpy())
    order = np.lexsort((v, r))
    return nh, np.stack([r[order], v[order], a[order], mc[order]])


def time_ms(fn, iters):
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


KERNEL_FN = {  # the __global__ function behind each kernel entry
    "affine_nibble": "affine_nibble_kernel",
    "delta_nibble": "delta_nibble_kernel", "plane": "plane_kernel",
    "affine_masked": "affine_masked_kernel",
    "planes": "planes_windowed_kernel",
    "planes_resident": "planes_resident_kernel",
    "planes_cmp": "planes_cmp_kernel",
    "planes_table": "planes_table_kernel",  # the whole-table mode of planes
    "band_counts": "band_counts_kernel",
    "conflict_prune": "conflict_prune_kernel",
    "binom_cdf": "binom_cdf_kernel"}
_profiler_warm = False


def device_ms(name, fn, iters=20):
    """(device ms, kernel ms, profiles) per call from torch.profiler: the
    device time of the kernel's __global__ function plus the launcher's
    memsets, of the function alone, and how many profiles it took to see
    the function (a profile now and then comes back without its device
    records; the count goes into the kernels' record); None when three
    profiles report no device time for it."""
    global _profiler_warm
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    if not _profiler_warm:
        # the first window of a process has come back without device
        # records: a discarded window with a launch in it comes first
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        _profiler_warm = True
    for attempt in (1, 2, 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernel_us = fill_us = 0.0
        keys = []
        for e in prof.key_averages():
            d = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
            if KERNEL_FN[name] in e.key:
                kernel_us += d
            elif "memset" in e.key.lower():
                fill_us += d
            if d:
                keys.append(e.key[:60])
        if kernel_us:
            return ((kernel_us + fill_us) / iters / 1e3,
                    kernel_us / iters / 1e3, attempt)
        print("   profile without %s; device records: %s"
              % (KERNEL_FN[name], keys), flush=True)
    return None


def kernel_vs_plain(name, kernel, plain, n_rows):
    """A range-join kernel's wrapper vs its plain version on the same CUDA
    tensors.  Returns (max_abs_err, ms, plain_ms, hits, (device_ms,
    kernel_ms)), as the dispatcher would launch: ms is the wrapper call by
    CUDA events (buffer fill and, where the host cannot enqueue faster than
    the card runs, host overhead included); the pair is device_ms()'s."""
    import numpy as np
    import torch
    nk, hk = sorted_hits(kernel())
    npl, hp = sorted_hits(plain())
    torch.cuda.synchronize()
    check(nk == npl, "%s: kernel found %d hits, plain %d" % (name, nk, npl))
    err = int(np.abs(hk - hp).max()) if hk.size else 0
    print("   %-13s range-join  rows=%d hits=%d max_abs_err=%d"
          % (name, n_rows, nk, err), flush=True)
    check(err == 0, "%s: kernel disagrees with plain version" % name)
    # in turns (plain, kernel, kernel, plain); each number is the mean of two
    p1 = time_ms(plain, 5)
    k1 = time_ms(kernel, 20)
    k2 = time_ms(kernel, 20)
    p2 = time_ms(plain, 5)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    dev = device_ms(name, kernel)
    check(dev is not None, "%s: the profiler saw no launch of %s"
          % (name, KERNEL_FN[name]))
    print("   %-13s wrapper call %.4f ms (%.4f, %.4f); on the card %.4f ms, "
          "kernel alone %.4f ms   plain %.4f ms (%.4f, %.4f)   (%d rows)"
          % (name, ms, k1, k2, dev[0], dev[1], plain_ms, p1, p2, n_rows),
          flush=True)
    return err, ms, plain_ms, nk, dev


def host_items(fn):
    """Wall of one dispatcher call under cProfile, with the cumulative
    seconds of its host items (packers, selects, uploads; it plans no
    window)."""
    import cProfile
    import pstats

    import torch
    names = ("_read_spans", "select", "pack_affine_nibble",
             "pack_delta_nibble", "pack_reads", "padded_table", "_upload",
             "assign_alleles", "resolve", "_fetch", "decode_packed_hits")
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    items = {}
    for (_, _, fname), (_, ncalls, _, cum, _) in \
            pstats.Stats(pr).stats.items():
        if fname in names:
            n0, c0 = items.get(fname, (0, 0.0))
            items[fname] = (n0 + ncalls, c0 + cum)
    print("   dispatcher under cProfile: wall %.3f s; host items (calls, "
          "cumulative s): %s"
          % (wall, ", ".join("%s x%d %.3f" % (k, n, c) for k, (n, c) in
                             sorted(items.items(), key=lambda kv: -kv[1][1]))),
          flush=True)
    return wall, items


def profile_dispatch(fn):
    """Device busy share of one dispatcher call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in events)
    print("   profile: wall %.2f ms, device busy %.2f ms (%.1f%%)"
          % (wall * 1e3, dev_us / 1e3, 100.0 * dev_us / 1e3 / (wall * 1e3)))
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
    for e in top:
        print("     cpu %-40s %9.2f ms x%d" % (e.key[:40],
                                                e.self_cpu_time_total / 1e3,
                                                e.count))
    top = sorted(events, key=lambda e: -getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
    for e in top[:4]:
        d = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if d:
            print("     dev %-40s %9.2f ms x%d" % (e.key[:40], d / 1e3,
                                                    e.count))
    sys.stdout.flush()


def rows_or_copy(K, call):
    """The dispatcher call with the packers given the kept reads' row
    indices (as shipped) against a gathered copy of those reads
    (BamData.select, then pack), in turns in this process."""
    import torch
    names = ("pack_reads", "pack_affine_nibble", "pack_delta_nibble")
    packers = {n: getattr(K, n) for n in names}

    def gathered(pack):
        def packed(b, *a, rows=None, **k):
            return pack(b if rows is None else b.select(rows), *a, **k)
        return packed
    walls = {"row index": [], "gathered copy": []}
    try:
        for mode in ("row index", "gathered copy", "gathered copy",
                     "row index") * 3:
            for n, pack in packers.items():
                setattr(K, n, pack if mode == "row index" else gathered(pack))
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
    finally:
        for n, pack in packers.items():
            setattr(K, n, pack)
    print("   packers by %s" % "; ".join(
        "%s %s s" % (m, " ".join("%.3f" % w for w in ws))
        for m, ws in walls.items()), flush=True)


def filter_stats(D, what, dropped):
    """Prints the dispatcher's counts since the last reset and checks them:
    the pre-filter ran (with `dropped`: it dropped rows), exactly the filled
    columns were fetched (min(n_hits, cap) + 1 a part), every upload left
    pinned memory."""
    st = dict(D.STATS)
    print("   %s: rows kept %d / rows in %d (dropped %d); columns fetched %d "
          "/ needed %d / allocated %d in %d parts; uploads pinned %d / %d"
          % (what, st["rows_kept"], st["rows_in"], st["rows_dropped"],
             st["columns_fetched"], st["columns_needed"],
             st["columns_allocated"], st["parts_fetched"],
             st["uploads_pinned"], st["uploads"]),
          flush=True)
    check(st["rows_in"] > 0 and
          st["rows_kept"] + st["rows_dropped"] == st["rows_in"],
          "%s: the pre-filter did not run: %s" % (what, st))
    if dropped:
        check(0 < st["rows_kept"] < st["rows_in"] // 2,
              "%s: the pre-filter kept %d of %d rows"
              % (what, st["rows_kept"], st["rows_in"]))
    check(st["parts_fetched"] > 0 and
          st["columns_fetched"] == st["columns_needed"] and
          st["parts_fetched"] < st["columns_fetched"] <
          st["columns_allocated"],
          "%s: fetched %d columns, needed %d of %d allocated in %d parts"
          % (what, st["columns_fetched"], st["columns_needed"],
             st["columns_allocated"], st["parts_fetched"]))
    check(st["uploads"] > 0 and st["uploads_pinned"] == st["uploads"],
          "%s: %d of %d uploads left pinned memory"
          % (what, st["uploads_pinned"], st["uploads"]))


def chromosome_phase(tmp, device):
    import numpy as np
    import torch

    from phaser_tpu_torch.engine.varmap import build_variant_table
    from phaser_tpu_torch.io import bam as bamio
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.mapper import dispatch as D
    from phaser_tpu_torch.mapper.dispatch import assign_alleles_auto
    from phaser_tpu_torch.testing import benchdata

    dev = torch.device(device)
    contig_len = 200_000_000
    t0 = time.perf_counter()
    bam = os.path.join(tmp, "chrscale.bam")
    benchdata.generate_bam(bam, n_reads=CHROM_READS, contig_len=contig_len)
    vt = build_variant_table(
        "chr1", benchdata.generate_variants(CHROM_HETS, contig_len))
    bd = bamio.read_bam(bam)
    print("   fixture: %d reads, %d hets, %.1f s"
          % (len(bd), len(vt), time.perf_counter() - t0), flush=True)

    t0 = time.perf_counter()
    want = assign_alleles_auto(bd, vt, baseq=10, device="host")
    t_host = time.perf_counter() - t0
    walls = []
    D.RELAUNCHES["capacity"] = 0
    for _ in range(2):
        K.reset_launches()
        D.reset_stats()
        t0 = time.perf_counter()
        got = assign_alleles_auto(bd, vt, baseq=10, device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        same_hits(got, want, "chromosome-scale assign_alleles_auto")
    chrom_launches = dict(K.LAUNCHES)
    filter_stats(D, "chromosome-scale call", dropped=True)
    print("   assign_alleles_auto: %d hits; host %.3f s, cuda %.3f s "
          "(first call) / %.3f s; launches %s"
          % (len(want), t_host, walls[0], walls[1], chrom_launches),
          flush=True)
    check(K.LAUNCHES["affine_nibble"] > 0 and K.LAUNCHES["plane"] > 0,
          "chromosome-scale run skipped a kernel: %s" % K.LAUNCHES)
    check(D.RELAUNCHES["capacity"] == 0,
          "chromosome-scale run overflowed its hit capacity")

    # forced hit-capacity overflow: every launch with more than one hit
    # overflows, and resolve() relaunches the chunk on the card with the
    # exact counts
    adaptive_cap = D._adaptive_cap
    D._adaptive_cap = lambda key, n: 1
    try:
        pend = assign_alleles_auto(bd, vt, baseq=10, device=device,
                                   defer=True)
    finally:
        D._adaptive_cap = adaptive_cap
    K.reset_launches()
    t0 = time.perf_counter()
    got = pend.resolve()
    torch.cuda.synchronize()
    t_relaunch = time.perf_counter() - t0
    same_hits(got, want, "capacity-overflow relaunch")
    print("   capacity overflow: relaunched %d chunk(s) on the card, "
          "resolve %.3f s, launches %s; hits equal the host's"
          % (D.RELAUNCHES["capacity"], t_relaunch, dict(K.LAUNCHES)),
          flush=True)
    check(D.RELAUNCHES["capacity"] == 1 and K.LAUNCHES["affine_nibble"] > 0
          and K.LAUNCHES["plane"] > 0, "overflow was not relaunched on the card")
    # the pre-filter's two ends: reads of which none reaches a device variant
    # (nothing packed, nothing launched) and reads that all do (none dropped)
    _, _, near = D._read_spans(bd, vt.pos)
    for what, sel in (("no read near a variant", np.flatnonzero(~near)),
                      ("every read near a variant", np.flatnonzero(near))):
        part = bd.select(sel[:300_000])
        want_part = assign_alleles_auto(part, vt, baseq=10, device="host")
        K.reset_launches()
        D.reset_stats()
        got = assign_alleles_auto(part, vt, baseq=10, device=device)
        torch.cuda.synchronize()
        same_hits(got, want_part, what)
        n_launch = sum(K.LAUNCHES.values())
        print("   %s: %d reads, %d hits, %d launches, stats %s"
              % (what, len(part), len(got), n_launch, dict(D.STATS)),
              flush=True)
        if what.startswith("no"):
            check(n_launch == 0 and D.STATS["rows_kept"] == 0 and
                  D.STATS["uploads"] == 0 and len(got) == 0,
                  "reads near no variant reached the card")
        else:
            check(n_launch > 0 and D.STATS["rows_dropped"] == 0 and
                  D.STATS["rows_kept"] == len(part) and len(got) > 0,
                  "reads near a variant were dropped")
    if dev.type == "cuda":
        profile_dispatch(lambda: assign_alleles_auto(bd, vt, baseq=10,
                                                     device=device))
        host_items(lambda: assign_alleles_auto(bd, vt, baseq=10,
                                               device=device))
        rows_or_copy(K, lambda: assign_alleles_auto(bd, vt, baseq=10,
                                                    device=device))

    # the dispatcher without the native nibble packer: affine reads take
    # the 1 B/base masked plane and the affine_masked kernel
    pack_nibble = K.pack_affine_nibble
    K.pack_affine_nibble = lambda *a, **k: None
    try:
        K.reset_launches()
        D.reset_stats()
        t0 = time.perf_counter()
        got = assign_alleles_auto(bd, vt, baseq=10, device=device)
        torch.cuda.synchronize()
        t_masked = time.perf_counter() - t0
        masked_launches = dict(K.LAUNCHES)
    finally:
        K.pack_affine_nibble = pack_nibble
    same_hits(got, want, "assign_alleles_auto without the nibble packer")
    filter_stats(D, "no-nibble call", dropped=True)
    print("   no nibble packer: %.3f s, launches %s; hits equal the host's"
          % (t_masked, masked_launches), flush=True)
    check(masked_launches["affine_masked"] > 0 and
          masked_launches["affine_nibble"] == 0,
          "the no-nibble-packer run skipped affine_masked: %s"
          % masked_launches)

    # one 262,144-row launch of each kernel at the main path's shapes
    dev_vidx = np.arange(len(vt))
    vpos = K.padded_table(vt, dev_vidx)[0]
    table = K.device_table(vt, dev_vidx, dev)
    cap = 1 << 20
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa

    ncodes, aff_all, st, lo, hi = K.pack_affine_nibble(bd, 10)
    n = min(SUB_ROWS, len(bd))
    ia = aff_all[:n]
    nc = np.where(ia[:, None], ncodes[:n], 0xFF).astype(np.uint8)
    st, lo, hi = (np.where(ia, x[:n], 0).astype(np.int32)
                  for x in (st, lo, hi))
    a_in = [T(x) for x in (nc, st, lo, hi)]

    def affine():
        return K.assign_compact_affine_nibble(*a_in, table, cap)

    def affine_plain():
        return K.affine_nibble_plain(*a_in, table, cap)

    # delta inputs from the same reads: start - lo with zero deltas gives
    # the affine positions; every 4th read gets a 2-base deletion after
    # base 33 (refpos shifts by 2 from there on); [rmin, rmax] bounds each
    # row's aligned positions, both 0 for a row without any
    L = 2 * nc.shape[1]
    dstart = np.where(ia, st - lo, 0).astype(np.int32)
    delta = np.zeros((n, L), np.int16)
    dele = ia & (np.arange(n) % 4 == 0)
    delta[dele, 33:] = 2
    live = hi > lo
    rmin = st
    rmax = np.where(live, st + (hi - lo) - 1 + np.where(dele, 2, 0),
                    0).astype(np.int32)
    d_in = [T(x) for x in (nc, dstart, delta, rmin, rmax)]

    def delta_k():
        return K.assign_compact_delta_nibble(*d_in, table, cap)

    def delta_plain():
        return K.delta_nibble_plain(*d_in, table, cap)

    # the kernel and its plain version both trust [rmin, rmax]; a search per
    # base over the whole table, which knows no range, must find the same
    # (row, entry) pairs, so a bound that cut a hit off would show
    nib = torch.stack((d_in[0] & 0xF, d_in[0] >> 4), dim=2).reshape(n, L)
    rp = torch.where(
        nib != 15,
        d_in[1][:, None] + torch.arange(L, dtype=torch.int32, device=dev) +
        d_in[2].to(torch.int32), 0)
    vpos_t = table[0]
    at = torch.searchsorted(vpos_t, rp).clamp_max(vpos_t.shape[0] - 1)
    rows_ref, base_ref = torch.nonzero((rp > 0) & (vpos_t[at] == rp),
                                       as_tuple=True)
    ref_pairs = torch.stack((rows_ref, at[rows_ref, base_ref])).cpu().numpy()
    got = K.decode_packed_hits(delta_k().cpu().numpy())
    order = np.lexsort((got[1], got[0]))
    check(got[4] == ref_pairs.shape[1] and
          np.array_equal(np.stack((got[0], got[1]))[:, order],
                         ref_pairs[:, np.lexsort((ref_pairs[1],
                                                  ref_pairs[0]))]),
          "delta_nibble: %d hits, a search per base with no range finds %d, "
          "or their (row, entry) pairs differ"
          % (got[4], ref_pairs.shape[1]))
    print("   delta_nibble: %d hits, the (row, entry) pairs of a search per "
          "base that knows no [rp_min, rp_max]" % got[4], flush=True)
    del nib, rp, at, rows_ref, base_ref

    mcodes, aff_m, st_m, lo_m, hi_m = K.pack_affine_masked(bd, 10)
    ia_m = aff_m[:n]
    st_m, lo_m, hi_m = (np.where(ia_m, x[:n], 0).astype(np.int32)
                        for x in (st_m, lo_m, hi_m))
    m_in = [T(x) for x in (
        np.where(ia_m[:, None], mcodes[:n], 15).astype(np.uint8), st_m, lo_m,
        hi_m)]

    def masked_k():
        return K.assign_compact_affine_masked(*m_in, table, cap)

    def masked_plain():
        return K.affine_masked_plain(*m_in, table, cap)

    sub = bd.select(np.flatnonzero(~aff_all)[:SUB_ROWS])
    codes, quals, refpos = K.pack_reads(sub)
    n_p = codes.shape[0]
    p_in = [T(x) for x in (codes, quals, refpos)]
    L_p = codes.shape[1]

    def plane():
        return K.assign_compact_plane(*p_in, 10, table, cap)

    def plane_plain():
        return K.plane_plain(*p_in, 10, table, cap)

    print("   table: %d entries (Mp), L=%d" % (table[0].shape[0], L),
          flush=True)
    mp = int(table[0].shape[0])
    tab_bytes = mp * TABLE_ROW_BYTES

    def under(pmin, pmax, has):
        """Table entries between the lowest and the highest position of a
        launch's rows (what a range join reads of the table), and per row
        the entries in its own [pmin, pmax]."""
        k0 = np.searchsorted(vpos, pmin)
        k1 = np.searchsorted(vpos, pmax, side="right")
        per_row = np.where(has, np.maximum(k1 - k0, 0), 0)
        span = int(k1[has].max() - k0[has].min()) if has.any() else 0
        return max(span, 0), per_row
    a_under, _ = under(st, st + (hi - lo) - 1, live)
    m_under, _ = under(st_m, st_m + (hi_m - lo_m) - 1, hi_m > lo_m)
    d_under, d_range = under(rmin, rmax, rmax > 0)
    d_live = int((d_range > 0).sum())   # rows that read their delta row
    p_under, p_range = under(
        np.where(refpos > 0, refpos, np.iinfo(np.int32).max).min(1),
        refpos.max(1), refpos.max(1) > 0)
    Lh = nc.shape[1]
    steps = max(mp.bit_length() - 1, 1)          # binary-search depth
    print("   table entries under the launch's rows: affine_nibble %d, "
          "delta_nibble %d (%d of %d rows have an entry in their range), "
          "plane %d, affine_masked %d of %d"
          % (a_under, d_under, d_live, n, p_under, m_under, mp), flush=True)
    results, bounds = {}, {}
    for name, k, p, rows in (
            ("affine_nibble", affine, affine_plain, n),
            ("delta_nibble", delta_k, delta_plain, n),
            ("plane", plane, plane_plain, n_p),
            ("affine_masked", masked_k, masked_plain, n)):
        err, ms, plain_ms, hits, on_card = kernel_vs_plain(name, k, p, rows)
        results[name] = (err, ms, plain_ms, on_card)
        out_bytes = 8 * hits + 4
        if name == "affine_nibble":
            need = rows * 12 + a_under * TABLE_ROW_BYTES + 32 * hits
            every = rows * (12 + Lh) + tab_bytes
            ops = rows * 2 * steps + 12 * hits
        elif name == "affine_masked":
            need = rows * 12 + m_under * TABLE_ROW_BYTES + 32 * hits
            every = rows * (12 + L) + tab_bytes
            ops = rows * 2 * steps + 12 * hits
        elif name == "delta_nibble":
            # [rp_min, rp_max] of every row (8 B); start (4 B) and the
            # 2 B/base delta row only of rows with an entry in their range;
            # a nibble sector per hit
            need = rows * 8 + d_live * (4 + 2 * L) + \
                d_under * TABLE_ROW_BYTES + 32 * hits
            every = rows * (12 + Lh + 2 * L) + tab_bytes
            ops = rows * 4 * steps + \
                int((d_range * (2 + L)).sum()) + 12 * hits
        else:  # plane
            need = rows * L_p * 4 + p_under * TABLE_ROW_BYTES + 64 * hits
            every = rows * L_p * 6 + tab_bytes
            ops = rows * L_p * (2 + float(p_range.mean())) + rows * 2 * 4 * 32
        bounds[name] = bound_of(need + out_bytes, ops) + \
            (bound_of(every + out_bytes, ops)[0],)
    torch.cuda.synchronize()
    # phase 9's chromosome-scale step input: the first 262,144 reads as
    # refpos planes, and the het table
    from phaser_tpu_torch.dist.multihost import table_arrays
    step_input = K.pack_reads(bd, rows=np.arange(min(STEP_ROWS, len(bd)))) + \
        table_arrays(vt)
    return (results, bounds, masked_launches["affine_masked"], chrom_launches,
            step_input)


def branch_shapes_phase(device):
    """The four range-join kernels against their plain versions on the
    layouts that reach every branch (testing/layouts.py), 20,000 rows each,
    with room for every hit and with a capacity of 4."""
    import numpy as np
    import torch
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.testing import layouts

    dev = torch.device(device)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    for name in layouts.NAMES + ["big_table"]:
        d = layouts.make(name, n_rows=20_000, n_vars=16_000,
                         contig=4_000_000)
        table = tuple(T(x) for x in layouts.padded_table(d))
        a_in = [T(x) for x in layouts.affine_inputs(d)]
        m_in = [T(x) for x in layouts.masked_inputs(d)]
        d_in = [T(x) for x in layouts.delta_inputs(d)]
        p_in = [T(x) for x in layouts.plane_inputs(d)]
        line = []
        for prog, kernel, plain in (
                ("affine_nibble",
                 lambda c: K.assign_compact_affine_nibble(*a_in, table, c),
                 lambda c: K.affine_nibble_plain(*a_in, table, c)),
                ("affine_masked",
                 lambda c: K.assign_compact_affine_masked(*m_in, table, c),
                 lambda c: K.affine_masked_plain(*m_in, table, c)),
                ("delta_nibble",
                 lambda c: K.assign_compact_delta_nibble(*d_in, table, c),
                 lambda c: K.delta_nibble_plain(*d_in, table, c)),
                ("plane",
                 lambda c: K.assign_compact_plane(*p_in, 10, table, c),
                 lambda c: K.plane_plain(*p_in, 10, table, c))):
            got, want = kernel(1 << 22), plain(1 << 22)
            torch.cuda.synchronize()
            (nk, hk), (npl, hp) = sorted_hits(got), sorted_hits(want)
            check(nk == npl and np.array_equal(hk, hp) and nk > 0,
                  "%s on layout %s: kernel %d hits, plain %d, or they differ"
                  % (prog, name, nk, npl))
            small = kernel(4)
            torch.cuda.synchronize()
            small = small.cpu().numpy()
            check(int(small[0, 0]) == nk and
                  int((small[0, 1:] >= 0).sum()) == min(4, nk),
                  "%s on layout %s: capacity 4 reported %d of %d hits"
                  % (prog, name, int(small[0, 0]), nk))
            line.append("%s %d" % (prog, nk))
        print("   %-12s L=%-3d Mp=%-8d hits: %s; max_abs_err 0, exact count "
              "past capacity" % (name, d["codes"].shape[1],
                                 table[0].shape[0], ", ".join(line)),
              flush=True)


def small_delta_phase(tmp, device):
    import torch

    from phaser_tpu_torch.engine.varmap import build_variant_table
    from phaser_tpu_torch.io import bam as bamio
    from phaser_tpu_torch.io import vcf as vcfio
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.mapper.dispatch import assign_alleles_auto
    from phaser_tpu_torch.testing import datagen

    d = os.path.join(tmp, "small")
    os.makedirs(d)
    vcf, bam, _ = datagen.write_fixture_dir(
        d, seed=52, contigs=("chr20",), contig_len=30000,
        n_variants_per_contig=150, n_reads_per_contig=3000,
        include_indel_variants=True, frac_multiallelic=0.15)
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
             if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = build_variant_table("chr20", hs.pool["chr20"], include_indels=True)
    bd = bamio.read_bam(bam)
    bd = bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0))
    want = assign_alleles_auto(bd, vt, baseq=10, device="host")
    K.reset_launches()
    got = assign_alleles_auto(bd, vt, baseq=10, device=device)
    torch.cuda.synchronize()
    same_hits(got, want, "datagen assign_alleles_auto")
    print("   datagen fixture: %d reads, %d hits, launches %s"
          % (len(bd), len(want), dict(K.LAUNCHES)), flush=True)
    check(min(K.LAUNCHES[k] for k in MAIN_PATH) > 0,
          "datagen run skipped a kernel: %s" % K.LAUNCHES)


def planes_vs_plain(name, path_out, kernel, plain):
    """A planes kernel's (vidx, allele) against its plain version on the
    same CUDA tensors: the path's output and one timed launch of each.
    Returns (max_abs_err, ms, plain_ms, (device_ms, kernel_ms)) as
    kernel_vs_plain."""
    import torch
    want = plain()
    err = 0
    for got in (path_out, kernel()):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.long() - w.long()).abs().max()))
    hits = int((want[0] >= 0).sum())
    check(err == 0, "%s: kernel disagrees with plain version" % name)
    check(hits > 100, "%s: only %d hits" % (name, hits))
    p1 = time_ms(plain, 5)
    k1 = time_ms(kernel, 20)
    k2 = time_ms(kernel, 20)
    p2 = time_ms(plain, 5)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    dev = device_ms(name, kernel)
    check(dev is not None, "%s: the profiler saw no launch of %s"
          % (name, KERNEL_FN[name]))
    print("   %-15s hits=%d max_abs_err=%d  wrapper call %.4f ms (%.4f, %.4f); "
          "on the card %.4f ms, kernel alone %.4f ms   plain %.4f ms (%.4f, "
          "%.4f)" % (name, hits, err, ms, k1, k2, dev[0], dev[1], plain_ms,
                     p1, p2), flush=True)
    return err, ms, plain_ms, dev


def entries_phase(device):
    """The kernel-level entries on tests/test_tpu_hw.py's layout: M = 100k
    table, N = 2^15 reads of 128 bases in 8 narrow regions, so that every
    256-row block's band fits the window (asserted).  The resident table is
    128 positions drawn from the reads' positions."""
    import numpy as np
    import torch
    from phaser_tpu_torch.kernels import alleles as K

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    M, contig, N, L = 100_000, 200_000_000, 1 << 15, 128
    vpos = np.sort(rng.choice(np.arange(1, contig, dtype=np.int64), size=M,
                              replace=False)).astype(np.int32)
    ind = rng.integers(1, 9, size=(M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    region_w = max(contig // 2000, 10 * L)
    region_lo = rng.integers(1, contig - region_w - L, size=8)
    starts = np.sort(np.concatenate([
        rng.integers(lo, lo + region_w, size=N // 8) for lo in region_lo
    ])).astype(np.int32)[:N]
    refpos = starts[:, None] + np.arange(L, dtype=np.int32)[None, :]
    codes = rng.integers(1, 16, size=(N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, size=(N, L)).astype(np.uint8)
    ws = K.plan_windows_plane(refpos, vpos)
    check(ws is not None, "windowed plan failed: the comparison would be "
          "vacuous (whole table against whole table)")
    R_res = 128
    vres = np.sort(rng.choice(np.unique(refpos), size=R_res,
                              replace=False)).astype(np.int32)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    big = [T(x) for x in (codes, quals, refpos, vpos, ind, ni)]
    res = [T(x) for x in (codes, quals, refpos, vres, ind[:R_res],
                          ni[:R_res])]

    K.reset_launches()
    t0 = time.perf_counter()
    outs = {
        "planes": K.assign_alleles_pallas_windowed(
            *big, 10, refpos_host=refpos, vpos_host=vpos),
        "planes_cmp": K.assign_alleles_pallas_windowed(
            *big, 10, refpos_host=refpos, vpos_host=vpos, algo="cmp"),
        "planes_resident": K.assign_alleles_pallas(*res, 10),
    }
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in outs}
    print("   entry calls: %.3f s, launches %s" % (wall, launches), flush=True)
    check(min(launches.values()) > 0, "an entry skipped its kernel: %s"
          % launches)

    # the launches alone (the windowed entry also plans on the host)
    table, rtable = K._entry_table(*big), K._entry_table(*res)
    ws_t = T(ws)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    R = min(256, N)
    runs = {
        "planes": (
            lambda: K._launch_planes("planes_launch", "planes", *big[:3], 10,
                                     ws_t, (K._WIN, R), table, (0,)),
            lambda: K.planes_plain(*big[:3], 10, ws_t, K._WIN, R, table)),
        "planes_cmp": (
            lambda: K._launch_planes("planes_cmp_launch", "planes_cmp",
                                     *big[:3], 10, ws_t, (R,), table),
            lambda: K.planes_cmp_plain(*big[:3], 10, ws_t, R, table)),
        "planes_resident": (
            lambda: K._launch_planes("planes_launch", "planes_resident",
                                     *res[:3], 10, zero, (R_res, N), rtable,
                                     (1,)),
            lambda: K.planes_plain(*res[:3], 10, zero, R_res, N, rtable)),
    }
    results = {name: planes_vs_plain(name, outs[name], *runs[name])
               for name in outs}
    # what these inputs need moved: 4 B of refpos read and 8 B written per
    # base, codes and quals (2 B) only under a base whose position matched,
    # the window starts, and the table entries under the launch's windows
    # (the resident table whole); beside it the "every input byte once"
    # figure of earlier records (6 B read per base, the whole table).  The
    # search depth in a 256-entry window or the resident table, or 256
    # compare-selects per base for cmp
    n_blocks = -(-N // R)
    covered = np.zeros(M + K._WIN + 1, np.int32)
    np.add.at(covered, ws, 1)
    np.add.at(covered, ws + K._WIN, -1)
    windowed = int((np.cumsum(covered)[:M] > 0).sum())
    print("   table entries under the %d windows: %d of %d"
          % (n_blocks, windowed, M), flush=True)
    bounds = {}
    for name, entries, every_entries, ops in (
            ("planes", windowed, M, N * L * 2 * 8),
            ("planes_cmp", windowed, M, N * L * 2 * K._WIN),
            ("planes_resident", R_res, R_res, N * L * 2 * 7)):
        hits = int((outs[name][0] >= 0).sum())
        starts_bytes = 0 if name == "planes_resident" else 4 * n_blocks
        need = N * L * (4 + 8) + 2 * hits + starts_bytes + \
            entries * TABLE_ROW_BYTES
        every = N * L * (6 + 8) + starts_bytes + \
            every_entries * TABLE_ROW_BYTES
        bounds[name] = bound_of(need, ops) + (bound_of(every, ops)[0],)
    # the windowed entry equals the whole-table classifier, as on the TPU,
    # and the whole-table mode (the table in global memory, a skeleton of it
    # in shared memory) equals its plain version at the 100k table
    whole = K.assign_alleles_device(*big, 10)
    whole_plain = K.planes_plain(*big[:3], 10, zero, M, N, table)
    torch.cuda.synchronize()
    for g, w, p in zip(outs["planes"], whole, whole_plain):
        check(torch.equal(g, w), "windowed planes differ from the whole "
              "table's")
        check(torch.equal(w, p), "whole-table planes differ from their "
              "plain version")
    on_card = device_ms("planes_table", lambda: K._launch_planes(
        "planes_launch", "planes", *big[:3], 10, zero, (M, N), table, (0,)))
    check(on_card is not None, "the profiler saw no planes_table_kernel")
    print("   whole-table mode, M = %d: max_abs_err 0, %.4f ms a call of the "
          "entry, %.4f ms on the card"
          % (M, time_ms(lambda: K.assign_alleles_device(*big, 10), 20),
             on_card[0]), flush=True)
    planes_layouts_phase(dev)
    return results, bounds, launches


def planes_layouts_phase(dev):
    """Every mode of the planes kernels against its plain version on the
    layouts of testing/layouts.py that the vector kernels treat apart: an L
    that is no multiple of 4 (the scalar instantiation) and one that is
    none of 16, spliced and descending rows, duplicate table positions (the
    search takes the first, cmp the last), a window that runs past a table
    whose length is no multiple of 4; 20,077 rows each, no multiple of the
    256-row block."""
    import numpy as np
    import torch
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.testing import layouts

    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for lname in layouts.PLANES_NAMES:
        arrays = layouts.planes_layout(lname, n_rows=20_077)
        codes, quals, refpos, vpos = arrays[:4]
        N, L = codes.shape
        M = len(vpos)
        ws = K.plan_windows_plane(refpos, vpos, 256)
        check(ws is not None, "layout %s: no window plan" % lname)
        tx = [T(x) for x in arrays]
        table = K._entry_table(*tx)
        ws_t = T(ws)
        # a resident table of 122 entries (no multiple of 4) under the reads
        seen = np.unique(refpos[refpos > 0])
        rng = np.random.default_rng(1)
        pick = np.sort(rng.choice(len(seen), 122, replace=False))
        rx = tx[:3] + [T(seen[pick].astype(np.int32)),
                       T(rng.integers(1, 9, size=(122, 2)).astype(np.uint8)),
                       T(np.full(122, 2, np.int8))]
        rtable = K._entry_table(*rx)
        modes = {
            "windowed": (
                lambda: K._launch_planes("planes_launch", "planes", *tx[:3],
                                         10, ws_t, (K._WIN, 256), table, (0,)),
                lambda: K.planes_plain(*tx[:3], 10, ws_t, K._WIN, 256, table)),
            "cmp": (
                lambda: K._launch_planes("planes_cmp_launch", "planes_cmp",
                                         *tx[:3], 10, ws_t, (256,), table),
                lambda: K.planes_cmp_plain(*tx[:3], 10, ws_t, 256, table)),
            "whole table": (
                lambda: K.assign_alleles_device(*tx, 10),
                lambda: K.planes_plain(*tx[:3], 10, zero, M, N, table)),
            "resident": (
                lambda: K._launch_planes("planes_launch", "planes_resident",
                                         *rx[:3], 10, zero, (122, N), rtable,
                                         (1,)),
                lambda: K.planes_plain(*rx[:3], 10, zero, 122, N, rtable)),
        }
        line, outs = [], {}
        for mode, (kernel, plain) in modes.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            hits = int((want[0] >= 0).sum())
            check(err == 0 and hits > 0,
                  "planes %s on layout %s: max_abs_err %d, %d hits"
                  % (mode, lname, err, hits))
            outs[mode] = got[0]
            line.append("%s %d" % (mode, hits))
        differ = int((outs["windowed"] != outs["cmp"]).sum())
        check((differ > 0) == (lname == "dup_positions"),
              "layout %s: the search and cmp differ on %d bases"
              % (lname, differ))
        print("   %-18s N=%d L=%d M=%d hits: %s; max_abs_err 0; search and "
              "cmp differ on %d bases"
              % (lname, N, L, M, ", ".join(line), differ), flush=True)


class _FakeVT:
    """Variant-table stand-in for build_connections
    (tests/test_components.py)."""

    def __init__(self, n):
        self._n = n
        self.phases = ["-"] * n
        self.ind_alleles = [("A", "G")] * n

    def __len__(self):
        return self._n


def timed_pair(fn, device, warm):
    """(host s, cuda s, results) in turns host, cuda, cuda, host; each time
    is the mean of its two runs.  With `warm`, one untimed device call
    first takes the CUDA start-up of the stage's operators."""
    import torch
    ts = {"host": [], device: []}
    out = {}
    for dv in ((device,) if warm else ()) + ("host", device, device,
                                            "host"):
        t0 = time.perf_counter()
        out[dv] = fn(dv)
        torch.cuda.synchronize()
        ts[dv].append(time.perf_counter() - t0)
    if warm:
        ts[device].pop(0)
    return (sum(ts["host"]) / 2, sum(ts[device]) / 2, out["host"],
            out[device], ts)


class forced_gate:
    """Sets a module's gate constant for a with-block (a below-gate size
    that should still take the device path)."""

    def __init__(self, module, name, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def stages_phase(device):
    """Engine stages #3-#5 below (gate forced down), at and above their
    gates, cuda against host."""
    from types import SimpleNamespace

    import numpy as np
    from phaser_tpu_torch.engine import blocks, connections, phasing

    rng = np.random.default_rng(1)
    rows = []

    # #3: synthetic two-hit reads over 5000 variants, pairs within 200
    n_vars = 5000
    for k, n_reads in enumerate((60_000, 240_000, 2_000_000)):
        v1 = rng.integers(0, n_vars, n_reads)
        v2 = np.minimum(v1 + 1 + rng.integers(0, 200, n_reads), n_vars - 1)
        ok = v1 != v2
        v1, v2 = v1[ok], v2[ok]
        uid = np.repeat(np.arange(len(v1), dtype=np.int64), 2)
        var = np.stack([v1, v2], 1).ravel().astype(np.int64)
        allele = rng.integers(0, 3, size=len(var)).astype(np.int64)
        vr = SimpleNamespace(vt=_FakeVT(n_vars), rv_uid=uid, rv_var=var,
                             h_uid=uid, h_var=var, h_allele=allele)
        before = connections.COUNTS["device_calls"]
        with forced_gate(connections, "DEVICE_PAIR_GATE",
                         0 if k == 0 else connections.DEVICE_PAIR_GATE):
            th, tc, h, c, ts = timed_pair(
                lambda dv: connections.build_connections(vr, 0.002, 0.01,
                                                         device=dv),
                device, warm=k == 0)
        check(connections.COUNTS["device_calls"] == before + 2 + (k == 0),
              "#3 did not take the device path")
        check((h.n_pairs >= connections.DEVICE_PAIR_GATE) == (k > 0),
              "#3 size on the wrong side of the gate")
        for f in ("var_a", "var_b", "c_supporting", "c_total", "p_value",
                  "chosen_config", "pruned"):
            check(np.array_equal(getattr(h, f), getattr(c, f)),
                  "#3 %s differs between cuda and host" % f)
        check(h.adj == c.adj and h.allele_conn == c.allele_conn,
              "#3 graph differs between cuda and host")
        rows.append(("#3 pair counting", "%d pairs" % h.n_pairs, th, tc, ts))

    # #4: local edges (each variant linked to one of its next four), the
    # shape of haplotype blocks; n_edges counts both directions
    for k, n_und in enumerate((13_000, 53_000, 500_000)):
        V = 4 * n_und
        a = rng.integers(0, V - 5, n_und)
        b = a + rng.integers(1, 5, n_und)
        adj = {}
        for x, y in zip(a.tolist(), b.tolist()):
            adj.setdefault(x, set()).add(y)
            adj.setdefault(y, set()).add(x)
        n_edges = sum(len(v) for v in adj.values())
        conn = SimpleNamespace(adj=adj,
                               var_rank=rng.permutation(V).astype(np.int64))
        vt = SimpleNamespace(pos=np.arange(V, dtype=np.int64) * 10)
        before = blocks.COUNTS["device_calls"]
        with forced_gate(blocks, "_DEVICE_EDGE_GATE",
                         0 if k == 0 else blocks._DEVICE_EDGE_GATE):
            th, tc, h, c, ts = timed_pair(
                lambda dv: blocks.find_blocks(conn, vt, device=dv), device,
                warm=k == 0)
        check(blocks.COUNTS["device_calls"] == before + 2 + (k == 0),
              "#4 did not take the device path")
        check((n_edges >= blocks._DEVICE_EDGE_GATE) == (k > 0),
              "#4 size on the wrong side of the gate")
        check(h == c, "#4 blocks differ between cuda and host")
        rows.append(("#4 components", "%d edges" % n_edges, th, tc, ts))

    # #5: a read-consistent chain with longer links: a unique best config
    gate = phasing.DEVICE_SCORE_GATE
    for n in range(gate - 4, 23):
        truth = rng.integers(0, 2, n)
        ac = {}
        for i in range(n - 1):
            for j in (i + 1, i + 3):
                if j >= n:
                    continue
                for x in (0, 1):
                    y = x if truth[i] == truth[j] else 1 - x
                    ac.setdefault((i, x), set()).add((j, y))
                    ac.setdefault((j, y), set()).add((i, x))
        variants = list(range(n))
        before = phasing.COUNTS["device_calls"]
        with forced_gate(phasing, "DEVICE_SCORE_GATE", min(n, gate)):
            th, tc, h, c, ts = timed_pair(
                lambda dv: phasing.sub_block_phase(variants, ac, device=dv),
                device, warm=n == gate - 4)
        check(phasing.COUNTS["device_calls"] ==
              before + 2 + (n == gate - 4), "#5 did not take the device path")
        check(h == c and "-" not in h[0], "#5 phase differs between cuda and "
              "host, or tied: %s / %s" % (h, c))
        rows.append(("#5 2^n scorer", "n = %d" % n, th, tc, ts))

    for stage, size, th, tc, ts in rows:
        print("   %-17s %-14s host %.4f s  cuda %.4f s   (runs %s)"
              % (stage, size, th, tc, {k: ["%.4f" % t for t in v]
                                       for k, v in ts.items()}), flush=True)
    return rows


def run_cli(argv):
    """The port's CLI entry point, `phaser_main.main(argv)` (what `python -m
    phaser_tpu_torch.cli.phaser_main` runs), in this process.  Returns
    (exit code, its standard output, wall seconds)."""
    import contextlib
    import io

    import torch
    from phaser_tpu_torch.cli import phaser_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = phaser_main.main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def counted_cli_run(argv, gates_down=False):
    """run_cli with every kernel launch, capacity relaunch and device stage
    call counted from 0 just before the run and read just after; with
    `gates_down` the three stage gates are forced down for the run.
    Returns (exit code, stdout, wall s, launches, relaunches, stage calls)."""
    import contextlib

    from phaser_tpu_torch.engine import blocks, connections, phasing
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.mapper import dispatch as D
    gates = ((connections, "DEVICE_PAIR_GATE", 0),
             (blocks, "_DEVICE_EDGE_GATE", 0),
             (phasing, "DEVICE_SCORE_GATE", 2))
    K.reset_launches()
    D.reset_stats()
    D.RELAUNCHES["capacity"] = 0
    for m, _, _ in gates:
        m.COUNTS["device_calls"] = 0
    with contextlib.ExitStack() as stack:
        if gates_down:
            for gate in gates:
                stack.enter_context(forced_gate(*gate))
        rc, stdout, wall = run_cli(argv)
    calls = {m.__name__.rsplit(".", 1)[1]: m.COUNTS["device_calls"]
             for m, _, _ in gates}
    return (rc, stdout, wall, dict(K.LAUNCHES), D.RELAUNCHES["capacity"],
            calls)


def e2e_phase(tmp, device):
    from phaser_tpu_torch.testing import datagen

    shares = (0.6, 0.25, 0.15)
    pairs = [int(E2E_READS // 2 * s) for s in shares]
    lens = [max(250_000, p * 12) for p in pairs]
    nvar = [max(100, p // 40) for p in pairs]
    d = os.path.join(tmp, "e2e")
    os.makedirs(d)
    t0 = time.perf_counter()
    vcf, bam, data = datagen.write_fixture_dir(
        d, seed=77, contigs=("chr1", "chr2", "chr3"), contig_len=lens,
        n_variants_per_contig=nvar, n_reads_per_contig=pairs,
        error_rate=0.01)
    print("   fixture: %d input reads, %d variants, %.1f s"
          % (2 * sum(pairs), sum(nvar), time.perf_counter() - t0),
          flush=True)
    from phaser_tpu_torch.engine import connections
    walls = {}
    launches, relaunches, stage_calls = None, 0, {}
    for run in (device, "host", "gates_down"):
        dv = "host" if run == "host" else device
        argv = ["--vcf", vcf, "--bam", bam, "--sample", data.sample,
                "--mapq", "10", "--baseq", "10", "--paired_end", "1",
                "--o", os.path.join(d, run), "--device", dv]
        rc, stdout, walls[run], run_launches, run_relaunches, calls = \
            counted_cli_run(argv, gates_down=run == "gates_down")
        if run == device:
            launches, relaunches = run_launches, run_relaunches
        stage_calls[run] = calls
        check(rc == 0, "CLI %s failed:\n%s" % (run, stdout[-3000:]))
        lines = stdout.splitlines()
        start = next((i for i, x in enumerate(lines)
                      if "stage timings" in x), len(lines))
        for line in lines[start + 1:]:
            if line.strip().startswith(("#", "device path", "COMPLETED")):
                print("   [%s] %s" % (run, line.strip()), flush=True)
        print("   [%s] device stage calls %s, reads over the pair K cap %d"
              % (run, calls, connections.COUNTS["host_reads"]), flush=True)
        if run != "host":
            from phaser_tpu_torch.mapper import dispatch as D
            filter_stats(D, "[%s] allele assignment" % run, dropped=False)
    for run in (device, "gates_down"):
        same_outputs(os.path.join(d, run), os.path.join(d, "host"),
                     "e2e run %s" % run, vcf_text=False)
    print("   outputs byte-identical to host in both cuda runs (%s)"
          % ", ".join(SUFFIXES), flush=True)
    print("   e2e wall (CLI main, in process): %s %.3f s, host %.3f s, "
          "gates down %.3f s; kernel launches %s; capacity relaunches %d"
          % (device, walls[device], walls["host"], walls["gates_down"],
             launches, relaunches), flush=True)
    check(launches and min(launches[k] for k in MAIN_PATH) > 0,
          "main path skipped a kernel: %s" % launches)
    check(min(stage_calls["gates_down"].values()) > 0,
          "gates-down run skipped a device stage: %s"
          % stage_calls["gates_down"])
    return launches, dict(vcf=vcf, bam=bam, sample=data.sample, dir=d)


def same_outputs(got, want, what, vcf_text):
    """The six outputs of `got` against those of `want`, byte for byte;
    with `vcf_text` the .vcf.gz after BGZF decompression, since a shard
    merge re-blocks the VCF body (in phaser_tpu as here)."""
    from phaser_tpu_torch.io import bgzf
    for sfx in SUFFIXES:
        if vcf_text and sfx == ".vcf.gz":
            same = bgzf.read_text_auto(got + sfx) == \
                bgzf.read_text_auto(want + sfx)
        else:
            with open(got + sfx, "rb") as a, open(want + sfx, "rb") as b:
                same = a.read() == b.read()
        check(same, "%s: output %s differs from its host reference"
              % (what, sfx))


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(cmds, timeout):
    """Starts every command at once (output to files: a full pipe would
    stall a rank in a collective), waits for all, and returns their
    outputs; fails unless every one exits 0."""
    procs, logs = [], []
    try:
        for cmd in cmds:
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        rcs = [p.wait(timeout=timeout) for p in procs]
        outs = []
        for fh in logs:
            fh.seek(0)
            outs.append(fh.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    check(rcs == [0] * len(cmds), "processes exited %s:\n%s"
          % (rcs, "\n".join(o[-2000:] for o in outs)))
    return outs


def multihost_run(fx, prefix, device, n_procs=2, timeout=600):
    """n_procs `python -m phaser_tpu_torch.dist.engine_multihost` engine
    processes with position shards over one Gloo group, all on this
    machine's card.  Returns (wall s, [device_s of each process])."""
    port = free_port()
    t0 = time.perf_counter()
    outs = run_ranks([
        [sys.executable, "-m", "phaser_tpu_torch.dist.engine_multihost",
         "--vcf", fx["vcf"], "--bam", fx["bam"], "--sample", fx["sample"],
         "--o", prefix, "--num-processes", str(n_procs), "--process-id",
         str(pid), "--position-shards", "--device", device, "--coordinator",
         "localhost:%d" % port, "--timeout", "300"]
        for pid in range(n_procs)], timeout)
    wall = time.perf_counter() - t0
    device_s = []
    for out in outs:
        done = [l for l in out.splitlines()
                if l.startswith("MULTIHOST_ENGINE_DONE")]
        check(done, "an engine process printed no result:\n" + out[-2000:])
        device_s.append(float(done[0].split("device_s=")[1].split()[0]))
    return wall, device_s


def sharded_phase(fx, device, smi):
    """The sharded runners on phase 6's fixture, each through its user entry
    point, against a single-process --device host reference:
      a. --threads 4: four position-shard engine threads sharing the card;
      b. the same with the three stage gates forced down;
      c. --threads 2 --device host: two engine processes over Gloo;
      d. two `python -m phaser_tpu_torch.dist.engine_multihost` processes
         on the card;
      e. --process_slow 1, and f. --process_slow 1 --threads 2, against
         --process_slow 1 --device host (slow mode estimates noise per
         contig, so its reference is its own host run).
    Counts are zeroed just before each run and read just after."""
    d = fx["dir"]
    base = ["--vcf", fx["vcf"], "--bam", fx["bam"], "--sample", fx["sample"],
            "--mapq", "10", "--baseq", "10", "--paired_end", "1"]
    host = os.path.join(d, "host")
    runs = (  # name, CLI flags, gates down, reference
        ("a", ["--threads", "4", "--device", device], False, host),
        ("b", ["--threads", "4", "--device", device], True, host),
        ("c", ["--threads", "2", "--device", "host"], False, host),
        ("slow_host", ["--process_slow", "1", "--device", "host"], False,
         None),
        ("e", ["--process_slow", "1", "--device", device], False,
         os.path.join(d, "slow_host")),
        ("f", ["--process_slow", "1", "--threads", "2", "--device", device],
         False, os.path.join(d, "slow_host")))
    record = {}
    for name, flags, gates_down, ref in runs:
        out = os.path.join(d, name)
        rc, stdout, wall, launches, _, calls = counted_cli_run(
            base + ["--o", out] + flags, gates_down=gates_down)
        check(rc == 0, "run %s (%s) failed:\n%s"
              % (name, " ".join(flags), stdout[-3000:]))
        shards = [l.split(":", 1)[1].strip() for l in stdout.splitlines()
                  if "shard device/wall seconds:" in l]
        print("   [%s] %-38s wall %.3f s on %s; launches %s; stage calls %s; "
              "shard device/wall s: %s"
              % (name, " ".join(flags), wall, smi,
                 {k: launches[k] for k in MAIN_PATH}, calls,
                 shards[0] if shards else "-"), flush=True)
        if ref is not None:
            same_outputs(out, ref, "run %s" % name,
                         vcf_text=ref == host)
        record[name] = dict(launches=launches, calls=calls)
    check(min(record["a"]["launches"][k] for k in MAIN_PATH) > 0,
          "run a (--threads 4) skipped a main-path kernel: %s"
          % record["a"]["launches"])
    check(min(record["b"]["calls"].values()) > 0,
          "run b (gates down) skipped a device stage: %s"
          % record["b"]["calls"])
    for name in ("e", "f"):
        check(sum(record[name]["launches"].values()) > 0,
              "run %s launched no kernel" % name)
    for name in ("c", "slow_host"):
        check(sum(record[name]["launches"].values()) == 0,
              "host run %s launched a kernel" % name)

    wall, device_s = multihost_run(fx, os.path.join(d, "d"), device)
    print("   [d] %-38s wall %.3f s on %s; device_s per process %s"
          % ("2 x engine_multihost --device " + device, wall, smi,
             ["%.3f" % x for x in device_s]), flush=True)
    same_outputs(os.path.join(d, "d"), host, "run d", vcf_text=True)
    check(min(device_s) > 0, "an engine process reported no device time: %s"
          % device_s)
    print("   outputs of a-d equal the single-process host run (text files "
          "byte for byte, the VCF decompressed); e-f equal the "
          "--process_slow 1 host run byte for byte", flush=True)


def tool_main(module, argv):
    """A CLI's `main(argv)` in this process: (exit code, stdout, wall s)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def tsv_columns(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    head = lines[0].split("\t")
    rows = [l.split("\t") for l in lines[1:]]
    check(all(len(r) == len(head) for r in rows), "%s: ragged rows" % path)
    return {h: [r[i] for r in rows] for i, h in enumerate(head)}


def downstream_phase(tmp, fx, smi):
    """Phase 8 (see the module docstring)."""
    import numpy as np
    import torch
    from phaser_tpu_torch.analysis import cis_var
    from phaser_tpu_torch.cli import (annotate_main, cis_var_main,
                                      expr_matrix_main, gene_ae_main,
                                      mapper_main)
    from phaser_tpu_torch.io import bgzf, tabix
    from phaser_tpu_torch.kernels import bootstrap
    from phaser_tpu_torch.testing import popdata

    d = os.path.join(tmp, "pop")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    gdir, features = popdata.make_gene_ae_dir(d, rng, POP_SAMPLES, POP_GENES)
    hap = popdata.make_hap_counts(d, rng, POP_GENES)
    vcf, pairs, smap = popdata.make_cis_var_inputs(d, rng, POP_SAMPLES,
                                                   POP_GENES, POP_PAIRS)
    sub = popdata.head_pairs(pairs, POP_SUBSET,
                             os.path.join(d, "pairs_sub.txt"))
    print("   fixture: %d gene-AE files x %d genes, %d haplotypic-count "
          "rows, %d pairs over %d samples, %.1f s"
          % (POP_SAMPLES, POP_GENES, 3 * POP_GENES, POP_PAIRS, POP_SAMPLES,
             time.perf_counter() - t0), flush=True)
    walls = {}

    o = os.path.join(d, "gene_ae.txt")
    rc, out, walls["gene_ae"] = tool_main(gene_ae_main, [
        "--haplotypic_counts", hap, "--features", features, "--o", o])
    check(rc == 0, "gene_ae failed:\n" + out[-2000:])
    cols = tsv_columns(o)
    check(len(cols) == 12 and len(cols["name"]) == POP_GENES and
          sum(int(x) for x in cols["totalCount"]) > 0,
          "gene_ae output is not one row per gene")
    print("   gene_ae: %d rows in, %d genes out, wall %.3f s on %s"
          % (3 * POP_GENES, POP_GENES, walls["gene_ae"], smi), flush=True)

    mat = os.path.join(d, "matrix")
    rc, out, walls["expr_matrix"] = tool_main(expr_matrix_main, [
        "--gene_ae_dir", gdir, "--features", features, "--o", mat])
    check(rc == 0, "expr_matrix failed:\n" + out[-2000:])
    lo = 1000 + 2000 * (POP_GENES // 2)         # genes every 2,000 bp
    hi = lo + 2000 * max(POP_GENES // 20, 5)
    for sfx in (".bed.gz", ".gw_phased.bed.gz"):
        rows = bgzf.read_text_auto(mat + sfx).decode().splitlines()
        check(len(rows) == POP_GENES + 1 and
              len(rows[0].split("\t")) == 4 + POP_SAMPLES,
              "matrix %s is not genes x samples" % sfx)
        tf = tabix.TabixFile(mat + sfx)
        got = list(tf.fetch("chr20", lo, hi))
        want = [r for r in rows[1:] if int(r.split("\t")[2]) > lo
                and int(r.split("\t")[1]) < hi]
        check(got == want and len(want) >= 5,
              "matrix %s: the .tbi does not read back its rows" % sfx)
    print("   expr_matrix: %d files, 2 matrices of %d x %d written, indexed "
          "and read back through TabixFile, wall %.3f s on %s"
          % (POP_SAMPLES, POP_GENES, POP_SAMPLES, walls["expr_matrix"], smi),
          flush=True)

    gates = {n: cis_var.resolve_engine("auto", "cuda", n, POP_BS)
             for n in (POP_SUBSET, POP_PAIRS)}
    print("   auto gate (crossover pairs x bs %d): %d pairs -> %s, %d pairs "
          "-> %s" % (cis_var.AUTO_CROSSOVER, POP_SUBSET, gates[POP_SUBSET],
                     POP_PAIRS, gates[POP_PAIRS]), flush=True)
    bed = mat + ".gw_phased.bed.gz"

    def cis(name, pairs_path, engine):
        out_path = os.path.join(d, name + ".txt")
        argv = ["--bed", bed, "--vcf", vcf, "--pairs", pairs_path, "--map",
                smap, "--o", out_path, "--bs", str(POP_BS), "--bs_seed", "7",
                "--engine", engine]
        if engine == "torch":
            argv += ["--device", "cuda"]
        before = dict(bootstrap.STATS)
        torch.cuda.reset_peak_memory_stats()
        rc, out, wall = tool_main(cis_var_main, argv)
        check(rc == 0, "cis_var %s failed:\n%s" % (name, out[-2000:]))
        walls[name] = wall
        ran = {k: bootstrap.STATS[k] - before[k] for k in before}
        return out_path, ran, torch.cuda.max_memory_allocated()

    # keep the cohorts of the full run, to time the same bootstrap warm
    real_bootstrap = bootstrap.bootstrap_cis_device
    cohorts = []

    def recording(cs, *a, **k):
        cohorts.extend(cs)
        return real_bootstrap(cs, *a, **k)
    bootstrap.bootstrap_cis_device = recording
    try:
        full, ran, peak = cis("cis_var_torch", pairs, "torch")
    finally:
        bootstrap.bootstrap_cis_device = real_bootstrap
    card_s = ran["device_s"]
    cols = tsv_columns(full)
    check(ran["calls"] == 1 and len(cols["gene"]) == POP_PAIRS,
          "the torch run made %d bootstrap calls for %d rows"
          % (ran["calls"], len(cols["gene"])))
    # the least the card could take: the (rows, bs) float32 medians written
    # once and read once (the draws' arithmetic over 67 T/s is less)
    bound_ms = bound_of(2 * 4 * ran["rows"] * POP_BS, 0)[0]
    lo, mid, hi = (np.array([float(v) for v in cols[c]]) for c in (
        "var_het_afc_lower", "var_het_afc", "var_het_afc_upper"))
    check(np.isfinite(lo).all() and (lo <= mid + 1e-6).all() and
          (mid <= hi + 1e-6).all(), "torch CI bounds out of order")
    print("   cis_var --engine torch --device cuda, %d pairs x bs %d (%d "
          "non-empty cohorts in %d chunks): wall %.3f s, bootstrap on the "
          "card %.4f s (CUDA events; %.2f%% of the wall; bound %.4f ms by "
          "bytes), peak device memory %.1f MB, on %s"
          % (POP_PAIRS, POP_BS, ran["rows"], ran["chunks"],
             walls["cis_var_torch"], card_s,
             100.0 * card_s / walls["cis_var_torch"], bound_ms, peak / 1e6,
             smi), flush=True)
    warm, results = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        before = bootstrap.STATS["device_s"]
        results.append(np.array(real_bootstrap(cohorts, POP_BS, seed=7,
                                               device="cuda")))
        warm.append(bootstrap.STATS["device_s"] - before)
    warm_peak = torch.cuda.max_memory_allocated()
    check(np.array_equal(results[0], results[1], equal_nan=True),
          "one seed gave two bootstraps on the card")
    # the draws follow the cohort set, so both devices get the same few
    few = cohorts[:4 * POP_SUBSET]
    on = {dev: np.array(real_bootstrap(few, POP_BS, seed=7, device=dev))
          for dev in ("cuda", "cpu")}
    cpu_gap = float(np.nanmax(np.abs(on["cpu"] - on["cuda"])[:, :2]))
    print("   the same bootstrap again, warm: %.4f / %.4f s on the card "
          "(CUDA events), peak device memory %.1f MB, the two equal; cpu "
          "against cuda on %d cohorts: CI bounds at most %.4f apart (other "
          "streams), on %s" % (warm[0], warm[1], warm_peak / 1e6, len(few),
                               cpu_gap, smi), flush=True)

    np_out, _, _ = cis("cis_var_numpy_sub", sub, "numpy")
    t1, ran1, _ = cis("cis_var_torch_sub", sub, "torch")
    t2, _, _ = cis("cis_var_torch_sub_again", sub, "torch")
    card1 = ran1["device_s"]
    A, B = tsv_columns(np_out), tsv_columns(t1)
    for c in POP_DET:
        check(A[c] == B[c], "column %s differs between numpy and torch" % c)
    het_n = np.array([int(x) for x in A["var_het_n"]])
    worst = 0.0
    for c in ("var_het_afc_lower", "var_het_afc_upper", "var_hom_afc_lower",
              "var_hom_afc_upper"):
        a = np.array([float(v) for v in A[c]])
        b = np.array([float(v) for v in B[c]])
        worst = max(worst, float(np.abs(a - b)[het_n > 3].max()))
    check(worst < 2.0, "torch CI bounds %.3f away from numpy's" % worst)
    with open(t1, "rb") as fa, open(t2, "rb") as fb:
        check(fa.read() == fb.read(), "one seed gave two torch files")
    per_np = walls["cis_var_numpy_sub"] / POP_SUBSET
    per_t = walls["cis_var_torch_sub"] / POP_SUBSET
    print("   %d pairs: numpy %.3f s, torch %.3f / %.3f s (card %.4f s); "
          "deterministic columns byte-equal, CI bounds within %.3f, the two "
          "torch files byte-equal; per pair numpy %.4f s, torch %.4f s "
          "(%d pairs: %.4f s), on %s"
          % (POP_SUBSET, walls["cis_var_numpy_sub"],
             walls["cis_var_torch_sub"], walls["cis_var_torch_sub_again"],
             card1, worst, per_np, per_t, POP_PAIRS,
             walls["cis_var_torch"] / POP_PAIRS, smi), flush=True)

    cadd = popdata.write_cadd(fx["vcf"], os.path.join(d, "cadd.tsv.gz"),
                              gene_span=2_000, n_genes=1_000_000)
    o = os.path.join(d, "compound_hets.txt")
    rc, out, walls["annotate"] = tool_main(annotate_main, [
        "--geno_vcf", os.path.join(fx["dir"], "cuda.vcf.gz"), "--sample",
        fx["sample"], "--cadd_file", cadd, "--o", o])
    check(rc == 0, "annotate failed:\n" + out[-2000:])
    cols = tsv_columns(o)
    check(len(cols) == 16 and len(cols["ensg"]) > 0 and
          set(cols["configuration"]) <= {"cis", "trans"},
          "annotate output is not well formed")
    print("   annotate: %d compound-het rows from phase 6's phased VCF, wall "
          "%.3f s on %s" % (len(cols["ensg"]), walls["annotate"], smi),
          flush=True)

    table, sam = popdata.mapper_inputs(fx["vcf"], fx["bam"], d, MAPPER_READS)
    o = os.path.join(d, "read_variant_map.tsv")
    t0 = time.perf_counter()
    rc = mapper_main.run(table, 10, o, 1, 0, sam.splitlines())
    walls["read_variant_map"] = time.perf_counter() - t0
    check(rc == 0, "the read -> variant mapper failed")
    with open(o) as fh:
        rows = [l.split("\t") for l in fh.read().splitlines()]
    check(len(rows) > 1000 and len({len(r) for r in rows}) == 1,
          "mapper output is not well formed")
    print("   read -> variant mapper: %d reads, %d rows, wall %.3f s on %s"
          % (MAPPER_READS, len(rows), walls["read_variant_map"], smi),
          flush=True)


def step_kernels_vs_plain(name, args, step, smi, device):
    """The four kernels of the sharded step against their plain versions
    on the step's own tensors (one input set of phase 9): planes_table on
    the step's read planes, band_counts on the planes it returned, and
    conflict_prune and binom_cdf on the merged band.  Returns {kernel:
    (max_abs_err, ms, plain_ms, (device_ms, kernel_ms, profiles))} and
    {kernel: (bound_ms, bound_by)}."""
    import numpy as np
    import torch
    from phaser_tpu_torch.dist import mesh as TM
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.kernels import stats as S

    dev = torch.device(device)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in args]
    N, L = t[0].shape
    M = int(t[3].shape[0])
    table = K._entry_table(*t)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    counts, pair = step[0], step[1]
    vidx, allele = K.assign_alleles_device(*t, 10)
    cfg = TM.band_configs(pair)
    noise = S.noise_from_counts(counts)
    sup, total, p_success = S._conflict_args(*cfg, noise)

    def planes_err(got, want):
        return max(int((g.long() - w.long()).abs().max()) for g, w in
                   zip(got, want))

    def bc_err(got, want):
        return max(int((g - w).abs().max()) for g, w in zip(got, want))

    def prune_err(got, want):
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              "conflict_prune: prune or uncertain differ from the plain "
              "version's")
        return float((got[0] - want[0]).abs().max())

    def cdf_err(got, want):
        return float((got - want).abs().max())
    runs = {
        "planes_table": (lambda: K.assign_alleles_device(*t, 10),
                         lambda: K.planes_plain(*t[:3], 10, zero, M, N,
                                                table), planes_err),
        "band_counts": (lambda: TM.band_counts(vidx, allele, M, STEP_BAND),
                        lambda: TM.band_counts_plain(vidx, allele, M,
                                                     STEP_BAND), bc_err),
        "conflict_prune": (lambda: S.prune_mask(*cfg, noise, STEP_THRESHOLD),
                           lambda: S.conflict_prune_plain(*cfg, noise,
                                                          STEP_THRESHOLD),
                           prune_err),
        "binom_cdf": (lambda: S.binom_cdf(sup, total, p_success),
                      lambda: S.binom_cdf_plain(sup, total, p_success),
                      cdf_err),
    }
    results = {}
    for kname, (kernel, plain, err_of) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = err_of(got, want)
        check(err <= STEP_TOL[kname], "%s (%s input): max_abs_err %g over "
              "%g" % (kname, name, err, STEP_TOL[kname]))
        p1 = time_ms(plain, 3)
        k1 = time_ms(kernel, 20)
        k2 = time_ms(kernel, 20)
        p2 = time_ms(plain, 3)
        on_card = device_ms(kname, kernel)
        check(on_card is not None, "%s: the profiler saw no launch of %s"
              % (kname, KERNEL_FN[kname]))
        results[kname] = (err, (k1 + k2) / 2, (p1 + p2) / 2, on_card)

    # bounds from this input: bytes each input read once and each output
    # written once; operations as these inputs need them
    hits = allele < 3
    per_row = hits.sum(dim=1).double()
    n_pairs = sup.numel()
    _, c_terms = S.conflict_terms(*cfg, noise)
    b_terms = S.binom_cdf_terms(sup, total, p_success)
    steps = max(M.bit_length() - 1, 1)
    bounds = {
        # refpos read and both planes written (12 B a base), codes and
        # quals under a hit, the table once; a search per base
        "planes_table": bound_of(N * L * 12 + 2 * int(hits.sum()) +
                                 M * TABLE_ROW_BYTES, N * L * 2 * steps),
        # both planes read (8 B a base), counts and the band written once;
        # a test per base and per ordered hit pair of a row
        "band_counts": bound_of(N * L * 8 + M * 12 + M * STEP_BAND * 36,
                                N * L * 2 + int((per_row ** 2).sum())),
        # three int32 counts and the noise read, p and two flags written;
        # float64 operations of the fractions these pairs take
        "conflict_prune": fp64_bound(
            n_pairs * 22 + 8, int(c_terms.sum()) * BETACF_TERM_FLOPS +
            int((c_terms > 0).sum()) * BETACF_SETUP_FLOPS),
        "binom_cdf": fp64_bound(
            n_pairs * 32, int(b_terms.sum()) * BETACF_TERM_FLOPS +
            int((b_terms > 0).sum()) * BETACF_SETUP_FLOPS),
    }
    for kname, (err, ms, plain_ms, (dev_ms, kernel_ms, _)) in \
            results.items():
        print("   [%s] %-14s max_abs_err %g  wrapper call %.4f ms; on the "
              "card %.4f ms, kernel alone %.4f ms   plain %.4f ms   bound "
              "%.4f ms (%s)   on %s"
              % (name, kname, err, ms, dev_ms, kernel_ms, plain_ms,
                 bounds[kname][0], bounds[kname][1], smi), flush=True)
    print("   [%s] %d x %d bases, M %d: %d hits, %d pairs in the band, %d "
          "pairs with support, fraction terms: conflict_prune %d (max %d), "
          "binom_cdf %d (max %d)"
          % (name, N, L, M, int(hits.sum()), int(pair.sum()),
             int((sup > 0).sum()), int(c_terms.sum()), int(c_terms.max()),
             int(b_terms.sum()), int(b_terms.max())), flush=True)
    return results, bounds


def step_subset_vs_host(args, device):
    """The step on the first STEP_CHECK_ROWS rows against dist/dryrun.py's
    numpy and scipy recomputations: counts, band and scores equal, the
    p-values within 1e-10 of scipy, prune equal."""
    import numpy as np
    from phaser_tpu_torch.dist import dryrun
    from phaser_tpu_torch.dist import mesh as TM

    sub = [np.ascontiguousarray(a[:STEP_CHECK_ROWS]) for a in args[:3]] + \
        list(args[3:])
    step = TM.sharded_phasing_step(TM.make_mesh(1, device=device), *sub, 10,
                                   band=STEP_BAND,
                                   cc_threshold=STEP_THRESHOLD)
    p = TM.connection_p_values(step[0], step[1]).cpu().numpy()
    counts, pair, prune, scores = (x.cpu().numpy() for x in step)
    ec, ep = dryrun._host_counts_band(*sub, 10, STEP_BAND)
    check(np.array_equal(counts, ec) and np.array_equal(pair, ep),
          "step counts or band differ from the numpy recomputation")
    check(np.array_equal(scores, dryrun._host_scores(ep, 8, STEP_BAND)),
          "step scores differ from the host's")
    eprune, ep_p = dryrun._host_prune(ec, ep, STEP_THRESHOLD)
    gap = float(np.abs(p - ep_p).max())
    sure = np.abs(ep_p - STEP_THRESHOLD) > 1e-12
    check(gap <= 1e-10 and np.array_equal(prune[sure], eprune[sure]),
          "step p-values %g from scipy's, or prune differs" % gap)
    return int(ec.sum()), int(ep.sum()), int(eprune.sum()), gap


def sharded_step_phase(step_input, fx, smi, device):
    """Phase 9 (see the module docstring).  Returns the four step kernels'
    (results, bounds, launches on the step path)."""
    import numpy as np
    import torch
    from phaser_tpu_torch.dist import dryrun
    from phaser_tpu_torch.dist import mesh as TM
    from phaser_tpu_torch.dist import multihost
    from phaser_tpu_torch.dist.scaling_bench import _gen
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.kernels import stats as S

    from phaser_tpu_torch.io import bam as bamio
    from phaser_tpu_torch.kernels.alleles import pack_reads
    bd = bamio.read_bam(fx["bam"])
    inputs = {"chromosome": step_input,
              "dense": _gen(STEP_ROWS, 128, CHROM_HETS),
              "e2e": pack_reads(bd, rows=np.flatnonzero(
                  bd.refid == 0)[:STEP_ROWS]) + multihost.device_table(
                      fx["vcf"], fx["sample"], "")}
    del bd
    mesh = TM.make_mesh(1, device=device)
    launches = dict.fromkeys(STEP_KERNELS, 0)
    results, bounds = {}, {}
    for name, args in inputs.items():
        # (a) the step and its connection p-values, launches counted from 0
        K.reset_launches()
        TM.reset_launches()
        S.reset_launches()
        t0 = time.perf_counter()
        step = TM.sharded_phasing_step(mesh, *args, 10, band=STEP_BAND,
                                       cc_threshold=STEP_THRESHOLD)
        p = TM.connection_p_values(step[0], step[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"planes_table": K.LAUNCHES["planes_table"],
               "band_counts": TM.LAUNCHES["band_counts"],
               "conflict_prune": S.LAUNCHES["conflict_prune"],
               "binom_cdf": S.LAUNCHES["binom_cdf"]}
        for k, n in run.items():
            launches[k] += n
        counts, pair, prune, scores = step
        check(int(counts.sum()) > 0 and bool(torch.isfinite(p).all()) and
              tuple(pair.shape) == (len(args[3]), STEP_BAND, 9) and
              scores.shape[0] == 128,
              "%s step: no hits, a p-value not finite, or a shape wrong"
              % name)
        print("   [%s] sharded_phasing_step + p-values, 1 shard: %.3f s "
              "(first call of the input); %d hits, %d band pairs, %d pruned "
              "of %d; launches %s; on %s"
              % (name, wall, int(counts.sum()), int(pair.sum()),
                 int(prune.sum()), prune.numel(), run, smi), flush=True)
        n_hits, n_pairs, n_pruned, gap = step_subset_vs_host(args, device)
        print("   [%s] first %d rows against dryrun._host_*: %d hits, %d band "
              "pairs, %d pruned equal; p-values within %.2e of scipy"
              % (name, STEP_CHECK_ROWS, n_hits, n_pairs, n_pruned, gap),
              flush=True)
        res, bnd = step_kernels_vs_plain(name, args, step, smi, device)
        for kname in STEP_KERNELS:
            if STEP_RECORD[kname] == name:
                results[kname], bounds[kname] = res[kname], bnd[kname]
        del step, p, counts, pair, prune, scores
        torch.cuda.synchronize()
    check(min(launches.values()) > 0,
          "the step path skipped a kernel: %s" % launches)

    # (b) the dry run: 4 shards in turn on the card, then the sharded engine
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(4, device)
    torch.cuda.synchronize()
    print("   [b] dryrun.dryrun_multichip(4, %r): passed, wall %.3f s on %s"
          % (device, time.perf_counter() - t0, smi), flush=True)

    # (c) the multihost CLI: two ranks over Gloo sharing the card
    port = free_port()
    out0 = os.path.join(fx["dir"], "multihost0.json")
    argv = ["--bam", fx["bam"], "--vcf", fx["vcf"], "--sample",
            fx["sample"], "--num-processes", "2", "--device", device,
            "--coordinator", "localhost:%d" % port, "--timeout", "300"]
    t0 = time.perf_counter()
    outs = run_ranks([[sys.executable, "-m", "phaser_tpu_torch.dist.multihost"]
                      + argv + ["--process-id", str(r)] +
                      (["--o", out0] if r == 0 else []) for r in range(2)],
                     timeout=600)
    wall = time.perf_counter() - t0
    with open(out0) as fh:
        got = np.array(json.load(fh)["counts"])
    t0 = time.perf_counter()
    want = multihost.multiprocess_allele_counts(
        fx["bam"], fx["vcf"], fx["sample"], 1, 0, device=device)
    one = time.perf_counter() - t0
    check(np.array_equal(got, want) and want.sum() > 0,
          "the two multihost ranks' counts differ from one process's")
    print("   [c] 2 x dist.multihost --device %s: wall %.3f s; one process "
          "in this one %.3f s; counts equal (%d hits over %d variants); on "
          "%s" % (device, wall, one, int(want.sum()), len(want), smi),
          flush=True)

    # (d) the weak-scaling bench, 1 and 2 ranks on the card
    t0 = time.perf_counter()
    outs = run_ranks([[sys.executable, "-m",
                       "phaser_tpu_torch.dist.scaling_bench", "--devices",
                       "1,2", "--device", device, "--reads-per-device",
                       str(STEP_ROWS)]], timeout=600)
    line = outs[0].strip().splitlines()[-1]
    res = json.loads(line)
    check(res["metric"] == "weak_scaling_efficiency" and
          min(r["hits"] for r in res["per_device"].values()) > 0,
          "scaling_bench printed no result: " + outs[0][-2000:])
    print("   [d] scaling_bench --devices 1,2 --device %s "
          "--reads-per-device %d: wall %.3f s on %s" %
          (device, STEP_ROWS, time.perf_counter() - t0, smi), flush=True)
    print("   " + line, flush=True)
    return results, bounds, launches


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "phaser_tpu_torch")):
        raise SmokeError("run chip_smoke.py from a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: no GPU")
    sys.path.insert(0, REPO)

    phase(1, "environment")
    print("   python %s, torch %s, CUDA %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    kind = torch.cuda.get_device_name(0)
    print("   device: %s (count %d)" % (kind, torch.cuda.device_count()))
    smi = nvidia_smi_line()
    print("   nvidia-smi: %s" % smi, flush=True)

    phase(2, "build")
    import threading

    from phaser_tpu_torch.io import native
    from phaser_tpu_torch.utils import build
    # one compiler per source, both started together
    failed = []

    def build_io():
        try:
            build.get_io_lib()
        except Exception as e:  # reported below, in the main thread
            failed.append(e)
    io_thread = threading.Thread(target=build_io)
    io_thread.start()
    build.build(force=True)
    io_thread.join()
    check(not failed, "the native IO library failed to build or load: %s"
          % (failed[0] if failed else ""))
    print("   nvcc build: %.2f s -> %s"
          % (build.last_build_seconds, os.path.relpath(build.LIB_PATH, REPO)))
    build.get_lib()
    check(build.last_io_build_seconds is not None and
          native.get_lib() is not None,
          "the native IO library was not built here")
    print("   g++ build of the native IO library: %.2f s -> %s, loaded"
          % (build.last_io_build_seconds,
             os.path.relpath(build.IO_LIB_PATH, REPO)), flush=True)

    tmp = tempfile.mkdtemp(prefix="phaser_smoke_")
    os.environ["PHASER_TPU_TORCH_CACHE"] = os.path.join(tmp, "cache")
    try:
        phase(3, "kernel parity at chromosome scale")
        results, bounds, masked_launches, chrom_launches, step_input = \
            chromosome_phase(tmp, "cuda")
        branch_shapes_phase("cuda")
        small_delta_phase(tmp, "cuda")
        torch.cuda.synchronize()

        phase(4, "kernel-level entries (planes kernels)")
        entry_results, entry_bounds, entry_launches = entries_phase("cuda")
        results.update(entry_results)
        bounds.update(entry_bounds)
        torch.cuda.synchronize()

        phase(5, "engine stages #3-#5 below, at and above their gates")
        stages_phase("cuda")
        torch.cuda.synchronize()

        phase(6, "end to end, --device cuda vs --device host")
        launches, fixture = e2e_phase(tmp, "cuda")
        e2e_launches = dict(launches)
        launches["affine_masked"] = masked_launches
        launches.update(entry_launches)
        torch.cuda.synchronize()

        phase(7, "sharded runners")
        sharded_phase(fixture, "cuda", smi)
        torch.cuda.synchronize()

        phase(8, "downstream tools at the pop benchmark's shape")
        downstream_phase(tmp, fixture, smi)
        torch.cuda.synchronize()

        phase(9, "sharded step and multi-process scaffolding")
        t0 = time.perf_counter()
        step_results, step_bounds, step_launches = sharded_step_phase(
            step_input, fixture, smi, "cuda")
        results.update(step_results)
        bounds.update(step_bounds)
        launches.update(step_launches)
        print("   phase 9 wall %.1f s on %s" % (time.perf_counter() - t0, smi),
              flush=True)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    check(not {"jax", "phaser_tpu", "pandas"} & set(sys.modules),
          "jax, the JAX package or pandas was imported")
    print("   not imported: jax, phaser_tpu, pandas", flush=True)
    kernels = []
    print("   kernel            ms (on the card, kernel alone)  plain ms  "
          "bound ms (by)  share of bound (of the time on the card)  "
          "launches: 5M-read call / 1M-read e2e, or on phase 9's step path"
          "   [%s]" % smi)
    for name, (err, ms, plain_ms, (dev_ms, kernel_ms, profiles)) in \
            results.items():
        bound_ms, bound_by = bounds[name][:2]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "kernel_ms": kernel_ms,
            "profiles": profiles})
        line = ("   %-15s %.4f (%.4f, %.4f)  %.4f  %.4f (%s)  %.1f%% (%.1f%%)  "
                % (name, ms, dev_ms, kernel_ms, plain_ms, bound_ms, bound_by,
                   100.0 * bound_ms / ms, 100.0 * bound_ms / dev_ms))
        if name in STEP_KERNELS:
            line += "%d on the step path (%s input)" % (launches[name],
                                                        STEP_RECORD[name])
        else:
            line += "%d / %d" % (chrom_launches.get(name, 0),
                                 e2e_launches.get(name, 0))
        if name == "affine_masked":
            line += "   (%d on the 5M-read call without the nibble packer)" \
                % masked_launches
        if len(bounds[name]) > 2 and bounds[name][2] != bound_ms:
            kernels[-1]["bound_every_input_byte_ms"] = bounds[name][2]
            line += "   (every input byte once: %.4f ms, %.1f%% (%.1f%%))" % (
                bounds[name][2], 100.0 * bounds[name][2] / ms,
                100.0 * bounds[name][2] / dev_ms)
        print(line)
    check(len(kernels) == len(REPLACES) and
          min(k["launches"] for k in kernels) > 0,
          "a kernel was not launched on its path: %s" % kernels)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
