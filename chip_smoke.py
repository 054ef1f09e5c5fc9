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
     exact host mapper, launching the ragged join and no other kernel,
     once for each table slice (its kept reads fit one launch), with the
     tile kernels' resident blocks an SM and waves printed,
     also with every launch's hit capacity forced to overflow (the chunk
     must be relaunched on the card, never rerun on the host) and with
     every host packer refusing (the route packs nothing);
     the dispatcher's counters after each such call (its pre-filter dropped
     the reads whose span holds no variant, only the filled columns of the
     packed-hit buffers were fetched, every upload left pinned memory), and
     the pre-filter's two ends: reads of which none reaches a variant
     (nothing uploaded, nothing launched) and reads that all do (none
     dropped);
     the dispatcher's wall with its host items (cProfile) and its device
     share (torch.profiler); the span pass three ways (the native pass over
     the CIGARs, the merge over the BAM decode's span summary that #2
     takes, the read_spans kernel), alone and as the call's pass, against
     the host mapper's call, in turns; then the unpacked affine pair on the
     first 262,144 reads' pack_affine planes: assign_compact_affine through its
     entry point (one affine_planes launch, counted from 0 just before;
     its hits equal affine_masked's on the same rows) and the unfused
     assign_alleles_affine_device on the card against the same entry on
     CPU tensors (max_abs_err 0 on both planes); then one 262,144-row
     launch of each fused kernel against its plain PyTorch version on the
     card (all six are range joins that take no window; the delta kernel
     gets per-row [rp_min, rp_max]; the ragged join the first 262,144
     rows the dispatcher keeps, staged as it stages them; hits compared
     after a (read, var) sort; timed with CUDA events; the ragged join's
     packed-buffer fill, card time less kernel time, printed apart), and
     the read_spans kernel on all 5M reads against its plain version
     (flags equal); then
     the six range-join kernels on the layouts of
     testing/layouts.py that reach every branch (rows in random order, a
     table too dense for the shared-memory slice, L of 256 and 384, lo > 0,
     empty rows, variants on first and last bases, a one-entry table, the
     second and the first (2^22 entries) slice of a table above the
     dispatcher's slice size, duplicate positions, a masked trailing clip
     at the position of an aligned base on a variant; for the ragged join
     the same rows as reads: clips, =, X, N, D, P and H ops, sequences of
     `*`, shorter and longer than their CIGAR, reads without ops; rows
     past a tile's op stage, runs of zero-op and `*` reads across tile
     boundaries, tables denser than a tile's stage, and more reads than
     one wave of either tile kernel holds), each also with a capacity of 4
     (exact count past capacity), and read_spans against its plain
     version on the same reads; then a small
     testing/datagen.py fixture with deletion reads.  A kernel whose
     profiler window never comes back whole fails the phase;
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
     vanishes modulo 2^32, 20,077 rows each (no multiple of the row block).
     A kernel whose profiler window never comes back whole fails the
     phase;
  5. engine stages #3 pair counting (below its gate, forced down, at it and
     above it: the sizes --device auto's pair gate rests on), #4
     components and #5 the 2^n scorer at and above their size gates, cuda
     against host in turns: equal results, both walls printed, and the
     cuda runs' card seconds from the stages' device clocks
     (utils/trace.DeviceClock);
  6. end to end: the CLI's entry point (phaser_main.main, what `python -m
     phaser_tpu_torch.cli.phaser_main` runs) with --device cuda, --device
     host, --device cuda with the stage gates forced down, and --device
     auto, on a testing/datagen.py fixture shaped like bench_engine.py (3
     contigs, 60/25/15% of 1M input reads); the six output files must be
     byte-identical, #2's kernels (default run) and every stage's device
     hook (gates-down run) must have run, and auto's run must take the
     route its constants give (counts zeroed just before each run, read
     just after);
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
  9. in a process of its own (`chip_smoke.py --phase9 DIR`, which the
     smoke starts with phase 3's step input and phase 6's fixture in DIR
     and whose records it reads back from there: a few minutes into a
     process the profiler returns windows short of their first device
     records, testing/profiler_age.py), the sharded step and the
     multi-process scaffolding (dist/): (a)
     dist.mesh.sharded_phasing_step on a one-shard mesh on the card, with
     the connection tests' p-values of its merged band
     (connection_p_values), at one shard's full width: 262,144 rows x 128
     bases on four inputs, phase 3's reads with its 100,000-het table,
     scaling_bench._gen's dense layout (a variant about every 8 bp) over
     100,000 variants with its rows in random order ("dense") and sorted
     by start ("dense_sorted", as a BAM-sorted shard arrives), and phase
     6's first contig; counts zeroed just before each run and read just
     after, every step kernel launched; the first 4,096 rows of each
     against dist/dryrun.py's numpy and scipy recomputations (counts,
     band, scores equal, p-values within 1e-10, prune equal); each step
     kernel (planes_table, band_counts, the connection-test tail
     band_prune, binom_cdf as conflicting_config_p launches it) against
     its plain version on the step's own tensors (max_abs_err 0 for the
     integer kernels, <= 1e-12 for the float64 ones, prune and uncertain
     equal), prune_mask's route through the same test body and binom_cdf
     on int32 counts and a 0-d p too, all timed (the statistics kernels
     and their plain versions from a cold L2); band_counts' blocks that took
     their shared-memory window (some on dense_sorted, none on dense);
     the tail before (band_configs, noise_from_counts, prune_mask) and
     after (band_prune) in turns, by CUDA events and by the profiler's
     device activities a call (band_prune at most 2); conflicting_config_p's
     device activities a call (one binom_cdf launch, counted in a whole
     window), and the launch floor
     (an empty kernel on the same grid: the mean of its profiler records,
     and whether their window was whole); then
     binom_cdf and band_prune on the long continued fractions of
     testing/layouts.py (binom_long, band_long) against their plain
     versions, with their bounds and launch floors, and the log-factorial
     table's entries that the kernels' lgamma replaced; (b)
     dryrun.dryrun_multichip(4, "cuda"); (c) two `python -m
     phaser_tpu_torch.dist.multihost --device cuda` ranks over Gloo on
     phase 6's fixture, their counts equal to one
     process's; (d) `python -m phaser_tpu_torch.dist.scaling_bench
     --devices 1,2 --device cuda --reads-per-device 262144`, its JSON line
     printed.

Each kernel's `launches` comes from the run of its own path: the e2e cuda
run for #2's kernel (the ragged join), phase 3's own call of each kernel
on no dispatcher path (the four fused kernels of phaser_tpu's packed
routes, affine_planes, read_spans: 0 on the 5M-read call and in the e2e
run), phase 4's entry calls for the planes kernels, and phase 9's step runs
(with their p-values) for the four step kernels.

Each kernel's `ms` is the wrapper call timed with CUDA events over 20 calls
(the packed buffer's fill included, and host overhead where the host cannot
enqueue as fast as the card runs), as in every earlier record.  `device_ms`
is what one call keeps the card busy (torch.profiler's device time of the
__global__ function plus the launcher's buffer fills), `kernel_ms` the
__global__ function alone, `profiles` how many profiler windows it took to
see the function in a whole window (each window profiles its calls as the
active step after a discarded warm-up step of the same calls, and is whole
when its device records equal the runtime's enqueues: late in a long
process a window has come back short of its first device records), and
`whole` whether the window it was read from was whole (after five windows
the last one that saw the function; phases 3-4 and 9 fail when a
kernel's or the tail's window is not whole).  `plain_ms` is event-timed.
The share of bound is taken against `ms`.

Each kernel's `bound_ms` is the larger of the bytes this run's inputs need
moved over 3.35 TB/s and its integer operations over 67 T/s (the card's
non-tensor rate); for the six range joins the bytes are what the data
needs (row parameters or the refpos plane, for the ragged join pos, two
offsets and the CIGAR words of each row, the table entries between the
lowest and the highest position of the launch's rows, for delta_nibble 8 B
of [rp_min, rp_max] per row and `start` and the delta row only of the rows
with a table entry in their range, one 32-byte sector of a code plane per
hit (for affine_planes and ragged_join one of the codes or seq and one of
the quals), 8 B per hit written; for read_spans every input byte once
(pos, offsets, CIGAR words, the table) and a flag byte a read written;
for the planes kernels 4 B of refpos read and 8 B
written per base, 2 B of codes and quals per hit, the table entries under
the launch's windows), and the line printed before the record also gives
the "every input byte once" figure.  The step kernels' bounds: for
band_counts the planes read once (8 B a base) and the counts and band
written once, or a test per base and per ordered hit pair; for
conflict_prune (the tail, band_prune: the counts and the band read, p and
two flags written) and binom_cdf their inputs and outputs once, or the float64
operations of the fraction terms these inputs actually take
(kernels/stats.py BETACF_TERM_FLOPS a term, BETACF_SETUP_FLOPS a live
element) over 34 T/s (the card's float64 rate outside the tensor cores).
binom_cdf's record is the instantiation the step path launches
(conflicting_config_p: three int32 counts read, p written).  Their inputs
would sit in the 50 MB L2 call after call, where bytes over the memory
rate bound nothing, so both records (ms, the card times, plain_ms) are
taken from a cold L2: each call after a flush (L2_FLUSH_BYTES written) and
a synchronize, the flush outside the timed span and outside the kernel's
profiler time.  The binom_cdf and conflict_prune records also hold, under
"inputs", the same numbers on phase 3's reads, phase 6's contig and the
long fractions, each with its launch floor.  `library_ms` is
null throughout: no single PyTorch call classifies bases against the table
and compacts the hits (`torch.searchsorted` is only the lookup), forms the
within-row pairs, or has an incomplete beta.  The tile kernels' records
(ragged_join, read_spans) also hold blocks_per_sm, sms, tile_rows,
smem_bytes and waves ({call: its tiles over the tiles of one wave}), and
ragged_join's fill_ms (the launcher's -1 fill of the packed buffer at
fill_capacity: the card time less the kernel's own).

The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
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
    "affine_planes": "phaser_tpu/kernels/alleles.py:217",
    # the Pallas body the dispatcher's three packed routes reach, with the
    # host packers before them
    "ragged_join": "phaser_tpu/kernels/alleles.py:673",
    # no TPU kernel: the host CIGAR pass of phaser_tpu's dispatcher
    # (_read_op_masks), which the port's pre-filter extends
    "read_spans": "phaser_tpu/mapper/dispatch.py:122",
    "planes": "phaser_tpu/kernels/alleles.py:673",
    "planes_resident": "phaser_tpu/kernels/alleles.py:627",
    "planes_cmp": "phaser_tpu/kernels/alleles.py:757",
    # the sharded step's programs (jnp inside phaser_tpu's shard_map step)
    "planes_table": "phaser_tpu/kernels/alleles.py:33",
    "band_counts": "phaser_tpu/dist/mesh.py:83",
    # since the tail's redesign: band_prune, which also replaces
    # noise_from_counts (:75) and the band's configurations
    # (phaser_tpu/dist/mesh.py:111)
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
            "prune_mask": 1e-12, "binom_cdf": 1e-12,
            "binom_cdf_operands": 1e-12}
TAIL_MAX_LAUNCHES = 2        # band_prune's device activities a call
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
# the host packers of phaser_tpu's routes: library entries, on no path of
# the dispatcher
PACKERS = ("pack_reads", "pack_codes_quals", "pack_affine",
           "pack_affine_masked", "pack_affine_nibble", "pack_delta_nibble")


HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
INT_OPS_PER_S = 67e12        # non-tensor rate (compares, index arithmetic)
FP64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20   # written before a cold call: over the 50 MB L2
COLD = ("binom_cdf", "conflict_prune", "prune_mask")   # timed from cold L2
TABLE_ROW_BYTES = 16         # vpos, a0, a1, n_ind: 4 x int32 per entry


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
    from phaser_tpu_torch.kernels.alleles import fetch_packed_hits
    r, v, a, mc, nh = fetch_packed_hits(packed)
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


_flush_buf = None


def l2_flush():
    """Enqueues a write of L2_FLUSH_BYTES (a float32 add, not a memset, so
    that device_ms does not count it), which evicts what the L2 held."""
    global _flush_buf
    import torch
    if _flush_buf is None:
        _flush_buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                 device="cuda")
    _flush_buf.add_(1.0)


def time_cold_ms(fn, iters):
    """fn's mean time by CUDA events, each call from a cold L2 on an idle
    card: the flush and a synchronize before each call, outside its span."""
    import torch
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        l2_flush()
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / iters


def cold(fn):
    """fn after an L2 flush: what device_ms profiles for a cold call."""
    def call():
        l2_flush()
        return fn()
    return call


KERNEL_FN = {  # the __global__ function behind each kernel entry
    "affine_nibble": "affine_nibble_kernel",
    "delta_nibble": "delta_nibble_kernel", "plane": "plane_kernel",
    "affine_masked": "affine_masked_kernel",
    "affine_planes": "affine_planes_kernel",
    "ragged_join": "ragged_join_kernel",
    "read_spans": "read_spans_kernel",
    "planes": "planes_windowed_kernel",
    "planes_resident": "planes_resident_kernel",
    "planes_cmp": "planes_cmp_kernel",
    "planes_table": "planes_table_kernel",  # the whole-table mode of planes
    "band_counts": "band_counts_kernel",
    # the tail (band_prune): the noise sums, then the test on the band
    "conflict_prune": ("noise_partials_kernel", "conflict_test_kernel"),
    "prune_mask": "conflict_test_kernel",   # the same test on three arrays
    "binom_cdf": "binom_cdf_kernel",
    "binom_cdf_operands": "binom_cdf_kernel",   # on k, n, p descriptors
    "launch_floor": "empty_grid_kernel"}   # an empty kernel on a grid
_profiler_warm = False


def device_ms(name, fn, iters=20):
    """(device ms, kernel ms, profiles, whole) per call from torch.profiler:
    the device time of the kernel's __global__ function plus the launcher's
    memsets, of the function alone, how many windows it took to see the
    function in a whole one (utils/trace.profile_window), and whether that
    window was whole (after PROFILE_TRIES windows the last one that saw the
    function at all, whole False); the last two go into the kernels'
    record.  None when no window saw the function."""
    global _profiler_warm
    import torch
    from torch.profiler import ProfilerActivity, profile

    from phaser_tpu_torch.utils.trace import PROFILE_TRIES, profile_window
    fns = KERNEL_FN[name] if isinstance(KERNEL_FN[name], tuple) else \
        (KERNEL_FN[name],)
    fn()
    torch.cuda.synchronize()
    if not _profiler_warm:
        # the first profile of a process comes back without device records
        # now and then: one discarded window with a launch in it first
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        _profiler_warm = True
    seen = None
    for attempt in range(1, PROFILE_TRIES + 1):
        avgs, device, runtime = profile_window(fn, iters)
        kernel_us = fill_us = 0.0
        keys = []
        for e in avgs:
            d = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
            if any(f in e.key for f in fns):
                kernel_us += d
            elif "memset" in e.key.lower():
                fill_us += d
            if d:
                keys.append(e.key[:60])
        if kernel_us:
            seen = ((kernel_us + fill_us) / iters / 1e3,
                    kernel_us / iters / 1e3, attempt, device == runtime)
            if seen[3]:
                return seen
        print("   profile of %s not whole (%d device records, %d runtime "
              "enqueues); device records: %s"
              % (KERNEL_FN[name], device, runtime, keys[:8]), flush=True)
    return seen


def device_all(fn, iters=20):
    """utils/trace.device_activity: (card ms, device activities, whole) a
    call of fn, every kernel, fill and copy it enqueues."""
    from phaser_tpu_torch.utils.trace import device_activity
    return device_activity(fn, iters, log=lambda line: print(
        "   tail " + line, flush=True))


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
    check(dev[3], "%s: no profiler window of %d came back whole"
          % (name, dev[2]))
    print("   %-13s wrapper call %.4f ms (%.4f, %.4f); on the card %.4f ms, "
          "kernel alone %.4f ms   plain %.4f ms (%.4f, %.4f)   (%d rows)"
          % (name, ms, k1, k2, dev[0], dev[1], plain_ms, p1, p2, n_rows),
          flush=True)
    return err, ms, plain_ms, nk, dev


def spans_vs_plain(K, s_in, ins_op, skip_op, steps):
    """The read_spans kernel against its plain version on the same CUDA
    tensors (the flags equal), timed as kernel_vs_plain times; its own
    launch counted from 0 just before.  Returns (record, bound, launches)."""
    import torch
    K.reset_launches()
    got = K.read_spans(*s_in, ins_op, skip_op)
    torch.cuda.synchronize()
    launches = K.LAUNCHES["read_spans"]
    want = K.read_spans_plain(*s_in, ins_op, skip_op)
    err = int((got.int() - want.int()).abs().max())
    check(err == 0 and launches == 1, "read_spans: max_abs_err %d, %d "
          "launches" % (err, launches))
    p1 = time_ms(lambda: K.read_spans_plain(*s_in, ins_op, skip_op), 3)
    k1 = time_ms(lambda: K.read_spans(*s_in, ins_op, skip_op), 20)
    k2 = time_ms(lambda: K.read_spans(*s_in, ins_op, skip_op), 20)
    p2 = time_ms(lambda: K.read_spans_plain(*s_in, ins_op, skip_op), 3)
    dev = device_ms("read_spans", lambda: K.read_spans(*s_in, ins_op,
                                                       skip_op))
    check(dev is not None and dev[3], "read_spans: no whole profiler window")
    n, n_ops, mp = s_in[0].shape[0], s_in[2].shape[0], s_in[3].shape[0]
    print("   read_spans     %d reads, %d ops, %d near; max_abs_err 0; "
          "wrapper call %.4f ms (%.4f, %.4f); on the card %.4f ms, kernel "
          "alone %.4f ms   plain %.4f ms (%.4f, %.4f)"
          % (n, n_ops, int(((got >> 2) & 1).sum()), (k1 + k2) / 2, k1, k2,
             dev[0], dev[1], (p1 + p2) / 2, p1, p2), flush=True)
    # pos, two offsets and a flag byte a read, 4 B an op, the table once;
    # a search of the staged slice a read
    bound = bound_of(n * (4 + 8 + 1) + 8 + 4 * n_ops + 4 * mp,
                     n * steps + 2 * n_ops)
    return (err, (k1 + k2) / 2, (p1 + p2) / 2, dev), bound, launches


def host_items(fn):
    """Wall of one dispatcher call under cProfile, with the cumulative
    seconds of its host items (the span pass, the gather into the pinned
    staging, selects, uploads, the host remainders, the hits' fetch and
    sort; it packs no plane and plans no window)."""
    import cProfile
    import pstats

    import torch
    names = ("_read_spans", "select", "_launch_chunks",
             "_row_offsets", "_stage_reads", "padded_table", "_upload",
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


def on_path_only(launches):
    """#2 launched the ragged join and no other kernel."""
    return launches["ragged_join"] > 0 and \
        not any(n for k, n in launches.items() if k != "ragged_join")


# per kernel, keys the kernels' record adds to the standard ones: the tile
# kernels' resident blocks and waves, the ragged join's buffer fill
KERNEL_EXTRA = {}


def tile_shapes(K, calls):
    """Prints the tile kernels' shapes on this card (kernels.alleles
    tile_shape: blocks resident on an SM as the runtime reports them, rows
    a tile, what a tile stages, shared memory a block, tiles a block at
    once) and, for each of `calls` ({what: (kernel, rows)}), its tiles and
    waves (tiles over the tiles one wave of blocks works on at once);
    records them in KERNEL_EXTRA.  Fails where the library's rows a tile
    and stages differ from kernels.alleles' JOIN_* / SPAN_*."""
    for what, (name, rows) in calls.items():
        sh = K.tile_shape(name)
        # the library's stages are the ones kernels.alleles reads from the
        # source, which testing/layouts.py's tile layouts are built to pass
        want = ((K.JOIN_TILE, K.JOIN_OPS, K.JOIN_STAGE)
                if name == "ragged_join" else (K.SPAN_TILE, 0, K.SPAN_STAGE))
        got = (sh["tile_rows"], sh["op_stage"], sh["table_stage"])
        check(got == want, "%s: the library's tile shape %s, kernels.alleles"
              " %s" % (name, got, want))
        wave = sh["blocks_per_sm"] * sh["sms"] * sh["tiles_per_block"]
        tiles = -(-rows // sh["tile_rows"])
        KERNEL_EXTRA.setdefault(name, {}).update(
            blocks_per_sm=sh["blocks_per_sm"], sms=sh["sms"],
            tile_rows=sh["tile_rows"], smem_bytes=sh["smem_bytes"])
        KERNEL_EXTRA[name].setdefault("waves", {})[what] = tiles / wave
        print("   %s: %d blocks resident an SM x %d SMs (%d B of shared "
              "memory a block, %d tile(s) a block at once; a tile %d rows, "
              "%d CIGAR words, %d table entries staged); %s: %d rows, %d "
              "tiles, %.3f waves"
              % (name, sh["blocks_per_sm"], sh["sms"], sh["smem_bytes"],
                 sh["tiles_per_block"], sh["tile_rows"], sh["op_stage"],
                 sh["table_stage"], what, rows, tiles, tiles / wave),
              flush=True)


def spans_on_card(D, K, bd, dev_pos, dev):
    """The span pass as the read_spans kernel: the reads' pos, CIGAR
    offsets and words up through the dispatcher's pinned staging, one flag
    byte a read back; (has_ins, has_n, near) as mapper/dispatch.py
    _read_spans returns them."""
    import numpy as np
    from phaser_tpu_torch.io.bam import OP_I, OP_N
    from phaser_tpu_torch.utils.trace import DeviceClock
    vpos = np.full(max(4, -(-len(dev_pos) // 4) * 4), np.iinfo(np.int32).max,
                   np.int32)
    vpos[:len(dev_pos)] = dev_pos
    clock = DeviceClock(dev)
    args = [D._upload(x, dev, clock) for x in (
        bd.pos, bd.cigar_off, bd.cigar_flat.view(np.int32), vpos)]
    flags = K.read_spans(*args, OP_I, OP_N).cpu().numpy()
    return tuple((flags & bit) != 0 for bit in (K.SPAN_INS, K.SPAN_SPLICED,
                                                 K.SPAN_NEAR))


def span_passes(D, K, bd, vt, want, dev):
    """The dispatcher's span pass three ways: the native pass over the
    CIGARs (a BamData without the decode's span summary), the merge over
    the summary (mapper/dispatch.py _read_spans, #2's route), the
    read_spans kernel (uploads and the flags' fetch included); each alone
    and as the 5M-read call's pass, against the host mapper's call, in
    turns.  The three give the same flags and the calls the host's hits."""
    import dataclasses

    import numpy as np
    import torch
    dev_pos = vt.pos[vt.is_simple]
    route = D._read_spans
    bare = dataclasses.replace(bd, span_end=None, span_flags=None)
    ways = {"native": lambda b, p: route(dataclasses.replace(
                b, span_end=None, span_flags=None), p),
            "decode": route,
            "card": lambda b, p: spans_on_card(D, K, b, p, dev)}
    ref = route(bare, dev_pos)
    for how in ("decode", "card"):
        got = ways[how](bd, dev_pos)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              "span pass %s differs from the native pass" % how)
    order = ("native", "decode", "card")
    alone = {k: [] for k in order}
    for how in (order + order[::-1]) * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ways[how](bd, dev_pos)
        torch.cuda.synchronize()
        alone[how].append(time.perf_counter() - t0)
    calls = {k: [] for k in ("host",) + order}
    try:
        for run in (("host",) + order + order[::-1] + ("host",)) * 2:
            D._read_spans = ways.get(run, route)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = D.assign_alleles_auto(bd, vt, baseq=10, device="host"
                                        if run == "host" else dev)
            torch.cuda.synchronize()
            calls[run].append(time.perf_counter() - t0)
            same_hits(got, want, "span pass %s" % run)
    finally:
        D._read_spans = route
    for what, ts in (("span pass alone", alone),
                     ("5M-read call by span pass (decode: #2's route)",
                      calls)):
        print("   %s (s, in turns): %s" % (what, "; ".join(
            "%s mean %.4f (%s)" % (k, sum(v) / len(v),
                                   " ".join("%.4f" % t for t in v))
            for k, v in ts.items())), flush=True)


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
    check(on_path_only(chrom_launches),
          "chromosome-scale run launched %s, not the ragged join alone"
          % chrom_launches)
    check(D.RELAUNCHES["capacity"] == 0,
          "chromosome-scale run overflowed its hit capacity")
    # one ragged_join launch a table slice: the call's kept rows fit one
    # launch (mapper/dispatch.py _SUB_ROWS), its table one slice or more
    # (_MAX_TABLE) of the device-eligible variants (simple, unique position)
    dup = np.zeros(len(vt), bool)
    same = np.diff(vt.pos) == 0
    dup[1:] |= same
    dup[:-1] |= same
    n_slices = -(-int((vt.is_simple & ~dup).sum()) // D._MAX_TABLE)
    check(chrom_launches["ragged_join"] == n_slices,
          "the 5M-read call launched ragged_join %d times, not once for each "
          "of its %d table slice(s)" % (chrom_launches["ragged_join"],
                                        n_slices))
    tile_shapes(K, {"the 5M-read call's kept rows": (
        "ragged_join", D.STATS["rows_kept"]),
        "the span pass over all its reads": ("read_spans", len(bd))})
    print("   one ragged_join launch for each of the call's %d table "
          "slice(s), %d kept rows" % (n_slices, D.STATS["rows_kept"]),
          flush=True)

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
    check(D.RELAUNCHES["capacity"] == 1 and K.LAUNCHES["ragged_join"] > 0
          and on_path_only(K.LAUNCHES),
          "overflow was not relaunched on the card: %s" % dict(K.LAUNCHES))
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
    profile_dispatch(lambda: assign_alleles_auto(bd, vt, baseq=10,
                                                 device=device))
    host_items(lambda: assign_alleles_auto(bd, vt, baseq=10, device=device))
    span_passes(D, K, bd, vt, want, dev)

    # the route takes no packer: with every packer refusing, the hits are
    # the host's and the ragged join alone ran (phaser_tpu's dispatcher
    # without its nibble packer takes the masked-affine program)
    packers = {n: getattr(K, n) for n in PACKERS}

    def refuse(*a, **k):
        raise SmokeError("the dispatcher called a packer")
    try:
        for n in PACKERS:
            setattr(K, n, refuse)
        K.reset_launches()
        D.reset_stats()
        t0 = time.perf_counter()
        got = assign_alleles_auto(bd, vt, baseq=10, device=device)
        torch.cuda.synchronize()
        t_nopack = time.perf_counter() - t0
        nopack_launches = dict(K.LAUNCHES)
    finally:
        for n, f in packers.items():
            setattr(K, n, f)
    same_hits(got, want, "assign_alleles_auto with every packer refusing")
    filter_stats(D, "no-packer call", dropped=True)
    print("   every packer refusing: %.3f s, launches %s; hits equal the "
          "host's" % (t_nopack, nopack_launches), flush=True)
    check(on_path_only(nopack_launches) and
          nopack_launches["ragged_join"] > 0,
          "the no-packer run launched %s" % nopack_launches)

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

    # the unpacked affine pair on the same reads: pack_affine's codes and
    # quals planes, BASEQ applied by the affine_planes kernel
    codes_a, quals_a, ia_a, st_a, lo_a, hi_a = K.pack_affine(
        bd.select(np.arange(n)))
    check(np.array_equal(ia_a, aff_all[:n]), "pack_affine and "
          "pack_affine_nibble classify the reads differently")
    st_a, lo_a, hi_a = (np.where(ia_a, x, 0).astype(np.int32)
                        for x in (st_a, lo_a, hi_a))
    pl_in = [T(x) for x in (codes_a, quals_a, st_a, lo_a, hi_a)]

    def planes_k():
        return K.assign_compact_affine(*pl_in, table, 10, cap)

    def planes_plain():
        return K.affine_planes_plain(*pl_in, table, 10, cap)

    # its own path: the entry point on phase 3's reads, counted from 0 just
    # before the call and read just after; its hits are the masked-plane
    # program's on the same rows
    K.reset_launches()
    packed = planes_k()
    torch.cuda.synchronize()
    planes_launches = K.LAUNCHES["affine_planes"]
    check(planes_launches == 1 and sum(K.LAUNCHES.values()) == 1,
          "assign_compact_affine launched %s" % dict(K.LAUNCHES))
    (n_pl, h_pl), (n_m, h_m) = sorted_hits(packed), sorted_hits(masked_k())
    check(n_pl == n_m > 0 and np.array_equal(h_pl, h_m),
          "affine_planes: %d hits, affine_masked on the same rows %d, or "
          "they differ" % (n_pl, n_m))
    print("   assign_compact_affine: %d hits on %d rows, equal to "
          "affine_masked's; launches %s" % (n_pl, n, dict(K.LAUNCHES)),
          flush=True)
    # the unfused assign_alleles_affine_device: the card against the same
    # entry on CPU tensors (its plain version), both (N, L) planes
    vpos_e = table[0]
    ind_e = torch.stack((table[1], table[2]), 1).to(torch.uint8)
    ni_e = table[3].to(torch.int8)
    unfused_in = pl_in + [vpos_e, ind_e, ni_e]
    K.reset_launches()
    got_u = K.assign_alleles_affine_device(*unfused_in, 10)
    torch.cuda.synchronize()
    unfused_launches = dict(K.LAUNCHES)
    want_u = K.assign_alleles_affine_device(*[x.cpu() for x in unfused_in], 10)
    err = max(int((g.cpu().long() - w.long()).abs().max())
              for g, w in zip(got_u, want_u))
    hits_u = int((want_u[0] >= 0).sum())
    check(err == 0 and hits_u == n_pl,
          "assign_alleles_affine_device: max_abs_err %d, %d hits (the fused "
          "program %d)" % (err, hits_u, n_pl))
    check(unfused_launches["planes_table"] == 1,
          "assign_alleles_affine_device launched %s" % unfused_launches)
    ms_u = time_ms(lambda: K.assign_alleles_affine_device(*unfused_in, 10),
                   10)
    print("   assign_alleles_affine_device: max_abs_err 0 on both planes, "
          "%d hits (the fused program's), %.4f ms a call; launches %s"
          % (hits_u, ms_u, unfused_launches), flush=True)
    del got_u, want_u

    # the ragged join on the first 262,144 rows the dispatcher keeps, staged
    # as it stages them
    from phaser_tpu_torch.utils.trace import DeviceClock
    has_ins_all, _, near_all = D._read_spans(bd, vt.pos)
    r_rows = np.flatnonzero(near_all & ~has_ins_all)[:SUB_ROWS]
    r_in = D._stage_reads(bd, r_rows, dev, DeviceClock(dev))
    n_r, n_ops, n_bases = len(r_rows), int(r_in[2].shape[0]), \
        int(r_in[4].shape[0])

    def ragged():
        return K.assign_compact_ragged(*r_in, 10, table, cap)

    def ragged_plain():
        return K.ragged_join_plain(*r_in, 10, table, cap)
    # the launch's reference range: pos + 1 to pos + its ops' reference
    # lengths, over its rows
    from phaser_tpu_torch.mapper.host import _REF_CONSUME
    r_cig = r_in[2].cpu().numpy().view(np.uint32)
    r_off = r_in[1].cpu().numpy().astype(np.int64)
    r_pos = r_in[0].cpu().numpy().astype(np.int64)
    r_end = r_pos + D._per_read_sum(
        np.where(_REF_CONSUME[r_cig & 0xF], r_cig >> 4, 0), r_off)

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
    pl_under, _ = under(st_a, st_a + (hi_a - lo_a) - 1, hi_a > lo_a)
    d_under, d_range = under(rmin, rmax, rmax > 0)
    d_live = int((d_range > 0).sum())   # rows that read their delta row
    p_under, p_range = under(
        np.where(refpos > 0, refpos, np.iinfo(np.int32).max).min(1),
        refpos.max(1), refpos.max(1) > 0)
    r_under, _ = under(r_pos + 1, r_end, r_end > r_pos)
    Lh = nc.shape[1]
    steps = max(mp.bit_length() - 1, 1)          # binary-search depth
    print("   table entries under the launch's rows: affine_nibble %d, "
          "delta_nibble %d (%d of %d rows have an entry in their range), "
          "plane %d, affine_masked %d, affine_planes %d, ragged_join %d of "
          "%d; ragged_join's launch %d rows, %d ops, %d bases"
          % (a_under, d_under, d_live, n, p_under, m_under, pl_under,
             r_under, mp, n_r, n_ops, n_bases), flush=True)
    results, bounds = {}, {}
    own_launches = {"affine_planes": planes_launches}
    for name, k, p, rows in (
            ("affine_nibble", affine, affine_plain, n),
            ("delta_nibble", delta_k, delta_plain, n),
            ("plane", plane, plane_plain, n_p),
            ("affine_masked", masked_k, masked_plain, n),
            ("affine_planes", planes_k, planes_plain, n),
            ("ragged_join", ragged, ragged_plain, n_r)):
        if name != "ragged_join":
            # a kernel on no path of the dispatcher: the launches of its
            # record are its own call's, counted from 0 just before
            K.reset_launches()
            k()
            torch.cuda.synchronize()
            own_launches.setdefault(name, K.LAUNCHES[name])
        err, ms, plain_ms, hits, on_card = kernel_vs_plain(name, k, p, rows)
        results[name] = (err, ms, plain_ms, on_card)
        if name == "ragged_join":
            # the launcher's -1 fill of the packed buffer (2 x (cap + 1)
            # int32, _pack_hits' layout), apart from the kernel
            fill = on_card[0] - on_card[1]
            KERNEL_EXTRA.setdefault(name, {}).update(fill_ms=fill,
                                                     fill_capacity=cap)
            tile_shapes(K, {"phase 3's launch": (name, rows)})
            print("   ragged_join's packed-buffer fill at capacity %d (%.1f "
                  "MB): %.4f ms on the card (card %.4f - kernel alone %.4f)"
                  % (cap, 8 * (cap + 1) / 1e6, fill, on_card[0], on_card[1]),
                  flush=True)
        out_bytes = 8 * hits + 4
        if name == "affine_nibble":
            need = rows * 12 + a_under * TABLE_ROW_BYTES + 32 * hits
            every = rows * (12 + Lh) + tab_bytes
            ops = rows * 2 * steps + 12 * hits
        elif name == "affine_masked":
            need = rows * 12 + m_under * TABLE_ROW_BYTES + 32 * hits
            every = rows * (12 + L) + tab_bytes
            ops = rows * 2 * steps + 12 * hits
        elif name == "affine_planes":
            # a sector of the codes plane and one of the quals plane a hit
            need = rows * 12 + pl_under * TABLE_ROW_BYTES + 2 * 32 * hits
            every = rows * (12 + 2 * L) + tab_bytes
            ops = rows * 2 * steps + 12 * hits
        elif name == "ragged_join":
            # pos and two offsets a row, 4 B an op, the entries under the
            # launch's range, a sector of seq and one of qual a hit; every
            # input byte once adds all the bases' seq and qual bytes
            need = rows * 12 + n_ops * 4 + r_under * TABLE_ROW_BYTES + \
                2 * 32 * hits
            every = rows * 12 + n_ops * 4 + 2 * n_bases + tab_bytes
            ops = rows * 2 * steps + n_ops * 4 + 12 * hits
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
    # the read_spans kernel on every read of the call, as its card pass
    # uploads them
    s_in = [T(x) for x in (bd.pos, bd.cigar_off, bd.cigar_flat.view(np.int32),
                           vpos)]
    from phaser_tpu_torch.io.bam import OP_I, OP_N
    results["read_spans"], bounds["read_spans"], \
        own_launches["read_spans"] = spans_vs_plain(K, s_in, OP_I, OP_N,
                                                    steps)
    torch.cuda.synchronize()
    # phase 9's chromosome-scale step input: the first 262,144 reads as
    # refpos planes, and the het table
    from phaser_tpu_torch.dist.multihost import table_arrays
    step_input = K.pack_reads(bd, rows=np.arange(min(STEP_ROWS, len(bd)))) + \
        table_arrays(vt)
    return results, bounds, own_launches, chrom_launches, step_input


def branch_shapes_phase(device):
    """The six range-join kernels against their plain versions on the
    layouts that reach every branch (testing/layouts.py), 20,000 rows each
    (for the ragged join the same rows as reads, ragged_inputs), with room
    for every hit and with a capacity of 4; read_spans against its plain
    version on the same reads.  many_rows (16 x n_rows reads) is made for
    the two tile kernels at more rows than one wave of either holds on
    this card (tile_shape), for the other kernels at 20,000."""
    import numpy as np
    import torch
    from phaser_tpu_torch.io.bam import OP_I, OP_N
    from phaser_tpu_torch.kernels import alleles as K
    from phaser_tpu_torch.testing import layouts

    dev = torch.device(device)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    shapes = [K.tile_shape(k) for k in ("ragged_join", "read_spans")]
    wave_rows = max(sh["blocks_per_sm"] * sh["sms"] * sh["tile_rows"] *
                    sh["tiles_per_block"] for sh in shapes)
    for name in layouts.NAMES + ["big_table"]:
        d = layouts.make(name, n_rows=20_000, n_vars=16_000,
                         contig=4_000_000)
        table = tuple(T(x) for x in layouts.padded_table(d))
        a_in = [T(x) for x in layouts.affine_inputs(d)]
        m_in = [T(x) for x in layouts.masked_inputs(d)]
        pl_in = [T(x) for x in layouts.affine_planes_inputs(d)]
        d_in = [T(x) for x in layouts.delta_inputs(d)]
        p_in = [T(x) for x in layouts.plane_inputs(d)]
        r_table = table
        if name == "many_rows":
            del d
            d = layouts.make(name, n_rows=-(-(wave_rows + 1) // 16),
                             n_vars=16_000, contig=4_000_000)
            r_table = tuple(T(x) for x in layouts.padded_table(d))
        r_in = [T(x) for x in layouts.ragged_inputs(d)]
        check(name != "many_rows" or r_in[0].shape[0] > wave_rows,
              "many_rows: %d reads, one wave holds %d"
              % (r_in[0].shape[0], wave_rows))
        s_in = [r_in[0], r_in[1].long(), r_in[2], r_table[0]]
        got_s = K.read_spans(*s_in, OP_I, OP_N)
        want_s = K.read_spans_plain(*s_in, OP_I, OP_N)
        torch.cuda.synchronize()
        check(torch.equal(got_s, want_s), "read_spans on layout %s differs "
              "from its plain version" % name)
        line = ["read_spans %d near of %d" % (int(((want_s >> 2) & 1).sum()),
                                              s_in[0].shape[0])]
        for prog, kernel, plain in (
                ("affine_nibble",
                 lambda c: K.assign_compact_affine_nibble(*a_in, table, c),
                 lambda c: K.affine_nibble_plain(*a_in, table, c)),
                ("affine_masked",
                 lambda c: K.assign_compact_affine_masked(*m_in, table, c),
                 lambda c: K.affine_masked_plain(*m_in, table, c)),
                ("affine_planes",
                 lambda c: K.assign_compact_affine(*pl_in, table, 10, c),
                 lambda c: K.affine_planes_plain(*pl_in, table, 10, c)),
                ("delta_nibble",
                 lambda c: K.assign_compact_delta_nibble(*d_in, table, c),
                 lambda c: K.delta_nibble_plain(*d_in, table, c)),
                ("plane",
                 lambda c: K.assign_compact_plane(*p_in, 10, table, c),
                 lambda c: K.plane_plain(*p_in, 10, table, c)),
                ("ragged_join",
                 lambda c: K.assign_compact_ragged(*r_in, 10, r_table, c),
                 lambda c: K.ragged_join_plain(*r_in, 10, r_table, c))):
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
        del d, a_in, m_in, pl_in, d_in, p_in, r_in, s_in


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
    check(on_path_only(K.LAUNCHES),
          "datagen run launched %s, not #2's kernels alone" % K.LAUNCHES)


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
    check(dev[3], "%s: no profiler window of %d came back whole"
          % (name, dev[2]))
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
    check(on_card is not None and on_card[3], "the profiler saw no "
          "planes_table_kernel in a whole window")
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
    """(host s, cuda s, results, runs, card s) in turns host, cuda, cuda,
    host; each time is the mean of its two runs, and `card s` the mean of
    the cuda runs' device clocks (utils/trace.DeviceClock: CUDA events
    around the stage's uploads, device work and fetch).  With `warm`, one
    untimed device call first takes the CUDA start-up of the stage's
    operators."""
    import torch
    from phaser_tpu_torch.utils.trace import thread_device_seconds
    ts = {"host": [], device: []}
    card = []
    out = {}
    for dv in ((device,) if warm else ()) + ("host", device, device,
                                            "host"):
        c0 = thread_device_seconds()
        t0 = time.perf_counter()
        out[dv] = fn(dv)
        torch.cuda.synchronize()
        ts[dv].append(time.perf_counter() - t0)
        if dv == device:
            card.append(thread_device_seconds() - c0)
    if warm:
        ts[device].pop(0)
        card.pop(0)
    return (sum(ts["host"]) / 2, sum(ts[device]) / 2, out["host"],
            out[device], ts, sum(card) / 2)


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
    # below the gate (forced down), at it and above it: auto's pair gate
    # rests on these
    for k, n_reads in enumerate((60_000, 120_000, 240_000, 500_000,
                                 1_000_000, 2_000_000)):
        forced = n_reads < 200_000
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
                         0 if forced else connections.DEVICE_PAIR_GATE):
            th, tc, h, c, ts, card = timed_pair(
                lambda dv: connections.build_connections(vr, 0.002, 0.01,
                                                         device=dv),
                device, warm=k == 0)
        check(connections.COUNTS["device_calls"] == before + 2 + (k == 0),
              "#3 did not take the device path")
        check((h.n_pairs >= connections.DEVICE_PAIR_GATE) == (not forced),
              "#3 size on the wrong side of the gate")
        for f in ("var_a", "var_b", "c_supporting", "c_total", "p_value",
                  "chosen_config", "pruned"):
            check(np.array_equal(getattr(h, f), getattr(c, f)),
                  "#3 %s differs between cuda and host" % f)
        check(h.adj == c.adj and h.allele_conn == c.allele_conn,
              "#3 graph differs between cuda and host")
        rows.append(("#3 pair counting", "%d pairs" % h.n_pairs, th, tc, ts,
                     card))

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
            th, tc, h, c, ts, card = timed_pair(
                lambda dv: blocks.find_blocks(conn, vt, device=dv), device,
                warm=k == 0)
        check(blocks.COUNTS["device_calls"] == before + 2 + (k == 0),
              "#4 did not take the device path")
        check((n_edges >= blocks._DEVICE_EDGE_GATE) == (k > 0),
              "#4 size on the wrong side of the gate")
        check(h == c, "#4 blocks differ between cuda and host")
        rows.append(("#4 components", "%d edges" % n_edges, th, tc, ts,
                     card))

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
            th, tc, h, c, ts, card = timed_pair(
                lambda dv: phasing.sub_block_phase(variants, ac, device=dv),
                device, warm=n == gate - 4)
        check(phasing.COUNTS["device_calls"] ==
              before + 2 + (n == gate - 4), "#5 did not take the device path")
        check(h == c and "-" not in h[0], "#5 phase differs between cuda and "
              "host, or tied: %s / %s" % (h, c))
        rows.append(("#5 2^n scorer", "n = %d" % n, th, tc, ts, card))

    for stage, size, th, tc, ts, card in rows:
        print("   %-17s %-14s host %.4f s  cuda %.4f s (card %.4f s)   "
              "(runs %s)" % (stage, size, th, tc, card,
                             {k: ["%.4f" % t for t in v]
                              for k, v in ts.items()}), flush=True)
        check(card > 0, "%s at %s: no card time on the device clock"
              % (stage, size))
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
    from phaser_tpu_torch.engine import blocks, connections, phasing
    from phaser_tpu_torch.mapper import dispatch as D
    walls = {}
    launches, relaunches, stage_calls, run_launch = None, 0, {}, {}
    for run in (device, "host", "gates_down", "auto"):
        dv = run if run in ("host", "auto") else device
        argv = ["--vcf", vcf, "--bam", bam, "--sample", data.sample,
                "--mapq", "10", "--baseq", "10", "--paired_end", "1",
                "--o", os.path.join(d, run), "--device", dv]
        rc, stdout, walls[run], run_launches, run_relaunches, calls = \
            counted_cli_run(argv, gates_down=run == "gates_down")
        if run == device:
            launches, relaunches = run_launches, run_relaunches
        stage_calls[run] = calls
        run_launch[run] = run_launches
        check(rc == 0, "CLI %s failed:\n%s" % (run, stdout[-3000:]))
        lines = stdout.splitlines()
        start = next((i for i, x in enumerate(lines)
                      if "stage timings" in x), len(lines))
        for line in lines[start + 1:]:
            if line.strip().startswith(("#", "device path", "COMPLETED")):
                print("   [%s] %s" % (run, line.strip()), flush=True)
        print("   [%s] device stage calls %s, reads over the pair K cap %d"
              % (run, calls, connections.COUNTS["host_reads"]), flush=True)
        if run != "host" and (run != "auto" or D.AUTO_ON_CARD):
            filter_stats(D, "[%s] allele assignment" % run, dropped=False)
    for run in (device, "gates_down", "auto"):
        same_outputs(os.path.join(d, run), os.path.join(d, "host"),
                     "e2e run %s" % run, vcf_text=False)
    print("   outputs byte-identical to host in the cuda, gates-down and "
          "auto runs (%s)" % ", ".join(SUFFIXES), flush=True)
    print("   e2e wall (CLI main, in process): %s %.3f s, host %.3f s, "
          "gates down %.3f s, auto %.3f s; kernel launches %s; capacity "
          "relaunches %d"
          % (device, walls[device], walls["host"], walls["gates_down"],
             walls["auto"], launches, relaunches), flush=True)
    check(launches and on_path_only(launches),
          "the main path launched %s, not #2's kernels alone" % launches)
    # auto: each stage on the card only where its module's AUTO_ON_CARD
    # says (#3-#5 also only above their gates)
    auto_2 = sum(run_launch["auto"].values()) > 0
    stage_ok = all((stage_calls["auto"][m.__name__.rsplit(".", 1)[1]] > 0)
                   <= m.AUTO_ON_CARD for m in (connections, blocks, phasing))
    check(auto_2 == D.AUTO_ON_CARD and stage_ok,
          "auto took a route its constants do not give: launches %s, stage "
          "calls %s" % (run_launch["auto"], stage_calls["auto"]))
    print("   auto's route: #2 %s (launches %s), stage calls %s; on the "
          "card: #3 %s, #4 %s, #5 %s" % (
              "card" if auto_2 else "host", run_launch["auto"],
              stage_calls["auto"], connections.AUTO_ON_CARD,
              blocks.AUTO_ON_CARD, phasing.AUTO_ON_CARD), flush=True)
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
                 {"ragged_join": launches["ragged_join"]}, calls,
                 shards[0] if shards else "-"), flush=True)
        if ref is not None:
            same_outputs(out, ref, "run %s" % name,
                         vcf_text=ref == host)
        record[name] = dict(launches=launches, calls=calls)
    check(record["a"]["launches"]["ragged_join"] > 0,
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
    the step's read planes, band_counts on the planes it returned (and
    its blocks that took the shared-memory window), the connection-test
    tail band_prune ("conflict_prune": two kernels), prune_mask's route
    through the same test body, binom_cdf as the step path launches it
    (conflicting_config_p on the merged band's counts) and on int32
    counts with a 0-d p ("binom_cdf_operands"); then the tail before (the
    three calls) and after (band_prune) in turns.
    Returns {kernel: (max_abs_err, ms, plain_ms, (device_ms, kernel_ms,
    profiles, whole))}, {kernel: (bound_ms, bound_by)} and the tail's and the
    window's numbers."""
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
    cfg = S.band_configs(pair)
    noise = S.noise_from_counts(counts)
    sup, total, p_success = S._conflict_args(*cfg, noise)
    sup32, total32 = sup.int(), total.int()

    def planes_err(got, want):
        return max(int((g.long() - w.long()).abs().max()) for g, w in
                   zip(got, want))

    def bc_err(got, want):
        return max(int((g - w).abs().max()) for g, w in zip(got, want))

    def prune_err(got, want):
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              "the connection test: prune or uncertain differ from the "
              "plain version's")
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
        "conflict_prune": (lambda: S.band_prune(counts, pair, STEP_THRESHOLD),
                           lambda: S.band_prune_plain(counts, pair,
                                                      STEP_THRESHOLD),
                           prune_err),
        "prune_mask": (lambda: S.prune_mask(*cfg, noise, STEP_THRESHOLD),
                       lambda: S.conflict_prune_plain(*cfg, noise,
                                                      STEP_THRESHOLD),
                       prune_err),
        "binom_cdf": (lambda: S.conflicting_config_p(*cfg, noise),
                      lambda: S.conflict_terms(*cfg, noise)[0], cdf_err),
        "binom_cdf_operands": (
            lambda: S.binom_cdf(sup32, total32, p_success),
            lambda: S.binom_cdf_plain(sup32, total32, p_success), cdf_err),
    }
    results = {}
    for kname, (kernel, plain, err_of) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = err_of(got, want)
        check(err <= STEP_TOL[kname], "%s (%s input): max_abs_err %g over "
              "%g" % (kname, name, err, STEP_TOL[kname]))
        timer = time_cold_ms if kname in COLD else time_ms
        p1 = timer(plain, 3)
        k1 = timer(kernel, 20)
        k2 = timer(kernel, 20)
        p2 = timer(plain, 3)
        on_card = device_ms(kname, cold(kernel) if kname in COLD else kernel)
        check(on_card is not None, "%s: the profiler saw no launch of %s"
              % (kname, KERNEL_FN[kname]))
        check(on_card[3], "%s: no profiler window of %d came back whole"
              % (kname, on_card[2]))
        results[kname] = (err, (k1 + k2) / 2, (p1 + p2) / 2, on_card)

    # band_counts' blocks, and those that added in their window
    TM.reset_launches()
    TM.band_counts(vidx, allele, M, STEP_BAND)
    window = TM.read_stats()
    # the tail before and after, in turns: CUDA events around the calls,
    # the profiler's device activities of a call
    three = lambda: S.prune_mask(*S.band_configs(pair),  # noqa: E731
                                 S.noise_from_counts(counts), STEP_THRESHOLD)
    after = lambda: S.band_prune(counts, pair, STEP_THRESHOLD)  # noqa: E731
    t_before = [time_ms(three, 20)]
    t_after = [time_ms(after, 20), time_ms(after, 20)]
    t_before.append(time_ms(three, 20))
    card_before, card_after = device_all(three), device_all(after)
    check(card_before is not None and card_after is not None,
          "the profiler saw no device activity of the tail")
    check(card_before[2] and card_after[2], "no whole profiler window of "
          "the tail, before (%s) or after (%s)" % (card_before[2],
                                                   card_after[2]))
    check(card_after[1] <= TAIL_MAX_LAUNCHES, "band_prune took %g device "
          "activities a call, over %d" % (card_after[1], TAIL_MAX_LAUNCHES))
    tail = {"before_ms": sum(t_before) / 2, "after_ms": sum(t_after) / 2,
            "before_card_ms": card_before[0],
            "before_launches": card_before[1],
            "after_card_ms": card_after[0], "after_launches": card_after[1]}

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
        # the tail: the counts and the band read, p and two flags written;
        # float64 operations of the fractions these pairs take
        "conflict_prune": fp64_bound(M * 12 + n_pairs * (36 + 10),
                                     fraction_flops(c_terms)),
        # three int32 counts and the noise read, p and two flags written
        "prune_mask": fp64_bound(n_pairs * 22 + 8, fraction_flops(c_terms)),
        # the step path's binom_cdf (conflicting_config_p): three int32
        # counts and the noise read, p written; the conflict test's terms
        "binom_cdf": fp64_bound(n_pairs * 20 + 8, fraction_flops(c_terms)),
        # int32 k and n read, p once (a 0-d tensor), p written
        "binom_cdf_operands": fp64_bound(n_pairs * 16 + 8,
                                         fraction_flops(b_terms)),
    }
    # conflicting_config_p's device activities a call (one binom_cdf
    # launch, nothing formed before it); the launch floor (an empty kernel
    # on the grid of the band's pairs)
    # (a window that is not whole only loses records, and could hide a
    # second activity: the count is read from a whole window)
    route_card = device_all(lambda: S.conflicting_config_p(*cfg, noise))
    check(route_card is not None and route_card[2] and route_card[1] == 1,
          "conflicting_config_p (%s input): %s device activities a call, "
          "not one launch in a whole window" % (name, route_card))
    stats_extra = {
        "elements": n_pairs, "live": int((c_terms > 0).sum()),
        "terms": int(c_terms.sum()),
        "operands_live": int((b_terms > 0).sum()),
        "operands_terms": int(b_terms.sum()),
        "operands_max_abs_err": results["binom_cdf_operands"][0],
        "route_card": route_card}
    stats_extra["launch_floor_ms"], stats_extra["launch_floor_whole"] = \
        launch_floor(n_pairs)
    print("   [%s] conflicting_config_p: %.4f ms on the card in %g device "
          "activity a call (window %s); launch floor (an empty kernel on the "
          "grid of %d) %.4f ms (window %s); on %s"
          % (name, route_card[0], route_card[1],
             "whole" if route_card[2] else "not whole", n_pairs,
             stats_extra["launch_floor_ms"], "whole" if
             stats_extra["launch_floor_whole"] else "not whole", smi),
          flush=True)
    for kname, (err, ms, plain_ms, (dev_ms, kernel_ms, _, _)) in \
            results.items():
        print("   [%s] %-14s max_abs_err %g  wrapper call %.4f ms; on the "
              "card %.4f ms, kernel alone %.4f ms   plain %.4f ms   bound "
              "%.4f ms (%s), %.1f%% of the time on the card   on %s"
              % (name, kname, err, ms, dev_ms, kernel_ms, plain_ms,
                 bounds[kname][0], bounds[kname][1],
                 100.0 * bounds[kname][0] / dev_ms, smi), flush=True)
    print("   [%s] band_counts: %d blocks, %d took the shared-memory window"
          % (name, window["blocks"], window["window_blocks"]), flush=True)
    print("   [%s] the tail, before (band_configs + noise_from_counts + "
          "prune_mask): call %.4f ms, on the card %.4f ms in %g device "
          "activities; after (band_prune): call %.4f ms, on the card %.4f "
          "ms in %g; whole profiler windows; on %s"
          % (name, tail["before_ms"], tail["before_card_ms"],
             tail["before_launches"], tail["after_ms"],
             tail["after_card_ms"], tail["after_launches"], smi), flush=True)
    print("   [%s] %d x %d bases, M %d: %d hits, %d pairs in the band, %d "
          "pairs with support, fraction terms: conflict_prune %d (max %d), "
          "binom_cdf on int32 operands %d (max %d)"
          % (name, N, L, M, int(hits.sum()), int(pair.sum()),
             int((sup > 0).sum()), int(c_terms.sum()), int(c_terms.max()),
             int(b_terms.sum()), int(b_terms.max())), flush=True)
    del results["binom_cdf_operands"], bounds["binom_cdf_operands"]
    return results, bounds, tail, window, stats_extra


def fraction_flops(terms):
    """The float64 operations of the incomplete beta's fractions and
    prefactors that these terms (binom_cdf_terms, conflict_terms) count."""
    from phaser_tpu_torch.kernels import stats as S
    return int(terms.sum()) * S.BETACF_TERM_FLOPS + \
        int((terms > 0).sum()) * S.BETACF_SETUP_FLOPS


def launch_floor(count):
    """(card ms, whole) of an empty kernel on binom_cdf_kernel's (and the
    conflict test's) grid for `count` elements: what a launch costs
    before any work.  The mean device time of the kernel's profiler
    records, from the first whole window of PROFILE_TRIES
    (utils/trace.profile_window), else from the last window that held any,
    whole False: a window short of records still times each record it
    holds, and the flag goes beside the floor."""
    import torch
    from phaser_tpu_torch.utils import build
    from phaser_tpu_torch.utils.trace import PROFILE_TRIES, profile_window
    stream = torch.cuda.current_stream().cuda_stream
    fn = lambda: build.launch("empty_grid_launch",  # noqa: E731
                              [ctypes.c_int, ctypes.c_void_p],
                              (count, stream))
    fn()
    torch.cuda.synchronize()
    seen = None
    for _ in range(PROFILE_TRIES):
        avgs, device, runtime = profile_window(fn, 20)
        recs = [e for e in avgs if KERNEL_FN["launch_floor"] in e.key]
        n = sum(e.count for e in recs)
        if n:
            seen = (sum(e.device_time_total for e in recs) / n / 1e3,
                    device == runtime)
            if seen[1]:
                return seen
        print("   profile of the empty kernel on %d elements not whole (%d "
              "device records, %d runtime enqueues)" % (count, device,
                                                        runtime), flush=True)
    check(seen is not None, "the profiler saw no empty kernel on %d elements"
          % count)
    return seen


def long_fraction_kernels(smi):
    """binom_cdf and the tail (band_prune) on the long fractions of
    testing/layouts.py (binom_long: 65,536 cdfs, n 1,000-10,000, k near
    the mean, p_success 0.97-0.994; band_long: 8,192 x 8 such tests at a
    noise rate of 0.3%), where the chain and not the launch sets the time:
    binom_cdf on binom_long's int32 k and n, binom_cdf as the step path
    launches it (conflicting_config_p) on band_long's counts, band_prune
    on band_long; against their plain versions (p within 1e-12, prune
    equal where |p - threshold| > 1e-12), timed from a cold L2, with their
    bounds and launch floors.  Returns {name: record}."""
    import torch
    from phaser_tpu_torch.kernels import stats as S
    from phaser_tpu_torch.testing import layouts
    dev = torch.device("cuda")
    k, n, p = (torch.from_numpy(x).to(dev) for x in layouts.binom_long())
    counts, pair = (torch.from_numpy(x).to(dev)
                    for x in layouts.band_long())
    cfg = S.band_configs(pair)
    noise = S.noise_from_counts(counts)
    b_terms = S.binom_cdf_terms(k, n, p)
    c_terms = S.conflict_terms(*cfg, noise)[1]
    runs = {
        # int32 k and n, float64 p read, p written
        "binom_cdf_operands": (lambda: S.binom_cdf(k, n, p),
                               lambda: S.binom_cdf_plain(k, n, p),
                               fp64_bound(k.numel() * 24,
                                          fraction_flops(b_terms)), b_terms),
        # three int32 counts and the noise read, p written
        "binom_cdf": (lambda: S.conflicting_config_p(*cfg, noise),
                      lambda: S.conflict_terms(*cfg, noise)[0],
                      fp64_bound(c_terms.numel() * 20 + 8,
                                 fraction_flops(c_terms)), c_terms),
        "conflict_prune": (lambda: S.band_prune(counts, pair,
                                                STEP_THRESHOLD),
                           lambda: S.band_prune_plain(counts, pair,
                                                      STEP_THRESHOLD),
                           fp64_bound(counts.numel() * 4 + pair.numel() * 4 +
                                      c_terms.numel() * 10,
                                      fraction_flops(c_terms)), c_terms)}
    out = {}
    for kname, (kernel, plain, bound, terms) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if kname != "conflict_prune":
            err = float((got - want).abs().max())
        else:
            err = float((got[0] - want[0]).abs().max())
            sure = (want[0] - STEP_THRESHOLD).abs() > 1e-12
            check(torch.equal(got[1][sure], want[1][sure]), "band_prune on "
                  "band_long: prune differs outside the uncertain band")
        check(err <= STEP_TOL[kname], "%s on the long fractions: max_abs_err "
              "%g over %g" % (kname, err, STEP_TOL[kname]))
        p1, k1, k2, p2 = (time_cold_ms(plain, 3), time_cold_ms(kernel, 20),
                          time_cold_ms(kernel, 20), time_cold_ms(plain, 3))
        on_card = device_ms(kname, cold(kernel))
        check(on_card is not None and on_card[3], "%s: no whole profiler "
              "window on the long fractions" % kname)
        rec = {"elements": terms.numel(), "live": int((terms > 0).sum()),
               "terms": int(terms.sum()), "max_terms": int(terms.max()),
               "max_abs_err": err, "ms": (k1 + k2) / 2,
               "plain_ms": (p1 + p2) / 2, "device_ms": on_card[0],
               "kernel_ms": on_card[1], "bound_ms": bound[0],
               "bound_by": bound[1]}
        rec["launch_floor_ms"], rec["launch_floor_whole"] = launch_floor(
            terms.numel())
        out[kname] = rec
        print("   [long] %-14s max_abs_err %g  wrapper call %.4f ms; on the "
              "card %.4f ms, kernel alone %.4f ms   plain %.4f ms   bound "
              "%.4f ms (%s), %.1f%% of the time on the card; launch floor "
              "%.4f ms (window %s); %d elements, %d fraction terms (max %d)"
              "   on %s"
              % (kname, err, rec["ms"], rec["device_ms"], rec["kernel_ms"],
                 rec["plain_ms"], rec["bound_ms"], rec["bound_by"],
                 100.0 * rec["bound_ms"] / rec["device_ms"],
                 rec["launch_floor_ms"], "whole" if rec["launch_floor_whole"]
                 else "not whole", rec["elements"], rec["terms"],
                 rec["max_terms"], smi), flush=True)
    return out


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
    (results, bounds, launches on the step path, extra keys of their
    records: band_counts' window blocks, the tail before and after)."""
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
    dense = _gen(STEP_ROWS, 128, CHROM_HETS)
    by_start = np.argsort(dense[2][:, 0], kind="stable")
    inputs = {"chromosome": step_input,
              "dense": dense,
              "dense_sorted": tuple(a[by_start] for a in dense[:3]) +
              dense[3:],
              "e2e": pack_reads(bd, rows=np.flatnonzero(
                  bd.refid == 0)[:STEP_ROWS]) + multihost.device_table(
                      fx["vcf"], fx["sample"], "")}
    del bd
    mesh = TM.make_mesh(1, device=device)
    launches = dict.fromkeys(STEP_KERNELS, 0)
    results, bounds = {}, {}
    extra = {k: {"inputs": {}} for k in ("binom_cdf", "conflict_prune")}
    table_launches = 0
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
        table_launches += S.LAUNCHES["lgamma_table"]
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
        res, bnd, tail, window, stats_extra = step_kernels_vs_plain(
            name, args, step, smi, device)
        if name == "dense_sorted":
            check(window["window_blocks"] > 0, "no band_counts block took "
                  "its shared-memory window on position-sorted rows")
        if name == "dense":
            check(window["window_blocks"] == 0, "band_counts blocks took "
                  "the window on rows in random order")
        for kname in STEP_KERNELS:
            if STEP_RECORD[kname] == name:
                results[kname], bounds[kname] = res[kname], bnd[kname]
        if STEP_RECORD["band_counts"] == name:
            extra["band_counts"] = {"window_blocks": window["window_blocks"],
                                    "blocks": window["blocks"]}
        if STEP_RECORD["conflict_prune"] == name:
            extra["conflict_prune"].update(tail)
        if name in ("chromosome", "e2e"):
            # the statistics kernels' other inputs, beside the record's own
            for kname in ("binom_cdf", "conflict_prune"):
                extra[kname]["inputs"][name] = dict(
                    stats_extra, max_abs_err=res[kname][0], ms=res[kname][1],
                    plain_ms=res[kname][2], device_ms=res[kname][3][0],
                    kernel_ms=res[kname][3][1], bound_ms=bnd[kname][0],
                    bound_by=bnd[kname][1])
        del step, p, counts, pair, prune, scores
        torch.cuda.synchronize()
    check(min(launches.values()) > 0,
          "the step path skipped a kernel: %s" % launches)
    for kname, rec in long_fraction_kernels(smi).items():
        if kname == "binom_cdf_operands":
            extra["binom_cdf"]["inputs"]["long_operands"] = rec
        else:
            extra[kname]["inputs"]["long"] = rec
    extra["binom_cdf"]["lgamma_table"] = {
        "launches": table_launches,
        "mismatches": S.lgamma_table_mismatches(torch.device(device))}
    print("   lgamma table: %d entries, %d of torch.lgamma's replaced by the "
          "kernels' lgamma" % (S.LGAMMA_TABLE_SIZE,
                               extra["binom_cdf"]["lgamma_table"]
                               ["mismatches"]), flush=True)

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
    return results, bounds, launches, extra


def phase9_in_child(step_input, fx, tmp):
    """sharded_step_phase in a process of its own, `chip_smoke.py --phase9
    DIR`, which finds its inputs in DIR and writes its records there: late
    in a process the profiler returns windows short of their first device
    records (PERF.md section 7), and phase 9's records need whole windows.
    Its output goes to this process's standard output."""
    import numpy as np
    d = os.path.join(tmp, "phase9")
    os.makedirs(d)
    np.savez(os.path.join(d, "step_input.npz"), *step_input)
    with open(os.path.join(d, "fixture.json"), "w") as f:
        json.dump(fx, f)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--phase9", d], cwd=REPO, timeout=900)
    check(proc.returncode == 0, "phase 9's process failed (exit %d)"
          % proc.returncode)
    with open(os.path.join(d, "records.json")) as f:
        rec = json.load(f)
    return rec["results"], rec["bounds"], rec["launches"], rec["extra"]


def phase9_main(d) -> int:
    """The child of phase9_in_child."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: no GPU")
    sys.path.insert(0, REPO)
    with np.load(os.path.join(d, "step_input.npz")) as z:
        step_input = tuple(z["arr_%d" % i] for i in range(len(z.files)))
    with open(os.path.join(d, "fixture.json")) as f:
        fx = json.load(f)
    results, bounds, launches, extra = sharded_step_phase(
        step_input, fx, nvidia_smi_line(), "cuda")
    check(not {"jax", "phaser_tpu", "pandas"} & set(sys.modules),
          "phase 9's process imported jax, the JAX package or pandas")
    with open(os.path.join(d, "records.json"), "w") as f:
        json.dump({"results": results, "bounds": bounds,
                   "launches": launches, "extra": extra}, f)
    return 0


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
        results, bounds, own_launches, chrom_launches, step_input = \
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
        launches.update(own_launches)
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
        step_results, step_bounds, step_launches, step_extra = \
            phase9_in_child(step_input, fixture, tmp)
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
    for name, (err, ms, plain_ms, (dev_ms, kernel_ms, profiles, whole)) \
            in results.items():
        bound_ms, bound_by = bounds[name][:2]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "kernel_ms": kernel_ms,
            "profiles": profiles, "whole": whole,
            **KERNEL_EXTRA.get(name, {}), **step_extra.get(name, {})})
        line = ("   %-15s %.4f (%.4f, %.4f)  %.4f  %.4f (%s)  %.1f%% (%.1f%%)  "
                % (name, ms, dev_ms, kernel_ms, plain_ms, bound_ms, bound_by,
                   100.0 * bound_ms / ms, 100.0 * bound_ms / dev_ms))
        if name in STEP_KERNELS:
            line += "%d on the step path (%s input)" % (launches[name],
                                                        STEP_RECORD[name])
        else:
            line += "%d / %d" % (chrom_launches.get(name, 0),
                                 e2e_launches.get(name, 0))
        if name in own_launches:
            line += "   (%d in its own phase-3 call; on no dispatcher path)" \
                % own_launches[name]
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
        if sys.argv[1:2] == ["--phase9"]:
            sys.exit(phase9_main(sys.argv[2]))
        sys.exit(main())
    except SmokeError as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
