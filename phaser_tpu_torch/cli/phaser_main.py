"""phaser_tpu_torch main CLI: phaser_tpu's `phaser` command (flag-compatible
with phASER's phaser.py:26-81) on the PyTorch / CUDA port.

--device: cuda (default) runs the device stages on the GPU and fails
without one: #2 allele assignment through the CUDA kernels, and, above
their size gates, #3 pair counting, #4 components and the #5 2^n scorer as
torch code.  auto asks for the GPU as cuda does, then routes each stage by
the H100 measurements its module records (mapper.dispatch.AUTO_ON_CARD,
engine.connections.AUTO_ON_CARD, engine.blocks.AUTO_ON_CARD,
engine.phasing.AUTO_ON_CARD): the card where it won, else the host code.
cpu runs the device stages with the kernels' plain PyTorch versions on CPU
tensors; host runs every stage on the host.

Runners, as phaser_tpu routes them (phaser_tpu/cli/phaser_main.py:105-138):
--process_slow 1 runs one engine per contig (engine.slow_mode), each
through N position-shard threads with --threads N; --threads N with
--device host spawns N engine processes over a Gloo group
(dist.engine_multihost.run_phaser_multiproc); --threads N with --device
cuda|auto|cpu runs N position-shard engine threads in this process, which
share the one card (run_phaser_sharded_threads).
"""

from __future__ import annotations

import argparse
import datetime
import functools
import sys
import time

from ..engine.output_stage import PhaserOptions
from ..utils import trace
from ..version import PHASER_COMPAT_VERSION, __version__

from ..engine.pipeline import run_phaser

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phaser")
    p.add_argument("--bam", required=False, default="")
    p.add_argument("--vcf", required=True, default="")
    p.add_argument("--sample", required=False, default="")
    p.add_argument("--mapq", required=True)
    p.add_argument("--baseq", type=int, required=True)
    p.add_argument("--paired_end", required=True)
    p.add_argument("--o", required=True)
    p.add_argument("--python_string", default="python3")          # accepted, unused
    p.add_argument("--haplo_count_bam_exclude", default="")
    p.add_argument("--haplo_count_blacklist", default="")
    p.add_argument("--cc_threshold", type=float, default=0.01)
    p.add_argument("--isize", default="0")
    p.add_argument("--as_q_cutoff", type=float, default=0.05)
    p.add_argument("--blacklist", default="")
    p.add_argument("--write_vcf", type=int, default=1)
    p.add_argument("--include_indels", type=int, default=0)
    p.add_argument("--output_read_ids", type=int, default=0)
    p.add_argument("--remove_dups", type=int, default=1)
    p.add_argument("--pass_only", type=int, default=1)
    p.add_argument("--unphased_vars", type=int, default=1)
    p.add_argument("--chr_prefix", type=str, default="")
    p.add_argument("--gw_phase_method", type=int, default=0)
    p.add_argument("--gw_af_field", default="AF")
    p.add_argument("--gw_phase_vcf", type=int, default=0)
    p.add_argument("--gw_phase_vcf_min_confidence", type=float, default=0.90)
    p.add_argument("--threads", type=int, default=1,
                   help="Position-sharded engines: N threads sharing the "
                        "device (--device cuda|auto|cpu) or N processes "
                        "(--device host); reference semantics "
                        "phaser.py:2077-2094.")
    p.add_argument("--max_block_size", type=int, default=15)
    p.add_argument("--temp_dir", default="")
    p.add_argument("--max_items_per_thread", type=int, default=100000)
    p.add_argument("--show_warning", type=int, default=0)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--chr", default="")
    p.add_argument("--unique_ids", type=int, default=0)
    p.add_argument("--id_separator", default="_")
    p.add_argument("--output_network", default="")
    p.add_argument("--process_slow", type=int, default=0,
                   help="1: one engine run per contig, outputs merged "
                        "(reference phaser.py:264-372).")
    p.add_argument("--resume", type=int, default=0,
                   help="Reuse completed work from a failed previous run: "
                        "with --process_slow 1, skip contigs whose outputs "
                        "exist; with --threads N (multiprocess), replay "
                        "completed shards' journals and recompute only "
                        "lost shards (phaser_tpu extension).")
    p.add_argument("--device", default="cuda",
                   choices=("cuda", "auto", "cpu", "host"),
                   help="Device of allele assignment and, above their "
                        "size gates, pair counting, components and the 2^n "
                        "scorer: cuda (CUDA kernels and torch on the GPU), "
                        "auto (needs the GPU; each stage on the card where "
                        "the H100 measurements say it wins, else on the "
                        "host), cpu (the kernels' plain PyTorch versions on "
                        "CPU tensors) or host (host code only) "
                        "(phaser_tpu_torch extension).")
    return p


def main(argv=None) -> int:
    with trace.root_span("phaser main"):
        return _main(argv)


def _main(argv) -> int:
    with trace.span("cli"):
        args = build_parser().parse_args(argv)
        print("")
        print("##################################################")
        print("       phaser_tpu_torch v%s (phASER v%s compatible)"
              % (__version__, PHASER_COMPAT_VERSION))
        print("   PyTorch / CUDA read-backed phasing + ASE engine")
        print("##################################################")
        print("")
        start = time.time()
        print('STARTED "Read backed phasing and ASE/haplotype analyses" ... ')
        print("    DATE, TIME : %s"
              % datetime.datetime.now().strftime("%Y-%m-%d, %H:%M:%S"))

        opts = PhaserOptions(
            id_separator=args.id_separator, unique_ids=args.unique_ids,
            gw_phase_method=args.gw_phase_method,
            output_read_ids=args.output_read_ids,
            output_network=args.output_network,
            unphased_vars=args.unphased_vars,
            max_block_size=args.max_block_size,
            cc_threshold=args.cc_threshold, as_q_cutoff=args.as_q_cutoff,
            pass_only=args.pass_only, include_indels=args.include_indels,
            remove_dups=args.remove_dups, write_vcf=args.write_vcf,
            gw_phase_vcf=args.gw_phase_vcf,
            gw_phase_vcf_min_confidence=args.gw_phase_vcf_min_confidence,
            gw_af_field=args.gw_af_field, chr_prefix=args.chr_prefix,
            show_warning=args.show_warning)
        device = args.device
        kwargs = dict(
            vcf=args.vcf, bam=args.bam, sample=args.sample, o=args.o,
            mapq=args.mapq, baseq=args.baseq, paired_end=args.paired_end,
            isize=args.isize, blacklist=args.blacklist,
            haplo_count_blacklist=args.haplo_count_blacklist,
            haplo_count_bam_exclude=args.haplo_count_bam_exclude)
        threads = max(1, args.threads)
        if args.process_slow == 1:
            from ..engine.slow_mode import run_phaser_slow
            _run = functools.partial(run_phaser_slow,
                                     resume=bool(args.resume),
                                     chrom=args.chr, opts=opts,
                                     threads=threads, device=device)
        elif threads > 1 and device == "host":
            from ..dist.engine_multihost import run_phaser_multiproc
            _run = functools.partial(run_phaser_multiproc, threads,
                                     chrom=args.chr, opts=opts,
                                     device=device, resume=bool(args.resume))
        elif threads > 1:
            from ..dist.engine_multihost import run_phaser_sharded_threads
            _run = functools.partial(run_phaser_sharded_threads,
                                     n_shards=threads, chrom=args.chr,
                                     opts=opts, device=device,
                                     position_shards=True)
        else:
            _run = functools.partial(run_phaser, chrom=args.chr, opts=opts,
                                     threads=1, device=device)
    try:
        res = _run(**kwargs)
    except (ValueError, RuntimeError, FileNotFoundError) as e:
        with trace.span("cli"):
            from ..utils.failures import write_failure_record
            record = write_failure_record(args.o, "phaser", e, argv)
            print("     FATAL ERROR: %s" % e)
            if record:
                print("     failure record: %s" % record)
        return 1
    with trace.span("cli"):
        from ..utils.failures import clear_failure_record
        clear_failure_record(args.o)
        if res.shard_device:
            print("     shard device/wall seconds: %s"
                  % " ".join("%.3f/%.3f" % dw for dw in res.shard_device))
        if device != "host":
            from ..engine import blocks, connections, phasing
            from ..kernels.alleles import LAUNCHES
            print("     kernel launches: %s"
                  % " ".join("%s=%d" % kv for kv in LAUNCHES.items()))
            print("     device stage calls: pair_counts=%d components=%d "
                  "phase_scores=%d (reads over the pair K cap on the host: "
                  "%d)"
                  % (connections.COUNTS["device_calls"],
                     blocks.COUNTS["device_calls"],
                     phasing.COUNTS["device_calls"],
                     connections.COUNTS["host_reads"]))
        print('COMPLETED "Read backed phasing" of sample %s in %s hh:mm:ss'
              % (args.sample,
                 time.strftime("%H:%M:%S",
                               time.gmtime(time.time() - start))))
    return 0

if __name__ == "__main__":
    sys.exit(main())
