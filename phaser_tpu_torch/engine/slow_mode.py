"""--process_slow mode on the port: the phaser_tpu_torch copy of
phaser_tpu/engine/slow_mode.py's `run_phaser_slow` (per-contig engine
runs, globally unique block indices, streamed merges of the per-contig
outputs; reference phaser.py:264-372).  The contig listing and the merge
helpers are unchanged copies.

It differs from phaser_tpu's in one place: a contig is skipped only when it
has nothing to phase (`NoHetSites`, `NoReadsMatched`).  phaser_tpu skips a
contig on any RuntimeError, but here a missing card, a failed nvcc build or
a second hit-capacity overflow are RuntimeErrors too, and skipping them
would turn a broken device into a run that exits 0 with contigs missing.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

from ..io import bgzf, tabix
from .output_stage import PhaserOptions
from .pipeline import NoHetSites, NoReadsMatched, PhaserResult, run_phaser

TEXT_SUFFIXES = ["variant_connections.txt", "allelic_counts.txt",
                 "haplotypes.txt", "haplotypic_counts.txt",
                 "allele_config.txt"]


# merged when present (--output_network)
OPTIONAL_TEXT_SUFFIXES = ["network.links.txt", "network.nodes.txt"]


def list_contigs(vcf_path: str) -> List[str]:
    """Distinct body contigs in appearance order (`tabix -l` equivalent)."""
    seen: List[str] = []
    data = bgzf.read_text_auto(vcf_path).decode()
    for line in data.splitlines():
        if line.startswith("#") or not line:
            continue
        c = line.split("\t", 1)[0]
        if c not in seen:
            seen.append(c)
    return seen


def _existing_block_count(prefix: str) -> int:
    """Blocks already written by a finished per-contig run (gw_confidence
    != 'nan' rows of its haplotypes file) — lets --resume keep PI unique."""
    path = prefix + ".haplotypes.txt"
    n = 0
    with open(path) as fh:
        next(fh, None)
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) > 15 and cols[15] != "nan":
                n += 1
    return n


def _stream_vcf_body(path: str, w: "bgzf.BgzfWriter",
                     include_header: bool) -> None:
    """Forward a per-contig bgzipped VCF into `w` block-by-block, dropping
    its header lines unless include_header. Memory: one block + line carry
    (header lines always precede the body, so once the body starts whole
    blocks pass through unscanned)."""
    import mmap
    with open(path, "rb") as fh, \
            mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        off = 0
        carry = b""
        in_header = True
        while off < len(mm):
            payload, bsize = bgzf.decompress_block(mm, off)
            off += bsize
            if not payload:
                continue
            if not in_header:
                w.write(payload)
                continue
            data = carry + payload
            nl = data.rfind(b"\n")
            if nl < 0:
                carry = data
                continue
            chunk, carry = data[:nl + 1], data[nl + 1:]
            pos = 0
            while in_header and pos < len(chunk):
                end = chunk.find(b"\n", pos) + 1
                if chunk[pos:pos + 1] == b"#":
                    if include_header:
                        w.write(chunk[pos:end])
                    pos = end
                else:
                    in_header = False
            if pos < len(chunk):
                w.write(chunk[pos:])
            if not in_header:
                # header scan just ended: flush the pending partial line in
                # place so later blocks can pass through unscanned (the
                # carry would otherwise be orphaned until EOF, corrupting
                # one record mid-file on any >1-block VCF)
                w.write(carry)
                carry = b""
        if carry:
            if carry[:1] == b"#":
                if include_header:
                    w.write(carry + b"\n")
            else:
                w.write(carry + b"\n")


def run_phaser_slow(*, vcf: str, bam: str, sample: str, o: str, mapq: str,
                    baseq: int, paired_end: str, chrom: str = "",
                    opts: Optional[PhaserOptions] = None,
                    device: str = "cuda", resume: bool = False,
                    threads: int = 1, log=print, **kw) -> PhaserResult:
    """threads > 1 composes memory-efficient mode with POSITION SHARDS:
    each contig runs through the sharded engine
    (dist.engine_multihost.run_phaser_sharded_threads: weight-balanced
    position ranges, bounded per-shard memory); outputs stay
    byte-identical to the single-threaded slow run, since slow mode's
    noise/AS scope is per-contig either way (reference composes its memory
    mode with its thread pool, phaser.py:264-321, 2077-2094)."""
    opts = opts or PhaserOptions()
    from ..mapper.dispatch import require_device
    require_device(device)
    contigs = chrom.split(",") if chrom else list_contigs(vcf)
    log("    Memory efficient mode is activated... ")
    log("    WARNING: this may produce slightly different results since the "
        "sequencing noise estimate is generated per chromosome")

    total = PhaserResult()
    pi_block_value = 0
    produced: List[str] = []
    for c in contigs:
        prefix = o + c
        if resume and all(os.path.isfile(prefix + "." + sfx)
                          for sfx in TEXT_SUFFIXES):
            log("     contig %s: resuming from existing outputs" % c)
            pi_block_value += _existing_block_count(prefix)
            produced.append(c)
            continue
        try:
            if threads > 1:
                from ..dist.engine_multihost import \
                    run_phaser_sharded_threads
                res = run_phaser_sharded_threads(
                    n_shards=threads, vcf=vcf, bam=bam, sample=sample,
                    o=prefix, mapq=mapq, baseq=baseq,
                    paired_end=paired_end, chrom=c, opts=opts,
                    device=device, position_shards=True,
                    pi_block_value=pi_block_value, log=lambda *a: None,
                    **kw)
            else:
                res = run_phaser(vcf=vcf, bam=bam, sample=sample, o=prefix,
                                 mapq=mapq, baseq=baseq,
                                 paired_end=paired_end, chrom=c, opts=opts,
                                 device=device,
                                 pi_block_value=pi_block_value, log=log,
                                 **kw)
        except (NoHetSites, NoReadsMatched) as e:
            log("     contig %s skipped: %s" % (c, e))
            continue
        pi_block_value = res.n_blocks
        produced.append(c)
        total.total_reads += res.total_reads
        total.het_count += res.het_count
        total.phased_variants += res.phased_variants
        total.unphased_count += res.unphased_count
        total.covered_count += res.covered_count
        total.dropped_connections += res.dropped_connections
        total.unphased_phased += res.unphased_phased
        total.phase_corrections += res.phase_corrections
        total.shard_device += res.shard_device or [(res.device_s, res.wall_s)]
    total.n_blocks = pi_block_value

    log("#8. Merging the results from several contigs/chromosome ...")
    # All merges STREAM (reference: bcftools concat | sort, phaser.py:359-367
    # — also constant-memory): peak RSS is one BGZF block + line carry,
    # independent of contig count.
    optional_present = [
        sfx for sfx in OPTIONAL_TEXT_SUFFIXES
        if any(os.path.isfile(o + c + "." + sfx) for c in produced)]
    for suffix in TEXT_SUFFIXES + optional_present:
        out_path = o + "." + suffix
        with open(out_path, "w") as out:
            header_written = False
            for c in produced:
                p = o + c + "." + suffix
                if not os.path.isfile(p):
                    continue
                with open(p) as fh:
                    first = fh.readline()
                    if first and not header_written:
                        out.write(first)
                        header_written = True
                    shutil.copyfileobj(fh, out)

    if opts.write_vcf == 1 and produced:
        # concatenate per-contig VCFs: one header (first), bodies in the
        # input VCF's contig order
        gz = o + ".vcf.gz"
        with bgzf.BgzfWriter(gz) as w:
            emitted_header = False
            for c in produced:
                p = o + c + ".vcf.gz"
                if not os.path.isfile(p):
                    continue
                _stream_vcf_body(p, w, include_header=not emitted_header)
                emitted_header = True
        tabix.build_vcf_index(gz)

    # delete per-contig files
    for c in produced:
        for suffix in TEXT_SUFFIXES + ["vcf.gz", "vcf.gz.tbi", "vcf.gz.csi",
                                       "network.links.txt", "network.nodes.txt"]:
            p = o + c + "." + suffix
            if os.path.isfile(p):
                os.remove(p)
    return total
