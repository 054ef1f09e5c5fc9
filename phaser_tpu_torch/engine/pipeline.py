"""End-to-end phasing pipeline: the phaser_tpu_torch copy of
phaser_tpu/engine/pipeline.py (the reference main flow,
phASER's phaser.py:182-1263), built on:

  decode (io.bam) -> allele assignment (mapper.host / kernels.alleles)
  -> hit accumulation (engine.hits) -> connection graph + binomial tests
  (engine.connections) -> blocks (engine.blocks) -> exhaustive phasing
  (engine.phasing) -> writers (engine.output_stage, engine.vcf_writer)

It differs from phaser_tpu's only where the device is reached: allele
assignment and hit resolution use this package's dispatcher (CUDA kernels),
the JAX compile-cache setup is gone, and connections (#3 pair counting),
blocks (#4 components) and phasing (#5 2^n scorer) are this package's
copies, which take `device` and run their torch device paths above their
size gates.  A run is cut into spans (utils/trace): `phaser run` holds the
numbered stages and, between them, unnumbered spans for the rest, so that
a trace names every part of a pass.  The two "nothing to phase" failures raise their own
RuntimeError subclasses (NoHetSites, NoReadsMatched), so that slow mode
can skip such a contig and let every other failure through.  Everything
else is kept line for line.

No subprocesses, no external genomics tools.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import bam as bamio
from ..io import vcf as vcfio
from ..io.bed import IntervalSet
from .blocks import find_blocks
from .connections import build_connections
from .hits import build_contig_rows, build_variant_reads, noise_terms
from .output_stage import (BlockOutputWriter, PhaserOptions,
                           write_allelic_counts, write_variant_connections)
from .phasing import phase_v3
from .varmap import build_variant_table
from ..mapper.dispatch import (AUTO_ON_CARD, assign_alleles_auto,
                               stage_device)
from ..utils import trace
from ..utils.trace import Tracer
from .vcf_writer import COUNTS as VCF_COUNTS
from .vcf_writer import write_phased_vcf


class NoHetSites(RuntimeError):
    """No heterozygous site of the run passed the filters."""


class NoReadsMatched(RuntimeError):
    """No read of the run matched a heterozygous site."""


@dataclass
class PhaserResult:
    total_reads: int = 0
    het_count: int = 0
    noise_e: float = 0.0
    n_blocks: int = 0
    phased_variants: int = 0
    unphased_phased: int = 0
    phase_corrections: int = 0
    unphased_count: int = 0
    covered_count: int = 0
    dropped_connections: int = 0
    # device-path seconds / wall seconds of this run (thread-scoped, so a
    # shard engine reports only its own device time); multi-shard runs
    # collect per-shard (device_s, wall_s) pairs into shard_device
    device_s: float = 0.0
    wall_s: float = 0.0
    shard_device: List[Tuple[float, float]] = field(default_factory=list)


def _broadcast(value: str, n: int, what: str) -> List[str]:
    lst = value.split(",")
    if len(lst) == 1 and n > 1:
        lst = lst * n
    elif len(lst) != n:
        raise ValueError("Number of %s values and input BAMs does not match." % what)
    return lst


def _index_skip_plan(xbam: str, contig_order, tables, log):
    """(voffset ranges, header meta) of the BGZF blocks of `xbam` whose
    reads can overlap a het site, or (None, None) to decode it whole.

    Index-driven decode skipping: with a .bai present, inflate only the
    BGZF blocks whose reads can overlap a het site (reference: `samtools
    view -L sites.bed`, phaser.py:1346 — which still inflates the whole
    stream). Reads in skipped blocks provably overlap no variant, so hits —
    and therefore every output and the AS-quantile population (per-hit
    rows, phaser.py:540-553) — are unchanged. PHASER_TPU_INDEX_SKIP:
    1=force, 0=off, auto=when selected bytes < 60% of the file."""
    skip_mode = os.environ.get("PHASER_TPU_INDEX_SKIP", "auto")
    from ..io import native as _native_mod
    # without the native inflater, read_bam_voffset_ranges falls back to a
    # full pure-Python decode — the slowest path; use the normal streaming
    # decode (and log no "skip" line) instead
    from ..io.bam_index import find_bam_index
    if skip_mode == "0" or find_bam_index(xbam) is None or \
            _native_mod.get_lib() is None:
        return None, None
    try:
        from ..io.bam_index import (
            BaiIndex, merge_voffset_ranges, plan_site_ranges,
            ranges_compressed_bytes, read_bam_header_meta)
        skip_meta = read_bam_header_meta(xbam)
        bai = BaiIndex.from_path(find_bam_index(xbam))
        chunks = []
        for c in contig_order:
            vt = tables[c]
            name = vt.chrom if vt.chrom in skip_meta[0] else \
                (c if c in skip_meta[0] else None)
            if name is None or len(vt) == 0:
                continue
            tid = skip_meta[0].index(name)
            beg = vt.pos.astype(np.int64) - 1
            end = beg + np.maximum(vt.ref_len.astype(np.int64), 1)
            chunks.extend(plan_site_ranges(bai, tid, beg, end))
        merged = merge_voffset_ranges(chunks)
        sel = ranges_compressed_bytes(merged, xbam)
        total = os.path.getsize(xbam)
        if skip_mode == "1" or sel < 0.6 * total:
            log("          index decode skip: %.0f%% of compressed blocks"
                % (100.0 * min(sel, total) / max(total, 1)))
            return merged, skip_meta
    except Exception as e:  # noqa: BLE001 - fall back whole
        log("          index decode skip unavailable (%s)" % e)
    return None, None


def _assign_counts() -> Dict[str, int]:
    """The dispatcher's and the allele kernels' counters that the
    `#2 allele assignment` spans record the increase of, and the
    `#2 hit resolve` spans, where an overflowed chunk is relaunched."""
    from ..kernels.alleles import LAUNCHES
    from ..mapper.dispatch import RELAUNCHES, STATS
    out = {k: STATS[k] for k in ("rows_in", "rows_kept", "uploads",
                                 "uploads_pinned", "stager_waits")}
    out.update(("launches_" + k, v) for k, v in LAUNCHES.items())
    out["relaunches_capacity"] = RELAUNCHES["capacity"]
    return out


def _vcf_counts() -> Dict[str, int]:
    """The writer's counters that a `#7 vcf write` span records the
    increase of: body lines written natively and formatted in Python."""
    return dict(VCF_COUNTS)


def _run_phaser_inner(*, vcf: str, bam: str, sample: str, o: str, mapq: str,
               baseq: int, paired_end: str, isize: str = "0",
               blacklist: str = "", haplo_count_blacklist: str = "",
               haplo_count_bam_exclude: str = "", chrom: str = "",
               opts: Optional[PhaserOptions] = None, device: str = "cuda",
               pi_block_value: int = 0, threads: int = 1,
               dist_reduce=None, split_outputs: bool = False,
               shard_plan=None, log=print) -> PhaserResult:
    """dist_reduce: optional cross-shard reducer (dist.engine_multihost)
    implementing the engine's global merge points, called in a FIXED
    order on every shard (collectives block until all shards arrive):

      1. `as_percentile(scores, q)` per bam — the AS-score quantile over
         all shards (phASER's phaser.py:540-553)
      2. `exchange_rows(...)` — position-sharded runs only: mapper rows of
         decoded-but-not-owned contigs move to the contig's owner
      3. `row_offsets(entries)` — global (bam, contig, entry) row-sequence
         placement, so first_seen ordering and uids match the
         single-process run exactly
      4. `noise(bm, bmm)` — the global sequencing-noise estimate merged
         before any shard tests edges (:610-632)
      5. `block_base(n_blocks)` — exclusive prefix sum of per-shard block
         counts, keeping PI block indices globally unique and ordered

    split_outputs: write globally-sorted sections (singletons, allelic
    counts) as keyed `.part` files for the cross-shard merge instead of
    appending them to the per-shard outputs.

    shard_plan: optional dist.shard_plan.ShardPlan — this shard DECODES
    reads whose start lies in plan.decode's (contig, position-range)s,
    classifies them against the FULL per-contig variant table (so
    boundary-spanning reads keep every hit without a halo), ships rows of
    non-owned contigs to their owners through dist_reduce.exchange_rows,
    and runs graph stages + outputs only for plan.own contigs.  Requires
    dist_reduce.  The reference caps parallelism at one worker per contig
    (phaser.py:62); the plan removes that cap."""
    opts = opts or PhaserOptions()
    if shard_plan is not None:
        if dist_reduce is None:
            raise ValueError("shard_plan requires dist_reduce")
        # parse variant tables for every contig this shard touches; the
        # graph/output stages below restrict themselves to plan.own
        touched = sorted(set(shard_plan.decode) | set(shard_plan.own))
        chrom = ",".join(touched) if touched else "\x00none"
    t0 = time.time()
    res = PhaserResult()
    tracer = Tracer()

    # tune the allocator + pre-fault the working set (lazily-backed VMs
    # serve first-touch faults remotely; see utils/memtune)
    # fail before any work when the GPU is asked for and absent
    from ..mapper.dispatch import require_device
    require_device(device)
    from ..utils import memtune
    with tracer.span("input sizes"):
        bam_bytes = 0
        for x in bam.split(","):
            if x and os.path.isfile(x):
                u = memtune.bgzf_uncompressed_size(x)
                bam_bytes += u if u > 0 else os.path.getsize(x) * 4
        # a position-sharded process only touches ~1/n of the BAM:
        # prefault its share, not the whole working set (the prefault is a
        # real per-process fixed cost on lazily-backed VMs)
        if shard_plan is not None and dist_reduce is not None:
            n_div = max(dist_reduce.n_shards, 1)
            pf = int(bam_bytes * 2 / 1e6 / n_div) + 128
        else:
            pf = int(bam_bytes * 5 / 1e6) + 256
    with tracer.span("prefault start"):
        memtune.setup(prefault_mb=min(pf, 4096), background=True)

    with tracer.span("vcf header"):
        if opts.id_separator == ":" or opts.id_separator == "":
            raise ValueError("ID separator must not be ':' or blank.")
        contig_ban = [opts.id_separator, ":"]

        map_sample_column = vcfio.sample_column_map(vcf)
        if sample not in map_sample_column:
            raise ValueError("Sample '%s' not found in the input VCF file."
                             % sample)
        sample_column = map_sample_column[sample]
        csi_index = os.path.isfile(vcf + ".csi")

        bam_list = bam.split(",")
        for xbam in bam_list:
            if xbam and not os.path.isfile(xbam):
                raise FileNotFoundError(xbam)
        mapq_list = _broadcast(mapq, len(bam_list), "mapq")
        isize_list = list(map(float, _broadcast(isize, len(bam_list),
                                                "isize")))
        paired_list = _broadcast(paired_end, len(bam_list), "paired_end")
        if haplo_count_bam_exclude:
            excl = [int(x) - 1 for x in haplo_count_bam_exclude.split(",")]
        else:
            excl = []

        # bam display names with duplicate suffixing (:469-480)
        file_names = [os.path.basename(x).replace(".bam", "")
                      for x in bam_list]
        bam_names: List[str] = []
        bam_counter: Dict[str, int] = {}
        for xbam in file_names:
            if file_names.count(xbam) > 1:
                bam_counter[xbam] = bam_counter.get(xbam, 0) + 1
                bam_names.append(xbam + "." + str(bam_counter[xbam]))
            else:
                bam_names.append(xbam)

        # ---- #1 VCF filtering
        log("#1. Loading heterozygous variants into intervals...")
        bl = IntervalSet.from_bed(blacklist) if blacklist else None
    with tracer.stage("#1 vcf filter", "lines"):
        filtered = vcfio.het_filtered_lines(vcf, sample_column, chrom or None, bl)
    tracer.add("#1 vcf filter", len(filtered), "lines")
    with tracer.span("variant tables"):
        set_haplo_blacklist = set()
        if haplo_count_blacklist:
            hbl = IntervalSet.from_bed(haplo_count_blacklist)
            set_haplo_blacklist = vcfio.haplo_blacklist_positions(
                [l for l in filtered if not l.startswith("#")], hbl, chrom)
        hs = vcfio.parse_het_sites(
            [l for l in filtered if not l.startswith("#")],
            chrom, contig_ban, bool(opts.pass_only))
        res.unphased_count = hs.unphased_count

        tables = {}
        het_count = 0
        indels_excluded = 0
        for c, recs in hs.pool.items():
            vt = build_variant_table(
                c, recs, id_separator=opts.id_separator,
                chr_prefix=opts.chr_prefix,
                include_indels=bool(opts.include_indels),
                gw_phase_method=opts.gw_phase_method,
                gw_af_field=opts.gw_af_field)
            tables[c] = vt
            het_count += vt.het_count
            indels_excluded += vt.indels_excluded
        res.het_count = het_count
        log("          %d heterozygous sites being used for phasing "
            "(%d filtered, %d indels excluded, %d unphased)"
            % (het_count, hs.filter_count, indels_excluded,
               hs.unphased_count))
        if het_count == 0 and dist_reduce is None:
            # a multi-shard run must keep going: every shard has to reach
            # the dist_reduce collectives in order or its peers would
            # block; a globally-empty run still fails at the noise
            # reduction below
            raise NoHetSites("No heterozygous sites that passed all "
                             "filters were included in the analysis")

        contig_order = list(hs.pool.keys())
        if shard_plan is not None:
            decode_order = [c for c in contig_order
                            if c in shard_plan.decode]
            own_order = [c for c in contig_order if c in shard_plan.own]
            # result counters describe this shard's OWNED contigs (summed
            # across shards by the shard runner); unphased/filter counts
            # remain the touched-set parse counts (summary cosmetics only)
            res.het_count = sum(tables[c].het_count for c in own_order)
        else:
            decode_order = own_order = contig_order

        # ---- #2 read retrieval + allele mapping
        log("#2. Retrieving reads that overlap heterozygous sites...")
        per_contig_bam_hits: Dict[str, list] = {c: [] for c in contig_order}
        as_scores_per_bam: Dict[int, list] = {}

        stream_threshold = float(os.environ.get(
            "PHASER_TPU_STREAM_THRESHOLD_MB", "2048")) * 1e6

        # --threads: the reference forks one pool worker per contig
        # (phaser.py:2077-2094); the in-process equivalent threads the
        # per-contig host stages — the C++ mapper and numpy release the
        # GIL, so per-contig work genuinely overlaps. Device launches stay
        # serial (ordering of deferred launches must be deterministic).
        pool = None
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=threads,
                                      thread_name_prefix="phaser-contig")

    # the pool must not leak worker threads on any failure path
    try:
        def _process_chunk(bam_i, bd, mq, isz, excl_flag, req_flag):
            """Filter one decoded chunk per contig and LAUNCH allele assignment
            (deferred device work — resolution happens after every chunk of
            every BAM has launched, keeping all device->host fetches after all
            program launches; see mapper.dispatch docstring)."""
            work = []
            with tracer.span("read filter"):
                for c in contig_order:
                    vt = tables[c]
                    if vt.chrom in bd.ref_names:
                        tid = bd.ref_names.index(vt.chrom)
                    elif c in bd.ref_names:
                        tid = bd.ref_names.index(c)
                    else:
                        continue
                    keep = ((bd.refid == tid) &
                            ((bd.flag & excl_flag) == 0) &
                            ((bd.flag & req_flag) == req_flag) &
                            (bd.mapq >= int(mq)))
                    if keep.any():
                        work.append((c, vt, keep))

            def _one(item):
                c, vt, keep = item
                chunk = bd.select(keep)
                pending = assign_alleles_auto(chunk, vt, baseq=baseq,
                                              splice=True, isize_cutoff=isz,
                                              device=device, defer=True)
                return c, chunk, pending

            with tracer.stage("#2 allele assignment", "reads",
                              _assign_counts):
                if pool is not None and len(work) > 1 and stage_device(
                        device, AUTO_ON_CARD) in ("host", "off"):
                    results = list(pool.map(trace.carry(_one), work))
                else:
                    results = [_one(w) for w in work]
            for c, chunk, pending in results:
                tracer.add("#2 allele assignment", len(chunk), "reads")
                per_contig_bam_hits[c].append(
                    (bam_i, chunk, pending, len(per_contig_bam_hits[c])))

        def _process_planned_bam(bam_i, xbam, mq, isz, excl_flag, req_flag):
            """Position-range decode (shard_plan): only this shard's
            (contig, range) spans are inflated, via the BAI linear index
            (io.bam_index.read_bam_starts); reads classify against the
            FULL contig table so boundary-spanning reads lose nothing."""
            from ..io.bam_index import (BaiIndex, ensure_bai,
                                        read_bam_header_meta, read_bam_starts)
            with tracer.span("decode plan"):
                meta = read_bam_header_meta(xbam)
                ref_names = meta[0]
                bai_p = ensure_bai(xbam)
                bai = BaiIndex.from_path(bai_p) if bai_p else None
            full_bd = None if bai is not None else bamio.read_bam(xbam)
            for c in decode_order:
                vt = tables[c]
                if vt.chrom in ref_names:
                    tid = ref_names.index(vt.chrom)
                elif c in ref_names:
                    tid = ref_names.index(c)
                else:
                    continue
                for rank, (lo, hi) in zip(shard_plan.range_rank[c],
                                          shard_plan.decode[c]):
                    hi_eff = hi
                    with tracer.stage("#2 bam decode", "reads"):
                        if bai is not None:
                            bd = read_bam_starts(xbam, tid, lo, hi_eff, bai,
                                                 header_meta=meta)
                        else:
                            # no-index fallback (CI): whole decode + mask
                            bd = full_bd.select(
                                (full_bd.refid == tid) &
                                (full_bd.pos >= lo) & (full_bd.pos < hi_eff))
                    tracer.add("#2 bam decode", len(bd), "reads")
                    with tracer.span("read filter"):
                        keep = (((bd.flag & excl_flag) == 0) &
                                ((bd.flag & req_flag) == req_flag) &
                                (bd.mapq >= int(mq)))
                        chunk = bd.select(keep)
                    with tracer.stage("#2 allele assignment", "reads",
                                      _assign_counts):
                        pending = assign_alleles_auto(
                            chunk, vt, baseq=baseq, splice=True,
                            isize_cutoff=isz, device=device, defer=True)
                    tracer.add("#2 allele assignment", len(chunk), "reads")
                    per_contig_bam_hits[c].append(
                        (bam_i, chunk, pending, rank))

        for bam_i, (xbam, mq, isz, pe) in enumerate(
                zip(bam_list, mapq_list, isize_list, paired_list)):
            with tracer.span("decode plan"):
                log("     file: %s" % xbam)
                log("          minimum mapq: %s" % mq)
                excl_flag = bamio.FLAG_UNMAPPED
                if opts.remove_dups == 1:
                    excl_flag |= bamio.FLAG_DUP
                req_flag = bamio.FLAG_PROPER_PAIR if int(pe) == 1 else 0
                skip_ranges = None
                if shard_plan is None:
                    skip_ranges, skip_meta = _index_skip_plan(
                        xbam, contig_order, tables, log)
                    if skip_ranges is None:
                        from ..utils.memtune import bgzf_uncompressed_size
                        usize = bgzf_uncompressed_size(xbam)
            if shard_plan is not None:
                _process_planned_bam(bam_i, xbam, mq, isz, excl_flag,
                                     req_flag)
                for c in contig_order:
                    log("               completed chromosome %s..."
                        % tables[c].chrom)
                as_scores_per_bam[bam_i] = []
                continue
            if skip_ranges is not None:
                from ..io.bam_index import read_bam_voffset_ranges
                with tracer.stage("#2 bam decode", "reads"):
                    bd = read_bam_voffset_ranges(xbam, skip_ranges,
                                                 header_meta=skip_meta)
                tracer.add("#2 bam decode", len(bd), "reads")
                _process_chunk(bam_i, bd, mq, isz, excl_flag, req_flag)
            elif usize > stream_threshold:
                log("          streaming decode (%.1f GB uncompressed)"
                    % (usize / 1e9))
                # windows decode on the prefetch thread; the critical
                # path pays the wait for each, timed as the decode stage
                # (its spans count `stream_waits`)
                from ..utils.prefetch import consumer_counts, iter_prefetch
                windows = iter_prefetch(bamio.iter_bam_stream(xbam),
                                        depth=2,
                                        parent=trace.current_span(),
                                        counters=bamio.stream_counts)
                try:
                    while True:
                        with tracer.stage("#2 bam decode", "reads",
                                          consumer_counts):
                            bd = next(windows, None)
                        if bd is None:
                            break
                        tracer.add("#2 bam decode", len(bd), "reads")
                        _process_chunk(bam_i, bd, mq, isz, excl_flag,
                                       req_flag)
                finally:
                    windows.close()
            else:
                with tracer.stage("#2 bam decode", "reads"):
                    bd = bamio.read_bam(xbam)
                tracer.add("#2 bam decode", len(bd), "reads")
                _process_chunk(bam_i, bd, mq, isz, excl_flag, req_flag)
            for c in contig_order:
                log("               completed chromosome %s..." % tables[c].chrom)
            as_scores_per_bam[bam_i] = []

        # resolve wave: all launches are in flight; force every launched
        # program to finish BEFORE the first device->host fetch (the fetch
        # drops the device link into slow dispatch mode), then fetch + merge
        # each chunk's hits and collect the per-BAM alignment scores
        with tracer.stage("#2 hit resolve", "hits", _assign_counts):
            from ..mapper.dispatch import resolve_all
            flat = [(c, ei) for c in contig_order
                    for ei in range(len(per_contig_bam_hits[c]))]
            # ONE batched device->host transfer for every launched chunk
            resolved = resolve_all([per_contig_bam_hits[c][ei][2]
                                    for c, ei in flat])
            for (c, ei), hits in zip(flat, resolved):
                bam_i, chunk, _, rank = per_contig_bam_hits[c][ei]
                per_contig_bam_hits[c][ei] = (bam_i, chunk, hits, rank)
                tracer.add("#2 hit resolve", len(hits), "hits")
                if len(hits):
                    ha = chunk.has_as[hits.read_idx]
                    as_scores_per_bam[bam_i].extend(
                        chunk.as_score[hits.read_idx][ha].tolist())

        # AS cutoffs (:540-553): quantile over all rows of the bam (across all
        # shards when running multi-host)
        with tracer.span("as cutoffs"):
            as_cutoffs: Dict[int, Optional[float]] = {}
            for bam_i in range(len(bam_list)):
                cutoff = None
                if opts.as_q_cutoff > 0:
                    scores = as_scores_per_bam[bam_i]
                    if dist_reduce is not None:
                        cutoff = dist_reduce.as_percentile(
                            scores, opts.as_q_cutoff * 100)
                        if cutoff is None:
                            log("          no alignment score value found "
                                "in reads, cannot use cutoff")
                        else:
                            log("          using alignment score cutoff "
                                "of %d" % cutoff)
                    elif len(scores) == 0:
                        log("          no alignment score value found in "
                            "reads, cannot use cutoff")
                    else:
                        cutoff = float(np.percentile(
                            scores, opts.as_q_cutoff * 100))
                        log("          using alignment score cutoff of %d"
                            % cutoff)
                as_cutoffs[bam_i] = cutoff

        # position-sharded runs: ship mapper rows of decoded-but-not-owned
        # contigs to their owner (one allgather; each shard keeps only its
        # owned contigs' entries), then sort every owned contig's entries
        # into global (bam, range_rank) order — identical to the
        # single-process (bam, position) scan order
        if shard_plan is not None:
            from .row_exchange import bundle_entry, unbundle_entry
            owned = set(own_order)
            outgoing = []
            with tracer.span("row bundle"):
                for c in decode_order:
                    if c in owned:
                        continue
                    for (b, chunk, hits, rank) in per_contig_bam_hits[c]:
                        outgoing.append((c, b, rank,
                                         bundle_entry(chunk, hits)))
                    per_contig_bam_hits[c] = []
            with tracer.stage("#2 row exchange", "rows"):
                incoming = dist_reduce.exchange_rows(outgoing, owned)
                for c, b, rank, bundle in incoming:
                    chunk, hits = unbundle_entry(bundle)
                    per_contig_bam_hits[c].append((b, chunk, hits, rank))
                    tracer.add("#2 row exchange", len(hits), "rows")
            with tracer.span("row bundle"):
                for c in own_order:
                    per_contig_bam_hits[c].sort(key=lambda t: (t[0], t[3]))

        # global row sequence offsets: bam-major, then contig, then entry/row.
        # row_seq values feed first_seen (output row ordering) and uid
        # assignment, so under a multi-shard run each shard must place its
        # entries at the offsets the single-process run would have used —
        # dist_reduce.row_offsets allgathers every shard's per-entry counts
        # and positions them in global (bam, contig_rank, entry_key) order,
        # where entry_key is the scan index (contig shards) or the global
        # range rank (position shards).
        with tracer.span("entry offsets"):
            entry_offsets: Dict[str, list] = {
                c: [None] * len(per_contig_bam_hits[c]) for c in contig_order}
            entries = []  # (bam_i, contig, pos_idx, entry_key, n_rows)
            for bam_i in range(len(bam_list)):
                for c in own_order:
                    for ei, (b, chunk, hits, rank) in \
                            enumerate(per_contig_bam_hits[c]):
                        if b != bam_i or chunk is None:
                            continue
                        n = len(hits)
                        if as_cutoffs[bam_i] is not None and n:
                            kept = (chunk.as_score[hits.read_idx] >=
                                    as_cutoffs[bam_i])
                            n = int(kept.sum())
                        entries.append((bam_i, c, ei, rank, n))
            if dist_reduce is not None:
                offs = dist_reduce.row_offsets(
                    [(b, c, rank, n) for (b, c, ei, rank, n) in entries])
            else:
                offs = []
                seq = 0
                for (_, _, _, _, n) in entries:
                    offs.append(seq)
                    seq += n
            for (bam_i, c, ei, rank, n), off in zip(entries, offs):
                entry_offsets[c][ei] = off

        total_reads = 0
        with tracer.stage("#2 accumulate", "rows"):
            def _accumulate(c):
                vt = tables[c]
                per_bam = []
                offsets = []
                for ei, (b, chunk, h, rank) in \
                        enumerate(per_contig_bam_hits[c]):
                    if chunk is not None:
                        per_bam.append((b, chunk, h))
                        offsets.append(entry_offsets[c][ei])
                rows = build_contig_rows(vt, per_bam, as_cutoffs, offsets)
                return len(rows), build_variant_reads(rows, excl)

            if pool is not None and len(own_order) > 1:
                accumulated = list(pool.map(trace.carry(_accumulate),
                                            own_order))
            else:
                accumulated = [_accumulate(c) for c in own_order]
            contig_states = []
            for n_rows, vr in accumulated:
                total_reads += n_rows
                contig_states.append((vr, None))
        tracer.add("#2 accumulate", total_reads, "rows")
        res.total_reads = total_reads
        log("          retrieved %d reads" % total_reads)

        # ---- #3 noise + connections
        with tracer.span("noise"):
            log("#3. Identifying connected variants...")
            bm, bmm = 0, 0
            for vr, _ in contig_states:
                m, mm = noise_terms(vr)
                bm += m
                bmm += mm
            if dist_reduce is not None:
                # one global reduction mid-pipeline, exactly like the
                # reference's parent-side merge before edge testing
                # (phaser.py:610-632)
                bm, bmm = dist_reduce.noise(bm, bmm)
            if bm == 0:
                raise NoReadsMatched("No reads could be matched to variants.")
            noise_e = float(bmm) / (float(bm + bmm) * 2)
            res.noise_e = noise_e
            log("     sequencing noise level estimated at %f" % noise_e)

        with tracer.stage("#3 connections", "pairs"):
            def _connect(state):
                vr = state[0]
                return (vr, build_connections(vr, noise_e, opts.cc_threshold,
                                              device=device))

            # same serial-launch invariant as _process_chunk: device pair-count
            # kernels are dispatched from one thread only
            if pool is not None and device in ("host", "off") and \
                    len(contig_states) > 1:
                contig_states = list(pool.map(trace.carry(_connect),
                                              contig_states))
            else:
                contig_states = [_connect(s) for s in contig_states]
        tracer.add("#3 connections",
                   sum(c.n_pairs for _, c in contig_states), "pairs")

        with tracer.span("tables write"):
            res.dropped_connections = write_variant_connections(
                o, contig_states)
            log("     %d variant connections dropped because of conflicting "
                "configurations (threshold = %f)"
                % (res.dropped_connections, opts.cc_threshold))
            res.covered_count = write_allelic_counts(o, contig_states,
                                                     keyed=split_outputs)
            log("     %d variants covered by at least 1 read"
                % res.covered_count)

        # ---- #4/#5 blocks + phasing
        log("#4. Identifying haplotype blocks...")
        log("#5. Phasing blocks...")
        final = []  # (vr, conn, [(v, allele_char)...])
        with tracer.stage("#4/#5 blocks+phasing", "blocks"):
            for vr, conn in contig_states:
                blocks = find_blocks(conn, vr.vt, device=device)
                tracer.add("#4/#5 blocks+phasing", len(blocks), "blocks")
                for block in blocks:
                    vconn = {v: conn.adj[v] for v in block if v in conn.adj}
                    ac = {}
                    for v in block:
                        for a in (0, 1):
                            if (v, a) in conn.allele_conn:
                                ac[(v, a)] = conn.allele_conn[(v, a)]
                    for phased in phase_v3(block, vconn, ac,
                                           opts.max_block_size,
                                           device=device):
                        final.append((vr, conn, phased))

        # ---- #6 outputs
        log("#6. Outputting haplotypes...")
        with tracer.stage("#6 outputs", "blocks"):
            from ..dist.block_exchange import balance_blocks_enabled
            delegate6 = (shard_plan is not None and dist_reduce is not None
                         and dist_reduce.n_shards > 1
                         and balance_blocks_enabled())
            writer = BlockOutputWriter(o, opts, bam_list, bam_names, excl,
                                       set_haplo_blacklist,
                                       singleton_files=split_outputs,
                                       block_files=delegate6)
            # PI block indices are assigned in global processing order; under a
            # multi-shard run each shard starts at the sum of earlier shards'
            # block counts (len(final) == blocks this shard will emit)
            base = (dist_reduce.block_base(len(final))
                    if dist_reduce is not None else 0)
            writer.state.block_count = pi_block_value + base
            if delegate6:
                # ownership-balanced #6: formatting a block needs only its own
                # slice of the contig state, so blocks spread round-robin by
                # global index across shards through one collective; rows land
                # in keyed parts the merge interleaves back into global block
                # order (round-4 verdict #3; dist.block_exchange)
                from ..dist.block_exchange import (bundle_block, delegate_of,
                                                   unbundle_block)
                first_bi = pi_block_value + base
                n_sh = dist_reduce.n_shards
                own_ids: List[str] = []
                outgoing6 = []
                for k_i, (vr, conn, phased) in enumerate(final):
                    bi = first_bi + k_i + 1
                    own_ids += [vr.vt.unique_ids[v] for v, _ in phased]
                    outgoing6.append((bi, delegate_of(bi, n_sh), bundle_block(
                        vr, conn, phased, len(bam_list),
                        opts.output_read_ids == 1)))
                mine6 = dist_reduce.exchange_blocks(outgoing6)
                for bi, bundle in mine6:
                    vr_s, conn_s, phased_s = unbundle_block(bundle)
                    writer.state.block_count = bi - 1
                    writer.block_key = bi
                    writer.process_block(vr_s, conn_s, phased_s)
                # owner-side bookkeeping (independent of where formatting ran):
                # this shard's phased-variant ids gate ITS singleton sections,
                # and the global block count closes over its own blocks
                writer.state.all_variant_ids = own_ids
                writer.state.block_count = first_bi + len(final)
            else:
                for vr, conn, phased in final:
                    writer.process_block(vr, conn, phased)
            res.n_blocks = writer.state.block_count
            res.phased_variants = len(writer.state.all_variant_ids)
            if opts.unphased_vars == 1:
                writer.write_singletons(contig_states)
            writer.close()

        # ---- #7 VCF
        if opts.write_vcf == 1:
            log("#7. Outputting phased VCF...")
            if shard_plan is not None:
                # ownership-BALANCED: every shard formats the body rows of
                # its weight-balanced DECODE ranges (not just owned
                # contigs), using the owners' phase state merged through
                # one collective — a 60%-weight contig's string-heavy VCF
                # work no longer lands on a single owner (round-4 verdict
                # #3; reference behavior preserved: byte order of
                # phASER's phaser.py:1661-1855)
                st = writer.state
                piece = {"haplotype_lookup": st.haplotype_lookup,
                         "gw_stat_lookup": st.gw_stat_lookup,
                         "max_maf_lookup": st.max_maf_lookup,
                         "gw_phase": st.gw_phase,
                         "ind_alleles": st.ind_alleles}
                with tracer.stage("#7 state exchange", "entries"):
                    parts = dist_reduce.exchange_state(piece)
                from .output_stage import OutputState
                with tracer.span("state merge"):
                    merged = OutputState()
                    for pc in parts:
                        merged.haplotype_lookup.update(
                            pc["haplotype_lookup"])
                        merged.gw_stat_lookup.update(pc["gw_stat_lookup"])
                        merged.max_maf_lookup.update(pc["max_maf_lookup"])
                        merged.gw_phase.update(pc["gw_phase"])
                        merged.ind_alleles.update(pc["ind_alleles"])
                with tracer.span("rsid lookup"):
                    rsid_lookup = {}
                    for c in decode_order:
                        vt = tables[c]
                        for i, uid in enumerate(vt.unique_ids):
                            rsid_lookup[uid] = vt.rsids_out[i]
                    # keyed by the VCF body's contig column = the VCF's own
                    # contig names (NOT vt.chrom, which carries
                    # --chr_prefix)
                    ranges_by_chrom = {c: shard_plan.decode[c]
                                       for c in decode_order}
                    vcf_chrom = (",".join(decode_order)
                                 if decode_order else "\x00none")
                with tracer.stage("#7 vcf write", "lines", _vcf_counts):
                    res.unphased_phased, res.phase_corrections = \
                        write_phased_vcf(
                            vcf, sample_column, o, vcf_chrom, merged, opts,
                            csi_index=csi_index, rsid_lookup=rsid_lookup,
                            pos_ranges=ranges_by_chrom, body_only=True,
                            write_header_file=dist_reduce.shard_id == 0)
            else:
                with tracer.span("rsid lookup"):
                    rsid_lookup = {}
                    for vr, _ in contig_states:
                        vt = vr.vt
                        for i, uid in enumerate(vt.unique_ids):
                            rsid_lookup[uid] = vt.rsids_out[i]
                with tracer.stage("#7 vcf write", "lines", _vcf_counts):
                    # contig-sharded runs: the per-shard VCF body carries
                    # ONLY owned contigs
                    vcf_chrom = (",".join(own_order)
                                 if own_order else "\x00none") \
                        if dist_reduce is not None and split_outputs \
                        else chrom
                    res.unphased_phased, res.phase_corrections = \
                        write_phased_vcf(
                            vcf, sample_column, o, vcf_chrom, writer.state,
                            opts, csi_index=csi_index,
                            rsid_lookup=rsid_lookup)

        with tracer.span("release"):
            # the run's reads, tables and lookups (and the loop variables
            # that still hold the last of them) are freed here, in a span,
            # and not unseen as the frame exits after the last one
            bd = filtered = hs = tables = per_contig_bam_hits = None
            flat = resolved = as_scores_per_bam = scores = None
            entries = offs = entry_offsets = accumulated = None
            contig_states = final = writer = rsid_lookup = merged = None
            parts = vr = conn = vt = chunk = hits = None
            blocks = block = vconn = ac = phased = None

        with tracer.span("summary"):
            total_time = time.time() - t0
            res.device_s, res.wall_s = tracer.device_share()
            for line in tracer.summary_lines():
                log(line)
            log("")
            log("     COMPLETED using %d reads in %d seconds"
                % (total_reads, total_time))
            if het_count:
                log("     PHASED  %d of %d all variants (= %f) with at least "
                    "one other variant"
                    % (res.phased_variants, het_count,
                       float(res.phased_variants) / float(het_count)))
        return res
    finally:
        if pool is not None:
            pool.shutdown()


def run_phaser(**kwargs) -> PhaserResult:
    """GC-freeze wrapper around the engine: freeze the CALLER's heap out
    of cyclic-GC for the duration of the run — the engine allocates in
    bursts, and every young-gen collection otherwise re-traverses whatever
    object graph the embedding process holds (measured 2.6x wall blowup
    under a 12M-object caller heap). Unfreezes on every exit path."""
    import gc
    # no gc.collect() first: a full pass over a large caller heap costs
    # more than the run saves; pre-existing garbage is frozen for the
    # duration and reclaimed by the caller's next gen-2 collection
    gc.freeze()
    try:
        with trace.root_span("phaser run"):
            return _run_phaser_inner(**kwargs)
    finally:
        gc.unfreeze()


run_phaser.__doc__ = (run_phaser.__doc__ or "") + "\n\n" + \
    (_run_phaser_inner.__doc__ or "")
