"""The plain reference of one engine run: the single-process path of
phaser_tpu_torch/engine/pipeline.py (phASER's phaser.py:182-1263) over the
generator's arrays, writing the six outputs to `<out>.*` (the phased VCF
uncompressed, as `<out>.vcf`).

Run with the configuration's flags and phASER's defaults for the rest;
`p_dtype` is the precision of the connection test's p-values."""

from __future__ import annotations

import numpy as np

from .assign import assign, chunk_of, kept
from .assign import join_work as join_work_of
from .engine.blocks import find_blocks
from .engine.connections import build_connections
from .engine.hits import build_contig_rows, build_variant_reads, noise_terms
from .engine.output_stage import (BlockOutputWriter, PhaserOptions,
                                  write_allelic_counts,
                                  write_variant_connections)
from .engine.phasing import phase_v3
from .engine.varmap import build_variant_table
from .engine.vcf import het_filtered_lines, parse_het_sites, sample_column_map
from .engine.vcf_writer import write_phased_vcf


def flag_values(flags: list) -> dict:
    return {flags[i].lstrip("-"): flags[i + 1]
            for i in range(0, len(flags), 2)}


def bam_flags(cfg: dict) -> tuple:
    """(MAPQ, paired) of each BAM and BASEQ, from the configuration's
    flags (one value for all BAMs, or one a BAM)."""
    fl = flag_values(cfg["flags"])
    n_bam = len(cfg["bams"])

    def per_bam(key):
        v = fl[key].split(",")
        return v * n_bam if len(v) == 1 else v
    return ([int(x) for x in per_bam("mapq")],
            [int(x) == 1 for x in per_bam("paired_end")], int(fl["baseq"]))


def variant_tables(cfg: dict, vcf_text: str, opts: PhaserOptions) -> tuple:
    """(sample column, {contig: VariantTable}) of #1's het filter."""
    sample_column = sample_column_map(vcf_text)[cfg["sample"]]
    filtered = het_filtered_lines(vcf_text, sample_column, None, None)
    hs = parse_het_sites([l for l in filtered if not l.startswith("#")], "",
                         [opts.id_separator, ":"], bool(opts.pass_only))
    return sample_column, {c: build_variant_table(c, recs)
                           for c, recs in hs.pool.items()}


def join_work(cfg: dict, donor, sets: list) -> list:
    """The ragged join's work in one pass, one entry a BAM and contig
    (`assign.join_work`)."""
    mapqs, paired, baseq = bam_flags(cfg)
    opts = PhaserOptions()
    _, tables = variant_tables(cfg, donor.vcf_text, opts)
    return [join_work_of(rs, kept(rs, mapqs[b], paired[b],
                                  bool(opts.remove_dups)), vt, baseq)
            for b, rs in enumerate(sets) for vt in tables.values()]


def run(cfg: dict, donor, sets: list, out: str,
        p_dtype=np.float64) -> None:
    mapqs, paired, baseq = bam_flags(cfg)
    n_bam = len(sets)
    opts = PhaserOptions()
    vcf_text = donor.vcf_text
    sample_column, tables = variant_tables(cfg, vcf_text, opts)
    contigs = list(tables.keys())
    bam_names = [b["name"] for b in cfg["bams"]]
    # #2 and the alignment-score cutoff of each BAM over its rows
    per_contig = {c: [] for c in contigs}
    cutoffs = {}
    for b, rs in enumerate(sets):
        keep = kept(rs, mapqs[b], paired[b], bool(opts.remove_dups))
        chunk = chunk_of(rs, keep)
        scores = []
        for c in contigs:
            hits = assign(rs, keep, tables[c], baseq)
            per_contig[c].append((b, chunk, hits))
            scores.append(chunk.as_score[hits.read_idx])
        s = np.concatenate(scores)
        cutoffs[b] = (float(np.percentile(s, opts.as_q_cutoff * 100))
                      if opts.as_q_cutoff > 0 and len(s) else None)
    offsets, seq = {c: [] for c in contigs}, 0
    for b in range(n_bam):
        for c in contigs:
            for bb, chunk, hits in per_contig[c]:
                if bb != b:
                    continue
                n = len(hits)
                if cutoffs[b] is not None and n:
                    n = int((chunk.as_score[hits.read_idx] >= cutoffs[b]).sum())
                offsets[c].append(seq)
                seq += n
    states = []
    for c in contigs:
        rows = build_contig_rows(tables[c], per_contig[c], cutoffs,
                                 offsets[c])
        states.append([build_variant_reads(rows, []), None])
    bm = bmm = 0
    for vr, _ in states:
        m, mm = noise_terms(vr)
        bm += m
        bmm += mm
    noise_e = float(bmm) / (float(bm + bmm) * 2)
    states = [(vr, build_connections(vr, noise_e, opts.cc_threshold,
                                     p_dtype=p_dtype)) for vr, _ in states]
    write_variant_connections(out, states)
    write_allelic_counts(out, states)
    final = []
    for vr, conn in states:
        for block in find_blocks(conn, vr.vt):
            vconn = {v: conn.adj[v] for v in block if v in conn.adj}
            ac = {(v, a): conn.allele_conn[(v, a)] for v in block
                  for a in (0, 1) if (v, a) in conn.allele_conn}
            for phased in phase_v3(block, vconn, ac, opts.max_block_size):
                final.append((vr, conn, phased))
    writer = BlockOutputWriter(out, opts, bam_names, bam_names, [], set())
    for vr, conn, phased in final:
        writer.process_block(vr, conn, phased)
    writer.write_singletons(states)
    writer.close()
    rsid_lookup = {vr.vt.unique_ids[i]: vr.vt.rsids_out[i]
                   for vr, _ in states for i in range(len(vr.vt))}
    write_phased_vcf(vcf_text, sample_column, out, "", writer.state, opts,
                     rsid_lookup=rsid_lookup)
