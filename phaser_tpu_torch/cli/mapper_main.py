"""Standalone read->variant mapper CLI, flag-compatible with the reference's
call_read_variant_map.py (reference phaser/call_read_variant_map.py:10-15):
SAM text on stdin, variant table file, TSV rows to --o.

Byte-identical output to the reference mapper on sorted input streams.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np

from ..engine.varmap import VariantTable
from ..io.sam import parse_sam
from ..mapper.host import ContigHits, assign_alleles, hits_to_tsv


def load_variant_table_file(path: str) -> List[VariantTable]:
    """Parse an 8-column mapping-table TSV into per-contig VariantTables,
    preserving contig appearance order."""
    tables: List[VariantTable] = []
    cur = None
    rows = {"pos": [], "uid": [], "rs": [], "all": [], "rl": [], "geno": [], "maf": []}

    def flush(chrom):
        if chrom is None:
            return
        vt = VariantTable(
            chrom=chrom, pos=np.asarray(rows["pos"], np.int64),
            unique_ids=list(rows["uid"]), rs_ids=list(rows["rs"]),
            all_alleles=list(rows["all"]),
            ref_len=np.asarray(rows["rl"], np.int32),
            geno_strings=list(rows["geno"]), maf_strs=list(rows["maf"]))
        vt.finalize()
        tables.append(vt)
        for v in rows.values():
            v.clear()

    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            c = line.split("\t")
            if c[0] != cur:
                flush(cur)
                cur = c[0]
            rows["pos"].append(int(c[1]))
            rows["uid"].append(c[2])
            rows["rs"].append(c[3])
            rows["all"].append(c[4].split(","))
            rows["rl"].append(int(c[5]))
            rows["geno"].append(c[6])
            rows["maf"].append(c[7])
    flush(cur)
    return tables


def run(variant_table: str, baseq: int, o: str, splice: int,
        isize_cutoff: float, sam_lines) -> int:
    bd, contigs = parse_sam(sam_lines)
    tables = load_variant_table_file(variant_table)
    by_chrom = {t.chrom: t for t in tables}

    # contig-mismatch check (read_variant_map.py:68-71): a read processed
    # while the variant stream rests on an unknown contig is a fatal error.
    unknown = [t.chrom for t in tables if t.chrom not in set(contigs)]
    if unknown and len(bd):
        err = _contig_mismatch_error(bd, contigs, tables)
        if err is not None:
            bad_chr, read_chr, n_ok_reads = err
            out = open(o, "w")
            out.write(_rows_for_reads(bd, by_chrom, baseq, splice,
                                      isize_cutoff, n_ok_reads))
            out.close()
            print("Error, VCF and BAM contigs do not match VCF = %s BAM = %s"
                  % (bad_chr, read_chr))
            return 1

    with open(o, "w") as out:
        out.write(_rows_for_reads(bd, by_chrom, baseq, splice, isize_cutoff,
                                  len(bd)))
    return 0


def _rows_for_reads(bd, by_chrom, baseq, splice, isize_cutoff, n_reads) -> str:
    """TSV rows for the first n_reads SAM lines, in stream order."""
    if n_reads == 0:
        return ""
    sub = bd.select(np.arange(n_reads))
    parts = []
    # contig chunks in stream order
    rid = sub.refid
    boundaries = np.flatnonzero(np.diff(rid) != 0) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [len(sub)]))
    for s, e in zip(starts, ends):
        chrom = sub.ref_names[rid[s]] if rid[s] >= 0 else None
        if chrom is None or chrom not in by_chrom:
            continue
        chunk = sub.select(np.arange(s, e))
        hits = assign_alleles(chunk, by_chrom[chrom], baseq=baseq,
                              splice=bool(splice), isize_cutoff=isize_cutoff)
        parts.append(hits_to_tsv(chunk, by_chrom[chrom], hits))
    return "".join(parts)


def _contig_mismatch_error(bd, contigs, tables):
    """Simulate the reference's variant-stream advancement at contig/position
    granularity to decide whether (and where) the mismatch error fires.

    Returns (vcf_chr, bam_chr, n_reads_processed_before_error) or None.
    """
    # flatten variant stream: (chrom, pos) in table order
    vchroms: List[str] = []
    vpos: List[int] = []
    for t in tables:
        vchroms.extend([t.chrom] * len(t))
        vpos.extend(int(p) for p in t.pos)
    nvar = len(vchroms)
    vi = 0
    cindex = {c: i for i, c in enumerate(contigs)}
    from ..mapper.host import expand_refpos
    _, _, ref_span = expand_refpos(bd)
    for r in range(len(bd)):
        read_chr = bd.ref_names[bd.refid[r]] if bd.refid[r] >= 0 else ""
        read_pos = int(bd.pos[r]) + 1
        if vi < nvar and vchroms[vi] != read_chr:
            if vchroms[vi] not in cindex:
                return (vchroms[vi], read_chr, r)
            if cindex[vchroms[vi]] < cindex.get(read_chr, -1):
                while vi < nvar and vchroms[vi] != read_chr:
                    vi += 1
        if vi < nvar and vchroms[vi] == read_chr:
            while vi < nvar and vchroms[vi] == read_chr and vpos[vi] < read_pos:
                vi += 1
            # segment additions consume variants up to last segment end + 1
            seg_end = read_pos + int(ref_span[r])
            while vi < nvar and vchroms[vi] == read_chr and vpos[vi] <= seg_end:
                vi += 1
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant_table", type=str, required=True)
    parser.add_argument("--baseq", type=int, default=10)
    parser.add_argument("--o", type=str, required=True)
    parser.add_argument("--splice", type=int, default=1)
    parser.add_argument("--isize_cutoff", type=float, default=0)
    args = parser.parse_args(argv)
    return run(args.variant_table, args.baseq, args.o, args.splice,
               args.isize_cutoff, sys.stdin)


if __name__ == "__main__":
    sys.exit(main())
