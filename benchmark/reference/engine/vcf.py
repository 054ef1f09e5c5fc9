"""VCF reading with the reference's het-site filter: a frozen copy of
phaser_tpu_torch/io/vcf.py whose `path` arguments take the VCF's text.

Reproduces the shell pipeline the reference builds at
reference phaser/phaser.py:205-228:

    (tabix -h VCF chr: | gunzip -c VCF)
      | cut -f 1-9,<sample_col+1>
      | grep -v '0|0\\|1|1'

Notably `grep -v` drops any line whose *entire cut text* contains the
substring "0|0" or "1|1" (so an INFO field containing "0|0" also drops the
line).  The subsequent GT parsing mirrors process_vcf (reference
phaser/phaser.py:396-434).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np



def sample_column_map(path: str, start_col: int = 9, line_key: str = "#CHR") -> Dict[str, int]:
    """Sample name -> 0-based column index, from the #CHROM header line.

    Mirrors reference phaser/phaser.py:2326-2342.
    """
    out: Dict[str, int] = {}
    for line in iter_vcf_lines(path):
        if line_key in line:
            cols = line.rstrip().rstrip("\n").split("\t")
            for i in range(start_col, len(cols)):
                out[cols[i]] = i
            break
    return out


def iter_vcf_lines(path: str, chrom: Optional[str] = None) -> Iterator[str]:
    """Yield text lines of a (possibly bgzipped) VCF.

    With `chrom`, emulates `tabix -h VCF chrom:` (header + that contig
    only). A comma-separated list selects several contigs (multi-contig
    shards of the multi-host engine).
    """
    data = path
    want = set(chrom.split(",")) if chrom is not None else None
    for line in data.splitlines():
        if want is not None and not line.startswith("#"):
            if line.split("\t", 1)[0] not in want:
                continue
        yield line


def cut_columns(line: str, sample_col: int) -> str:
    """`cut -f 1-9,<sample_col+1>` on a VCF line (sample_col is 0-based).

    cut emits fields in ascending field order and ignores out-of-range fields,
    which matters for header lines with fewer tab fields.
    """
    cols = line.split("\t")
    keep = list(range(0, min(9, len(cols))))
    if sample_col >= 9 and sample_col < len(cols):
        keep.append(sample_col)
    elif sample_col < 9:
        pass  # already included in 1-9
    return "\t".join(cols[i] for i in keep)


def het_filtered_lines(path: str, sample_col: int, chrom: Optional[str] = None,
                       blacklist=None) -> List[str]:
    """Apply the full reference filter pipeline; returns surviving cut lines
    (headers included, as `bedtools intersect -header` keeps them)."""
    out: List[str] = []
    for line in iter_vcf_lines(path, chrom):
        cut = cut_columns(line, sample_col)
        if "0|0" in cut or "1|1" in cut:
            continue
        if not cut.startswith("#") and blacklist is not None:
            cols = cut.split("\t")
            if len(cols) > 3:
                pos = int(cols[1])
                ref = cols[3]
                hit = blacklist.overlaps(cols[0], np.array([pos - 1]),
                                         np.array([pos - 1 + len(ref)]))
                if hit[0]:
                    continue
        out.append(cut)
    return out


@dataclass
class HetSites:
    """Per-chromosome het records, in VCF appearance order.

    records[chrom] entries mirror the reference's chromosome_pool rows:
    vcf_columns[0:9] + [geno_string, xgeno] (phaser.py:427).
    """
    pool: "dict[str, list]" = field(default_factory=dict)
    unphased_count: int = 0
    filter_count: int = 0


def parse_het_sites(filtered_lines: List[str], chrom_of_interest: str,
                    contig_ban: List[str], pass_only: bool) -> HetSites:
    """Mirror of process_vcf's line loop (reference phaser/phaser.py:396-434).

    chrom_of_interest may be a comma-separated contig list (multi-contig
    shards of the multi-host engine)."""
    hs = HetSites()
    want = set(chrom_of_interest.split(",")) if chrom_of_interest else None
    for line in filtered_lines:
        if line.startswith("#"):
            continue
        vcf_columns = line.rstrip("\n").split("\t")
        chrom = vcf_columns[0]
        for item in contig_ban:
            if item in chrom:
                raise ValueError(
                    "Character '%s' must not be present in contig name." % item)
        filt = vcf_columns[6]
        if want is not None and chrom not in want:
            continue
        if chrom not in hs.pool:
            hs.pool[chrom] = []
        fields = vcf_columns[8].split(":")
        if "GT" not in fields:
            continue
        gt_index = fields.index("GT")
        geno_string = vcf_columns[9].split(":")[gt_index]
        xgeno = list(geno_string)
        unphased = False
        if "." in xgeno:
            continue
        if "|" in xgeno:
            xgeno.remove("|")
        if "/" in xgeno:
            xgeno.remove("/")
            unphased = True
        if len(set(xgeno)) > 1:
            filters = filt.split(";")
            if (not pass_only) or "PASS" in filters:
                hs.pool[chrom].append(vcf_columns[0:9] + [geno_string, xgeno])
                if unphased:
                    hs.unphased_count += 1
            else:
                hs.filter_count += 1
    return hs
