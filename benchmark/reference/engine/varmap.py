"""Variant mapping table — parity port of generate_mapping_table and
generate_variant_dict (reference phaser/phaser.py:1355-1413, 1418-1462),
re-shaped into struct-of-arrays for the device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

CHAR_TO_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def _annotation_to_dict(text: str, sep: str = ";") -> Dict[str, str]:
    out: Dict[str, str] = {}
    for var in text.split(sep):
        if "=" in var:
            out[var.split("=")[0]] = var.split("=")[1]
    return out


@dataclass
class VariantTable:
    """Per-contig het-variant table, in VCF appearance order (mapping-table
    row order == variant-buffer order in the reference mapper)."""

    chrom: str                         # with chr_prefix applied
    pos: np.ndarray                    # int64, 1-based
    unique_ids: List[str]
    rs_ids: List[str]
    all_alleles: List[List[str]]       # REF + ALTs from the VCF
    ref_len: np.ndarray                # int32
    geno_strings: List[str]
    maf_strs: List[str]                # str(maf) incl. "None"
    het_count: int = 0
    indels_excluded: int = 0

    # derived (generate_variant_dict semantics)
    ind_alleles: List[List[str]] = field(default_factory=list)
    phases: List[List[str]] = field(default_factory=list)   # allele strings or ["-","-"]
    is_phased: np.ndarray = None       # bool
    mafs: List = field(default_factory=list)                # float or int 0
    rsids_out: List[str] = field(default_factory=list)      # rsid fallback to unique id

    # SNP fast-path codes
    is_simple: np.ndarray = None       # bool: every VCF allele is length 1
    ind_codes: np.ndarray = None       # (n, 2) uint8 nibble codes (15 pad)
    n_ind: np.ndarray = None           # int8 number of ind alleles

    def __len__(self) -> int:
        return len(self.pos)

    def finalize(self) -> None:
        """Compute generate_variant_dict-derived fields for every variant."""
        n = len(self.pos)
        self.ind_alleles = []
        self.phases = []
        self.mafs = []
        self.rsids_out = []
        self.is_phased = np.zeros(n, bool)
        self.is_simple = np.zeros(n, bool)
        self.ind_codes = np.full((n, 2), 15, np.uint8)
        self.n_ind = np.zeros(n, np.int8)
        for i in range(n):
            alleles = self.all_alleles[i]
            genotype = list(self.geno_strings[i])
            is_phased = False
            if "|" in genotype:
                genotype.remove("|")
                is_phased = True
            if "/" in genotype:
                genotype.remove("/")
            ind = [alleles[k] for k in range(len(alleles)) if str(k) in genotype]
            if is_phased:
                phase = [alleles[int(ix)] for ix in genotype]
            else:
                phase = ["-", "-"]
            try:
                maf = float(self.maf_strs[i])
            except (TypeError, ValueError):
                maf = 0
            rsid = self.rs_ids[i]
            if rsid == "." or rsid == "":
                rsid = self.unique_ids[i]
            self.ind_alleles.append(ind)
            self.phases.append(phase)
            self.is_phased[i] = is_phased
            self.mafs.append(maf)
            self.rsids_out.append(rsid)
            simple = all(len(a) == 1 for a in alleles)
            self.is_simple[i] = simple
            self.n_ind[i] = len(ind)
            if simple:
                for k, a in enumerate(ind[:2]):
                    self.ind_codes[i, k] = CHAR_TO_NIBBLE.get(a, 15)

    def mapping_table_text(self) -> str:
        """The 8-column TSV consumed by the reference mapper (for interop)."""
        rows = []
        for i in range(len(self.pos)):
            rows.append("\t".join([
                self.chrom, str(int(self.pos[i])), self.unique_ids[i],
                self.rs_ids[i], ",".join(self.all_alleles[i]),
                str(int(self.ref_len[i])), self.geno_strings[i],
                self.maf_strs[i]]))
        return "\n".join(rows) + ("\n" if rows else "")


def build_variant_table(chrom: str, vcf_records: List[list], *,
                        id_separator: str = "_", chr_prefix: str = "",
                        include_indels: bool = False,
                        gw_phase_method: int = 0,
                        gw_af_field: str = "AF") -> VariantTable:
    """Mirror of generate_mapping_table (reference phaser/phaser.py:1355-1413).

    vcf_records entries are `vcf_columns[0:9] + [geno_string, xgeno]` rows from
    phaser_tpu.io.vcf.parse_het_sites.
    """
    chrom = chr_prefix + chrom
    pos_l, uid_l, rs_l, all_l, reflen_l, geno_l, maf_l = [], [], [], [], [], [], []
    het_count = 0
    indels_excluded = 0
    for cols in vcf_records:
        pos = cols[1]
        rs_id = cols[2]
        alt_alleles = cols[4].split(",")
        all_alleles = [cols[3]] + alt_alleles
        unique_id = chrom + id_separator + pos + id_separator + \
            id_separator.join(all_alleles)
        geno_string = cols[9]
        genotype = cols[10]
        maf = None
        if gw_phase_method == 1:
            info_fields = _annotation_to_dict(cols[7])
            if gw_af_field in info_fields:
                afs = list(map(float, info_fields[gw_af_field].split(",")))
                if len(afs) == len(alt_alleles):
                    use_afs = []
                    for allele in list(genotype):
                        if allele != "." and int(allele) != 0:
                            use_afs.append(int(allele) - 1)
                    if use_afs:
                        maf = min(min(afs[x], 1 - afs[x]) for x in use_afs)
        max_allele_size = max(len(x) for x in all_alleles)
        if max_allele_size == 1 or include_indels:
            pos_l.append(int(pos))
            uid_l.append(unique_id)
            rs_l.append(rs_id)
            all_l.append(all_alleles)
            reflen_l.append(len(cols[3]))
            geno_l.append(geno_string)
            maf_l.append(str(maf))
            het_count += 1
        else:
            indels_excluded += 1

    vt = VariantTable(
        chrom=chrom, pos=np.asarray(pos_l, np.int64), unique_ids=uid_l,
        rs_ids=rs_l, all_alleles=all_l,
        ref_len=np.asarray(reflen_l, np.int32), geno_strings=geno_l,
        maf_strs=maf_l, het_count=het_count, indels_excluded=indels_excluded)
    vt.finalize()
    return vt
