"""Compound-het annotation (phASER Annotate).

Parity implementation of reference phaser_annotate/phaser_annotate.py
(a Python-2-era tool) on our own IO stack: reads a phased VCF twice per
variant (GT genome-wide phase + phASER PG/PI read-backed blocks),
tabix-fetches CADD annotations, optionally looks up allele frequencies, and
classifies all within-gene het-variant pairs as cis/trans with a read-backed
concordance flag.

Deliberate divergences from the reference (documented):
  - `all_genes.remove("NA")` -> discard (the reference raises KeyError when no
    variant lacks a gene annotation)
  - the reference's get_variant_af references an undefined `afs` when the AF
    field is scalar (crash); we treat scalar AF as a one-element list
  - gene output order is canonical (first-seen), not set-iteration order
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..io import bgzf, tabix


def _annotation_to_dict(text: str) -> Dict[str, str]:
    out = {}
    for var in text.split(";"):
        if "=" in var:
            out[var.split("=")[0]] = var.split("=")[1]
    return out


def _get_interactions(variant_a, variant_b) -> List[list]:
    out = []
    if variant_a[3] == variant_b[3]:  # same block (gw: always 0)
        for index_a in range(len(variant_a[0])):
            for index_b in range(len(variant_a[0])):
                cfg = "cis" if index_a == index_b else "trans"
                out.append([int(variant_a[0][index_a]),
                            int(variant_b[0][index_b]), cfg])
    return [i for i in out if i[0] != 0 and i[1] != 0]


def run_annotate(geno_vcf: str, sample: str, o: str,
                 cadd_file: Optional[str] = None,
                 af_vcf: Optional[str] = None, af_field: str = "AF",
                 log=print) -> None:
    tabix_cadd = tabix.TabixFile(cadd_file) if cadd_file else None
    tabix_af = tabix.TabixFile(af_vcf) if af_vcf else None

    dict_gw_variant_info: Dict[str, list] = {}
    dict_pg_variant_info: Dict[str, list] = {}
    dict_gw_gene_variants: Dict[str, List[str]] = {}
    dict_pg_gene_variants: Dict[str, List[str]] = {}
    dict_uniqueid_rsid: Dict[str, str] = {}

    cadd_gw: List[tuple] = []
    cadd_pg: List[tuple] = []

    sample_column = 0
    for line in bgzf.read_text_auto(geno_vcf).decode().splitlines():
        columns = line.split("\t")
        if line[0:4] == "#CHR":
            if sample in columns:
                sample_column = columns.index(sample)
            else:
                raise ValueError("sample not found in VCF")
        elif line[0:1] != "#":
            chrom, pos, rsid, ref, alt = columns[0:5]
            unique_id = "_".join([chrom, pos, ref, alt])
            info_fields = _annotation_to_dict(columns[7])
            dict_uniqueid_rsid[unique_id] = rsid
            fmt = columns[8].split(":")
            sf = columns[sample_column].split(":")
            if len(fmt) != len(sf):
                log("Column info error %s" % unique_id)
                continue
            gt_index = fmt.index("GT")
            genotype = list(sf[gt_index])
            if "." not in genotype and genotype.count("0") != 2:
                gt_alleles = [c for c in genotype if c not in "/|"]
                if "|" in genotype or len(set(gt_alleles)) == 1:
                    cadd_gw.append((unique_id, info_fields, gt_alleles, 0))
            if "PG" in fmt:
                pg_index = fmt.index("PG")
                genotype = list(sf[pg_index])
                if "." not in genotype and genotype.count("0") != 2 and \
                        "/" not in genotype:
                    pi_index = fmt.index("PI")
                    block_index = float(sf[pi_index])
                    gt_alleles = [c for c in genotype if c != "|"]
                    if "|" in genotype or len(set(gt_alleles)) == 1:
                        cadd_pg.append((unique_id, info_fields, gt_alleles,
                                        block_index))

    def get_variant_cadd(item):
        unique_id, info_fields, gt_alleles, phaser_bi = item
        variant = unique_id.split("_")
        chrom, pos = variant[0], int(variant[1])
        alt_alleles = variant[3].split(",")
        output = {}
        gene_list = []
        records = tabix_cadd.fetch(chrom, pos - 1, pos) if tabix_cadd else []
        for record in records:
            if record == "":
                continue
            vf = record.rstrip().split("\t")
            if int(vf[1]) != pos:
                continue
            if vf[4] not in alt_alleles:
                continue
            a_index = alt_alleles.index(vf[4]) + 1
            phred = vf[len(vf) - 1]
            annotation = vf[10]
            gene_ensg = vf[92]
            gene_name = vf[95]
            var_alt = vf[4]
            gene_list.append(gene_ensg)
            allele_freq = None
            if af_vcf is None and af_field in info_fields:
                afs = list(map(float, info_fields[af_field].split(",")))
                if a_index - 1 < len(afs):
                    allele_freq = afs[a_index - 1]
            output[gene_ensg + ":" + str(a_index)] = [
                phred, annotation, gene_ensg, gene_name, chrom, pos,
                allele_freq, var_alt]
        return [unique_id, gt_alleles, output, gene_list, phaser_bi]

    log("2. Retrieving CADD info for all phased variants...")
    for item in cadd_gw:
        uid, gt_alleles, cadd_info, gene_list, bi = get_variant_cadd(item)
        dict_gw_variant_info[uid] = [gt_alleles, cadd_info, gene_list, bi]
        for gene in gene_list:
            dict_gw_gene_variants.setdefault(gene, []).append(uid)

    retrieved = set(dict_gw_variant_info.keys())
    for item in cadd_pg:
        uid = item[0]
        if uid in retrieved:
            # reference quirk (:144-153): the PG dict reuses the ENTIRE GW
            # entry (GW gt_alleles and block index 0), not the PG phase
            dict_pg_variant_info[uid] = dict_gw_variant_info[uid]
            for gene in dict_gw_variant_info[uid][2]:
                dict_pg_gene_variants.setdefault(gene, []).append(uid)
        else:
            uid2, gt_alleles, cadd_info, gene_list, bi = get_variant_cadd(item)
            dict_pg_variant_info[uid2] = [gt_alleles, cadd_info, gene_list, bi]
            for gene in gene_list:
                dict_pg_gene_variants.setdefault(gene, []).append(uid2)

    # allele frequencies from af_vcf
    dict_allele_af: Dict[str, object] = {}
    if tabix_af is not None:
        af_keys = set()
        for info in list(dict_gw_variant_info.values()) + \
                list(dict_pg_variant_info.values()):
            for allele_key in info[1]:
                rec = info[1][allele_key]
                af_keys.add("%s_%s_%s" % (rec[4], rec[5], rec[7]))
        for key in af_keys:
            chrom, pos, allele = key.rsplit("_", 2)
            pos = int(pos)
            af_out = 0
            for line in tabix_af.fetch(chrom, pos - 1, pos):
                cols = line.split("\t")
                if int(cols[1]) != pos:
                    continue
                alts = cols[4].split(",")
                info_d = _annotation_to_dict(cols[7])
                if af_field not in info_d:
                    continue
                afs = [float(x) for x in info_d[af_field].split(",")]
                if allele in alts:
                    ai = alts.index(allele)
                    if ai < len(afs):
                        af_out = afs[ai]
                break
            dict_allele_af[key] = af_out

    log("4. Identifying cases of compound heterozygosity...")
    all_genes = []
    for g in list(dict_gw_gene_variants) + list(dict_pg_gene_variants):
        if g not in all_genes:
            all_genes.append(g)
    if "NA" in all_genes:
        all_genes.remove("NA")

    def build_rows(xgene, variant_a, info_a, variant_b, info_b, interactions,
                   read_backed):
        rows = []
        for allele_a, allele_b, configuration in interactions:
            ka = xgene + ":" + str(allele_a)
            kb = xgene + ":" + str(allele_b)
            if ka not in info_a[1] or kb not in info_b[1]:
                continue
            ra, rb = info_a[1][ka], info_b[1][kb]
            out_allele_a, out_allele_b = allele_a, allele_b
            af_a = "."
            if tabix_af is not None:
                out_allele_a = ra[7]
                af_a = dict_allele_af["%s_%s_%s" % (ra[4], ra[5], ra[7])]
            elif ra[6] is not None:
                af_a = ra[6]
            af_b = "."
            if tabix_af is not None:
                out_allele_b = rb[7]
                af_b = dict_allele_af["%s_%s_%s" % (rb[4], rb[5], rb[7])]
            elif rb[6] is not None:
                af_b = rb[6]
            rows.append([xgene, ra[3], variant_a, dict_uniqueid_rsid[variant_a],
                         out_allele_a, af_a, ra[0], ra[1], variant_b,
                         dict_uniqueid_rsid[variant_b], out_allele_b, af_b,
                         rb[0], rb[1], configuration, read_backed])
        return rows

    out = open(o, "w")
    out.write("\t".join(["ensg", "name", "variant_a", "rsid_a", "allele_a",
                         "af_a", "cadd_phred_a", "cadd_effect_a", "variant_b",
                         "rsid_b", "allele_b", "af_b", "cadd_phred_b",
                         "cadd_effect_b", "configuration", "read_backed"]) + "\n")
    for xgene in all_genes:
        outputted = set()
        if xgene in dict_gw_gene_variants:
            for variant_a in dict_gw_gene_variants[xgene]:
                for variant_b in dict_gw_gene_variants[xgene]:
                    if variant_a == variant_b:
                        continue
                    gw_i = _get_interactions(dict_gw_variant_info[variant_a],
                                             dict_gw_variant_info[variant_b])
                    rb_i = []
                    if xgene in dict_pg_gene_variants and \
                            variant_a in dict_pg_gene_variants[xgene] and \
                            variant_b in dict_pg_gene_variants[xgene]:
                        rb_i = _get_interactions(
                            dict_pg_variant_info[variant_a],
                            dict_pg_variant_info[variant_b])
                    read_backed = "0"
                    if len(gw_i) == len(rb_i) and gw_i == rb_i:
                        read_backed = "1"
                    if len(gw_i) == len(rb_i) and gw_i != rb_i:
                        read_backed = "-1"
                    elif len(rb_i) == 0:
                        read_backed = "0"
                    for row in build_rows(xgene, variant_a,
                                          dict_gw_variant_info[variant_a],
                                          variant_b,
                                          dict_gw_variant_info[variant_b],
                                          gw_i, read_backed):
                        out.write("\t".join(map(str, row)) + "\n")
                    if read_backed == "-1":
                        for row in build_rows(xgene, variant_a,
                                              dict_gw_variant_info[variant_a],
                                              variant_b,
                                              dict_gw_variant_info[variant_b],
                                              rb_i, "1"):
                            out.write("\t".join(map(str, row)) + "\n")
                    outputted.add(variant_a + "_" + variant_b)
        if xgene in dict_pg_gene_variants:
            for variant_a in dict_pg_gene_variants[xgene]:
                for variant_b in dict_pg_gene_variants[xgene]:
                    if variant_a == variant_b:
                        continue
                    if variant_a + "_" + variant_b in outputted:
                        continue
                    pg_i = _get_interactions(dict_pg_variant_info[variant_a],
                                             dict_pg_variant_info[variant_b])
                    for row in build_rows(xgene, variant_a,
                                          dict_pg_variant_info[variant_a],
                                          variant_b,
                                          dict_pg_variant_info[variant_b],
                                          pg_i, "1"):
                        out.write("\t".join(map(str, row)) + "\n")
                    outputted.add(variant_a + "_" + variant_b)
    out.close()
