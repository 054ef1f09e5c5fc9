"""Phased VCF writer: a frozen copy of phaser_tpu_torch/engine/vcf_writer.py
(the reproduction of phASER's write_vcf, phaser.py:1661-1855) that reads
the input VCF's text and writes the output uncompressed to
`<out_prefix>.vcf`; the compression and the index are left out.
"""

from __future__ import annotations

from typing import List, Tuple

from .vcf import cut_columns, iter_vcf_lines
from .fmt import list_to_string
from .output_stage import OutputState, PhaserOptions

_TAGS = ("PG", "PB", "PI", "PW", "PC", "PM")

_FORMAT_HEADERS = [
    ("PG", "##FORMAT=<ID=PG,Number=1,Type=String,Description=\"phASER Local Genotype\">"),
    ("PB", "##FORMAT=<ID=PB,Number=1,Type=String,Description=\"phASER Local Block\">"),
    ("PI", "##FORMAT=<ID=PI,Number=1,Type=String,Description=\"phASER Local Block Index (unique for each block)\">"),
    ("PM", "##FORMAT=<ID=PM,Number=1,Type=String,Description=\"phASER Local Block Maximum Variant MAF\">"),
    ("PW", "##FORMAT=<ID=PW,Number=1,Type=String,Description=\"phASER Genome Wide Genotype\">"),
    ("PC", "##FORMAT=<ID=PC,Number=1,Type=String,Description=\"phASER Genome Wide Confidence\">"),
]


def write_phased_vcf(vcf_path: str, sample_column: int, out_prefix: str,
                     chromosome_of_interest: str, state: OutputState,
                     opts: PhaserOptions,
                     rsid_lookup=None) -> Tuple[int, int]:
    """Returns (unphased_phased, phase_corrections); `vcf_path` is the
    input VCF's text."""
    set_phased_vars = set(state.haplotype_lookup.keys())
    _fmt_cache = {}
    _block_cache = {}
    phase_corrections = 0
    unphased_phased = 0
    out_lines: List[str] = []
    format_text = ""
    chrom_set = set(chromosome_of_interest.split(",")) \
        if chromosome_of_interest != "" else None

    def _emit_header(line: str) -> None:
        out_lines.append(line)

    chrom_arg = chromosome_of_interest if chromosome_of_interest != "" else None
    for raw_line in iter_vcf_lines(vcf_path, chrom_arg):
        line = cut_columns(raw_line, sample_column)
        vcf_columns = line.split("\t")
        if "##FORMAT" in line:
            format_text += line + "\n"
            _emit_header(line)
        elif line.startswith("#CHROM"):
            for tag, hdr in _FORMAT_HEADERS:
                if ("##FORMAT=<ID=%s," % tag) not in format_text:
                    _emit_header(hdr)
            if opts.gw_phase_vcf == 2:
                if "##FORMAT=<ID=PS," not in format_text:
                    _emit_header("##FORMAT=<ID=PS,Number=1,Type=String,"
                                 "Description=\"Phase Set\">")
            _emit_header("\t".join(vcf_columns[0:9] + [vcf_columns[9]]))
        elif line[0:1] == "#":
            _emit_header(line)
        else:
            chrom = vcf_columns[0]
            pos = int(vcf_columns[1])
            if chrom_set is not None and chrom not in chrom_set:
                continue
            if "GT" in vcf_columns[8]:
                # format strings repeat across lines: parse each DISTINCT
                # one once (gt position, tag indices, extended header) —
                # the per-line .split/.index chain was ~1/3 of #7 time
                cache = _fmt_cache.get(vcf_columns[8])
                if cache is None:
                    fields0 = vcf_columns[8].split(":")
                    gt_index = fields0.index("GT")
                    vff = list(fields0)
                    for tag in ["PG", "PB", "PI", "PW", "PC", "PM"]:
                        if tag not in vff:
                            vff.append(tag)
                    cache = (gt_index, len(fields0), ":".join(vff), vff,
                             {t: vff.index(t) for t in _TAGS})
                    _fmt_cache[vcf_columns[8]] = cache
                gt_index, n_fields, fmt_out, vcf_format_fields, tag_idx = \
                    cache

                alt_alleles = vcf_columns[4].split(",")
                all_alleles = [vcf_columns[3]] + alt_alleles

                for i in range(9, len(vcf_columns)):
                    sample_fields_n = len(vcf_columns[i].split(":"))
                    if sample_fields_n != n_fields:
                        vcf_columns[i] += ":" * (n_fields - sample_fields_n)

                vcf_columns[8] = fmt_out

                unique_id = (chrom + opts.id_separator + str(pos) +
                             opts.id_separator +
                             opts.id_separator.join(all_alleles))

                if unique_id in set_phased_vars:
                    alleles_out = []
                    gw_phase_out = ["", ""]
                    variants_lu, hap_pair, block_index = \
                        state.haplotype_lookup[unique_id]
                    ind_alleles = state.ind_alleles[unique_id]
                    gw_list = state.gw_phase[unique_id]
                    for allele in hap_pair.split("|"):
                        allele_base = ind_alleles[int(allele)]
                        vcf_allele_index = all_alleles.index(allele_base)
                        gw_phase = gw_list[int(allele)]
                        if isinstance(gw_phase, int):
                            gw_phase_out[gw_phase] = str(vcf_allele_index)
                        alleles_out.append(str(vcf_allele_index))

                    # every variant of a block shares the same variants_lu
                    # LIST OBJECT (output_stage stores one list per block):
                    # format the block-level strings once per block
                    blk = _block_cache.get(id(variants_lu))
                    if blk is None:
                        vl_str = list_to_string(variants_lu)
                        blk = (list_to_string(
                                   [rsid_lookup[v].replace(":", "_")
                                    for v in variants_lu]),
                               str(state.gw_stat_lookup[vl_str]),
                               state.gw_stat_lookup[vl_str],
                               str(state.max_maf_lookup[vl_str]))
                        _block_cache[id(variants_lu)] = blk
                    pb_str, pc_str, gw_stat, pm_str = blk

                    if "-" not in gw_phase_out:
                        xfields = vcf_columns[9].split(":")
                        new_phase = "|".join(gw_phase_out)
                        if gw_stat >= opts.gw_phase_vcf_min_confidence:
                            if "|" in xfields[gt_index] and \
                                    xfields[gt_index] != new_phase:
                                phase_corrections += 1
                            if "/" in xfields[gt_index] and \
                                    xfields[gt_index] != "./." and \
                                    xfields[gt_index] != new_phase:
                                unphased_phased += 1
                            if opts.gw_phase_vcf in (1, 2):
                                xfields[gt_index] = new_phase
                                vcf_columns[9] = ":".join(xfields)
                        if opts.gw_phase_vcf == 2 and \
                                gw_stat < opts.gw_phase_vcf_min_confidence:
                            xfields[gt_index] = "|".join(alleles_out)
                            vcf_columns[9] = ":".join(xfields)

                    sample_fields = vcf_columns[9].split(":")
                    sample_fields += [""] * (len(vcf_format_fields) - len(sample_fields))
                    sample_fields[tag_idx["PG"]] = "|".join(alleles_out)
                    sample_fields[tag_idx["PB"]] = pb_str
                    sample_fields[tag_idx["PI"]] = str(block_index)
                    sample_fields[tag_idx["PM"]] = pm_str
                    sample_fields[tag_idx["PW"]] = "|".join(gw_phase_out)
                    sample_fields[tag_idx["PC"]] = pc_str

                    if opts.gw_phase_vcf == 2 and \
                            gw_stat < opts.gw_phase_vcf_min_confidence:
                        if "PS" not in vcf_format_fields:
                            # copy: vcf_format_fields is the cached list
                            vcf_format_fields = vcf_format_fields + ["PS"]
                            vcf_columns[8] += ":PS"
                            sample_fields.append("")
                        sample_fields[vcf_format_fields.index("PS")] = str(block_index)

                    vcf_columns[9] = ":".join(sample_fields)
                else:
                    genotype = list(vcf_columns[9].split(":")[gt_index])
                    if "|" in genotype:
                        genotype.remove("|")
                    if "/" in genotype:
                        genotype.remove("/")
                    sample_fields = vcf_columns[9].split(":")
                    sample_fields += [""] * (len(vcf_format_fields) - len(sample_fields))
                    sample_fields[tag_idx["PG"]] = \
                        "/".join(sorted(genotype))
                    sample_fields[tag_idx["PB"]] = "."
                    sample_fields[tag_idx["PI"]] = "."
                    sample_fields[tag_idx["PM"]] = "."
                    sample_fields[tag_idx["PW"]] = \
                        vcf_columns[9].split(":")[gt_index]
                    sample_fields[tag_idx["PC"]] = "."
                    vcf_columns[9] = ":".join(sample_fields)

            out_lines.append("\t".join(vcf_columns[0:9] + [vcf_columns[9]]))

    with open(out_prefix + ".vcf", "w") as fh:
        fh.write("\n".join(out_lines) + "\n")
    return unphased_phased, phase_corrections
