"""Output assembly: haplotypes / haplotypic counts / allele configs /
network / allelic counts / variant connections.

Faithful reproduction of the reference's #6 output loop and singleton
sections (reference phaser/phaser.py:832-1243), with canonical
deterministic orders where the reference depends on Python set iteration
(documented inline; values are unchanged, only row/element order is pinned).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .fmt import list_to_string, pystr, str_join
from .connections import ContigConnections
from .hits import VariantReads


def _nanf() -> float:
    return float("nan")


@dataclass
class PhaserOptions:
    id_separator: str = "_"
    unique_ids: int = 0
    gw_phase_method: int = 0
    output_read_ids: int = 0
    output_network: str = ""
    unphased_vars: int = 1
    max_block_size: int = 15
    cc_threshold: float = 0.01
    as_q_cutoff: float = 0.05
    pass_only: int = 1
    include_indels: int = 0
    remove_dups: int = 1
    write_vcf: int = 1
    gw_phase_vcf: int = 0
    gw_phase_vcf_min_confidence: float = 0.90
    gw_af_field: str = "AF"
    chr_prefix: str = ""
    show_warning: int = 0


@dataclass
class OutputState:
    """Everything write_vcf needs (haplotype_lookup & co.,
    reference phaser/phaser.py:849-858)."""

    haplotype_lookup: Dict[str, Tuple[List[str], str, int]] = field(default_factory=dict)
    gw_stat_lookup: Dict[str, object] = field(default_factory=dict)
    max_maf_lookup: Dict[str, object] = field(default_factory=dict)
    gw_phase: Dict[str, list] = field(default_factory=dict)   # uid -> [v0, v1]
    all_variant_ids: List[str] = field(default_factory=list)
    ind_alleles: Dict[str, List[str]] = field(default_factory=dict)
    block_count: int = 0


def _first_seen_unique(arr: np.ndarray) -> np.ndarray:
    """Unique values in first-occurrence order (canonical stand-in for the
    reference's list(set(...)) which is hash-order dependent)."""
    if len(arr) == 0:
        return arr
    uniq, first = np.unique(arr, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


class _KeyedOut:
    """File shim prefixing every written line with the current block key —
    block-section rows of a DELEGATED block go to `.blocks.*.part` files
    and the cross-shard merge interleaves them back into global block
    order (dist.block_exchange)."""

    __slots__ = ("fh", "owner")

    def __init__(self, fh, owner: "BlockOutputWriter"):
        self.fh = fh
        self.owner = owner

    def write(self, text: str) -> None:
        key = self.owner.block_key
        for ln in text.splitlines(True):
            self.fh.write("%d\t%s" % (key, ln))

    def close(self) -> None:
        self.fh.close()


class BlockOutputWriter:
    def __init__(self, out_prefix: str, opts: PhaserOptions,
                 bam_list: List[str], bam_names: List[str],
                 haplo_count_bam_exclude: Sequence[int],
                 set_haplo_blacklist: Set[str],
                 singleton_files: bool = False,
                 block_files: bool = False):
        """singleton_files: divert singleton rows into keyed `.part` files
        ("<first_seen_key>\\t<row>") instead of appending to the main
        outputs. Used by the multi-shard engine (dist.engine_multihost):
        singleton sections are sorted GLOBALLY by first_seen in the
        reference's output (phaser.py:1179-1239), so per-shard rows must
        carry their sort key for the cross-shard merge."""
        self.opts = opts
        self.bam_list = bam_list
        self.bam_names = bam_names
        self.excl = set(haplo_count_bam_exclude)
        self.blacklist = set_haplo_blacklist
        self.state = OutputState()
        self.singleton_files = singleton_files
        self.f_hap_sing = self.f_ase_sing = None
        self.f_ase = open(out_prefix + ".haplotypic_counts.txt", "w",
                          buffering=1 << 20)
        ase_columns = ["contig", "start", "stop", "variants", "variantCount",
                       "variantsBlacklisted", "variantCountBlacklisted",
                       "haplotypeA", "haplotypeB", "aCount", "bCount",
                       "totalCount", "blockGWPhase", "gwStat", "max_haplo_maf",
                       "bam", "aReads", "bReads"]
        if opts.output_read_ids == 1:
            ase_columns += ["read_ids_a", "read_ids_b"]
        self.f_ase.write("\t".join(ase_columns) + "\n")
        self.f_hap = open(out_prefix + ".haplotypes.txt", "w",
                          buffering=1 << 20)
        self.f_hap.write("\t".join(
            ["contig", "start", "stop", "length", "variants", "variant_ids",
             "variant_alleles", "reads_hap_a", "reads_hap_b", "reads_total",
             "edges_supporting", "edges_total", "annotated_phase",
             "phase_concordant", "gw_phase", "gw_confidence"]) + "\n")
        self.f_cfg = open(out_prefix + ".allele_config.txt", "w",
                          buffering=1 << 20)
        self.f_cfg.write("\t".join(
            ["variant_a", "rsid_a", "variant_b", "rsid_b", "configuration"]) + "\n")
        if singleton_files:
            self.f_hap_sing = open(
                out_prefix + ".singletons.haplotypes.part", "w")
            self.f_ase_sing = open(
                out_prefix + ".singletons.haplotypic_counts.part", "w")
        self.block_key = 0
        self.block_files = block_files
        self._mains = []
        if block_files:
            # block-section rows route to keyed part files (the main files
            # above keep just their headers for the merge); process_block
            # itself stays unchanged. Requires singleton_files (sharded
            # runs always split singletons).
            assert singleton_files, "block_files requires singleton_files"
            self._mains = [self.f_hap, self.f_ase, self.f_cfg]
            self.f_hap = _KeyedOut(open(
                out_prefix + ".blocks.haplotypes.part", "w",
                buffering=1 << 20), self)
            self.f_ase = _KeyedOut(open(
                out_prefix + ".blocks.haplotypic_counts.part", "w",
                buffering=1 << 20), self)
            self.f_cfg = _KeyedOut(open(
                out_prefix + ".blocks.allele_config.part", "w",
                buffering=1 << 20), self)
        self.out_prefix = out_prefix

    def _emit_single_hap(self, key: int, line: str) -> None:
        if self.singleton_files:
            self.f_hap_sing.write("%d\t%s" % (key, line))
        else:
            self.f_hap.write(line)

    def _emit_single_ase(self, key: int, line: str) -> None:
        if self.singleton_files:
            self.f_ase_sing.write("%d\t%s" % (key, line))
        else:
            self.f_ase.write(line)

    # ------------------------------------------------------------------
    def process_block(self, vr: VariantReads, conn: ContigConnections,
                      block: List[Tuple[int, str]]) -> None:
        """One phased block: [(table_idx, allele_char)...] in variant order."""
        opts = self.opts
        vt = vr.vt
        st = self.state
        st.block_count += 1
        block_index = st.block_count

        v_idx = [v for v, _ in block]
        variants = [vt.unique_ids[v] for v in v_idx]
        st.all_variant_ids += variants
        haplotype_a = "".join(a for _, a in block)
        haplotype_b = "".join(str(int(not int(a))) for a in haplotype_a)

        # supporting / total edges (directed halves -> /2 float, :876-895):
        # set-intersection form of the reference's O(b^2) membership loop —
        # counts identical pairs ((w,b) in conns with (w,b)!=(v,a);
        # (w,0)/(w,1) in conns for every block w except w==v)
        ac = conn.allele_conn
        supporting = 0
        total = 0
        balleles = [(v, int(a)) for v, a in block]
        ball_set = set(balleles)
        both = set()
        for (w, _) in balleles:
            both.add((w, 0))
            both.add((w, 1))
        for (v, a) in balleles:
            conns = ac.get((v, a))
            if not conns:
                continue
            supporting += len(conns & ball_set) - (1 if (v, a) in conns
                                                   else 0)
            t = len(conns & both)
            if (v, 0) in conns:
                t -= 1
            if (v, 1) in conns:
                t -= 1
            total += t
        supporting = supporting / 2
        total = total / 2

        if opts.unique_ids == 0:
            rsids = [vt.rsids_out[v] for v in v_idx]
        else:
            rsids = variants
        chrom = vt.chrom
        positions = [int(vt.pos[v]) for v in v_idx]

        for i, vid in enumerate(variants):
            st.haplotype_lookup[vid] = (variants,
                                        haplotype_a[i] + "|" + haplotype_b[i],
                                        block_index)
            st.ind_alleles[vid] = vt.ind_alleles[v_idx[i]]

        alleles = [[], []]
        phases = [[], []]
        hap_counts = [0, 0]
        hap_read_sets = [None, None]
        ind_list = [vt.ind_alleles[v] for v in v_idx]
        for hap_index in range(2):
            hap_x = [haplotype_a, haplotype_b][hap_index]
            sets = []
            for i, v in enumerate(v_idx):
                ind = ind_list[i]
                allele = ind[int(hap_x[i])]
                alleles[hap_index].append(allele)
                phase = vt.phases[v]
                try:
                    phases[hap_index].append(phase.index(allele))
                except ValueError:
                    phases[hap_index].append(_nanf())
                allele_index = ind.index(allele)
                sets.append(vr.read_set(v, allele_index))
            uids = np.unique(np.concatenate(sets)) if sets else np.zeros(0, np.int64)
            hap_read_sets[hap_index] = uids
            hap_counts[hap_index] = len(uids)

        use_phases = [x for x in phases[0] if str(x) != "nan"]
        phase_concordant = 1 if len(set(use_phases)) <= 1 else 0
        phase_string = ["".join(str(x).replace("nan", "-") for x in phases[0]),
                        "".join(str(x).replace("nan", "-") for x in phases[1])]

        # ---- genome-wide phasing (:945-1029)
        nan_strip = [int(x) for x in phases[0] if x >= 0]
        corrected_phases = [phases[0], phases[1]]
        cor_phase_stat = 0.5
        haplotype_mafs = [vt.mafs[v] for v in v_idx]

        if len(nan_strip) > 0:
            # phase_set with reference nan-identity semantics: each nan entry
            # is a distinct object
            n_ints = len(set(x for x in phases[0] if isinstance(x, int)))
            n_nans = sum(1 for x in phases[0] if not isinstance(x, int))
            if n_ints + n_nans == 1:
                corrected_phases = [phases[0], phases[1]]
                cor_phase_stat = 1
            elif opts.gw_phase_method == 0:
                cor_phase_stat = np.mean(nan_strip)
                if cor_phase_stat < 0.5:
                    corrected_phases = [[0] * len(variants), [1] * len(variants)]
                elif cor_phase_stat > 0.5:
                    corrected_phases = [[1] * len(variants), [0] * len(variants)]
                cor_phase_stat = max([cor_phase_stat, 1 - cor_phase_stat])
            elif opts.gw_phase_method == 1:
                phase_support = [0, 0]
                for phase, maf in zip(phases[0], haplotype_mafs):
                    if phase == 0:
                        phase_support[0] += maf
                    elif phase == 1:
                        phase_support[1] += maf
                if sum(phase_support) > 0:
                    cor_phase_stat = max(phase_support) / sum(phase_support)
                    if phase_support[0] > phase_support[1]:
                        corrected_phases = [[0] * len(variants), [1] * len(variants)]
                    elif phase_support[1] > phase_support[0]:
                        corrected_phases = [[1] * len(variants), [0] * len(variants)]
                else:
                    cor_phase_stat = np.mean(nan_strip)
                    if cor_phase_stat < 0.5:
                        corrected_phases = [[0] * len(variants), [1] * len(variants)]
                    elif cor_phase_stat > 0.5:
                        corrected_phases = [[1] * len(variants), [0] * len(variants)]
                    cor_phase_stat = max([cor_phase_stat, 1 - cor_phase_stat])

        st.gw_stat_lookup[list_to_string(variants)] = cor_phase_stat
        st.max_maf_lookup[list_to_string(variants)] = max(haplotype_mafs)

        for i, v in enumerate(v_idx):
            vid = variants[i]
            allele_index = vt.ind_alleles[v].index(alleles[0][i])
            gw = st.gw_phase.setdefault(vid, [None, None])
            gw[allele_index] = corrected_phases[0][i]
            gw[1 - allele_index] = corrected_phases[1][i]

        corrected_phase_string = [
            "".join(str(x).replace("nan", "-") for x in corrected_phases[0]),
            "".join(str(x).replace("nan", "-") for x in corrected_phases[1])]

        self.f_hap.write(str_join("\t", [
            chrom, min(positions), max(positions),
            max(positions) - min(positions), len(variants),
            list_to_string(rsids),
            list_to_string(alleles[0]) + "|" + list_to_string(alleles[1]),
            hap_counts[0], hap_counts[1], sum(hap_counts),
            supporting, total,
            phase_string[0] + "|" + phase_string[1], phase_concordant,
            corrected_phase_string[0] + "|" + corrected_phase_string[1],
            cor_phase_stat]) + "\n")

        # ---- haplotypic counts per BAM (:1048-1125)
        # variant selection / blacklist / allele strings are IDENTICAL for
        # every BAM: precompute once (the reference recomputes them inside
        # its bam loop, phaser.py:1050-1080 — values match, this is the
        # single-process engine's hottest string loop)
        used_alleles = [[], []]
        used_vars: List[str] = []
        used_var_pos: List[int] = []
        blacklisted_vars: List[str] = []   # canonical: first-add order
        kept: List[List[Tuple[int, int]]] = [[], []]  # (i, allele_idx)/hap
        no_blacklist = not self.blacklist
        for hap_index in range(2):
            hap_x = [haplotype_a, haplotype_b][hap_index]
            for i, v in enumerate(v_idx):
                used_var_pos.append(positions[i])
                if no_blacklist or (chrom + "_" + str(positions[i])
                                    not in self.blacklist):
                    ind = ind_list[i]
                    allele = ind[int(hap_x[i])]
                    allele_index = ind.index(allele)
                    if variants[i] not in used_vars:
                        used_vars.append(variants[i])
                    used_alleles[hap_index].append(allele)
                    kept[hap_index].append((i, allele_index))
                else:
                    if variants[i] not in blacklisted_vars:
                        blacklisted_vars.append(variants[i])

        out_block_gw_phase = "0/1"
        if corrected_phases[0][0] == 0:
            out_block_gw_phase = "0|1"
        elif corrected_phases[0][0] == 1:
            out_block_gw_phase = "1|0"

        for bam_i in range(len(self.bam_list)):
            if bam_i in self.excl:
                continue
            bam_name = self.bam_names[bam_i]
            set_hap_expr_reads = [None, None]
            hap_expr_counts = [0, 0]
            var_reads = [[], []]

            hap_var_reads = [[], []]
            for hap_index in range(2):
                for i, allele_index in kept[hap_index]:
                    lst = vr.haplo_list(v_idx[i], allele_index, bam_i)
                    var_reads[hap_index].append(
                        lst if lst is not None else np.zeros(0, np.int64))
                # first-seen unique + each read's first-seen RANK in one
                # vectorized pass (was: python dict + per-read list comp,
                # the hottest loop of the single-process output stage)
                concat = (np.concatenate(var_reads[hap_index])
                          if var_reads[hap_index] else np.zeros(0, np.int64))
                if concat.size:
                    suniq, first, inv = np.unique(
                        concat, return_index=True, return_inverse=True)
                    order = np.argsort(first, kind="stable")
                    uniq = suniq[order]
                    rank = np.empty(len(suniq), np.int64)
                    rank[order] = np.arange(len(suniq))
                    ranks = rank[inv]
                else:
                    uniq = concat
                    ranks = concat
                set_hap_expr_reads[hap_index] = uniq
                hap_expr_counts[hap_index] = len(uniq)
                off = 0
                for var_index in range(len(used_vars)):
                    n = len(var_reads[hap_index][var_index])
                    hap_var_reads[hap_index].append(
                        ",".join(map(str, ranks[off:off + n].tolist())))
                    off += n
            hv0 = list_to_string(hap_var_reads[0], sep=";")
            hv1 = list_to_string(hap_var_reads[1], sep=";")
            total_cov = sum(hap_expr_counts)

            if total_cov > 0:
                fields_out = [chrom, min(used_var_pos), max(used_var_pos),
                              list_to_string(used_vars), len(used_vars),
                              list_to_string(blacklisted_vars),
                              len(blacklisted_vars),
                              list_to_string(used_alleles[0]),
                              list_to_string(used_alleles[1]),
                              hap_expr_counts[0], hap_expr_counts[1],
                              total_cov, out_block_gw_phase, cor_phase_stat]
                if opts.output_read_ids == 1:
                    names = vr.rows.uid_names
                    fields_out += [
                        list_to_string([names[int(u)].decode()
                                        for u in set_hap_expr_reads[0]]),
                        list_to_string([names[int(u)].decode()
                                        for u in set_hap_expr_reads[1]])]
                fields_out += [str(max(haplotype_mafs)), bam_name]
                fields_out += [hv0, hv1]
                self.f_ase.write(str_join("\t", fields_out) + "\n")

        # ---- network output (:1127-1157)
        if opts.output_network in variants:
            self._write_network(vr, v_idx, variants, alleles)

        # ---- allele configs (:1159-1172): "trans" when hap-A allele i and
        # hap-B allele j are both ref or both alt, "cis" otherwise — the
        # reference's four-way branch reduces to one equality test and its
        # empty-config case is unreachable
        ref_eq_a = [vt.all_alleles[v_idx[i]][0] == alleles[0][i]
                    for i in range(len(v_idx))]
        ref_eq_b = [vt.all_alleles[v_idx[j]][0] == alleles[1][j]
                    for j in range(len(v_idx))]
        rsids_out = [vt.rsids_out[v] for v in v_idx]
        # per-j suffixes precomputed once per block: the pair loop does one
        # concat per row
        sfx = [(variants[j] + "\t" + rsids_out[j] + "\ttrans\n",
                variants[j] + "\t" + rsids_out[j] + "\tcis\n")
               for j in range(len(v_idx))]
        cfg_rows = []
        for i, variant_a in enumerate(variants):
            head = variant_a + "\t" + rsids_out[i] + "\t"
            ea = ref_eq_a[i]
            cfg_rows.extend(
                head + sfx[j][0 if ea == ref_eq_b[j] else 1]
                for j, variant_b in enumerate(variants)
                if variant_a != variant_b)
        self.f_cfg.write("".join(cfg_rows))

    # ------------------------------------------------------------------
    def _write_network(self, vr: VariantReads, v_idx: List[int],
                       variants: List[str], alleles) -> None:
        vt = vr.vt
        out_junctions = []
        counted = set()
        n = len(v_idx)
        for vi in range(n):
            for oj in range(n):
                if oj == vi:
                    continue
                for ai in range(2):
                    for bj in range(2):
                        if (vi, ai, oj, bj) in counted or (oj, bj, vi, ai) in counted:
                            continue
                        s1 = vr.read_set(v_idx[vi], ai)
                        s2 = vr.read_set(v_idx[oj], bj)
                        n_j = len(np.intersect1d(s1, s2, assume_unique=True))
                        ida = vt.unique_ids[v_idx[vi]]
                        idb = vt.unique_ids[v_idx[oj]]
                        out_junctions.append(
                            [ida + ":" + vt.ind_alleles[v_idx[vi]][ai],
                             idb + ":" + vt.ind_alleles[v_idx[oj]][bj], n_j, 0])
                        out_junctions.append(
                            [ida + ":" + vt.ind_alleles[v_idx[vi]][int(not ai)],
                             idb + ":" + vt.ind_alleles[v_idx[oj]][int(not bj)],
                             n_j, 1])
                        counted.add((vi, ai, oj, bj))
        with open(self.out_prefix + ".network.links.txt", "w") as f:
            f.write("\t".join(["variantA", "variantB", "connections",
                               "inferred\n"]))
            nodes = []
            for item in out_junctions:
                if item[2] > 0:
                    f.write(list_to_string(item, "\t") + "\n")
                    nodes.append(item[0])
                    nodes.append(item[1])
        with open(self.out_prefix + ".network.nodes.txt", "w") as f:
            f.write("id\tindex\tassigned_hap\n")
            seen = []
            for item in nodes:
                if item not in seen:
                    seen.append(item)
            for item in seen:   # canonical first-seen (reference: set order)
                xvar = item.rsplit(":", 1)[0]
                xallele = item.rsplit(":", 1)[1]
                var_index = variants.index(xvar)
                assigned = "A" if alleles[0][var_index] == xallele else "B"
                f.write(item + "\t" + str(var_index) + "\t" + assigned + "\n")

    # ------------------------------------------------------------------
    def write_singletons(self, contig_states) -> None:
        """Unphased-variant rows (:1179-1239), canonical first-seen order."""
        opts = self.opts
        st = self.state
        phased = set(st.all_variant_ids)
        singles: List[Tuple[int, VariantReads, int]] = []
        for vr, _conn in contig_states:
            vt = vr.vt
            matched = vr.raw_counts[:, 0] + vr.raw_counts[:, 1]
            for v in vr.touched:
                if matched[v] == 0:
                    continue  # removed in cleanup (:769-771)
                if vt.unique_ids[v] in phased:
                    continue
                singles.append((int(vr.first_seen[v]), vr, int(v)))
        singles.sort(key=lambda t: t[0])

        for skey, vr, v in singles:
            vt = vr.vt
            vid = vt.unique_ids[v]
            chrom = vt.chrom
            pos = int(vt.pos[v])
            ind = vt.ind_alleles[v]
            phase = vt.phases[v]
            if chrom + "_" + str(pos) not in self.blacklist:
                for bam_i in range(len(self.bam_list)):
                    if bam_i in self.excl:
                        continue
                    bam_name = self.bam_names[bam_i]
                    la = vr.haplo_list(v, 0, bam_i)
                    lb = vr.haplo_list(v, 1, bam_i)
                    ua = _first_seen_unique(la) if la is not None else np.zeros(0, np.int64)
                    ub = _first_seen_unique(lb) if lb is not None else np.zeros(0, np.int64)
                    hap_a_count, hap_b_count = len(ua), len(ub)
                    total_cov = hap_a_count + hap_b_count
                    if total_cov > 0:
                        if "-" not in phase:
                            phase_string = (str(phase.index(ind[0])) + "|" +
                                            str(phase.index(ind[1])))
                        else:
                            phase_string = "0/1"
                        fields_out = [chrom, str(pos), str(pos), vid, str(1),
                                      "", str(0), ind[0], ind[1],
                                      str(hap_a_count), str(hap_b_count),
                                      str(total_cov), phase_string, "1"]
                        if opts.output_read_ids == 1:
                            names = vr.rows.uid_names
                            fields_out += [
                                list_to_string([names[int(u)].decode() for u in ua]),
                                list_to_string([names[int(u)].decode() for u in ub])]
                        fields_out += [str(vt.mafs[v]), bam_name]
                        fields_out += ["", ""]
                        self._emit_single_ase(
                            skey, "\t".join(fields_out) + "\n")

        for skey, vr, v in singles:
            vt = vr.vt
            vid = vt.unique_ids[v]
            ind = vt.ind_alleles[v]
            phase = vt.phases[v]
            c0 = vr.unique_count(v, 0)
            c1 = vr.unique_count(v, 1)
            total_cov = c0 + c1
            if "-" not in phase:
                phase_string = (str(phase.index(ind[0])) + "|" +
                                str(phase.index(ind[1])))
            else:
                phase_string = "-|-"
            out_name = vt.rsids_out[v] if opts.unique_ids == 0 else vid
            self._emit_single_hap(
                skey,
                vt.chrom + "\t" + str(int(vt.pos[v]) - 1) + "\t" +
                str(int(vt.pos[v])) + "\t" + str(1) + "\t" + str(1) + "\t" +
                out_name + "\t" + ind[0] + "|" + ind[1] + "\t" + str(c0) +
                "\t" + str(c1) + "\t" + str(total_cov) + "\t" + str(0) +
                "\t" + str(0) + "\t" + phase_string + "\t" +
                str(float("nan")) + "\t" + phase_string + "\t" +
                str(float("nan")) + "\n")

    def close(self) -> None:
        self.f_hap.close()
        self.f_ase.close()
        self.f_cfg.close()
        for fh in self._mains:
            fh.close()
        if self.f_hap_sing is not None:
            self.f_hap_sing.close()
        if self.f_ase_sing is not None:
            self.f_ase_sing.close()


def write_allelic_counts(out_prefix: str, contig_states,
                         keyed: bool = False) -> int:
    """GATK-ASEReadCounter-format counts (:736-751), global first-seen order.

    keyed: write "<first_seen_key>\\t<row>" lines to a headerless
    `.allelic_counts.part` file instead — the multi-shard engine merge
    sorts rows by key ACROSS shards (first_seen is a global row sequence,
    bam-major, so per-shard concatenation alone would misorder multi-bam
    runs)."""
    rows: List[Tuple[int, str]] = []
    covered = 0
    for vr, _ in contig_states:
        vt = vr.vt
        for v in vr.touched:
            ref_reads = vr.unique_count(v, 0)
            alt_reads = vr.unique_count(v, 1)
            if ref_reads + alt_reads > 0:
                covered += 1
                ind = vt.ind_alleles[v]
                row = "\t".join([vt.chrom, str(int(vt.pos[v])),
                                 vt.unique_ids[v], ind[0], ind[1],
                                 str(ref_reads), str(alt_reads),
                                 str(ref_reads + alt_reads) + "\n"])
                rows.append((int(vr.first_seen[v]), row))
    rows.sort(key=lambda t: t[0])
    if keyed:
        with open(out_prefix + ".allelic_counts.part", "w") as f:
            for key, row in rows:
                f.write("%d\t%s" % (key, row))
        return covered
    with open(out_prefix + ".allelic_counts.txt", "w") as f:
        f.write("contig\tposition\tvariantID\trefAllele\taltAllele\trefCount"
                "\taltCount\ttotalCount\n")
        for _, row in rows:
            f.write(row)
    return covered


def write_variant_connections(out_prefix: str, contig_states) -> int:
    """variant_connections.txt (:683-695), canonical (rank_a, rank_b) order
    per contig, contigs in processing order. Returns dropped-connection count."""
    dropped = 0
    with open(out_prefix + ".variant_connections.txt", "w") as f:
        f.write("variant_a\tvariant_b\tsupporting_connections\t"
                "total_connections\tconflicting_configuration_p\t"
                "phase_concordant\n")
        for vr, conn in contig_states:
            vt = vr.vt
            for k in range(conn.n_pairs):
                f.write("\t".join(map(pystr, [
                    vt.unique_ids[int(conn.var_a[k])],
                    vt.unique_ids[int(conn.var_b[k])],
                    int(conn.c_supporting[k]), int(conn.c_total[k]),
                    conn.p_display[k], conn.phase_concordant[k]])) + "\n")
            dropped += int(conn.pruned.sum())
    return dropped
