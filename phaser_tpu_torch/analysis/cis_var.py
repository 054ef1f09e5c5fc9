"""phASER-POP cis-var: cis-regulatory effect sizes (aFC) from the gw_phased
expression matrix + a population VCF (the port of
phaser_tpu/analysis/cis_var.py).

Parity implementation of reference phaser_pop/phaser_cis_var.py (modulo its
py2 leftovers): per (gene, variant) pair, per phased-het sample compute
aFC = log2((aCount+pc)/(bCount+pc)) sign-oriented ALT/REF; homozygous
samples form the null cohort; bootstrap median CIs + empirical p + Wilcoxon
rank-sum het-vs-hom |aFC| test.

The expression matrix is parsed ONCE into dense (genes x samples) count
arrays, the sample <-> column correspondence is hoisted out of the pair
loop, and genotype classification runs vectorized per record; only the
per-sample aFC accumulation stays scalar, preserving math.log bit-for-bit
output parity with phaser_tpu.

Tables are read and the result written by utils.table, which types and
formats cells as phaser_tpu's pandas calls do; no pandas is needed.

Bootstrap engines:
  * numpy: per-pair seeded Generator index resampling (phaser_tpu's numpy
    engine, the same numbers);
  * torch: every pair's four cohorts in one kernels.bootstrap call on
    `device` (cuda by default; cpu runs the same torch code on the CPU);
  * auto: torch only when `device` is cuda and pairs x bs reaches
    AUTO_CROSSOVER, numpy otherwise.  The choice is made from the pairs
    file's line count before torch is imported, so an auto run that
    resolves to numpy imports no torch.
A torch run that asks for the card raises when there is none: nothing
falls back to numpy.  Point estimates, cohort lists, counts and the
rank-sum test are identical between engines; the four CI lower/upper
bounds and var_het_pval are engine- and device-specific for the same
--bs_seed (statistically equal, not bitwise equal).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
from scipy.stats import ranksums

from ..io import bgzf, tabix
from ..utils.table import read_tsv, write_tsv

# pairs x bs from which engine="auto" runs the torch bootstrap on the card:
# where the walls of fresh numpy and torch processes cross, import torch
# and CUDA start-up included (testing/cis_var_crossover.py on an NVIDIA
# H100 80GB HBM3, 700 W: numpy 5.6 s + 0.139 s a pair, torch 17.3 s flat,
# 83 pairs at bs 10,000; PERF.md)
AUTO_CROSSOVER = 833_000

COLUMNS = [
    "gene", "var_id", "var_chr", "var_pos", "var_het_n", "var_hom_n",
    "het_hom_pvalue", "var_het_afc_lower", "var_het_afc",
    "var_het_afc_upper", "var_het_pval", "var_het_abs_afc_lower",
    "var_het_abs_afc", "var_het_abs_afc_upper", "var_hom_afc_lower",
    "var_hom_afc", "var_hom_afc_upper", "var_hom_abs_afc_lower",
    "var_hom_abs_afc", "var_hom_abs_afc_upper", "var_het_afcs",
    "var_hom_afcs", "var_het_ref_counts", "var_het_alt_counts",
    "var_hom_hap1_counts", "var_hom_hap2_counts", "var_het_sample_ids",
    "var_hom_sample_ids"]


def _parse_count_cells(cells: np.ndarray):
    """Parse one sample column of "aCount|bCount[|...]" cells.

    Returns (a, b, total, ok): first two |-fields, the sum of ALL fields
    (the reference's min_cov test sums every field,
    phaser_cis_var.py:143-144), and an eligibility mask. Cells that do not
    parse as |-separated floats with >= 2 fields get ok=False — the
    reference would crash on such a cell when the pair loop visits it; we
    mark the sample ineligible for that gene instead (documented
    divergence, fail-soft).

    Vectorized fast path for the universal well-formed "a|b" case; scalar
    fallback only when a column contains malformed / ragged cells.
    """
    n = len(cells)
    try:
        part = np.char.partition(cells, "|")
        rest = part[:, 2]
        if (rest == "").any():
            raise ValueError("cell without '|'")
        a = part[:, 0].astype(float)
        total = a.copy()
        b = None
        cur = rest
        while True:
            p = np.char.partition(cur, "|")
            tok, cur = p[:, 0], p[:, 2]
            if (tok == "").any():
                raise ValueError("empty field")
            vals = tok.astype(float)
            if b is None:
                b = vals
            total = total + vals
            if (cur == "").all():
                break
            if (cur == "").any():
                raise ValueError("ragged field counts")
        return a, b, total, np.ones(n, bool)
    except ValueError:
        pass
    a = np.full(n, np.nan)
    b = np.full(n, np.nan)
    total = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    for i in range(n):
        try:
            fs = [float(x) for x in str(cells[i]).split("|")]
        except ValueError:
            continue
        if len(fs) < 2:
            continue
        a[i], b[i] = fs[0], fs[1]
        total[i] = sum(fs)
        ok[i] = True
    return a, b, total, ok


def _bootstrap_ci(x: List[float], bs: int, rng: np.random.Generator,
                  return_p: bool = False) -> List[float]:
    if len(x) > 0:
        arr = np.asarray(x, float)
        idx = rng.integers(0, len(arr), size=(bs, len(arr)))
        vals = np.median(arr[idx], axis=1)
        out = [float(np.percentile(vals, 2.5)), float(np.median(arr)),
               float(np.percentile(vals, 97.5))]
        if return_p:
            p = (min(int((vals > 0).sum()), int((vals < 0).sum())) / bs) * 2
            out.append(float(p))
        return out
    out = [float("nan")] * 3
    if return_p:
        out.append(float("nan"))
    return out


def _list_to_str(x, sep=",") -> str:
    return sep.join(map(str, x))


def count_pairs(pairs: str) -> int:
    """Data lines of the pairs file (its line count less the header)."""
    with open(pairs) as fh:
        return max(sum(1 for _ in fh) - 1, 0)


def resolve_engine(engine: str, device: str, n_pairs: int, bs: int) -> str:
    """The bootstrap engine a run uses: "auto" is torch only on the card and
    from AUTO_CROSSOVER pairs x draws on."""
    if engine not in ("auto", "numpy", "torch"):
        raise ValueError("unknown engine %r" % engine)
    if device not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % device)
    if engine == "auto":
        return "torch" if device == "cuda" and \
            n_pairs * bs >= AUTO_CROSSOVER else "numpy"
    return engine


def run_cis_var(bed: str, vcf: str, pairs: str, sample_map: str, o: str,
                pc: int = 1, min_cov: int = 8, chrom: str = "",
                bs: int = 10000, ignore_v: int = 0, bs_seed: int = 0,
                engine: str = "auto", device: str = "cuda",
                log=print) -> str:
    """Writes the result table to `o` and returns the engine that ran.

    engine="torch" batches every pair's bootstrap into one
    kernels.bootstrap call on `device`; it raises before any work when
    `device` is cuda and there is no card."""
    engine = resolve_engine(engine, device, count_pairs(pairs), bs)
    if engine == "torch":
        from ..kernels import bootstrap
        bootstrap.check_device(device)
    df_map = read_tsv(sample_map)
    dict_map = dict(zip(df_map["vcf_sample"], df_map["bed_sample"]))

    df_pairs = read_tsv(pairs)
    if ignore_v == 1:
        df_pairs.set_column("gene_id",
                            [x.split(".")[0] for x in df_pairs["gene_id"]])
    if chrom != "":
        df_pairs.set_column("var_contig",
                            list(map(str, df_pairs["var_contig"])))
        df_pairs = df_pairs.where("var_contig", chrom)

    # load matrix rows for needed genes (reference filters lines by gene)
    raw = bgzf.read_text_auto(bed).decode() if bed.endswith(".gz") else \
        open(bed).read()
    set_use_genes = set(df_pairs["gene_id"])
    use_lines = []
    for xline in raw.splitlines():
        if xline.startswith("#"):
            use_lines.append(xline)
            continue
        xcols = xline.split("\t")
        name = xcols[3]
        if ignore_v == 1 and name.split(".")[0] in set_use_genes:
            use_lines.append(xline)
        elif name in set_use_genes:
            use_lines.append(xline)
    df_phaser = read_tsv(text="\n".join(use_lines), drop_extra=False)
    gene_names = df_phaser["name"]
    index = gene_names
    if ignore_v == 1:
        index = [x.split(".")[0] for x in index]
    if len(df_phaser) == 0:
        raise RuntimeError("no phASER data read from input")

    tf = tabix.TabixFile(vcf)
    # VCF column names
    header_cols: List[str] = []
    for line in bgzf.read_text_auto(vcf).decode().splitlines():
        if line.startswith("#CHROM"):
            header_cols = line.lstrip("#").split("\t")
            break

    # ---- hoisted per-run metadata (the reference recomputes all of this
    # per pair x per sample): samples usable for EVERY record are the
    # dict_map entries present in both the VCF header and the matrix
    col_of = {name: i for i, name in enumerate(header_cols)}
    use_samples = [s for s in dict_map
                   if s in col_of and dict_map[s] in df_phaser]
    vcf_cols = [col_of[s] for s in use_samples]
    # gene -> matrix row position (index is unique in valid matrices; the
    # reference's .loc would misbehave identically on duplicates)
    gene_row_of: Dict = {}
    for i, g in enumerate(index):
        if g not in gene_row_of:
            gene_row_of[g] = i
    # parse every used "aCount|bCount" cell exactly once (matrix lines were
    # pre-filtered to genes referenced by the pairs table, so no unused row
    # is parsed); min_cov sums ALL |-fields like the reference's
    # sum(counts) (phaser_cis_var.py:143-144)
    n_genes = len(df_phaser)
    n_use = len(use_samples)
    cnt_a = np.empty((n_genes, n_use), float)
    cnt_b = np.empty_like(cnt_a)
    cov_ok_all = np.zeros((n_genes, n_use), bool)
    for j, s in enumerate(use_samples):
        cells = np.asarray([str(x) for x in df_phaser[dict_map[s]]],
                           dtype="U")
        a, b, total, ok = _parse_count_cells(cells)
        cnt_a[:, j] = a
        cnt_b[:, j] = b
        cov_ok_all[:, j] = ok & (total >= min_cov)

    results = []
    pending = []  # torch engine: bootstrap all pairs in one batched call
    for pos, xindex in enumerate(df_pairs.index):
        row_test = df_pairs.row(pos)
        grow = gene_row_of.get(row_test["gene_id"])
        if grow is None:
            continue
        var_pos = int(row_test["var_pos"])
        var_chr = str(row_test["var_contig"])
        for rec_line in tf.fetch(var_chr, var_pos - 1, var_pos):
            fields = rec_line.split("\t")
            if int(fields[1]) != var_pos:
                continue
            match = ((str(row_test.get("var_ref", "")) != "" and
                      str(row_test.get("var_alt", "")) != "" and
                      fields[3] == row_test["var_ref"] and
                      fields[4] == row_test["var_alt"]) or
                     fields[2] == row_test["var_id"])
            if not match:
                continue
            gt_index = fields[8].split(":").index("GT")
            gts = [fields[ci].split(":")[gt_index]
                   if ci < len(fields) else "" for ci in vcf_cols]
            # dtype pinned: np.asarray([]) without it is float64 and
            # np.char.* would raise on records with zero usable samples
            # (the reference simply yields empty cohorts there)
            g_arr = np.asarray(gts, dtype="U")
            phased = np.char.find(g_arr, "|") >= 0
            has0 = np.char.find(g_arr, "0") >= 0
            has1 = np.char.find(g_arr, "1") >= 0
            is_het = has0 & has1
            is_hom = (np.char.count(g_arr, "0") == 2) | \
                     (np.char.count(g_arr, "1") == 2)
            elig = phased & cov_ok_all[grow] & (is_het | is_hom)
            ca, cb = cnt_a[grow], cnt_b[grow]

            afcs = [[], []]
            phaser_counts = [[[], []], [[], []]]
            ids = [[], []]
            for j in np.flatnonzero(elig):
                xgt = gts[j]
                c0, c1 = ca[j], cb[j]
                afc = math.log((c0 + pc) / (c1 + pc), 2)
                if is_het[j]:
                    alt_index = xgt.split("|").index("1")
                    if alt_index == 1:
                        afc *= -1
                    afcs[0].append(afc)
                    ids[0].append(use_samples[j])
                    phaser_counts[0][0].append(
                        int((c0, c1)[int(not alt_index)]))
                    phaser_counts[0][1].append(int((c0, c1)[alt_index]))
                else:
                    afcs[1].append(afc)
                    ids[1].append(use_samples[j])
                    phaser_counts[1][0].append(int(c0))
                    phaser_counts[1][1].append(int(c1))

            abs_afcs = [list(map(abs, afcs[0])), list(map(abs, afcs[1]))]
            if engine == "torch":
                pending.append(dict(
                    xindex=xindex, name=gene_names[grow],
                    var_id=row_test["var_id"], var_chr=var_chr,
                    var_pos=var_pos, afcs=afcs, abs_afcs=abs_afcs,
                    phaser_counts=phaser_counts, ids=ids))
                continue
            rng = np.random.default_rng([bs_seed, int(xindex)])
            het_ci = _bootstrap_ci(afcs[0], bs, rng, True)
            het_abs_ci = _bootstrap_ci(abs_afcs[0], bs, rng)
            hom_ci = _bootstrap_ci(afcs[1], bs, rng)
            hom_abs_ci = _bootstrap_ci(abs_afcs[1], bs, rng)
            stat, pval = ranksums(abs_afcs[0], abs_afcs[1])
            results.append(
                [xindex, gene_names[grow], row_test["var_id"], var_chr,
                 var_pos, len(afcs[0]), len(afcs[1]), pval] + het_ci +
                het_abs_ci + hom_ci + hom_abs_ci +
                [_list_to_str(afcs[0]), _list_to_str(afcs[1]),
                 _list_to_str(phaser_counts[0][0]),
                 _list_to_str(phaser_counts[0][1]),
                 _list_to_str(phaser_counts[1][0]),
                 _list_to_str(phaser_counts[1][1]),
                 _list_to_str(ids[0]), _list_to_str(ids[1])])

    if engine == "torch" and pending:
        from ..kernels.bootstrap import bootstrap_cis_device
        cohorts = []
        for pdta in pending:
            cohorts += [np.asarray(pdta["afcs"][0], float),
                        np.asarray(pdta["abs_afcs"][0], float),
                        np.asarray(pdta["afcs"][1], float),
                        np.asarray(pdta["abs_afcs"][1], float)]
        cis = bootstrap_cis_device(cohorts, bs, seed=bs_seed, device=device)
        for k, pdta in enumerate(pending):
            het, het_abs, hom, hom_abs = cis[4 * k:4 * k + 4]

            def _mid(vals):
                return float(np.median(vals)) if len(vals) else float("nan")

            afcs, abs_afcs = pdta["afcs"], pdta["abs_afcs"]
            het_ci = [het[0], _mid(afcs[0]), het[1], het[2]]
            het_abs_ci = [het_abs[0], _mid(abs_afcs[0]), het_abs[1]]
            hom_ci = [hom[0], _mid(afcs[1]), hom[1]]
            hom_abs_ci = [hom_abs[0], _mid(abs_afcs[1]), hom_abs[1]]
            stat, pval = ranksums(abs_afcs[0], abs_afcs[1])
            pc_ = pdta["phaser_counts"]
            results.append(
                [pdta["xindex"], pdta["name"], pdta["var_id"],
                 pdta["var_chr"], pdta["var_pos"], len(afcs[0]), len(afcs[1]),
                 pval] + het_ci + het_abs_ci + hom_ci + hom_abs_ci +
                [_list_to_str(afcs[0]), _list_to_str(afcs[1]),
                 _list_to_str(pc_[0][0]), _list_to_str(pc_[0][1]),
                 _list_to_str(pc_[1][0]), _list_to_str(pc_[1][1]),
                 _list_to_str(pdta["ids"][0]), _list_to_str(pdta["ids"][1])])

    # rows come in pair order already; a stable sort keeps the records of
    # one pair in the order the VCF gave them
    results.sort(key=lambda r: r[0])
    write_tsv(o, COLUMNS, [r[1:] for r in results])
    return engine
