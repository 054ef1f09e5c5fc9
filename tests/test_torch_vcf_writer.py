"""The port's phased VCF writer (engine/vcf_writer.py): the native pass
(scan, emit, the phased lines formatted in Python, compress and index from
the text in memory) writes the same `.vcf.gz` and `.vcf.gz.tbi`, byte for
byte, as its Python loop (PHASER_TPU_NO_NATIVE=1) and as phaser_tpu's
writer, on random small VCFs and phased states; `tabix.vcf_index_from_text`
equals `build_vcf_index` on the written file."""

import math
import os
import random

import numpy as np
import pytest

from phaser_tpu.engine import output_stage as jax_output_stage
from phaser_tpu.engine import vcf_writer as jax_vcf_writer
from phaser_tpu_torch.engine import output_stage, vcf_writer
from phaser_tpu_torch.io import bgzf, native, tabix
from phaser_tpu_torch.utils.fmt import list_to_string

BLOCK = bgzf.MAX_BLOCK_PAYLOAD
SAMPLES = ("S0", "S1", "S2")
GT_HEADER = '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">'


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PHASER_TPU_NO_NATIVE", "1")


def _body(rng, n, contigs=("chr1", "chr2", "chr3"), gts=("0|1", "1|0"),
          formats=("GT", "GT:DP"), multi=0.0, extra_fields=0.0,
          few_fields=0.0, ref_len=(1,), step=(1, 300)):
    """Body lines [(chrom, pos, ref, alts, line)], sorted by contig and
    position, some positions shared by two lines."""
    out = []
    per = max(1, n // len(contigs))
    for chrom in contigs:
        pos = rng.randint(1, 500)
        for _ in range(per):
            pos += 0 if rng.random() < 0.05 else rng.randint(*step)
            ref = "".join(rng.choice("ACGT")
                          for _ in range(rng.choice(ref_len)))
            alts = [rng.choice([b for b in "ACGT" if b != ref[0]])]
            if rng.random() < multi:
                alts.append(rng.choice(["AT", "G", "CCA", "T"]))
            fmt = rng.choice(formats)
            cols = []
            for _ in SAMPLES:
                vals = {"GT": rng.choice(gts), "DP": str(rng.randint(0, 90)),
                        "GQ": str(rng.randint(0, 99)), "AD": "3,4"}
                fields = [vals.get(f, ".") for f in fmt.split(":")]
                if rng.random() < extra_fields:
                    fields += ["7", "x"]
                if len(fields) > 1 and rng.random() < few_fields:
                    fields = fields[:rng.randint(1, len(fields) - 1)]
                cols.append(":".join(fields))
            line = "\t".join([chrom, str(pos), "rs%d" % rng.randint(1, 10**7),
                              ref, ",".join(alts), "50", "PASS", "AC=1", fmt]
                             + cols)
            out.append((chrom, pos, ref, alts, line))
    return out


def _headers(extra=()):
    return (["##fileformat=VCFv4.2", "##contig=<ID=chr1>", GT_HEADER]
            + list(extra)
            + ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
               + "\t".join(SAMPLES)])


def _state(rng, body, sample_column, share=0.4, sep="_"):
    """A phased state over a share of the body's GT lines (blocks of 1-4
    neighbours), and the rsid lookup: genome-wide phases of 0/1 and nan,
    confidences on both sides of 0.9."""
    hl, ind, gw, stat, maf, rsid = {}, {}, {}, {}, {}, {}
    cand = []
    for chrom, pos, ref, alts, line in body:
        cols = line.split("\t")
        if "GT" not in cols[8].split(":"):
            continue
        gt_i = cols[8].split(":").index("GT")
        sample = cols[sample_column].split(":")
        if len(sample) <= gt_i or sample[gt_i] not in ("0|1", "1|0",
                                                        "0/1", "1|2"):
            continue
        if rng.random() < share:
            cand.append((chrom, pos, ref, alts, cols[2]))
    block_index = 0
    i = 0
    while i < len(cand):
        k = rng.randint(1, 4)
        group = cand[i:i + k]
        i += k
        uids = [sep.join([c, str(p), r] + a) for c, p, r, a, _ in group]
        if len(set(uids)) != len(uids):
            continue
        variants = list(uids)
        key = list_to_string(variants)
        stat[key] = rng.choice([0.55, 0.95, 0.999, 1.0])
        maf[key] = rng.choice([0.1, 0.25, 0.5])
        for uid, (c, p, r, a, rs) in zip(uids, group):
            alleles = [r] + a
            pair = rng.sample(alleles, 2)
            hl[uid] = (variants, rng.choice(["0|1", "1|0"]), block_index)
            ind[uid] = pair
            gw[uid] = rng.choice([[0, 1], [1, 0], [math.nan, math.nan]])
            rsid[uid] = rs if rng.random() < 0.8 else rs + ":x"
        block_index += 1
    return dict(haplotype_lookup=hl, ind_alleles=ind, gw_phase=gw,
                gw_stat_lookup=stat, max_maf_lookup=maf), rsid


def _write(tmp_path, name, lines):
    path = str(tmp_path / (name + ".vcf.gz"))
    text = ("\n".join(lines) + "\n").encode()
    with open(path, "wb") as fh:
        fh.write(bgzf.compress_bytes(text))
    return path


def _case(tmp_path, rng, case):
    """(vcf path, sample column, state dict, rsid lookup, writer kwargs,
    gw_phase_vcf) of one case."""
    kw, gw_mode, sample_column = {}, 0, 9 + rng.randrange(len(SAMPLES))
    headers = _headers()
    if case == "multiallelic":
        body = _body(rng, 300, multi=0.5, gts=("0|1", "1|0", "1|2", "0/1"))
    elif case == "gt_forms":
        body = _body(rng, 300, gts=("0|1", "./.", "1", "10|2", "0/1", "1|0|2",
                                    ".|.", "0", "2/10", ""))
    elif case == "format_without_gt":
        body = _body(rng, 300, formats=("GT", "DP:GQ", "DP", "GQ:GT:DP"))
    elif case == "field_counts":
        body = _body(rng, 300, formats=("GT:DP:GQ", "DP:GT", "GT:AD:DP:GQ"),
                     extra_fields=0.3, few_fields=0.3)
    elif case == "existing_tags":
        headers = _headers([
            '##FORMAT=<ID=PG,Number=1,Type=String,Description="old">',
            '##FORMAT=<ID=PS,Number=1,Type=String,Description="old">'])
        body = _body(rng, 300, formats=("GT", "GT:PG", "PS:GT"))
        gw_mode = 2
    elif case in ("gw_phase_vcf_0", "gw_phase_vcf_1", "gw_phase_vcf_2"):
        gw_mode = int(case[-1])
        body = _body(rng, 300, gts=("0|1", "1|0", "0/1", "./.", "1|1"),
                     formats=("GT", "GT:DP", "GT:PS"))
    elif case == "contig_list":
        body = _body(rng, 300, contigs=("chr1", "chr2", "chr3", "chrX"))
        kw["chromosome_of_interest"] = "chr1,chr3"
    elif case == "empty_body":
        body = []
    elif case == "block_boundary":
        body = _body(rng, 2400, formats=("GT", "GT:DP"))
    else:
        raise AssertionError(case)
    lines = headers + [b[-1] for b in body]
    state, rsid = _state(rng, body, sample_column)
    if case == "block_boundary":
        # pad the first header line so that a body line's '\n' is the
        # last byte of the output's first block
        probe = str(tmp_path / "probe")
        os.makedirs(probe)
        _run_port(_write(tmp_path, "probe", lines), sample_column, state,
                  rsid, kw, gw_mode, os.path.join(probe, "o"))
        out = bgzf.decompress_all(
            open(os.path.join(probe, "o.vcf.gz"), "rb").read())
        ends = [i + 1 for i, b in enumerate(out[:BLOCK]) if b == 10]
        lines[0] += "x" * (BLOCK - ends[-1])
    return _write(tmp_path, "in", lines), sample_column, state, rsid, kw, \
        gw_mode


def _run_port(vcf, sample_column, state, rsid, kw, gw_mode, out):
    st = output_stage.OutputState(**state)
    opts = output_stage.PhaserOptions(gw_phase_vcf=gw_mode)
    return vcf_writer.write_phased_vcf(
        vcf, sample_column, out, kw.get("chromosome_of_interest", ""), st,
        opts, rsid_lookup=rsid,
        **{k: v for k, v in kw.items() if k != "chromosome_of_interest"})


def _run_jax(vcf, sample_column, state, rsid, kw, gw_mode, out):
    st = jax_output_stage.OutputState(**state)
    opts = jax_output_stage.PhaserOptions(gw_phase_vcf=gw_mode)
    return jax_vcf_writer.write_phased_vcf(
        vcf, sample_column, out, kw.get("chromosome_of_interest", ""), st,
        opts, rsid_lookup=rsid,
        **{k: v for k, v in kw.items() if k != "chromosome_of_interest"})


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def _all_ways(tmp_path, monkeypatch, args, runs=(("", {}),)):
    """Each (suffix, kwargs) of `runs` through the native path, the Python
    loop with the native compressor, the Python loop under
    PHASER_TPU_NO_NATIVE=1 and phaser_tpu's writer: the files, returns and
    writer counts of each."""
    got = {}
    for way in ("native", "loop", "no_native", "jax"):
        d = tmp_path / way
        d.mkdir()
        res = []
        with monkeypatch.context() as m:
            if way == "loop":
                m.setattr(vcf_writer, "_write_native", lambda *a: False)
            if way == "no_native":
                _no_native(m)
            before = dict(vcf_writer.COUNTS)
            for suffix, extra in runs:
                vcf, col, state, rsid, kw, gw_mode = args
                run = _run_jax if way == "jax" else _run_port
                res.append(run(vcf, col, state, rsid, dict(kw, **extra),
                               gw_mode, str(d / ("o" + suffix))))
            counts = {k: vcf_writer.COUNTS[k] - before[k]
                      for k in vcf_writer.COUNTS}
        got[way] = (_files(str(d)), res, counts)
    return got


WRITER_CASES = ["multiallelic", "gt_forms", "format_without_gt",
                "field_counts", "existing_tags", "gw_phase_vcf_0",
                "gw_phase_vcf_1", "gw_phase_vcf_2", "contig_list",
                "empty_body", "block_boundary", "pos_ranges_body_only"]


@pytest.mark.parametrize("case", WRITER_CASES)
def test_native_writer_matches_python_and_phaser_tpu(tmp_path, monkeypatch,
                                                     case):
    rng = random.Random("vcf-writer-" + case)
    runs = (("", {}),)
    if case == "pos_ranges_body_only":
        args = _case(tmp_path, rng, "multiallelic")
        # two shards over each contig, the first writing the header file
        runs = tuple(
            ("s%d" % k, dict(pos_ranges={c: [((0, 4000), (9000, 20000)),
                                             ((4000, 9000), (20000, 10**9))][k]
                                         for c in ("chr1", "chr3")},
                             body_only=True, write_header_file=k == 0))
            for k in range(2))
    else:
        args = _case(tmp_path, rng, case)
    got = _all_ways(tmp_path, monkeypatch, args, runs)
    files, res, counts = got["native"]
    assert files == got["loop"][0] == got["jax"][0]
    assert res == got["loop"][1] == got["no_native"][1] == got["jax"][1]
    # without the library the compressor is zlib's, whose blocks may differ
    # from libdeflate's: the text is the same
    no_native = got["no_native"][0]
    assert sorted(no_native) == sorted(files)
    for name, data in files.items():
        if name.endswith(".gz"):
            assert bgzf.decompress_all(no_native[name]) == \
                bgzf.decompress_all(data), name
    py = got["loop"][2]
    assert got["no_native"][2] == py
    # the native path took the text: it wrote every body line the Python
    # loop wrote, and formatted only the phased ones in Python
    assert counts["lines_native"] + counts["lines_python"] == \
        py["lines_python"] and py["lines_native"] == 0
    phased = args[2]["haplotype_lookup"]
    n_phased = 0
    for name, data in files.items():
        if name.endswith(".vcf.gz") or name.endswith(".vcfbody.gz"):
            for line in bgzf.decompress_all(data).decode().splitlines():
                c = line.split("\t")
                n_phased += not line.startswith("#") and "_".join(
                    [c[0], c[1], c[3]] + c[4].split(",")) in phased
    assert counts["lines_python"] == n_phased
    if case != "empty_body":
        assert counts["lines_native"] > 0 and counts["lines_python"] > 0
    if case == "pos_ranges_body_only":
        assert sorted(files) == ["os0.vcfbody.gz", "os0.vcfhdr.gz",
                                 "os1.vcfbody.gz"]
    else:
        assert sorted(files) == ["o.vcf.gz", "o.vcf.gz.tbi"]
    if case == "block_boundary":
        text = bgzf.decompress_all(files["o.vcf.gz"])
        assert text[BLOCK - 1:BLOCK] == b"\n" and len(text) > BLOCK
        assert not text[BLOCK:].startswith(b"#")


def _index_text(rng, case):
    lines = _headers() if case != "no_header" else []
    contigs = ("chr1", "chr2", "chr10", "chrX") if case == "contigs" \
        else ("chr1",)
    for chrom in contigs:
        pos = 1
        for _ in range(rng.randint(1500, 3000) // len(contigs)):
            pos += rng.randint(0, 60 if case != "ref_windows" else 4000)
            ref = "A" * (rng.choice([1, 1, 3, 17000, 40000])
                         if case == "ref_windows" else rng.choice([1, 2]))
            lines.append("\t".join([chrom, str(pos), ".", ref, "G", "50",
                                    "PASS", "AC=1", "GT", "0|1"]))
            if case == "comments" and rng.random() < 0.02:
                lines.append(rng.choice(["#mid", ""]))
    return ("\n".join(lines) + ("\n" if case != "comments" else "")).encode()


@pytest.mark.parametrize("case", ["contigs", "ref_windows", "block_lines",
                                  "comments", "no_header"])
def test_vcf_index_from_text_matches_build_vcf_index(tmp_path, case):
    """Several contigs; REF spans across 16 KiB windows; lines across
    block boundaries; comment and empty lines in the body, no final
    newline; no header, so the first record starts at virtual offset 0,
    which the linear index treats as unset."""
    rng = random.Random("vcf-index-" + case)
    text = np.frombuffer(_index_text(rng, case), np.uint8)
    gz, csizes, usizes = bgzf.compress_sized(text)
    assert len(csizes) > 2 and gz == bgzf.compress_bytes(text)
    path = str(tmp_path / "x.vcf.gz")
    with open(path, "wb") as fh:
        fh.write(gz)
    tabix.build_vcf_index(path)
    raw = tabix.vcf_index_from_text(text, csizes, usizes)
    assert raw == bgzf.decompress_all(open(path + ".tbi", "rb").read())
    # lines that cross a block boundary are indexed
    nl = np.flatnonzero(text == 10)
    assert any(a // BLOCK != b // BLOCK for a, b in zip(nl, nl[1:]))
