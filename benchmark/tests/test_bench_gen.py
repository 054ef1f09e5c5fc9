"""The generator: the same seed gives the same files, and the BAM, BAI,
VCF and tabix index read back as the arrays they were written from, both
by the benchmark's own reader and by the port's decoder."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest

from conftest import small_config
from gen import make, readback

SEED = 2 ** 31 + 12345


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d))
            if f != "manifest.json"}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    cfg, mix = small_config("dna_rna_1kg", 0.01)
    out = {}
    for tag, seed in (("a", SEED), ("b", SEED), ("c", SEED + 1)):
        d = str(tmp_path_factory.mktemp("inputs_" + tag))
        out[tag] = (d, make.make(cfg, mix, seed, d, threads=2))
    donor, sets = make.inputs(cfg, mix, SEED)
    return cfg, mix, out, donor, sets


def test_same_seed_same_files(made):
    _, _, out, _, _ = made
    assert _digests(out["a"][0]) == _digests(out["b"][0])
    assert _digests(out["a"][0]) != _digests(out["c"][0])
    assert out["a"][1]["reads"] == out["c"][1]["reads"]


def test_counts_are_fixed_by_the_mix(made):
    cfg, mix, _, donor, sets = made
    assert len(donor.pos) == cfg["vcf"]["lines"]
    assert int((donor.gt[:, 0] != donor.gt[:, 1]).sum()) == \
        int(round(cfg["vcf"]["lines"] * cfg["vcf"]["het_share"]))
    for b, rs in zip(cfg["bams"], sets):
        assert len(rs) == mix["bams"][b["name"]]["reads"]
        nf = len(rs) // 2
        assert int(((rs.flag & 0x400) > 0).sum()) == \
            2 * int(round(nf * b["dup_share"]))
        assert np.all(np.diff(rs.pos) >= 0)


def test_bam_reads_back(made):
    cfg, _, out, _, sets = made
    d, man = out["a"]
    from phaser_tpu_torch.io import bam as port_bam
    for name, rs in zip(man["bams"], sets):
        path = os.path.join(d, name)
        refs, recs = readback.bam_records(path)
        assert refs == [n for n, _ in cfg["header_contigs"]]
        assert len(recs) == len(rs)
        names = rs.names()
        for i in np.linspace(0, len(rs) - 1, 200).astype(int):
            r = recs[i]
            assert r["pos"] == rs.pos[i] and r["flag"] == rs.flag[i]
            assert r["mapq"] == rs.mapq[i] and r["tlen"] == rs.tlen[i]
            assert r["mate_pos"] == rs.mate_pos[i]
            assert r["name"].encode() == names[i]
            assert r["cigar"] == rs.cigar[rs.cig_off[i]:
                                          rs.cig_off[i + 1]].tolist()
            assert r["seq"] == rs.seq[i].tolist()
            assert r["qual"] == rs.qual[i].tolist()
            assert r["aux"]["AS"] == rs.as_score[i]
        bd = port_bam.read_bam(path)
        assert np.array_equal(bd.pos, rs.pos)
        assert np.array_equal(bd.flag, rs.flag)
        assert np.array_equal(bd.mapq, rs.mapq)
        assert np.array_equal(bd.cigar_flat, rs.cigar)
        assert np.array_equal(bd.seq_flat, rs.seq.reshape(-1))
        assert np.array_equal(bd.qual_flat, rs.qual.reshape(-1))
        assert np.array_equal(bd.as_score, rs.as_score)
        assert list(bd.names) == names


def test_bai_matches_the_ports_index_and_reaches_every_read(made, tmp_path):
    cfg, _, out, _, sets = made
    d, man = out["a"]
    from phaser_tpu_torch.io.bam_index import BaiIndex
    from phaser_tpu_torch.io.tabix import build_bai_index
    tid = [n for n, _ in cfg["header_contigs"]].index(cfg["contig"])
    for name, rs in zip(man["bams"], sets):
        path = os.path.join(d, name)
        mine = BaiIndex.from_path(path + ".bai")
        theirs_path = str(tmp_path / (name + ".bai"))
        build_bai_index(path, theirs_path)
        theirs = BaiIndex.from_path(theirs_path)
        assert mine.bins[tid] == theirs.bins[tid]
        assert np.array_equal(mine.linear[tid], theirs.linear[tid])
        own = readback.bai(path + ".bai")[tid]
        lo, hi = int(rs.pos.min()), int(rs.end.max())
        for beg in np.linspace(lo, hi - 5000, 12).astype(int):
            chunks = readback.query(own, int(beg), int(beg) + 5000)
            assert chunks == sorted(chunks)
            assert mine.chunks_for_region(tid, int(beg), int(beg) + 5000)


def test_vcf_and_tabix_read_back(made):
    cfg, _, out, donor, _ = made
    d, man = out["a"]
    path = os.path.join(d, man["vcf"])
    from gen import bgzf
    assert bgzf.read(path).decode() == donor.vcf_text
    names, idx = readback.tbi(path + ".tbi")
    assert names == [n for n, _ in cfg["header_contigs"]]
    from phaser_tpu_torch.io.tabix import TabixFile
    tf = TabixFile(path)
    body = [x for x in donor.vcf_text.splitlines() if not x.startswith("#")]
    beg0 = np.array([int(x.split("\t")[1]) - 1 for x in body])
    end0 = beg0 + np.array([len(x.split("\t")[3]) for x in body])
    own = idx[names.index(cfg["contig"])]
    for beg in np.linspace(beg0[0], beg0[-1], 8).astype(int).tolist():
        end = beg + 3000
        want = [x for x, b, e in zip(body, beg0, end0) if b < end and e > beg]
        assert list(tf.fetch(cfg["contig"], beg, end)) == want
        assert readback.query(own, beg, end)
