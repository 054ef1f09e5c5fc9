"""The port's own copies of phaser_tpu's JAX-free modules (io, mapper.host,
engine host halves, dist helpers) against the originals: the same inputs
through both, byte or array equality.  One parametrised test per group.
And the port's public surface: every module's top-level public names
against phaser_tpu's."""

import ast
import dataclasses
import filecmp
import os
import shutil
import threading

import numpy as np
import pytest

import datagen
from phaser_tpu.dist import block_exchange as jax_block_exchange
from phaser_tpu.dist import engine_multihost as jax_multihost
from phaser_tpu.dist import shard_plan as jax_shard_plan
from phaser_tpu.engine import hits as jax_hits
from phaser_tpu.engine import row_exchange as jax_row_exchange
from phaser_tpu.engine import varmap as jax_varmap
from phaser_tpu.engine.output_stage import PhaserOptions as JaxOptions
from phaser_tpu.engine.pipeline import run_phaser as jax_run_phaser
from phaser_tpu.io import bam as jax_bam
from phaser_tpu.io import bam_index as jax_bam_index
from phaser_tpu.io import bed as jax_bed
from phaser_tpu.io import bgzf as jax_bgzf
from phaser_tpu.io import native as jax_native
from phaser_tpu.io import sam as jax_sam
from phaser_tpu.io import tabix as jax_tabix
from phaser_tpu.io import vcf as jax_vcf
from phaser_tpu.mapper import host as jax_host
from phaser_tpu.utils import fmt as jax_fmt
from phaser_tpu_torch.dist import block_exchange, engine_multihost, shard_plan
from phaser_tpu_torch.engine import hits, row_exchange, varmap
from phaser_tpu_torch.engine.output_stage import PhaserOptions
from phaser_tpu_torch.engine.pipeline import run_phaser
from phaser_tpu_torch.io import bam, bam_index, bed, bgzf, native, sam, tabix
from phaser_tpu_torch.io import vcf
from phaser_tpu_torch.mapper import host
from phaser_tpu_torch.testing import datagen as port_datagen
from phaser_tpu_torch.utils import fmt

PORT = dict(bam=bam, bam_index=bam_index, bed=bed, bgzf=bgzf, sam=sam,
            tabix=tabix, vcf=vcf, host=host, varmap=varmap, hits=hits,
            row_exchange=row_exchange)
JAX = dict(bam=jax_bam, bam_index=jax_bam_index, bed=jax_bed, bgzf=jax_bgzf,
           sam=jax_sam, tabix=jax_tabix, vcf=jax_vcf, host=jax_host,
           varmap=jax_varmap, hits=jax_hits, row_exchange=jax_row_exchange)

GEN = dict(seed=23, contigs=("chr20", "chr21"), contig_len=20000,
           n_variants_per_contig=90, n_reads_per_contig=800,
           include_indel_variants=True, frac_indel_reads=0.15,
           frac_multiallelic=0.1, frac_spliced=0.2)


# fields the port's copies add to phaser_tpu's classes: the allele
# dispatcher's span summary, written by the port's native BAM decode (held
# against a walk over the CIGARs in tests/test_torch_ragged.py)
PORT_ONLY_FIELDS = {"BamData": ("span_end", "span_flags")}


def same(a, b, where="value"):
    """Deep equality of what the two packages return: arrays by value and
    dtype, dataclasses and plain objects field by field (class names must
    match, the classes themselves are each package's own; the port's own
    fields, PORT_ONLY_FIELDS, aside)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            same(a[k], b[k], "%s[%r]" % (where, k))
    elif isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), \
            (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, "%s[%d]" % (where, i))
    elif dataclasses.is_dataclass(a) or hasattr(a, "__slots__") or \
            (hasattr(a, "__dict__") and not callable(a)):
        assert type(a).__name__ == type(b).__name__, where
        if hasattr(a, "__slots__"):
            va, vb = ({k: getattr(o, k) for k in type(o).__slots__}
                      for o in (a, b))
        else:
            va, vb = vars(a), vars(b)
        extra = PORT_ONLY_FIELDS.get(type(a).__name__, ())
        va, vb = ({k: v for k, v in o.items() if k not in extra}
                  for o in (va, vb))
        assert sorted(va) == sorted(vb), where
        for k in va:
            same(va[k], vb[k], "%s.%s" % (where, k))
    elif isinstance(a, float) and a != a:
        assert b != b, where
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("copies"))
    vcf_path, bam_path, data = datagen.write_fixture_dir(d, **GEN)
    return dict(dir=d, vcf=vcf_path, bam=bam_path, sample=data.sample)


def _both(fn):
    return fn(PORT), fn(JAX)


# ---------------------------------------------------------------------------
# io

def _io_fixture_files(fx, tmp_path):
    """The port's datagen (its own bgzf, tabix, BAM writer, BAI indexer)
    writes the same bytes as tests/datagen.py on phaser_tpu's."""
    d = str(tmp_path / "port")
    os.makedirs(d)
    port_datagen.write_fixture_dir(d, **GEN)
    names = sorted(os.listdir(fx["dir"]))
    assert names == sorted(os.listdir(d)) and len(names) >= 3, names
    for n in names:
        assert filecmp.cmp(os.path.join(fx["dir"], n), os.path.join(d, n),
                           shallow=False), n


def _io_bgzf(fx, tmp_path):
    rng = np.random.default_rng(3)
    text = b"".join(b"chr%d\t%d\tA\tG\n" % (i % 5, i) for i in range(30000))
    for data in (b"", b"x" * 100, text,
                 rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()):
        got, want = _both(lambda m: m["bgzf"].compress_bytes(data))
        assert got == want
        assert bgzf.block_offsets(got) == jax_bgzf.block_offsets(want)
        assert bgzf.decompress_all(got) == jax_bgzf.decompress_all(want) \
            == data
        assert bgzf.compress_block(data[:60000]) == \
            jax_bgzf.compress_block(data[:60000])
    paths = []
    for tag, m in (("port", bgzf), ("jax", jax_bgzf)):
        p = str(tmp_path / (tag + ".gz"))
        with m.BgzfWriter(p) as w:
            for k in range(0, len(text), 7001):
                w.write(text[k:k + 7001])
        assert m.is_bgzf(p) and m.read_text_auto(p) == text
        paths.append(p)
    assert filecmp.cmp(*paths, shallow=False)
    r, jr = bgzf.BgzfReader(paths[0]), jax_bgzf.BgzfReader(paths[1])
    assert r.read(100_000) == jr.read(100_000) == text[:100_000]
    assert r.tell_virtual() == jr.tell_virtual()


def _io_tabix(fx, tmp_path):
    outs = []
    for tag, m in (("port", tabix), ("jax", jax_tabix)):
        gz = str(tmp_path / (tag + ".vcf.gz"))
        shutil.copy(fx["vcf"], gz)
        m.build_vcf_index(gz)
        m.build_csi_index(gz)
        tf = m.TabixFile(gz)
        rows = [list(tf.fetch(c, beg, beg + 4000))
                for c in GEN["contigs"] for beg in (0, 5000, 12000)]
        assert sum(map(len, rows)) > 20
        outs.append((open(gz + ".tbi", "rb").read(),
                     open(gz + ".csi", "rb").read(), rows))
    same(outs[0], outs[1])


def _io_bam_read(fx, tmp_path):
    for kw in (dict(), dict(native=False)):
        got, want = _both(lambda m: m["bam"].read_bam(fx["bam"], **kw))
        assert len(got) > 1000
        same(got, want)
    sel = np.arange(0, 900, 7)
    got, want = _both(lambda m: m["bam"].read_bam(fx["bam"]).select(sel))
    same(got, want)
    same(*_both(lambda m: [m["bam"].record_to_sam_line(
        m["bam"].read_bam(fx["bam"]), i) for i in range(0, 300, 11)]))
    same(*_both(lambda m: [w for w in m["bam"].iter_bam_stream(
        fx["bam"], window_bytes=1 << 16)]))


def _io_bam_index(fx, tmp_path):
    outs = []
    for tag, m in (("port", PORT), ("jax", JAX)):
        b = str(tmp_path / (tag + ".bam"))
        shutil.copy(fx["bam"], b)
        m["tabix"].build_bai_index(b)
        m["tabix"].build_csi_bam_index(b)
        raw = (open(b + ".bai", "rb").read(), open(b + ".csi", "rb").read())
        res = []
        for idx_path in (b + ".bai", b + ".csi"):
            bai = m["bam_index"].BaiIndex.from_path(idx_path)
            for tid in (0, 1):
                res.append(bai.chunks_for_region(tid, 2000, 9000))
                res.append(bai.start_voff(tid, 5000))
                res.append(bai.contig_coffset_span(tid))
                beg = np.array([100, 4000, 4100, 15000], np.int64)
                vr = m["bam_index"].plan_site_ranges(bai, tid, beg, beg + 1)
                res.append(vr)
                res.append(m["bam_index"].read_bam_voffset_ranges(b, vr))
        res.append(m["bam_index"].read_bam_header_meta(b))
        outs.append((raw, res))
    same(outs[0], outs[1])


def _io_vcf(fx, tmp_path):
    def read(m):
        col = m["vcf"].sample_column_map(fx["vcf"])
        lines = [l for l in m["vcf"].het_filtered_lines(
            fx["vcf"], col[fx["sample"]]) if not l.startswith("#")]
        hs = m["vcf"].parse_het_sites(lines, "", ["_", ":"], True)
        cut = [m["vcf"].cut_columns(l, 9) for l in lines[:20]]
        return col, lines, hs, cut, list(m["vcf"].iter_vcf_lines(fx["vcf"],
                                                                 "chr21"))
    got, want = _both(read)
    assert len(got[1]) > 50
    same(got, want)


def _io_sam_bed(fx, tmp_path):
    def read(m):
        bd = m["bam"].read_bam(fx["bam"])
        lines = [m["bam"].record_to_sam_line(bd, i) for i in range(400)]
        return m["sam"].parse_sam(lines)
    same(*_both(read))
    p = str(tmp_path / "x.bed")
    with open(p, "w") as fh:
        fh.write("chr20\t100\t900\nchr20\t800\t1500\nchr21\t5\t50\n")
    got, want = bed.IntervalSet.from_bed(p), jax_bed.IntervalSet.from_bed(p)
    same(got, want)
    q = np.array([0, 850, 1499, 1500, 40], np.int64)
    for c in ("chr20", "chr21", "x"):
        np.testing.assert_array_equal(got.overlaps(c, q, q + 1),
                                      want.overlaps(c, q, q + 1))


IO_CASES = {"fixture_files": _io_fixture_files, "bgzf": _io_bgzf,
            "tabix": _io_tabix, "bam_read": _io_bam_read,
            "bam_index": _io_bam_index, "vcf": _io_vcf,
            "sam_bed": _io_sam_bed}


@pytest.mark.parametrize("case", sorted(IO_CASES))
def test_io_copy_matches_phaser_tpu(fx, tmp_path, case):
    IO_CASES[case](fx, tmp_path)


# ---------------------------------------------------------------------------
# mapper.host

def _contig_inputs(m, fx, contig="chr20", include_indels=True):
    col = m["vcf"].sample_column_map(fx["vcf"])[fx["sample"]]
    lines = [l for l in m["vcf"].het_filtered_lines(fx["vcf"], col)
             if not l.startswith("#")]
    hs = m["vcf"].parse_het_sites(lines, "", ["_", ":"], True)
    vt = m["varmap"].build_variant_table(contig, hs.pool[contig],
                                         include_indels=include_indels)
    bd = m["bam"].read_bam(fx["bam"])
    tid = bd.ref_names.index(contig)
    return bd.select((bd.refid == tid) & ((bd.flag & 0x404) == 0)), vt


@pytest.mark.parametrize("native_lib", [True, False])
@pytest.mark.parametrize("kw", [dict(), dict(splice=False),
                                dict(isize_cutoff=300)])
def test_host_mapper_copy_matches_phaser_tpu(fx, monkeypatch, native_lib, kw):
    """mapper.host.assign_alleles (and expand_refpos), with the native
    library and on the pure-Python path."""
    if not native_lib:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None

    def run(m):
        bd, vt = _contig_inputs(m, fx)
        return (m["host"].assign_alleles(bd, vt, baseq=10, **kw),
                m["host"].expand_refpos(bd))
    got, want = _both(run)
    assert len(got[0]) > 100 and got[0].allele_strs
    same(got, want)


# ---------------------------------------------------------------------------
# engine host halves

def _engine_varmap(fx, tmp_path):
    for indels in (True, False):
        got, want = _both(lambda m: _contig_inputs(
            m, fx, "chr21", include_indels=indels)[1])
        assert len(got) > 30
        same(got, want)


def _engine_hits(fx, tmp_path):
    def run(m):
        bd, vt = _contig_inputs(m, fx)
        found = m["host"].assign_alleles(bd, vt, baseq=10)
        rows = m["hits"].build_contig_rows(vt, [(0, bd, found)], {0: None},
                                           {0: 0})
        vr = m["hits"].build_variant_reads(rows, [])
        chunk, back = m["row_exchange"].unbundle_entry(
            m["row_exchange"].bundle_entry(bd, found))
        return (m["hits"].classify_alleles(found, vt), rows, vr,
                m["hits"].noise_terms(vr), chunk, back)
    same(*_both(run))


def _engine_fmt(fx, tmp_path):
    vals = [0.5, 1.0, 1e-12, 3, "x", float("nan"), np.float64(0.1 + 0.2)]
    assert fmt.str_join("\t", vals) == jax_fmt.str_join("\t", vals)
    assert fmt.list_to_string(vals) == jax_fmt.list_to_string(vals)
    assert [fmt.pystr(v) for v in vals] == [jax_fmt.pystr(v) for v in vals]


def _engine_outputs(fx, tmp_path):
    """Every writer (output_stage, vcf_writer with genome-wide phasing,
    read ids, the network files) through the two engines' host paths."""
    kw = dict(gw_phase_vcf=1, output_read_ids=1, include_indels=1)
    run = dict(vcf=fx["vcf"], bam=fx["bam"], sample=fx["sample"], mapq="10",
               baseq=10, paired_end="1", device="host", log=lambda *a: None)
    run_phaser(o=str(tmp_path / "port"), opts=PhaserOptions(**kw), **run)
    jax_run_phaser(o=str(tmp_path / "jax"), opts=JaxOptions(**kw), **run)
    names = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("port."))
    assert len(names) >= 7, names
    for n in names:
        assert filecmp.cmp(str(tmp_path / n),
                           str(tmp_path / ("jax" + n[4:])), shallow=False), n


ENGINE_CASES = {"varmap": _engine_varmap, "hits_rows": _engine_hits,
                "fmt": _engine_fmt, "output_files": _engine_outputs}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_copy_matches_phaser_tpu(fx, tmp_path, case):
    ENGINE_CASES[case](fx, tmp_path)


# ---------------------------------------------------------------------------
# dist

def _as_percentile(base_cls, parts, q):
    """as_percentile of `base_cls` over the shards' scores `parts`, the
    shards running in threads over one in-process allgather."""
    reducers = []
    for sid, scores in enumerate(parts):
        r = base_cls()
        r.shard_id, r.n_shards, r.rank_of = sid, len(parts), {}
        reducers.append(r)
    # run the shards in lock step: each collective gathers the payload that
    # every shard sends at that step
    barrier = threading.Barrier(len(parts))
    slot = [None] * len(parts)
    out = [None] * len(parts)

    def gather(sid):
        def _allgather(payload):
            slot[sid] = payload
            barrier.wait()
            got = list(slot)
            barrier.wait()
            return got
        return _allgather

    def work(sid):
        reducers[sid]._allgather = gather(sid)
        out[sid] = reducers[sid].as_percentile(parts[sid], q)
    ts = [threading.Thread(target=work, args=(s,)) for s in range(len(parts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert len(set(out)) == 1
    return out[0]


def _dist_shard_plan(fx, tmp_path):
    contigs = list(GEN["contigs"])
    for n in (1, 2, 3, 5):
        got = shard_plan.plan_shards(fx["bam"], contigs, n)
        want = jax_shard_plan.plan_shards(fx["bam"], contigs, n)
        assert len(got) == n
        same(got, want)
    assert engine_multihost.split_contigs(list("abcde"), 3) == \
        jax_multihost.split_contigs(list("abcde"), 3)
    assert engine_multihost.EMPTY_SHARD == jax_multihost.EMPTY_SHARD


def _dist_reducer(fx, tmp_path):
    rng = np.random.default_rng(9)
    for n in (50, 30_000):
        parts = [rng.normal(100, 20, n).round(1), rng.normal(90, 5, n // 3),
                 np.zeros(0)]
        for q in (5.0, 50.0, 99.9):
            got = _as_percentile(engine_multihost._ReducerBase, parts, q)
            want = _as_percentile(jax_multihost._ReducerBase, parts, q)
            assert got == want == float(np.percentile(
                np.concatenate(parts), q))


def _dist_block_exchange(fx, tmp_path):
    assert [block_exchange.delegate_of(i, 3) for i in range(10)] == \
        [jax_block_exchange.delegate_of(i, 3) for i in range(10)]
    assert block_exchange.balance_blocks_enabled() == \
        jax_block_exchange.balance_blocks_enabled()


def _dist_merge(fx, tmp_path, monkeypatch):
    """merge_shard_outputs on the same shard files: the port's sharded run
    leaves its per-shard files (merge stubbed out), then each package's
    merge assembles a copy of them."""
    monkeypatch.setattr(engine_multihost, "merge_shard_outputs",
                        lambda *a, **k: None)
    d = tmp_path / "shards"
    d.mkdir()
    engine_multihost.run_phaser_sharded_threads(
        n_shards=3, vcf=fx["vcf"], bam=fx["bam"], sample=fx["sample"],
        o=str(d / "out"), mapq="10", baseq=10, paired_end="1",
        device="host", position_shards=True, log=lambda *a: None)
    monkeypatch.undo()
    assert len(os.listdir(str(d))) > 12
    for tag in ("port", "jax"):
        shutil.copytree(str(d), str(tmp_path / tag))
    engine_multihost.merge_shard_outputs(str(tmp_path / "port" / "out"), 3,
                                         PhaserOptions())
    jax_multihost.merge_shard_outputs(str(tmp_path / "jax" / "out"), 3,
                                      JaxOptions())
    names = sorted(os.listdir(str(tmp_path / "port")))
    assert names == sorted(os.listdir(str(tmp_path / "jax")))
    assert "out.vcf.gz" in names and not [n for n in names if "shard" in n]
    for n in names:
        assert filecmp.cmp(str(tmp_path / "port" / n),
                           str(tmp_path / "jax" / n), shallow=False), n


DIST_CASES = {"shard_plan": _dist_shard_plan, "reducer": _dist_reducer,
              "block_exchange": _dist_block_exchange}


@pytest.mark.parametrize("case", sorted(DIST_CASES) + ["merge"])
def test_dist_copy_matches_phaser_tpu(fx, tmp_path, monkeypatch, case):
    if case == "merge":
        _dist_merge(fx, tmp_path, monkeypatch)
    else:
        DIST_CASES[case](fx, tmp_path)


# ---------------------------------------------------------------------------
# the public surface: phaser_tpu's top-level public names that the port
# leaves out on purpose.  The windowed fused programs and their planners
# gave way to range joins that take no window (kernels/alleles.py); JAX's
# compile cache has utils/build.py in its place; `device_section`, which
# timed host-clock sections as device time, had no caller in the port (its
# device seconds come from DeviceClock, its sections are spans).

INTENDED_MISSING = {
    "kernels/alleles.py": [
        "assign_compact_affine_nibble_windowed",
        "assign_compact_delta_nibble_windowed",
        "assign_compact_plane_windowed", "plan_windows_affine",
        "plan_windows_minmax"],
    "utils/jaxtune.py": "module",
    "utils/trace.py": ["device_section"],
}


def _public_names(path):
    """Names a module defines at its top level (functions, classes,
    assignments; not imports) that do not start with an underscore."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_public_names_match_phaser_tpu():
    """An ast walk over both packages: each phaser_tpu module has its
    counterpart at the same path in the port, with every public name,
    apart from INTENDED_MISSING."""
    import phaser_tpu
    import phaser_tpu_torch
    jax_root = os.path.dirname(phaser_tpu.__file__)
    port_root = os.path.dirname(phaser_tpu_torch.__file__)
    missing = {}
    for root, _, files in os.walk(jax_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), jax_root)
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                missing[rel] = "module"
                continue
            gone = _public_names(os.path.join(root, f)) - _public_names(port)
            if gone:
                missing[rel] = sorted(gone)
    assert missing == INTENDED_MISSING
