"""The dispatcher's pre-filter, hit fetch and staging (phaser_tpu_torch
mapper/dispatch.py) on the CPU: device="cpu" drives the same dispatcher
through the kernels' plain versions.

Before any per-read work the device side drops every read whose reference
span [pos + 1, pos + sum of all CIGAR op lengths] holds no device-eligible
variant.  Hits are integers, tolerance 0: the port's ContigHits must equal
its own host mapper's and phaser_tpu's assign_alleles_auto(device="host"),
on hand-built reads (sequences and qualities from a numpy seed) and on
tests/datagen.py fixtures, with the native span pass and with numpy.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import datagen
from phaser_tpu.engine import varmap as jax_varmap
from phaser_tpu.io import bam as jax_bamio
from phaser_tpu.io import vcf as jax_vcfio
from phaser_tpu.mapper import dispatch as jax_dispatch
from phaser_tpu_torch.engine import varmap
from phaser_tpu_torch.io import bam as bamio
from phaser_tpu_torch.io import native
from phaser_tpu_torch.io import vcf as vcfio
from phaser_tpu_torch.kernels import alleles as K
from phaser_tpu_torch.mapper import dispatch as D

M, I, DEL, N, S, H = 0, 1, 2, 3, 4, 5
CONTIG = 20_000


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    D.reset_stats()


def _records(reads, seed):
    """BamRecords from (pos0, cigar[, tlen]) with bases and qualities drawn
    from a numpy seed; qualities straddle baseq = 10."""
    rng = np.random.default_rng(seed)
    out = []
    for k, rd in enumerate(reads):
        pos0, cigar = rd[0], rd[1]
        tlen = rd[2] if len(rd) > 2 else 0
        n = sum(ln for ln, op in cigar if op in (M, I, S, 7, 8))
        seq = "".join(rng.choice(list("ACGT"), size=n))
        qual = rng.choice([5, 20, 30, 40], size=n, p=[.1, .3, .3, .3])
        out.append(bamio.BamRecord(
            name="r%d" % k, refid=0, pos=pos0, mapq=60, flag=0,
            cigar=cigar, seq=seq, qual=[int(q) for q in qual], tlen=tlen))
    return out


def _vcf_rows(variants):
    """Rows as io.vcf.parse_het_sites gives them: (pos1, ref, alt)."""
    return [["chr20", str(p), ".", ref, alt, ".", "PASS", ".", "GT", "0|1",
             ["0", "1"]] for p, ref, alt in variants]


def _case(tmp_path, reads, variants, seed=3):
    """(bd, vt) of the port and a `want(**kw)` that runs phaser_tpu's host
    dispatcher on its own objects from the same BAM file and rows."""
    order = sorted(range(len(reads)), key=lambda k: reads[k][0])
    reads = [reads[k] for k in order]
    bam = str(tmp_path / "reads.bam")
    bamio.write_bam(bam, ["chr20"], [CONTIG], _records(reads, seed))
    rows = _vcf_rows(sorted(variants))
    vt = varmap.build_variant_table("chr20", rows, include_indels=True)
    jvt = jax_varmap.build_variant_table("chr20", rows, include_indels=True)
    bd, jbd = bamio.read_bam(bam), jax_bamio.read_bam(bam)
    assert len(bd) == len(reads)

    def want(**kw):
        return jax_dispatch.assign_alleles_auto(jbd, jvt, baseq=10,
                                                device="host", **kw)
    return bd, vt, want


def _same(got, want):
    np.testing.assert_array_equal(got.read_idx, want.read_idx)
    np.testing.assert_array_equal(got.var_idx, want.var_idx)
    np.testing.assert_array_equal(got.allele_code, want.allele_code)
    assert got.allele_strs == want.allele_strs


def _check(bd, vt, want, **kw):
    """cpu dispatcher == the port's host mapper == phaser_tpu's, with the
    native span pass and with numpy.  Returns the hits and the stats of
    the native run."""
    w = want(**kw)
    _same(D.assign_alleles_auto(bd, vt, baseq=10, device="host", **kw), w)
    D.reset_stats()
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu", **kw)
    stats = dict(D.STATS)
    _same(got, w)
    real = native.get_lib()

    class NoSpans:
        def __getattr__(self, name):
            if name in ("read_spans_native", "near_sorted_native"):
                raise AttributeError(name)
            return getattr(real, name)
    orig = native.get_lib
    native.get_lib = lambda: NoSpans()
    try:
        D.reset_stats()
        _same(D.assign_alleles_auto(bd, vt, baseq=10, device="cpu", **kw), w)
        assert dict(D.STATS) == stats
    finally:
        native.get_lib = orig
    assert stats["rows_kept"] + stats["rows_dropped"] == stats["rows_in"]
    return got, stats


# variant positions are 1-based, read positions 0-based: a read at pos0 with
# 50M covers 1-based positions pos0 + 1 .. pos0 + 50
EDGE_CASES = {
    "first_and_last_base": dict(
        reads=[(999, [(50, M)]), (1050, [(50, M)]), (3000, [(50, M)])],
        variants=[(1000, "A", "G"), (1049, "C", "T"), (1100, "G", "A")],
        kept=2, hits=3),
    "just_outside": dict(
        # variants one base before the first and one after the last base
        reads=[(1000, [(50, M)])],
        variants=[(1000, "A", "G"), (1051, "C", "T"), (5000, "C", "T")],
        kept=0, hits=0),
    "intron_holds_the_only_variant": dict(
        # kept (the span is conservative) but no hit: the variant lies in N
        reads=[(1000, [(20, M), (500, N), (30, M)])],
        variants=[(1200, "A", "G")], kept=1, hits=0),
    "spliced_hits_both_exons": dict(
        reads=[(1000, [(20, M), (500, N), (30, M)])],
        variants=[(1020, "A", "G"), (1521, "C", "T"), (1551, "C", "T")],
        kept=1, hits=2),
    "deletion_spans_the_variant": dict(
        reads=[(1000, [(20, M), (5, DEL), (30, M)])],
        variants=[(1022, "A", "G"), (1026, "C", "T"), (1055, "G", "C")],
        kept=1, hits=2),
    "soft_clipped_ends": dict(
        # 10S40M5S at pos0 2000: aligned 2001..2040; the clips add 15 to
        # the span's end, so the variant at 2050 keeps the read, hitless
        reads=[(2000, [(10, S), (40, M), (5, S)]),
               (4000, [(3, H), (10, S), (40, M)])],
        variants=[(2001, "A", "G"), (2040, "C", "T"), (2050, "C", "T"),
                  (3995, "A", "C"), (4041, "A", "C")],
        kept=2, hits=2),
    "insertion_reads_go_to_the_host": dict(
        reads=[(1000, [(20, M), (3, I), (27, M)]), (1010, [(50, M)])],
        variants=[(1015, "A", "G"), (1040, "C", "T")],
        kept=1, hits=4, rows_in=1),
    "duplicate_and_multibase_variants": dict(
        # host remainders: the duplicate pair and the deletion allele never
        # reach the device side, so only the SNP at 1030 counts as `near`
        reads=[(1000, [(50, M)]), (1200, [(50, M)]), (1400, [(50, M)])],
        variants=[(1010, "A", "G"), (1010, "A", "T"), (1030, "C", "T"),
                  (1220, "ACG", "A"), (1420, "G", "GTT")],
        kept=1, hits=None),
    "no_read_kept": dict(
        reads=[(100 * k, [(50, M)]) for k in range(1, 40)],
        variants=[(9000, "A", "G"), (9500, "C", "T")], kept=0, hits=0),
    "every_read_kept": dict(
        reads=[(1000 + k, [(50, M)]) for k in range(40)],
        variants=[(1045, "A", "G")], kept=40, hits=None),
    "empty_cigar": dict(
        # a read without CIGAR ops (unaligned payload) between two others:
        # its span is empty and its neighbours' sums stay their own
        reads=[(1000, [(50, M)]), (1001, []), (1002, [(50, M)])],
        variants=[(1001, "A", "G"), (1051, "C", "T"), (1052, "C", "T")],
        kept=2, hits=None),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_prefilter_edge_cases(tmp_path, name):
    case = EDGE_CASES[name]
    bd, vt, want = _case(tmp_path, case["reads"], case["variants"])
    got, stats = _check(bd, vt, want)
    assert stats["rows_kept"] == case["kept"], stats
    assert stats["rows_in"] == case.get("rows_in", len(bd)), stats
    if case["hits"] is not None:
        assert len(got) <= case["hits"]      # low-quality bases drop out
        if case["hits"] == 0:
            assert len(got) == 0
    if case["kept"] and case["hits"] != 0:
        assert len(got) > 0


def test_no_launch_with_zero_rows(tmp_path, monkeypatch):
    """When the pre-filter keeps nothing, no packer and no program runs."""
    case = EDGE_CASES["no_read_kept"]
    bd, vt, want = _case(tmp_path, case["reads"], case["variants"])

    def refuse(*a, **k):
        raise AssertionError("device-side work for zero rows")
    for name in ("pack_affine_nibble", "pack_affine_masked", "pack_reads",
                 "pack_delta_nibble", "assign_compact_affine_nibble",
                 "assign_compact_plane", "assign_compact_ragged",
                 "padded_table"):
        monkeypatch.setattr(K, name, refuse)
    monkeypatch.setattr(D, "_stage_reads", refuse)
    pend = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu", defer=True)
    assert pend._dev == []
    _same(pend.resolve(), want())


@pytest.mark.parametrize("kw", [dict(isize_cutoff=300), dict(splice=False)])
def test_prefilter_with_read_filters(tmp_path, kw):
    """isize_cutoff and splice=False take reads off the device side before
    the span test; rows_in counts what is left."""
    reads = [(1000, [(50, M)], 200), (1005, [(50, M)], 900),
             (1010, [(20, M), (300, N), (30, M)], 100),
             (1350, [(50, M)], -250), (1360, [(50, M)], -301)]
    variants = [(1015, "A", "G"), (1340, "C", "T"), (1380, "G", "A")]
    bd, vt, want = _case(tmp_path, reads, variants)
    _, stats = _check(bd, vt, want, **kw)
    assert stats["rows_in"] == (3 if "isize_cutoff" in kw else 4), stats
    assert stats["rows_kept"] == stats["rows_in"]


FIXTURES = {
    "sparse": dict(seed=71, contigs=("chr20",), contig_len=120000,
                   n_variants_per_contig=25, n_reads_per_contig=3000,
                   frac_spliced=0.3, frac_indel_reads=0.2, error_rate=0.01),
    "dense_indel": dict(seed=72, contigs=("chr20",), contig_len=15000,
                        n_variants_per_contig=90, n_reads_per_contig=900,
                        include_indel_variants=True, frac_indel_reads=0.25,
                        frac_multiallelic=0.15, frac_spliced=0.2),
}


def _datagen_case(tmp_path, name):
    vcf, bam, _ = datagen.write_fixture_dir(str(tmp_path), **FIXTURES[name])

    def read(vcfio, varmap, bamio):
        lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
                 if not l.startswith("#")]
        hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
        vt = varmap.build_variant_table("chr20", hs.pool["chr20"],
                                        include_indels=True)
        bd = bamio.read_bam(bam)
        return bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0)), vt
    bd, vt = read(vcfio, varmap, bamio)
    jbd, jvt = read(jax_vcfio, jax_varmap, jax_bamio)
    return bd, vt, lambda **kw: jax_dispatch.assign_alleles_auto(
        jbd, jvt, baseq=10, device="host", **kw)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("kw", [dict(), dict(isize_cutoff=400),
                                dict(splice=False)])
def test_prefilter_on_datagen_fixtures(tmp_path, name, kw):
    bd, vt, want = _datagen_case(tmp_path, name)
    got, stats = _check(bd, vt, want, **kw)
    assert len(got) > 20
    if name == "sparse":
        # most reads reach no variant and never get packed
        assert 0 < stats["rows_kept"] < stats["rows_in"] // 2, stats
    else:
        assert stats["rows_dropped"] < stats["rows_in"], stats


def test_packers_see_only_kept_rows(tmp_path, monkeypatch):
    """The device side gathers the kept reads' bytes and nothing else: one
    gather of exactly the kept rows, in the kernel's ragged layout."""
    bd, vt, want = _datagen_case(tmp_path, "sparse")
    seen = []
    stage = D._stage_reads
    monkeypatch.setattr(D, "_stage_reads",
                        lambda b, rows, *a: seen.append(rows.copy()) or
                        stage(b, rows, *a))
    selected = []
    select = bamio.BamData.select
    monkeypatch.setattr(bamio.BamData, "select",
                        lambda self, idx, **k: selected.append(len(idx)) or
                        select(self, idx, **k))
    D.reset_stats()
    _same(D.assign_alleles_auto(bd, vt, baseq=10, device="cpu"), want())
    selected = list(selected)
    assert [len(r) for r in seen] == [D.STATS["rows_kept"]]
    assert 0 < len(seen[0]) < len(bd) // 2
    has_ins, _, near = D._read_spans(bd, vt.pos[vt.is_simple])
    np.testing.assert_array_equal(seen[0], np.flatnonzero(near & ~has_ins))
    # the staged arrays are those reads' own bytes, as BAM decode holds them
    pos, co, cig, so, seq, qual = stage(bd, seen[0], torch.device("cpu"),
                                        None)
    sub = bd.select(seen[0])
    np.testing.assert_array_equal(pos.numpy(), sub.pos)
    np.testing.assert_array_equal(co.numpy(), sub.cigar_off)
    np.testing.assert_array_equal(cig.numpy().view(np.uint32),
                                  sub.cigar_flat)
    np.testing.assert_array_equal(so.numpy(), sub.seq_off)
    np.testing.assert_array_equal(seq.numpy(), sub.seq_flat)
    np.testing.assert_array_equal(qual.numpy(), sub.qual_flat)
    # the kept reads are gathered by index: the only selected copies are
    # the host remainders' (insertion reads, and the host mapper's own)
    assert selected and max(selected) <= int(has_ins.sum())


@pytest.mark.parametrize("packer", ["pack_reads", "pack_affine_nibble",
                                    "pack_affine_masked",
                                    "pack_delta_nibble"])
def test_packers_take_rows(tmp_path, packer):
    """A packer given `rows` fills row i from read rows[i]: the planes of
    the gathered reads, without the gather (also rows out of order)."""
    bd, _, _ = _datagen_case(tmp_path, "dense_indel")
    rng = np.random.default_rng(9)
    rows = rng.permutation(len(bd))[:len(bd) // 3]
    args = () if packer == "pack_reads" else (10,)
    got = getattr(K, packer)(bd, *args, rows=rows)
    want = getattr(K, packer)(bd.select(rows), *args)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == len(rows)


def test_read_spans_native_equals_numpy(tmp_path, monkeypatch):
    bd, vt, _ = _datagen_case(tmp_path, "dense_indel")
    dev_pos = np.unique(vt.pos)[::3]
    nat = D._read_spans(bd, dev_pos)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    ref = D._read_spans(bd, dev_pos)
    for a, b in zip(nat, ref):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)
    assert nat[0].any() and nat[1].any() and 0 < nat[2].sum() < len(bd)
    # the masks equal a walk over each read's ops
    for r in range(0, len(bd), 37):
        ops = bd.cigar_flat[bd.cigar_off[r]:bd.cigar_off[r + 1]] & 0xF
        assert nat[0][r] == (ops == I).any() and nat[1][r] == (ops == N).any()


_op = st.sampled_from([M, M, M, I, DEL, N, S])


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.tuples(
    st.integers(0, 600),
    st.lists(st.tuples(st.integers(1, 40), _op), min_size=1, max_size=6)),
    min_size=1, max_size=12),
    st.lists(st.integers(1, 900), min_size=1, max_size=25, unique=True),
    st.integers(0, 2 ** 31))
def test_span_never_drops_a_read_with_a_hit(tmp_path_factory, reads, vpos,
                                            seed):
    """The conservative span end never drops a read the host mapper gives
    a hit on a device-eligible variant."""
    reads = [(p, c) for p, c in reads
             if any(op in (M, I, S) for _, op in c)]
    if not reads:
        return
    tmp = tmp_path_factory.mktemp("hyp")
    variants = [(p, "A", "G") for p in vpos]
    bd, vt, want = _case(tmp, reads, variants, seed=seed)
    w = want()
    has_ins, _, near = D._read_spans(bd, vt.pos)
    hit_reads = np.unique(w.read_idx)
    assert near[hit_reads[~has_ins[hit_reads]]].all()
    _same(D.assign_alleles_auto(bd, vt, baseq=10, device="cpu"), w)


def _packed(cap, n_hits, rng):
    """A packed-hit buffer as a program leaves it: n_hits exact, the first
    min(n_hits, cap) slots filled, the rest -1."""
    out = np.full((2, cap + 1), -1, np.int32)
    out[0, 0] = n_hits
    k = min(n_hits, cap)
    out[0, 1:1 + k] = rng.integers(0, 5, k)
    out[1, 1:1 + k] = (rng.integers(0, 7, k) << 8) | (2 << 4) | 1
    return torch.from_numpy(out)


@pytest.mark.parametrize("n_hits", [0, 3, 8, 11])
@pytest.mark.parametrize("many", [False, True])
def test_fetch_copies_only_filled_columns(n_hits, many):
    """resolve / resolve_all with n_hits of 0, below, equal to and above the
    capacity of 8: only min(n_hits, cap) + 1 columns come back, the hits
    decode as from the whole buffer, and overflow takes the relaunch."""
    rng = np.random.default_rng(n_hits)
    cap = 8
    packed = _packed(cap, n_hits, rng)
    row_map = np.arange(100, 105)
    dev_vidx = np.arange(50, 57)
    relaunched = []
    sentinel = D.ContigHits(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.int16))

    def pending():
        return D.PendingHits(
            lambda: relaunched.append(1) or sentinel,
            [(packed, cap, row_map, dev_vidx, ("t", 8, n_hits))], [], {})
    D.reset_stats()
    before = D.RELAUNCHES["capacity"]
    if many:
        extra = D.PendingHits(None, [(_packed(4, 2, rng), 4, row_map,
                                      dev_vidx, ("u", 8, 0))], [], {})
        got, other = D.resolve_all([pending(), extra])
        assert len(other) == 2
        fetched = min(n_hits, cap) + 1 + 3
        allocated = cap + 1 + 5
    else:
        got = pending().resolve()
        fetched, allocated = min(n_hits, cap) + 1, cap + 1
    assert D.STATS["columns_fetched"] == D.STATS["columns_needed"] == fetched
    assert D.STATS["columns_allocated"] == allocated
    if n_hits > cap:
        assert got is sentinel and relaunched == [1]
        assert D.RELAUNCHES["capacity"] == before + 1
        return
    assert relaunched == []
    r, v, a, mc, nh = K.decode_packed_hits(packed.numpy())
    assert nh == n_hits == len(got)
    order = np.lexsort((dev_vidx[v], row_map[r]))
    np.testing.assert_array_equal(got.read_idx, row_map[r][order])
    np.testing.assert_array_equal(got.var_idx, dev_vidx[v][order])
    np.testing.assert_array_equal(got.allele_code, mc[order])


def test_overflow_relaunch_takes_the_same_filter(tmp_path, monkeypatch):
    """A forced hit-capacity overflow relaunches the chunk on its device:
    the relaunch drops the same rows and the hits stay the host's."""
    bd, vt, want = _datagen_case(tmp_path, "sparse")
    adaptive = D._adaptive_cap
    monkeypatch.setattr(D, "_adaptive_cap", lambda key, n: 2)
    pend = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu", defer=True)
    monkeypatch.setattr(D, "_adaptive_cap", adaptive)
    first = dict(D.STATS)
    before = D.RELAUNCHES["capacity"]
    _same(pend.resolve(), want())
    assert D.RELAUNCHES["capacity"] == before + 1
    assert D.STATS["rows_kept"] == 2 * first["rows_kept"] > 0
    assert D.STATS["rows_dropped"] == 2 * first["rows_dropped"] > 0


def test_cpu_uploads_alias_and_count_nothing(tmp_path):
    """On the CPU an upload aliases its array (no staging, no count); the
    device seconds of a cpu run are those of its plain-version calls."""
    from phaser_tpu_torch.utils import trace
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    clock = trace.DeviceClock(torch.device("cpu"))
    t = D._upload(x, torch.device("cpu"), clock)
    assert t.data_ptr() == x.ctypes.data
    assert D.STATS["uploads"] == D.STATS["uploads_pinned"] == 0
    bd, vt, want = _datagen_case(tmp_path, "dense_indel")
    t0 = trace.thread_device_seconds()
    _same(D.assign_alleles_auto(bd, vt, baseq=10, device="cpu"), want())
    assert trace.thread_device_seconds() > t0


def test_pack_reads_rows_without_native(tmp_path, monkeypatch):
    """Without the native library pack_reads gathers the rows itself and
    fills the same planes; the dispatcher's hits stay the host's."""
    bd, vt, want = _datagen_case(tmp_path, "sparse")
    rows = np.arange(5, len(bd), 7)
    native_planes = K.pack_reads(bd, rows=rows)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    for a, b in zip(K.pack_reads(bd, rows=rows), native_planes):
        np.testing.assert_array_equal(a, b)
    D.reset_stats()
    _same(D.assign_alleles_auto(bd, vt, baseq=10, device="cpu"), want())
    assert 0 < D.STATS["rows_kept"] < D.STATS["rows_in"] // 2
