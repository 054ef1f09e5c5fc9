"""The ragged range join (phaser_tpu_torch kernels.alleles
assign_compact_ragged; on the CPU its plain version ragged_join_plain) and
the dispatcher's route through it, against phaser_tpu.

Hits are integers, tolerance 0.  On the layouts of testing/layouts.py the
reads go to the join as BAM decode stores them (testing.layouts
ragged_inputs) and to phaser_tpu's plane program as the padded refpos plane
of the same reads (ragged_plane: a walk over each read's ops written out
there), its jnp twin and, where its planner finds windows, its windowed
Pallas program in interpret mode; the packed buffers must be equal word for
word (both compact in row-major order).  On tests/datagen.py fixtures the
join over every read equals phaser_tpu's plane program on phaser_tpu's own
pack_reads planes, and the dispatcher (device="cpu") equals phaser_tpu's
assign_alleles_auto(device="host").  A hypothesis fuzz holds the dispatcher
to the host mapper on CIGARs of S, H, M, =, X, D, N and P, sequences of
`*`, reads without ops and sequences shorter or longer than their CIGAR:
phaser_tpu's host mapper reads a base past a read's own bases from its
neighbour's (or past the end of the array), so its side gets the same
reads with each sequence cut or padded (with N, qual 0) to its CIGAR's
length, which is what the join reads (and the port's host mapper, native
and numpy, which reads no base past a read's own).
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import datagen
from phaser_tpu.engine import varmap as jax_varmap
from phaser_tpu.io import bam as jax_bamio
from phaser_tpu.io import vcf as jax_vcfio
from phaser_tpu.kernels import alleles as J
from phaser_tpu.mapper import dispatch as jax_dispatch
from phaser_tpu_torch.engine import varmap
from phaser_tpu_torch.io import bam as bamio
from phaser_tpu_torch.io import native
from phaser_tpu_torch.io import vcf as vcfio
from phaser_tpu_torch.kernels import alleles as K
from phaser_tpu_torch.mapper import dispatch as D
from phaser_tpu_torch.testing import layouts

M, I, DEL, N, S, H, P, EQ, X = range(9)
OLD_ROUTES = ("affine_nibble", "delta_nibble", "plane", "affine_masked")


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    D.reset_stats()


@pytest.fixture
def spy(monkeypatch):
    """Plain-version runs per program; "rows": the rows of each ragged
    join."""
    calls = dict.fromkeys(OLD_ROUTES + ("ragged_join",), 0)
    calls["rows"] = []
    for name in OLD_ROUTES + ("ragged_join",):
        orig = getattr(K, name + "_plain")

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            if _name == "ragged_join":
                calls["rows"].append(int(a[0].shape[0]))
            return _orig(*a, **kw)
        monkeypatch.setattr(K, name + "_plain", wrapped)
    return calls


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(got, want):
    np.testing.assert_array_equal(got.read_idx, want.read_idx)
    np.testing.assert_array_equal(got.var_idx, want.var_idx)
    np.testing.assert_array_equal(got.allele_code, want.allele_code)
    assert got.allele_strs == want.allele_strs


# ---------------------------------------------------------------------------
# the layouts that reach every branch of the kernel


@pytest.mark.parametrize("cap", [1 << 15, 4])
@pytest.mark.parametrize("layout", layouts.NAMES)
def test_ragged_layout_matches_jax(layout, cap):
    """assign_compact_ragged on a layout's reads == JAX's jnp plane program
    on their refpos plane and, where its planner finds windows, JAX's
    windowed Pallas program, word for word; past capacity (cap 4) the count
    stays exact."""
    d = layouts.make(layout)
    planes = layouts.ragged_plane(d)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    jargs = [jnp.asarray(x) for x in planes]
    want = np.asarray(J.assign_compact_plane(*jargs, *jtab, 10, cap))
    ws = J.plan_windows_plane(planes[2], d["vpos"], 256)
    if ws is not None:
        np.testing.assert_array_equal(np.asarray(J._plane_windowed_impl(
            *jargs, jnp.asarray(ws), *jtab, 10, cap, interpret=True)), want)
    if layout == "sorted":
        assert ws is not None  # the windowed comparison is not vacuous
    table = tuple(_t(x) for x in layouts.padded_table(d))
    got = K.assign_compact_ragged(
        *[_t(x) for x in layouts.ragged_inputs(d)], 10, table, cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] > (cap if cap == 4 else 0)


def test_ragged_layouts_reach_every_branch():
    """The layouts' reads hold what the CIGAR walk branches on: every op
    class, reads of no op, all-clip reads, sequences of `*`, shorter and
    longer than their CIGAR, an N and a D inside the aligned range; and
    the join finds hits on both sides of a gap."""
    d = layouts.make("lo_gt0")
    reads = layouts.ragged_reads(d)
    ops = {op for _, o, _, _ in reads for _, op in o}
    assert ops == {M, DEL, N, S, H, P, EQ, X}
    qlen = [sum(ln for ln, op in o if op in (M, I, S, EQ, X))
            for _, o, _, _ in reads]
    n_bases = [len(c) for _, _, c, _ in reads]
    empty = layouts.ragged_reads(layouts.make("empty_rows"))
    assert any(not o for _, o, _, _ in empty)
    assert any(o and all(op == S for _, op in o) for _, o, _, _ in empty)
    assert any(q and not b for q, b in zip(qlen, n_bases))
    assert any(0 < b < q for q, b in zip(qlen, n_bases))
    assert any(b > q > 0 for q, b in zip(qlen, n_bases))
    codes, quals, refpos = layouts.ragged_plane(d)
    pos, co, cig, so, seq, qual = layouts.ragged_inputs(d)
    assert np.array_equal(np.diff(so), n_bases) and len(pos) == len(reads)
    # every read's aligned positions in the plane rise along the read
    for r in range(len(reads)):
        rp = refpos[r][refpos[r] > 0]
        assert np.all(np.diff(rp) > 0)
    _reach_tile_branches()


def _tile_runs(co, rows):
    """The CIGAR words of each tile of `rows` consecutive rows, plus the
    (at most 3 words of) 16-byte alignment the stage copies from."""
    ends = co[np.minimum(np.arange(0, len(co) - 1 + rows, rows),
                         len(co) - 1)]
    return np.diff(ends) + 3


def _reach_tile_branches():
    """The tile kernels' branches (csrc/alleles.cu ragged_join and
    read_spans, shapes in kernels.alleles): rows whose ops pass a join
    tile's op stage, a single row past that whole stage, runs of zero-op
    and `*` rows across a tile boundary, tiles whose table slice passes
    both kernels' stages, and more rows than one H100 wave holds."""
    pos, co, cig, so, seq, qual = layouts.ragged_inputs(
        layouts.make("long_cigar"))
    n_ops = np.diff(co)
    assert n_ops.max() > K.JOIN_OPS and n_ops.min() < 10
    assert _tile_runs(co, K.JOIN_TILE).max() > K.JOIN_OPS
    # a tile whose first rows fit the stage and whose later ones do not
    run = np.cumsum(n_ops[:K.JOIN_TILE])
    assert run.min() <= K.JOIN_OPS - 3 < K.JOIN_OPS < run.max()

    d = layouts.make("empty_runs")
    pos, co, cig, so, seq, qual = layouts.ragged_inputs(d)
    n_ops, n_bases = np.diff(co), np.diff(so)
    across = np.arange(K.JOIN_TILE - 12, K.JOIN_TILE + 12)
    assert (n_ops[across] == 0).sum() >= 12
    star = (n_ops > 0) & (n_bases == 0)
    assert star[across].sum() >= 12
    for side in (across[:12], across[12:]):
        assert (n_ops[side] == 0).any() and star[side].any()
    assert np.array_equal(n_ops == 0, d["no_ops"] |
                          (d["hi"] <= d["lo"]) & (np.arange(len(pos)) % 2 ==
                                                  0))

    d = layouts.make("wide_slice")
    refpos = layouts.ragged_plane(d)[2]
    vpos = d["vpos"]
    for rows, stage in ((K.JOIN_TILE, K.JOIN_STAGE),
                        (K.SPAN_TILE, K.SPAN_STAGE)):
        under = []
        for t in range(0, len(refpos), rows):
            rp = refpos[t:t + rows]
            rp = rp[rp > 0]
            under.append(np.searchsorted(vpos, rp.max(), "right") -
                         np.searchsorted(vpos, rp.min()))
        assert max(under) > stage

    # an H100 (132 SMs) holds at most 2,048 threads an SM: at the size
    # chip_smoke.py makes it (the card's tests make it at 48,000 reads,
    # inside one wave), many_rows is more rows than one wave of the join
    # (256-row tiles of 256 threads) holds
    assert len(layouts.make("many_rows")["start"]) == 16 * 300
    big = layouts.make("many_rows", n_rows=20_000, n_vars=16_000,
                       contig=4_000_000)
    assert len(big["start"]) > 132 * 2048 // 256 * K.JOIN_TILE


def test_ragged_join_reads_only_its_own_bases():
    """A read whose CIGAR runs past its bases, and a read of `*` between two
    others, hit nothing past their own bases; their neighbours' hits are
    their own (the plain version on hand-made rows)."""
    words = lambda ops: [(ln << 4) | op for ln, op in ops]   # noqa
    rows = [(999, [(10, M)], [1] * 10),        # positions 1000..1009
            (999, [(10, M)], []),              # `*`
            (999, [(3, S), (10, M)], [2] * 8),  # bases end at position 1004
            (999, [], [4] * 10)]               # no ops
    cig = np.array(sum((words(o) for _, o, _ in rows), []),
                   np.uint32).view(np.int32)
    co = np.cumsum([0] + [len(o) for _, o, _ in rows]).astype(np.int32)
    so = np.cumsum([0] + [len(c) for _, _, c in rows]).astype(np.int32)
    seq = np.array(sum((c for _, _, c in rows), []), np.uint8)
    vpos = np.array([1000, 1004, 1005, 1009] + [2 ** 31 - 1] * 4, np.int32)
    table = (_t(vpos), _t(np.full(8, 1, np.int32)), _t(np.full(8, 2, np.int32)),
             _t(np.full(8, 2, np.int32)))
    out = K.ragged_join_plain(_t(np.full(4, 999, np.int32)), _t(co), _t(cig),
                              _t(so), _t(seq), _t(np.full(len(seq), 30,
                                                          np.uint8)),
                              10, table, 64).numpy()
    r, v, a, mc, nh = K.decode_packed_hits(out)
    assert list(zip(r, v, mc)) == [(0, 0, 1), (0, 1, 1), (0, 2, 1), (0, 3, 1),
                                   (2, 0, 2), (2, 1, 2)]


def test_ragged_wrapper_checks_its_inputs():
    d = layouts.make("sorted", n_rows=20)
    args = [_t(x) for x in layouts.ragged_inputs(d)]
    table = tuple(_t(x) for x in layouts.padded_table(d))
    K.assign_compact_ragged(*args, 10, table, 16)
    for k, bad in ((0, args[0].long()), (1, args[1][:-1]),
                   (2, args[2].to(torch.int64)), (3, args[3].long()),
                   (4, args[4][:-1]), (5, args[5].to(torch.int16))):
        with pytest.raises(ValueError):
            K.assign_compact_ragged(*args[:k], bad, *args[k + 1:], 10,
                                    table, 16)
    with pytest.raises(ValueError, match="capacity"):
        K.assign_compact_ragged(*args, 10, table, 0)
    with pytest.raises(ValueError):
        K.assign_compact_ragged(*args, 10, table[:3] + (table[3][:-1],), 16)


# ---------------------------------------------------------------------------
# datagen fixtures

FIXTURES = {
    "spliced_indels": dict(seed=81, contigs=("chr20",), contig_len=30000,
                           n_variants_per_contig=150,
                           n_reads_per_contig=600, frac_spliced=0.35,
                           frac_indel_reads=0.3, error_rate=0.01),
    "indel_multiallelic": dict(seed=82, contigs=("chr20",),
                               contig_len=15000, n_variants_per_contig=90,
                               n_reads_per_contig=900,
                               include_indel_variants=True,
                               frac_indel_reads=0.25, frac_multiallelic=0.15,
                               frac_spliced=0.2),
}


def _datagen(tmp_path, name):
    vcf, bam, _ = datagen.write_fixture_dir(str(tmp_path), **FIXTURES[name])

    def read(vcfio, varmap, bamio):
        lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
                 if not l.startswith("#")]
        hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
        vt = varmap.build_variant_table("chr20", hs.pool["chr20"],
                                        include_indels=True)
        bd = bamio.read_bam(bam)
        return bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0)), vt
    return read(vcfio, varmap, bamio), read(jax_vcfio, jax_varmap, jax_bamio)


@pytest.mark.parametrize("cap", [1 << 14, 4])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_ragged_join_on_datagen_matches_jax_plane(tmp_path, name, cap):
    """Every read of a fixture (insertion reads too) through the join, as
    the dispatcher stages them, == phaser_tpu's plane program on its own
    pack_reads planes of the same reads, word for word."""
    (bd, vt), (jbd, jvt) = _datagen(tmp_path, name)
    simple = np.flatnonzero(vt.is_simple)
    assert np.array_equal(simple, np.flatnonzero(jvt.is_simple))
    vpos, a0, a1, ni = K.padded_table(vt, simple)
    planes = [jnp.asarray(x) for x in J.pack_reads(jbd)]
    want = np.asarray(J.assign_compact_plane(
        *planes, jnp.asarray(vpos),
        jnp.asarray(np.stack([a0, a1], 1).astype(np.uint8)),
        jnp.asarray(ni.astype(np.int8)), 10, cap))
    reads = D._stage_reads(bd, np.arange(len(bd)), torch.device("cpu"), None)
    got = K.assign_compact_ragged(*reads, 10,
                                  tuple(_t(x) for x in (vpos, a0, a1, ni)),
                                  cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 0] > 50


@pytest.mark.parametrize("kw", [dict(), dict(isize_cutoff=400),
                                dict(splice=False)])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_ragged_route_on_datagen_matches_host(tmp_path, spy, name, kw):
    """The dispatcher on device="cpu" == phaser_tpu's host dispatcher; every
    kept row went through ragged_join_plain, once, and no program of the
    packed routes ran."""
    (bd, vt), (jbd, jvt) = _datagen(tmp_path, name)
    want = jax_dispatch.assign_alleles_auto(jbd, jvt, baseq=10,
                                            device="host", **kw)
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu", **kw)
    _same(got, want)
    assert spy["ragged_join"] > 0 and sum(spy["rows"]) == \
        D.STATS["rows_kept"] > 0
    assert not any(spy[k] for k in OLD_ROUTES), spy


def test_ragged_route_in_small_launches(tmp_path, monkeypatch, spy):
    """Launch chunks cut by rows and by bases (the kernel's int32 offsets)
    give the host's hits; every kept row is staged once."""
    (bd, vt), (jbd, jvt) = _datagen(tmp_path, "spliced_indels")
    want = jax_dispatch.assign_alleles_auto(jbd, jvt, baseq=10,
                                            device="host")
    monkeypatch.setattr(D, "_SUB_ROWS", 37)
    monkeypatch.setattr(D, "_SUB_BASES", 1500)
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu")
    _same(got, want)
    assert len(spy["rows"]) > 5 and max(spy["rows"]) <= 37
    assert sum(spy["rows"]) == D.STATS["rows_kept"]
    chunks = D._launch_chunks(bd, np.arange(len(bd)))
    assert chunks[0][0] == 0 and chunks[-1][1] == len(bd)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


def test_stage_reads_without_native_library(tmp_path, monkeypatch):
    """The numpy gather stages the same bytes as the native one."""
    (bd, vt), _ = _datagen(tmp_path, "spliced_indels")
    rows = np.random.default_rng(5).permutation(len(bd))[:len(bd) // 2]
    cpu = torch.device("cpu")
    nat = D._stage_reads(bd, rows, cpu, None)
    assert native.get_lib() is not None
    monkeypatch.setattr(native, "get_lib", lambda: None)
    for a, b in zip(D._stage_reads(bd, rows, cpu, None), nat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the span pass: the decode's summary, the read_spans kernel's plain version


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_span_passes_agree(tmp_path, monkeypatch, order):
    """(has_ins, has_n, near) from the span summary the native decode
    writes (a merge, also over reads out of position order), from the
    read_spans kernel's plain version, from the native pass over the
    CIGARs and from numpy are equal; the summary equals a walk over each
    read's ops and survives select and slice_rows."""
    (bd, vt), _ = _datagen(tmp_path, "spliced_indels")
    if order == "shuffled":
        bd = bd.select(np.random.default_rng(2).permutation(len(bd)))
    assert bd.span_end is not None
    dev_pos = vt.pos[vt.is_simple][::2]
    merged = D._read_spans(bd, dev_pos)
    mp = -(-len(dev_pos) // 4) * 4
    vpos = np.full(mp, 2 ** 31 - 1, np.int32)
    vpos[:len(dev_pos)] = dev_pos
    flags = K.read_spans(_t(bd.pos), _t(bd.cigar_off),
                         _t(bd.cigar_flat.view(np.int32)), _t(vpos),
                         I, N).numpy()
    plain = ((flags & 1) > 0, (flags & 2) > 0, (flags & 4) > 0)
    bare = dataclasses.replace(bd, span_end=None, span_flags=None)
    walk = D._read_spans(bare, dev_pos)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    numpy_pass = D._read_spans(bare, dev_pos)
    for got in (merged, plain, walk):
        for a, b in zip(got, numpy_pass):
            np.testing.assert_array_equal(a, b)
    assert 0 < merged[2].sum() < len(bd) and merged[0].any() and \
        merged[1].any()
    total = D._per_read_sum(bd.cigar_flat >> 4, bd.cigar_off)
    np.testing.assert_array_equal(bd.span_end, bd.pos + total)
    np.testing.assert_array_equal(bd.span_flags,
                                  numpy_pass[0] + 2 * numpy_pass[1])
    part = bd.slice_rows(10, 200)
    np.testing.assert_array_equal(part.span_end, bd.span_end[10:200])
    np.testing.assert_array_equal(part.span_flags, bd.span_flags[10:200])


def test_read_spans_wrapper_checks_its_inputs():
    pos = _t(np.array([5, 9], np.int32))
    co = _t(np.array([0, 1, 2], np.int64))
    cig = _t(np.array([(10 << 4) | M, (3 << 4) | I], np.uint32).view(
        np.int32))
    vpos = _t(np.array([8, 2 ** 31 - 1, 2 ** 31 - 1, 2 ** 31 - 1], np.int32))
    np.testing.assert_array_equal(K.read_spans(pos, co, cig, vpos, I, N),
                                  [K.SPAN_NEAR, K.SPAN_INS])
    with pytest.raises(ValueError):
        K.read_spans(pos, co.to(torch.int32), cig, vpos, I, N)
    with pytest.raises(ValueError):
        K.read_spans(pos.long(), co, cig, vpos, I, N)


# ---------------------------------------------------------------------------
# the fuzz

_OPS = st.sampled_from([M, M, M, EQ, X, DEL, N, S, H, P])
_SEQ_MODES = st.sampled_from(["exact", "exact", "exact", "star", "short",
                              "long"])


def _fuzz_records(reads, seed, normalized):
    """BamRecords of (pos0, cigar, mode); with `normalized` each sequence is
    cut or padded with N (qual 0) to its CIGAR's query length."""
    rng = np.random.default_rng(seed)
    out = []
    for k, (pos0, cigar, mode) in enumerate(reads):
        qlen = sum(ln for ln, op in cigar if op in (M, I, S, EQ, X))
        n = {"exact": qlen, "star": 0, "short": qlen // 2,
             "long": qlen + 7}[mode]
        seq = "".join(rng.choice(list("ACGT"), size=n))
        qual = [int(q) for q in rng.choice([5, 20, 30, 40], size=n,
                                           p=[.1, .3, .3, .3])]
        if normalized:
            seq = (seq + "N" * qlen)[:qlen]
            qual = (qual + [0] * qlen)[:qlen]
        out.append(bamio.BamRecord(
            name="r%d" % k, refid=0, pos=pos0, mapq=60, flag=0, cigar=cigar,
            seq=seq, qual=qual))
    return out


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.tuples(
    st.integers(0, 600),
    st.lists(st.tuples(st.integers(0, 40), _OPS), min_size=0, max_size=6),
    _SEQ_MODES), min_size=1, max_size=14),
    st.lists(st.integers(1, 900), min_size=1, max_size=25, unique=True),
    st.integers(0, 2 ** 31))
def test_ragged_route_fuzz_matches_host(tmp_path_factory, reads, vpos, seed):
    tmp = tmp_path_factory.mktemp("ragged")
    reads = sorted(reads, key=lambda r: r[0])
    # SNPs, a duplicate position and a deletion allele now and then: the
    # host remainders stay in the comparison
    variants = [(p, "A", "G") for p in vpos]
    if len(vpos) > 3:
        variants += [(vpos[0], "A", "T"), (vpos[1] + 1000, "ACG", "A")]
    rows = [["chr20", str(p), ".", ref, alt, ".", "PASS", ".", "GT", "0|1",
             ["0", "1"]] for p, ref, alt in sorted(variants)]
    raw, norm = str(tmp / "raw.bam"), str(tmp / "norm.bam")
    bamio.write_bam(raw, ["chr20"], [20_000], _fuzz_records(reads, seed,
                                                            False))
    bamio.write_bam(norm, ["chr20"], [20_000], _fuzz_records(reads, seed,
                                                             True))
    vt = varmap.build_variant_table("chr20", rows, include_indels=True)
    jvt = jax_varmap.build_variant_table("chr20", rows, include_indels=True)
    want = jax_dispatch.assign_alleles_auto(jax_bamio.read_bam(norm), jvt,
                                            baseq=10, device="host")
    bd = bamio.read_bam(raw)
    # the normalized reads give the same hits; so does the port's own host
    # mapper on the raw reads, native and numpy (it reads no base past a
    # read's own)
    _same(D.assign_alleles_auto(bamio.read_bam(norm), vt, baseq=10,
                                device="cpu"), want)
    real = native.get_lib
    for lib in (real, lambda: None):
        native.get_lib = lib
        try:
            for dv in ("cpu", "host"):
                _same(D.assign_alleles_auto(bd, vt, baseq=10, device=dv),
                      want)
        finally:
            native.get_lib = real
