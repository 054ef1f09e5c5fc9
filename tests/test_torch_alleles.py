"""phaser_tpu_torch allele kernels against phaser_tpu's fused programs and
its kernel-level entries (assign_alleles_device, compact_hits,
assign_alleles_pallas_windowed with gather and cmp, assign_alleles_pallas),
and the unpacked affine pair (pack_affine, assign_alleles_affine_device,
assign_compact_affine) with fetch_packed_hits.

Every comparison is of integers, tolerance 0.  On the CPU the port's
wrappers run their plain PyTorch versions; the JAX side runs the windowed
Pallas programs in interpret mode and their unwindowed jnp twins, as
tests/test_kernels.py does.  The plain versions compact in row-major order,
so their packed buffers must equal JAX's word for word; the CUDA kernels
compact with atomics, so those are compared after a (read, var) sort.

The port's five fused programs are range joins that find their own table
ranges: JAX's windowed programs are fed planned windows, the port gets none
(the delta program gets the packer's per-row [rp_min, rp_max] instead).
"""

import fcntl
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import datagen
from phaser_tpu.engine import varmap as jax_varmap
from phaser_tpu.io import bam as jax_bamio
from phaser_tpu.io import native as jax_native
from phaser_tpu.io import vcf as jax_vcfio
from phaser_tpu.kernels import alleles as J
from phaser_tpu_torch.engine import varmap
from phaser_tpu_torch.io import bam as bamio
from phaser_tpu_torch.io import vcf as vcfio
from phaser_tpu_torch.kernels import alleles as K
from phaser_tpu_torch.testing import layouts


def _fixture(tmp_path, seed, **kw):
    kw.setdefault("contigs", ("chr20",))
    kw.setdefault("contig_len", 30000)
    kw.setdefault("n_variants_per_contig", 150)
    kw.setdefault("frac_indel_reads", 0.0)
    vcf, bam, _ = datagen.write_fixture_dir(str(tmp_path), seed=seed, **kw)

    def read(vcfio, varmap, bamio):
        lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
                 if not l.startswith("#")]
        hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
        vt = varmap.build_variant_table("chr20", hs.pool["chr20"])
        bd = bamio.read_bam(bam)
        return bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0)), vt
    chunk, vt = read(vcfio, varmap, bamio)
    # phaser_tpu's own objects from the same files, for its packers
    jchunk, _ = read(jax_vcfio, jax_varmap, jax_bamio)
    return chunk, vt, jchunk


def _tables(vt):
    """The dispatcher's pow2-padded table, for JAX (numpy) and the port."""
    dev_vidx = np.arange(len(vt))
    vpos, a0, a1, ni = K.padded_table(vt, dev_vidx)
    jax_tab = (jnp.asarray(vpos),
               jnp.asarray(np.stack([a0, a1], 1).astype(np.uint8)),
               jnp.asarray(ni.astype(np.int8)))
    return vpos, jax_tab, K.device_table(vt, dev_vidx, "cpu")


def _t(x, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _on(table, device):
    return tuple(t.to(device) for t in table)


def _sorted_hits(packed):
    r, v, a, mc, nh = K.decode_packed_hits(np.asarray(packed))
    order = np.lexsort((v, r))
    return nh, r[order], v[order], a[order], mc[order]


def _assert_same_hits(got, want):
    g, w = _sorted_hits(got), _sorted_hits(want)
    assert g[0] == w[0], (g[0], w[0])
    for a, b in zip(g[1:], w[1:]):
        np.testing.assert_array_equal(a, b)


def _affine_case(tmp_path):
    chunk, vt, jchunk = _fixture(tmp_path, 13, n_reads_per_contig=220)
    nb = K.pack_affine_nibble(chunk, 10)
    for a, b in zip(nb, J.pack_affine_nibble(jchunk, 10)):
        np.testing.assert_array_equal(a, b)
    ncodes, ia, st, lo, hi = nb
    st, lo, hi = (np.where(ia, x, 0).astype(np.int32) for x in (st, lo, hi))
    N = ncodes.shape[0]
    vpos, (jv, ji, jn), table = _tables(vt)
    ws = J.plan_windows_affine(st, lo, hi, hi > lo, vpos, N, min(256, N))
    jargs = [jnp.asarray(x) for x in (ncodes, st, lo, hi)]

    def jax_windowed(cap):
        return J._nibble_windowed_impl(*jargs, jnp.asarray(ws), jv, ji, jn,
                                       cap, interpret=True)

    def jax_plain(cap):
        return J.assign_compact_affine_nibble(*jargs, jv, ji, jn, cap)

    def port(cap, planned=None, device="cpu"):
        return K.assign_compact_affine_nibble(
            *[_t(x, device) for x in (ncodes, st, lo, hi)],
            _on(table, device), cap)
    return N, jax_windowed, jax_plain, port, (None,)


def _delta_case(tmp_path):
    chunk, vt, jchunk = _fixture(tmp_path, 44, n_reads_per_contig=400,
                                 frac_spliced=0.35, frac_indel_reads=0.5)
    dn = K.pack_delta_nibble(chunk, 10)
    for a, b in zip(dn, J.pack_delta_nibble(jchunk, 10)):
        np.testing.assert_array_equal(a, b)
    ncd, dlt, okm, dst, rmn, rmx = dn
    ok = np.flatnonzero(okm)
    ncd, dlt, dst, rmn, rmx = (x[ok] for x in (ncd, dlt, dst, rmn, rmx))
    N = ok.size
    vpos, (jv, ji, jn), table = _tables(vt)
    valid = np.ones(N, bool)
    ws = J.plan_windows_minmax(rmn, rmx, valid, vpos, N, min(256, N))
    jargs = [jnp.asarray(x) for x in (ncd, dst, dlt)]

    def jax_windowed(cap):
        return J._delta_windowed_impl(*jargs, jnp.asarray(ws), jv, ji, jn,
                                      cap, interpret=True)

    def jax_plain(cap):
        return J.assign_compact_delta_nibble(*jargs, jv, ji, jn, cap)

    def port(cap, planned=None, device="cpu"):
        return K.assign_compact_delta_nibble(
            *[_t(x, device) for x in (ncd, dst, dlt, rmn, rmx)],
            _on(table, device), cap)
    return N, jax_windowed, jax_plain, port, (None,)


def _plane_case(tmp_path):
    chunk, vt, jchunk = _fixture(tmp_path, 14, n_reads_per_contig=200,
                                 frac_spliced=0.5)
    planes = K.pack_reads(chunk)
    for a, b in zip(planes, J.pack_reads(jchunk)):
        np.testing.assert_array_equal(a, b)
    codes, quals, refpos = planes
    N = codes.shape[0]
    vpos, (jv, ji, jn), table = _tables(vt)
    ws = J.plan_windows_plane(refpos, vpos, min(256, N))
    np.testing.assert_array_equal(
        ws, K.plan_windows_plane(refpos, vpos, min(256, N)))
    jargs = [jnp.asarray(x) for x in planes]

    def jax_windowed(cap):
        return J._plane_windowed_impl(*jargs, jnp.asarray(ws), jv, ji, jn,
                                      10, cap, interpret=True)

    def jax_plain(cap):
        return J.assign_compact_plane(*jargs, jv, ji, jn, 10, cap)

    def port(cap, planned=None, device="cpu"):
        return K.assign_compact_plane(
            *[_t(x, device) for x in planes], 10, _on(table, device), cap)
    return N, jax_windowed, jax_plain, port, (None,)


CASES = {"affine_nibble": _affine_case, "delta_nibble": _delta_case,
         "plane": _plane_case}


@pytest.fixture(scope="module")
def jax_native_so(tmp_path_factory):
    """None when phaser_tpu's native IO library loads; otherwise the path
    of a copy built for this module.  phaser_tpu's nibble packers return
    None without the library, and phaser_tpu builds it in place at first
    use: when several test processes start on a fresh checkout, one can
    load the file while another is still writing it and keep no library
    for good.  The copy is the same source built with phaser_tpu's
    compiler line into this module's temporary directory, under a file
    lock; nothing under phaser_tpu/ is written."""
    if jax_native.get_lib() is not None:
        return None
    so = str(tmp_path_factory.mktemp("jax_native") / "libphaser_io.so")
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", "-o", so + ".tmp", jax_native._SRC, "-lz",
               "-lpthread"]
        for libdir in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu",
                       "/usr/lib", "/usr/local/lib"):
            if os.path.exists(os.path.join(libdir, "libdeflate.so")):
                cmd.append("-ldeflate")
                break
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0 and "-ldeflate" in cmd:
            cmd.remove("-ldeflate")
            cmd.insert(1, "-DPHASER_NO_LIBDEFLATE")
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        os.replace(so + ".tmp", so)
    return so


@pytest.fixture
def jax_native_lib(jax_native_so, monkeypatch):
    """phaser_tpu's native IO library loaded for the test (the module's
    copy when the in-place one failed to load)."""
    if jax_native_so is None:
        return
    monkeypatch.setattr(jax_native, "_SO", jax_native_so)
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.get_lib() is not None


@pytest.mark.usefixtures("jax_native_lib")
@pytest.mark.parametrize("program", sorted(CASES))
def test_program_matches_jax(tmp_path, program):
    """Each program's plain version (a range join with no window) == the
    JAX windowed Pallas program (interpret, fed phaser_tpu's planned
    windows) == its jnp twin."""
    N, jax_windowed, jax_plain, port, plans = CASES[program](tmp_path)
    cap = 1 << 13
    want = np.asarray(jax_plain(cap))
    np.testing.assert_array_equal(np.asarray(jax_windowed(cap)), want)
    assert want[0, 0] > 5
    for planned in plans:
        got = port(cap, planned).numpy()
        np.testing.assert_array_equal(got, want)
        _assert_same_hits(got, want)


@pytest.mark.usefixtures("jax_native_lib")
@pytest.mark.parametrize("program", sorted(CASES))
def test_capacity_overflow_keeps_exact_count(tmp_path, program):
    """Past capacity the hit counter stays exact and only `cap` hits are
    written, as in phaser_tpu's _pack_hits."""
    N, _, jax_plain, port, _ = CASES[program](tmp_path)
    cap = 4
    want = np.asarray(jax_plain(cap))
    got = port(cap).numpy()
    assert got[0, 0] == want[0, 0] > cap
    np.testing.assert_array_equal(got, want)
    assert K.decode_packed_hits(got)[4] == want[0, 0]


def _scattered(seed, M=2000, N=300, L=128):
    """Reads scattered over a wide table: every 256-row block spans more
    than the 256-entry window."""
    rng = np.random.default_rng(seed)
    vpos = np.arange(1, M + 1, dtype=np.int32) * 7
    ind = rng.integers(1, 9, size=(M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    starts = np.sort(rng.integers(1, M * 7 - L, size=N)).astype(np.int32)
    codes = rng.integers(1, 16, size=(N, L)).astype(np.uint8)
    table = tuple(_t(x.astype(np.int32)) for x in
                  (vpos, ind[:, 0], ind[:, 1], ni))
    return vpos, ind, ni, starts, codes, table


def test_band_overflow_plane_whole_table():
    vpos, ind, ni, starts, codes, table = _scattered(6)
    N, L = codes.shape
    refpos = starts[:, None] + np.arange(L, dtype=np.int32)[None, :]
    quals = np.full((N, L), 30, np.uint8)
    assert K.plan_windows_plane(refpos, vpos, 256) is None
    assert J.plan_windows_plane(refpos, vpos, 256) is None
    cap = 1 << 14
    want = np.asarray(J.assign_compact_plane(
        jnp.asarray(codes), jnp.asarray(quals), jnp.asarray(refpos),
        jnp.asarray(vpos), jnp.asarray(ind), jnp.asarray(ni), 10, cap))
    got = K.assign_compact_plane(_t(codes), _t(quals), _t(refpos), 10, table,
                                 cap).numpy()
    assert want[0, 0] > 100
    np.testing.assert_array_equal(got, want)


def test_band_overflow_affine_whole_table():
    vpos, ind, ni, starts, codes, table = _scattered(7)
    N, L = codes.shape
    ncodes = (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)
    lo = np.full(N, 3, np.int32)
    hi = np.full(N, L - 5, np.int32)
    assert J.plan_windows_affine(starts, lo, hi, hi > lo, vpos, N, 256) is None
    cap = 1 << 14
    want = np.asarray(J.assign_compact_affine_nibble(
        *[jnp.asarray(x) for x in (ncodes, starts, lo, hi, vpos, ind, ni)],
        cap))
    got = K.assign_compact_affine_nibble(
        *[_t(x) for x in (ncodes, starts, lo, hi)], table, cap).numpy()
    assert want[0, 0] > 100
    np.testing.assert_array_equal(got, want)


def test_ragged_tail_rows_classified():
    """N % 256 != 0: rows of the last, partial block must be classified
    (tests/test_kernels.py:649 for the JAX side)."""
    rng = np.random.default_rng(15)
    N, L, M = 300, 128, 128
    starts = np.sort(rng.integers(1, 40000, size=N)).astype(np.int32)
    refpos = starts[:, None] + np.arange(L, dtype=np.int32)[None, :]
    codes = rng.integers(1, 16, size=(N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, size=(N, L)).astype(np.uint8)
    vpos = np.sort(rng.choice(np.arange(1, 41000, dtype=np.int64), size=M,
                              replace=False)).astype(np.int32)
    ind = rng.integers(1, 9, size=(M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    ws = K.plan_windows_plane(refpos, vpos, 256)
    assert ws is not None and ws.shape[0] == 2
    cap = 1 << 13
    want = np.asarray(J._plane_windowed_impl(
        *[jnp.asarray(x) for x in (codes, quals, refpos, ws, vpos, ind, ni)],
        10, cap, interpret=True))
    table = tuple(_t(x.astype(np.int32)) for x in
                  (vpos, ind[:, 0], ind[:, 1], ni))
    got = K.assign_compact_plane(_t(codes), _t(quals), _t(refpos), 10, table,
                                 cap).numpy()
    np.testing.assert_array_equal(got, want)
    r = K.decode_packed_hits(got)[0]
    assert r.max() >= 256


def test_wrappers_check_their_inputs():
    table = tuple(torch.zeros(8, dtype=torch.int32) for _ in range(4))
    nc = torch.zeros((4, 64), dtype=torch.uint8)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        K.assign_compact_affine_nibble(nc, z.long(), z, z, table, 16)
    with pytest.raises(TypeError, match="ws"):
        # the range joins take no window
        K.assign_compact_affine_nibble(nc, z, z, z, table, 16,
                                       ws=torch.zeros(1, dtype=torch.int32))
    dl = torch.zeros((4, 128), dtype=torch.int16)
    with pytest.raises(TypeError, match="ws"):
        K.assign_compact_delta_nibble(nc, z, dl, z, z, table, 16,
                                      ws=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="ws"):
        K.assign_compact_affine_masked(
            torch.zeros((4, 128), dtype=torch.uint8), z, z, z, table, 16,
            ws=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="rp_max has shape"):
        K.assign_compact_delta_nibble(
            nc, z, dl, z, torch.zeros(3, dtype=torch.int32), table, 16)
    with pytest.raises(ValueError, match="rp_min has dtype"):
        K.assign_compact_delta_nibble(nc, z, dl, z.long(), z, table, 16)
    with pytest.raises(ValueError, match="delta has shape"):
        K.assign_compact_delta_nibble(
            nc, z, torch.zeros((4, 64), dtype=torch.int16), z, z, table, 16)
    with pytest.raises(ValueError, match="mcodes has dtype"):
        K.assign_compact_affine_masked(
            torch.zeros((4, 128), dtype=torch.int32), z, z, z, table, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        K.assign_compact_plane(torch.zeros((4, 6), dtype=torch.uint8),
                               torch.zeros((4, 6), dtype=torch.uint8),
                               torch.zeros((4, 6), dtype=torch.int32), 10,
                               table, 16)
    with pytest.raises(ValueError, match="contiguous"):
        K.assign_compact_plane(torch.zeros((64, 4), dtype=torch.uint8).t(),
                               torch.zeros((4, 64), dtype=torch.uint8),
                               torch.zeros((4, 64), dtype=torch.int32), 10,
                               table, 16)
    cq = torch.zeros((4, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="quals has shape"):
        K.assign_compact_affine(cq, torch.zeros((4, 64), dtype=torch.uint8),
                                z, z, z, table, 10, 16)
    with pytest.raises(ValueError, match="hi has dtype"):
        K.assign_compact_affine(cq, cq, z, z, z.long(), table, 10, 16)
    with pytest.raises(ValueError, match="n_ind has dtype"):
        K.assign_compact_affine(cq, cq, z, z, z, table[:3] + (table[3].long(),),
                                10, 16)
    with pytest.raises(ValueError, match="capacity 0 out of range"):
        K.assign_compact_affine(cq, cq, z, z, z, table, 10, 0)
    vpos = torch.arange(1, 9, dtype=torch.int32)
    ind = torch.ones((8, 2), dtype=torch.uint8)
    ni = torch.full((8,), 2, dtype=torch.int8)
    with pytest.raises(ValueError, match="start has shape"):
        K.assign_alleles_affine_device(
            cq, cq, torch.zeros(3, dtype=torch.int32), z, z, vpos, ind, ni,
            10)
    with pytest.raises(ValueError, match="ind_codes has dtype"):
        K.assign_alleles_affine_device(cq, cq, z, z, z, vpos, ind.int(), ni, 10)
    before = dict(K.LAUNCHES)
    meta = torch.zeros((4, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        K.assign_compact_affine_nibble(
            meta, *[torch.zeros(4, dtype=torch.int32, device="meta")] * 3,
            _on(table, "meta"), 16)
    # plain runs on CPU tensors never count as kernel launches
    K.assign_compact_affine_nibble(nc, z, z, z, table, 16)
    K.assign_compact_affine(cq, cq, z, z, z, table, 10, 16)
    K.assign_alleles_affine_device(cq, cq, z, z, z, vpos, ind, ni, 10)
    assert K.LAUNCHES == before


# ---------------------------------------------------------------------------
# the range joins on layouts that reach every branch of the CUDA kernels

LAYOUTS = layouts.NAMES


def _layout(name):
    return layouts.make(name)


def _port_table(d):
    return tuple(_t(x) for x in layouts.padded_table(d))


_affine_inputs = layouts.affine_inputs
_plane_inputs = layouts.plane_inputs
_delta_inputs = layouts.delta_inputs
_masked_inputs = layouts.masked_inputs


@pytest.mark.parametrize("cap", [1 << 15, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_affine_range_join_matches_jax(layout, cap):
    """assign_compact_affine_nibble without a window == JAX's jnp twin and,
    where its planner finds windows, JAX's windowed Pallas program fed
    those windows, word for word; past capacity (cap 4) the count stays
    exact."""
    d = _layout(layout)
    ncodes, start, lo, hi = _affine_inputs(d)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    jargs = [jnp.asarray(x) for x in (ncodes, start, lo, hi)]
    want = np.asarray(J.assign_compact_affine_nibble(*jargs, *jtab, cap))
    N = len(start)
    ws = J.plan_windows_affine(start, lo, hi, hi > lo, d["vpos"], N, 256)
    if ws is not None:
        np.testing.assert_array_equal(np.asarray(J._nibble_windowed_impl(
            *jargs, jnp.asarray(ws), *jtab, cap, interpret=True)), want)
    if layout in ("sorted", "dense"):
        # so the comparison with the windowed program is not vacuous, and
        # the dense table is one no window holds
        assert (ws is None) == (layout == "dense")
    got = K.assign_compact_affine_nibble(
        *[_t(x) for x in (ncodes, start, lo, hi)], _port_table(d),
        cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] > (cap if cap == 4 else 0)


@pytest.mark.parametrize("cap", [1 << 15, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plane_range_join_matches_jax(layout, cap):
    """assign_compact_plane without a window == JAX's jnp twin and, where
    its planner finds windows, JAX's windowed Pallas program."""
    d = _layout(layout)
    planes = _plane_inputs(d)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    jargs = [jnp.asarray(x) for x in planes]
    want = np.asarray(J.assign_compact_plane(*jargs, *jtab, 10, cap))
    ws = J.plan_windows_plane(planes[2], d["vpos"], 256)
    if ws is not None:
        np.testing.assert_array_equal(np.asarray(J._plane_windowed_impl(
            *jargs, jnp.asarray(ws), *jtab, 10, cap, interpret=True)), want)
    got = K.assign_compact_plane(*[_t(x) for x in planes], 10,
                                 _port_table(d), cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] > (cap if cap == 4 else 0)


@pytest.mark.parametrize("cap", [1 << 15, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_delta_range_join_matches_jax(layout, cap):
    """assign_compact_delta_nibble from the rows' [rp_min, rp_max] == JAX's
    jnp twin (a search per base over the whole table), word for word; past
    capacity (cap 4) the count stays exact."""
    d = _layout(layout)
    ncodes, start, delta, rp_min, rp_max = _delta_inputs(d)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    want = np.asarray(J.assign_compact_delta_nibble(
        *[jnp.asarray(x) for x in (ncodes, start, delta)], *jtab, cap))
    got = K.assign_compact_delta_nibble(
        *[_t(x) for x in (ncodes, start, delta, rp_min, rp_max)],
        _port_table(d), cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] > (cap if cap == 4 else 0)


@pytest.mark.parametrize("cap", [1 << 15, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_range_join_matches_jax(layout, cap):
    """assign_compact_affine_masked without a window == JAX's jnp program,
    word for word, and == the nibble program on the same rows."""
    d = _layout(layout)
    args = _masked_inputs(d)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    want = np.asarray(J.assign_compact_affine_masked(
        *[jnp.asarray(x) for x in args], *jtab, cap))
    table = _port_table(d)
    got = K.assign_compact_affine_masked(*[_t(x) for x in args], table,
                                         cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, K.assign_compact_affine_nibble(
        *[_t(x) for x in _affine_inputs(d)], table, cap).numpy())
    assert got[0, 0] > (cap if cap == 4 else 0)


def test_clip_collision_layout_collides():
    """The layout really puts a masked trailing clip at the position of an
    aligned base on a variant, the delta program reports that variant once,
    from the aligned base, and a base that is aligned but of low quality
    reports nothing."""
    d = _layout("clip_collide")
    ncodes, start, delta, rp_min, rp_max = _delta_inputs(d)
    L = delta.shape[1]
    i = np.arange(L)[None, :]
    pos = start[:, None] + i + delta
    clip = i >= d["hi"][:, None]
    on_var = np.isin(pos, d["vpos"])
    aligned = (i >= d["lo"][:, None]) & ~clip
    # rows with a clipped base and an aligned base on one variant position
    both = [(r, p) for r in range(len(start))
            for p in set(pos[r][clip[r] & on_var[r]]) &
            set(pos[r][aligned[r] & on_var[r]])]
    assert len(both) > 20
    got = K.assign_compact_delta_nibble(
        *[_t(x) for x in (ncodes, start, delta, rp_min, rp_max)],
        _port_table(d), 1 << 15).numpy()
    r, v, _, mc, _ = K.decode_packed_hits(got)
    hits = {}
    for rr, vv in zip(r.tolist(), v.tolist()):
        hits[(rr, int(d["vpos"][vv]))] = hits.get((rr, int(d["vpos"][vv])),
                                                  0) + 1
    assert max(hits.values()) == 1
    masked = np.where(aligned & (d["quals"] >= 10), d["codes"], 15)
    seen = 0
    for row, p in both:
        base = int(np.flatnonzero(aligned[row] & (pos[row] == p))[0])
        assert ((row, int(p)) in hits) == (masked[row, base] != 15)
        seen += (row, int(p)) in hits
    assert 0 < seen < len(both)


def test_range_joins_hit_first_and_last_base():
    """The layout really puts variants under first and last aligned bases,
    and both programs report them."""
    d = _layout("first_last")
    got = K.assign_compact_affine_nibble(
        *[_t(x) for x in _affine_inputs(d)], _port_table(d), 1 << 15).numpy()
    r, v, _, _, _ = K.decode_packed_hits(got)
    base = d["lo"][r] + (d["vpos"][v] - d["start"][r])
    assert (base == d["lo"][r]).any() and (base == d["hi"][r] - 1).any()


def _affine_masked_case(tmp_path):
    chunk, vt, _ = _fixture(tmp_path, 13, n_reads_per_contig=220)
    am = K.pack_affine_masked(chunk, 10)
    mcodes, ia, st, lo, hi = am
    st, lo, hi = (np.where(ia, x, 0).astype(np.int32) for x in (st, lo, hi))
    N = mcodes.shape[0]
    vpos, (jv, ji, jn), table = _tables(vt)

    def jax_plain(cap):
        return J.assign_compact_affine_masked(
            *[jnp.asarray(x) for x in (mcodes, st, lo, hi)], jv, ji, jn, cap)

    def port(cap, device="cpu"):
        return K.assign_compact_affine_masked(
            *[_t(x, device) for x in (mcodes, st, lo, hi)],
            _on(table, device), cap)
    return N, jax_plain, port


def test_affine_masked_matches_jax(tmp_path):
    """The masked-affine plain version (a range join with no window) ==
    phaser_tpu's jnp assign_compact_affine_masked, word for word, and past
    capacity."""
    N, jax_plain, port = _affine_masked_case(tmp_path)
    for cap in (1 << 13, 4):
        want = np.asarray(jax_plain(cap))
        assert want[0, 0] > 5
        np.testing.assert_array_equal(port(cap).numpy(), want)


# ---------------------------------------------------------------------------
# the unpacked affine pair: pack_affine, assign_alleles_affine_device (the
# refpos plane formed on the device, then assign_alleles_device) and the
# fused assign_compact_affine (a range join over the codes and quals planes)


def _pack_affine_reads(tmp_path):
    """tests/test_kernels.py:346's reads (seed 21: clips, splices, indels)
    as each package reads them."""
    data = datagen.generate(seed=21, contigs=("chr1",), contig_len=100000,
                            n_variants_per_contig=50, n_reads_per_contig=400,
                            read_len=90, frac_spliced=0.3,
                            frac_indel_reads=0.2, frac_softclip=0.3)
    p = str(tmp_path / "x.bam")
    data.write_bam(p)
    return bamio.read_bam(p), jax_bamio.read_bam(p)


@pytest.mark.usefixtures("jax_native_lib")
def test_pack_affine_matches_jax(tmp_path):
    """pack_affine == phaser_tpu's pack_affine on all six outputs, values
    and dtypes, also into reused scratch."""
    bd, jbd = _pack_affine_reads(tmp_path)
    want = J.pack_affine(jbd)
    assert want is not None
    for reuse in (False, True):
        got = K.pack_affine(bd, reuse=reuse)
        assert got is not None and len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    ia = want[2]
    assert ia.sum() > 0 and (~ia).sum() > 0
    assert want[0].shape[1] % 128 == 0


@pytest.mark.usefixtures("jax_native_lib")
def test_affine_pair_on_packed_reads_matches_jax(tmp_path):
    """On pack_affine's planes of real reads (non-affine rows emptied, as a
    caller routes them elsewhere): assign_alleles_affine_device's two planes
    and assign_compact_affine's packed buffer == phaser_tpu's, ample and
    past capacity."""
    bd, _ = _pack_affine_reads(tmp_path)
    codes, quals, ia, start, lo, hi = K.pack_affine(bd)
    start, lo, hi = (np.where(ia, x, 0).astype(np.int32)
                     for x in (start, lo, hi))
    rng = np.random.default_rng(21)
    M = 3000
    vpos = np.sort(rng.choice(np.arange(1, 100000, dtype=np.int64), size=M,
                              replace=False)).astype(np.int32)
    ind = rng.integers(0, 16, size=(M, 2)).astype(np.uint8)
    ni = rng.integers(0, 3, size=M).astype(np.int8)
    args = (codes, quals, start, lo, hi)
    jx = [jnp.asarray(x) for x in args + (vpos, ind, ni)]
    want = J.assign_alleles_affine_device(*jx, 10)
    got = K.assign_alleles_affine_device(*[_t(x) for x in
                                           args + (vpos, ind, ni)], 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0] >= 0).sum()) > 50
    table = _port_table(dict(vpos=vpos, ind=ind, ni=ni))
    for cap in (1 << 14, 4):
        want = np.asarray(J.assign_compact_affine(*jx, 10, cap))
        got = K.assign_compact_affine(*[_t(x) for x in args], table, 10,
                                      cap).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0, 0] > 50


@pytest.mark.parametrize("layout", LAYOUTS)
def test_affine_device_planes_match_jax(layout):
    """assign_alleles_affine_device's (vidx, allele) planes == phaser_tpu's
    on every layout (duplicate positions: both take the first of equal
    entries)."""
    d = _layout(layout)
    arrays = layouts.affine_planes_inputs(d) + (d["vpos"], d["ind"], d["ni"])
    want = J.assign_alleles_affine_device(*[jnp.asarray(x) for x in arrays],
                                          10)
    got = K.assign_alleles_affine_device(*[_t(x) for x in arrays], 10)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0] >= 0).sum()) > 0


@pytest.mark.parametrize("cap", [1 << 15, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_affine_planes_range_join_matches_jax(layout, cap):
    """assign_compact_affine (BASEQ applied by the program) == phaser_tpu's
    jnp assign_compact_affine word for word, == the masked-plane program on
    where(quals >= baseq, codes, 15) of the same rows, and bases under
    BASEQ are really dropped (BASEQ 0 finds more hits)."""
    d = _layout(layout)
    args = layouts.affine_planes_inputs(d)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    want = np.asarray(J.assign_compact_affine(
        *[jnp.asarray(x) for x in args], *jtab, 10, cap))
    table = _port_table(d)
    tx = [_t(x) for x in args]
    got = K.assign_compact_affine(*tx, table, 10, cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, K.assign_compact_affine_masked(
        *[_t(x) for x in _masked_inputs(d)], table, cap).numpy())
    assert got[0, 0] > (cap if cap == 4 else 0)
    assert K.assign_compact_affine(*tx, table, 0, cap)[0, 0] > got[0, 0]


def test_affine_planes_baseq0_reads_the_pad():
    """With BASEQ 0 nothing is masked: pad bases (code 0, qual 0) inside
    [lo, hi), where hi reaches past the read and past the plane, read as
    code 0 and hit, as in phaser_tpu; with BASEQ 10 they are masked."""
    d = dict(_layout("sorted"))
    codes, quals, start, lo, hi = (x.copy() for x in
                                   layouts.affine_planes_inputs(d))
    L = codes.shape[1]
    codes[:, 96:] = 0
    quals[:, 96:] = 0
    hi[0::2] = L + 40
    hi[1::2] = 110
    rng = np.random.default_rng(3)
    vpos = np.unique(np.concatenate([d["vpos"], (start + 100 - lo)[::3],
                                     (start + L - 1 - lo)[::5]]))
    d.update(vpos=vpos.astype(np.int32),
             ind=rng.integers(0, 9, size=(len(vpos), 2)).astype(np.uint8),
             ni=rng.integers(0, 3, size=len(vpos)).astype(np.int8))
    args = (codes, quals, start, lo, hi)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    table = _port_table(d)
    for baseq in (0, 10):
        want = np.asarray(J.assign_compact_affine(
            *[jnp.asarray(x) for x in args], *jtab, baseq, 1 << 15))
        got = K.assign_compact_affine(*[_t(x) for x in args], table, baseq,
                                      1 << 15).numpy()
        np.testing.assert_array_equal(got, want)
        r, v, _, mc, nh = K.decode_packed_hits(got)
        pad_hits = int((mc == 0).sum())
        assert (pad_hits > 20) if baseq == 0 else pad_hits == 0
        if baseq == 0:
            base = lo[r] + (d["vpos"][v] - start[r])
            assert (base == L - 1).any() and (base >= 96).sum() == pad_hits


@pytest.mark.parametrize("cap", [1 << 15, 4])
def test_fetch_packed_hits_matches_jax(cap):
    """fetch_packed_hits == phaser_tpu's on the same program's buffer:
    (read, var, allele, base, n_hits), empty arrays past capacity."""
    d = _layout("lo_gt0")
    args = layouts.affine_planes_inputs(d)
    jtab = [jnp.asarray(d[k]) for k in ("vpos", "ind", "ni")]
    want = J.fetch_packed_hits(J.assign_compact_affine(
        *[jnp.asarray(x) for x in args], *jtab, 10, cap))
    got = K.fetch_packed_hits(K.assign_compact_affine(
        *[_t(x) for x in args], _port_table(d), 10, cap))
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4] > 4
    assert (len(got[0]) == 0) == (cap == 4)


def _entry_inputs(seed, M, N, L, contig, regions=None, holes=0.05):
    """tests/test_kernels.py:509-520's layout: reads uniformly over the
    contig or, with `regions`, in block-aligned narrow regions so that
    every 256-row block's band fits the window (tests/test_tpu_hw.py)."""
    rng = np.random.default_rng(seed)
    vpos = np.sort(rng.choice(np.arange(1, contig, dtype=np.int32), size=M,
                              replace=False)).astype(np.int32)
    ind = rng.integers(1, 9, size=(M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    if regions is None:
        starts = np.sort(rng.integers(1, contig - contig // 30, size=N))
    else:
        region_lo = rng.integers(1, contig - 20_000 - L, size=regions)
        starts = np.sort(np.concatenate([
            rng.integers(lo, lo + 20_000, size=N // regions)
            for lo in region_lo]))
    refpos = starts.astype(np.int32)[:, None] + \
        np.arange(L, dtype=np.int32)[None, :]
    refpos[rng.random((N, L)) < holes] = 0
    codes = rng.integers(1, 16, size=(N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, size=(N, L)).astype(np.uint8)
    return codes, quals, refpos, vpos, ind, ni


@pytest.mark.parametrize("layout", ["uniform", "regions"])
def test_windowed_entry_matches_jax(layout):
    """assign_alleles_pallas_windowed, gather and cmp, == JAX's (Pallas in
    interpret mode) == assign_alleles_device.  The uniform layout is
    tests/test_kernels.py:509-520's, whose bands overflow the window; the
    regions layout is planned (asserted, so the comparison is not
    vacuous)."""
    if layout == "uniform":
        arrays = _entry_inputs(5, 4000, 700, 128, 3_000_000)
    else:
        arrays = _entry_inputs(5, 4000, 768, 128, 3_000_000, regions=3)
    planned = K.plan_windows_plane(arrays[2], arrays[3], 256) is not None
    assert planned == (layout == "regions")
    jx = [jnp.asarray(x) for x in arrays]
    tx = [_t(x) for x in arrays]
    want_v, want_a = (np.asarray(x) for x in J.assign_alleles_device(*jx, 10))
    assert int((want_v >= 0).sum()) > 50
    got_v, got_a = K.assign_alleles_device(*tx, 10)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    for algo in ("gather", "cmp"):
        jv, ja = J.assign_alleles_pallas_windowed(*jx, 10, interpret=True,
                                                  algo=algo)
        np.testing.assert_array_equal(np.asarray(jv), want_v)
        np.testing.assert_array_equal(np.asarray(ja), want_a)
        for host in (False, True):
            kw = dict(refpos_host=arrays[2], vpos_host=arrays[3]) if host \
                else {}
            gv, ga = K.assign_alleles_pallas_windowed(*tx, 10, algo=algo,
                                                      **kw)
            assert gv.dtype == ga.dtype == torch.int32
            np.testing.assert_array_equal(gv.numpy(), want_v)
            np.testing.assert_array_equal(ga.numpy(), want_a)


def test_windowed_entry_band_overflow():
    """tests/test_kernels.py:541-552: a block spanning more than the window
    takes assign_alleles_device, in JAX and in the port."""
    rng = np.random.default_rng(6)
    M = 2000
    vpos = np.arange(1, M + 1, dtype=np.int32) * 7
    ind = rng.integers(1, 9, size=(M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    N, L = 300, 128
    starts = np.sort(rng.integers(1, M * 7 - L, size=N)).astype(np.int32)
    refpos = starts[:, None] + np.arange(L, dtype=np.int32)[None, :]
    codes = rng.integers(1, 16, size=(N, L)).astype(np.uint8)
    quals = np.full((N, L), 30, np.uint8)
    arrays = (codes, quals, refpos, vpos, ind, ni)
    assert K.plan_windows_plane(refpos, vpos, 256) is None
    jx = [jnp.asarray(x) for x in arrays]
    want = J.assign_alleles_pallas_windowed(*jx, 10, interpret=True)
    got = K.assign_alleles_pallas_windowed(*[_t(x) for x in arrays], 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0] >= 0).sum()) > 100


@pytest.mark.parametrize("M", [100, 300])
def test_resident_entry_matches_jax(M):
    """assign_alleles_pallas == JAX's under force_tpu_interpret_mode: the
    resident table when next_pow2(M) <= L, the windowed entry when M > L."""
    from jax.experimental.pallas import tpu as pltpu
    arrays = _entry_inputs(11, M, 300, 128, 20_000, holes=0.1)
    jx = [jnp.asarray(x) for x in arrays]
    with pltpu.force_tpu_interpret_mode():
        want = J.assign_alleles_pallas(*jx, 10)
    want = [np.asarray(w) for w in want]
    assert int((want[0] >= 0).sum()) > 50
    np.testing.assert_array_equal(
        want[0], np.asarray(J.assign_alleles_device(*jx, 10)[0]))
    got = K.assign_alleles_pallas(*[_t(x) for x in arrays], 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    r, v, a, n = K.compact_hits(*got, 1 << 14)
    jr, jv, ja, jn = J.compact_hits(*[jnp.asarray(w) for w in want], 1 << 14)
    assert n == int(jn) > 50
    for g, w in zip((r, v, a), (jr, jv, ja)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_hits_past_capacity():
    arrays = _entry_inputs(12, 500, 64, 128, 40_000)
    vidx, allele = K.assign_alleles_device(*[_t(x) for x in arrays], 10)
    jr, jv, ja, jn = J.compact_hits(jnp.asarray(vidx.numpy()),
                                    jnp.asarray(allele.numpy()), 16)
    r, v, a, n = K.compact_hits(vidx, allele, 16)
    assert n == int(jn) > 16
    for g, w in zip((r, v, a), (jr, jv, ja)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cmp_takes_the_last_duplicate():
    """On duplicate positions cmp keeps the last equal entry of the window
    and gather the first: why cmp is held to unique positions."""
    vpos = np.array([5, 9, 9, 12] + list(range(20, 148)), np.int32)
    M = len(vpos)
    ind = np.tile(np.array([[1, 2]], np.uint8), (M, 1))
    ni = np.full(M, 2, np.int8)
    refpos = np.zeros((1, 128), np.int32)
    refpos[0, :3] = (9, 12, 4)
    codes = np.full((1, 128), 1, np.uint8)
    quals = np.full((1, 128), 30, np.uint8)
    tx = [_t(x) for x in (codes, quals, refpos, vpos, ind, ni)]
    gv, _ = K.assign_alleles_pallas_windowed(*tx, 10)
    cv, _ = K.assign_alleles_pallas_windowed(*tx, 10, algo="cmp")
    assert gv[0, :3].tolist() == [1, 3, -1]
    assert cv[0, :3].tolist() == [2, 3, -1]


@pytest.mark.parametrize("layout", layouts.PLANES_NAMES)
def test_planes_layouts_match_jax(layout):
    """The planes plain versions on the layouts the card check adds (an L
    that is no multiple of 4 and one that is none of 16, spliced and descending rows, duplicate table
    positions, a window past the table's end; 1000 rows, no multiple of the
    row block) == JAX's assign_alleles_device and, where phaser_tpu plans
    windows (L % 128 == 0), its windowed Pallas programs in interpret mode:
    the search takes the first of equal entries, cmp the last."""
    arrays = layouts.planes_layout(layout)
    N, L = arrays[0].shape
    M = len(arrays[3])
    ws = K.plan_windows_plane(arrays[2], arrays[3], 256)
    assert ws is not None and N % 256 != 0
    if layout == "table_end":
        assert ws.max() + K._WIN > M and M % 4 != 0
    if layout == "pair_products":
        # the layout really makes (e0 - r)(e1 - r) vanish modulo 2^32 with
        # neither factor zero, for positions the reads hold
        v = arrays[3].astype(np.int64)
        for r, pair in ((5000, 32), (5005, 34)):
            d0, d1 = v[pair] - r, v[pair + 1] - r
            assert d0 and d1 and (d0 * d1) % (1 << 32) == 0
            assert (arrays[2] == r).sum() > 10
        assert 5000 in v and 5005 not in v
    jx = [jnp.asarray(x) for x in arrays]
    tx = [_t(x) for x in arrays]
    table = K._entry_table(*tx)
    want = [np.asarray(x) for x in J.assign_alleles_device(*jx, 10)]
    assert int((want[0] >= 0).sum()) > 50
    zero = torch.zeros(1, dtype=torch.int32)
    for got in (K.assign_alleles_device(*tx, 10),
                K.planes_plain(*tx[:3], 10, zero, M, N, table),
                K.planes_plain(*tx[:3], 10, _t(ws), K._WIN, 256, table),
                K.assign_alleles_pallas_windowed(*tx, 10)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    cmp = K.planes_cmp_plain(*tx[:3], 10, _t(ws), 256, table)
    if L % 128 == 0:
        for algo, got in (("gather", want),
                          ("cmp", [x.numpy() for x in cmp])):
            jv, ja = J.assign_alleles_pallas_windowed(*jx, 10, interpret=True,
                                                      algo=algo)
            np.testing.assert_array_equal(got[0], np.asarray(jv))
            np.testing.assert_array_equal(got[1], np.asarray(ja))
        entry = K.assign_alleles_pallas_windowed(*tx, 10, algo="cmp")
        assert torch.equal(entry[0], cmp[0]) and torch.equal(entry[1], cmp[1])
    differ = int((cmp[0].numpy() != want[0]).sum())
    assert (differ > 0) == (layout == "dup_positions")
    if differ == 0:
        np.testing.assert_array_equal(cmp[1].numpy(), want[1])
