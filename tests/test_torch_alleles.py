"""phaser_tpu_torch allele kernels against phaser_tpu's three fused programs.

Every comparison is of integers, tolerance 0.  On the CPU the port's
wrappers run their plain PyTorch versions; the JAX side runs the windowed
Pallas programs in interpret mode and their unwindowed jnp twins, as
tests/test_kernels.py does.  The plain versions compact in row-major order,
so their packed buffers must equal JAX's word for word; the CUDA kernels
compact with atomics, so those are compared after a (read, var) sort.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import datagen
from phaser_tpu.engine.varmap import build_variant_table
from phaser_tpu.io import bam as bamio
from phaser_tpu.io import vcf as vcfio
from phaser_tpu.kernels import alleles as J
from phaser_tpu_torch.kernels import alleles as K


def _fixture(tmp_path, seed, **kw):
    kw.setdefault("contigs", ("chr20",))
    kw.setdefault("contig_len", 30000)
    kw.setdefault("n_variants_per_contig", 150)
    kw.setdefault("frac_indel_reads", 0.0)
    vcf, bam, _ = datagen.write_fixture_dir(str(tmp_path), seed=seed, **kw)
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
             if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = build_variant_table("chr20", hs.pool["chr20"])
    bd = bamio.read_bam(bam)
    return bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0)), vt


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
    chunk, vt = _fixture(tmp_path, 13, n_reads_per_contig=220)
    nb = K.pack_affine_nibble(chunk, 10)
    for a, b in zip(nb, J.pack_affine_nibble(chunk, 10)):
        np.testing.assert_array_equal(a, b)
    ncodes, ia, st, lo, hi = nb
    st, lo, hi = (np.where(ia, x, 0).astype(np.int32) for x in (st, lo, hi))
    N = ncodes.shape[0]
    vpos, (jv, ji, jn), table = _tables(vt)
    ws = K.plan_windows_affine(st, lo, hi, hi > lo, vpos, N, min(256, N))
    np.testing.assert_array_equal(
        ws, J.plan_windows_affine(st, lo, hi, hi > lo, vpos, N, min(256, N)))
    jargs = [jnp.asarray(x) for x in (ncodes, st, lo, hi)]

    def jax_windowed(cap):
        return J._nibble_windowed_impl(*jargs, jnp.asarray(ws), jv, ji, jn,
                                       cap, interpret=True)

    def jax_plain(cap):
        return J.assign_compact_affine_nibble(*jargs, jv, ji, jn, cap)

    def port(cap, planned=True, device="cpu"):
        return K.assign_compact_affine_nibble(
            *[_t(x, device) for x in (ncodes, st, lo, hi)],
            _on(table, device), cap, ws=_t(ws, device) if planned else None)
    return N, jax_windowed, jax_plain, port


def _delta_case(tmp_path):
    chunk, vt = _fixture(tmp_path, 44, n_reads_per_contig=400,
                         frac_spliced=0.35, frac_indel_reads=0.5)
    dn = K.pack_delta_nibble(chunk, 10)
    for a, b in zip(dn, J.pack_delta_nibble(chunk, 10)):
        np.testing.assert_array_equal(a, b)
    ncd, dlt, okm, dst, rmn, rmx = dn
    ok = np.flatnonzero(okm)
    ncd, dlt, dst, rmn, rmx = (x[ok] for x in (ncd, dlt, dst, rmn, rmx))
    N = ok.size
    vpos, (jv, ji, jn), table = _tables(vt)
    valid = np.ones(N, bool)
    ws = K.plan_windows_minmax(rmn, rmx, valid, vpos, N, min(256, N))
    np.testing.assert_array_equal(
        ws, J.plan_windows_minmax(rmn, rmx, valid, vpos, N, min(256, N)))
    jargs = [jnp.asarray(x) for x in (ncd, dst, dlt)]

    def jax_windowed(cap):
        return J._delta_windowed_impl(*jargs, jnp.asarray(ws), jv, ji, jn,
                                      cap, interpret=True)

    def jax_plain(cap):
        return J.assign_compact_delta_nibble(*jargs, jv, ji, jn, cap)

    def port(cap, planned=True, device="cpu"):
        return K.assign_compact_delta_nibble(
            *[_t(x, device) for x in (ncd, dst, dlt)], _on(table, device),
            cap, ws=_t(ws, device) if planned else None)
    return N, jax_windowed, jax_plain, port


def _plane_case(tmp_path):
    chunk, vt = _fixture(tmp_path, 14, n_reads_per_contig=200,
                         frac_spliced=0.5)
    planes = K.pack_reads(chunk)
    for a, b in zip(planes, J.pack_reads(chunk)):
        np.testing.assert_array_equal(a, b)
    codes, quals, refpos = planes
    N = codes.shape[0]
    vpos, (jv, ji, jn), table = _tables(vt)
    ws = K.plan_windows_plane(refpos, vpos, min(256, N))
    np.testing.assert_array_equal(
        ws, J.plan_windows_plane(refpos, vpos, min(256, N)))
    jargs = [jnp.asarray(x) for x in planes]

    def jax_windowed(cap):
        return J._plane_windowed_impl(*jargs, jnp.asarray(ws), jv, ji, jn,
                                      10, cap, interpret=True)

    def jax_plain(cap):
        return J.assign_compact_plane(*jargs, jv, ji, jn, 10, cap)

    def port(cap, planned=True, device="cpu"):
        return K.assign_compact_plane(
            *[_t(x, device) for x in planes], 10, _on(table, device), cap,
            ws=_t(ws, device) if planned else None)
    return N, jax_windowed, jax_plain, port


CASES = {"affine_nibble": _affine_case, "delta_nibble": _delta_case,
         "plane": _plane_case}


@pytest.mark.parametrize("program", sorted(CASES))
def test_program_matches_jax(tmp_path, program):
    """Each program's plain version (planned windows and whole table) ==
    the JAX windowed Pallas program (interpret) == its jnp twin."""
    N, jax_windowed, jax_plain, port = CASES[program](tmp_path)
    cap = 1 << 13
    want = np.asarray(jax_plain(cap))
    np.testing.assert_array_equal(np.asarray(jax_windowed(cap)), want)
    assert want[0, 0] > 5
    for planned in (True, False):
        got = port(cap, planned).numpy()
        np.testing.assert_array_equal(got, want)
        _assert_same_hits(got, want)


@pytest.mark.parametrize("program", sorted(CASES))
def test_capacity_overflow_keeps_exact_count(tmp_path, program):
    """Past capacity the hit counter stays exact and only `cap` hits are
    written, as in phaser_tpu's _pack_hits."""
    N, _, jax_plain, port = CASES[program](tmp_path)
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
    assert K.plan_windows_affine(starts, lo, hi, hi > lo, vpos, N, 256) is None
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
                                 cap, ws=_t(ws)).numpy()
    np.testing.assert_array_equal(got, want)
    r = K.decode_packed_hits(got)[0]
    assert r.max() >= 256


def test_wrappers_check_their_inputs():
    table = tuple(torch.zeros(8, dtype=torch.int32) for _ in range(4))
    nc = torch.zeros((4, 64), dtype=torch.uint8)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        K.assign_compact_affine_nibble(nc, z.long(), z, z, table, 16)
    with pytest.raises(ValueError, match="shape"):
        K.assign_compact_affine_nibble(nc, z, z, z, table, 16,
                                       ws=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        K.assign_compact_plane(torch.zeros((64, 4), dtype=torch.uint8).t(),
                               torch.zeros((4, 64), dtype=torch.uint8),
                               torch.zeros((4, 64), dtype=torch.int32), 10,
                               table, 16)
    before = dict(K.LAUNCHES)
    meta = torch.zeros((4, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        K.assign_compact_affine_nibble(
            meta, *[torch.zeros(4, dtype=torch.int32, device="meta")] * 3,
            _on(table, "meta"), 16)
    # plain runs on CPU tensors never count as kernel launches
    K.assign_compact_affine_nibble(nc, z, z, z, table, 16)
    assert K.LAUNCHES == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("program", sorted(CASES))
def test_cuda_kernel_matches_plain(tmp_path, cuda, program):
    """On the card: the CUDA kernel == the plain version == JAX's jnp
    program, planned and whole-table, after a (read, var) sort."""
    N, _, jax_plain, port = CASES[program](tmp_path)
    cap = 1 << 13
    want = np.asarray(jax_plain(cap))
    before = K.LAUNCHES[program]
    outs = [port(cap, planned, cuda) for planned in (True, False)]
    torch.cuda.synchronize()
    assert K.LAUNCHES[program] == before + 2
    for got in outs:
        assert got.device.type == "cuda"
        _assert_same_hits(got.cpu().numpy(), want)
