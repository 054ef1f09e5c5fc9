"""The CUDA kernels of phaser_tpu_torch on a card, every test marked `gpu`:
each kernel against its plain PyTorch version on the same inputs (integers,
tolerance 0; packed hits after a (read, var) sort, since the kernels compact
with atomics; the float64 statistics kernels within 1e-12), the dispatcher
and the sharded step on the card against the host mapper and the CPU, and,
where jax is installed, the kernels against phaser_tpu's jnp programs.

Nothing here imports jax or phaser_tpu at module level, and the file puts
the repository's root on the import path itself, so on a machine that has
neither it runs without tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from phaser_tpu_torch.kernels import alleles as K
from phaser_tpu_torch.testing import layouts

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(x, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _sorted_hits(packed):
    r, v, a, mc, nh = K.decode_packed_hits(np.asarray(packed))
    order = np.lexsort((v, r))
    return nh, r[order], v[order], a[order], mc[order]


def _assert_same_hits(got, want):
    g, w = _sorted_hits(got), _sorted_hits(want)
    assert g[0] == w[0] > 0, (g[0], w[0])
    for a, b in zip(g[1:], w[1:]):
        np.testing.assert_array_equal(a, b)


def _affine_planes(codes, quals, start, lo, hi, table, cap):
    return K.assign_compact_affine(codes, quals, start, lo, hi, table, 10,
                                   cap)


FUSED = {
    "affine_nibble": (layouts.affine_inputs, K.assign_compact_affine_nibble,
                      ()),
    "affine_planes": (layouts.affine_planes_inputs, _affine_planes, ()),
    "affine_masked": (layouts.masked_inputs, K.assign_compact_affine_masked,
                      ()),
    "delta_nibble": (layouts.delta_inputs, K.assign_compact_delta_nibble, ()),
    "plane": (layouts.plane_inputs, K.assign_compact_plane, (10,)),
    "ragged_join": (layouts.ragged_inputs, K.assign_compact_ragged, (10,)),
}


@pytest.mark.parametrize("layout", layouts.NAMES)
@pytest.mark.parametrize("program", sorted(FUSED))
def test_fused_kernel_matches_plain(cuda, program, layout):
    """The wrapper on CUDA tensors (the kernel) == the wrapper on CPU
    tensors (the plain version), with room for every hit and at a capacity
    of 4 (exact count past capacity); one launch counted per call."""
    inputs, fn, extra = FUSED[program]
    d = layouts.make(layout, n_rows=3000, n_vars=2000, contig=600_000)
    arrays = inputs(d)
    table = layouts.padded_table(d)

    def run(device, cap):
        return fn(*[_t(x, device) for x in arrays], *extra,
                  tuple(_t(x, device) for x in table), cap)
    want = run("cpu", 1 << 20).numpy()
    before = K.LAUNCHES[program]
    got = run(cuda, 1 << 20)
    small = run(cuda, 4)
    torch.cuda.synchronize()
    assert K.LAUNCHES[program] == before + 2
    assert got.device.type == "cuda"
    _assert_same_hits(got.cpu().numpy(), want)
    small = small.cpu().numpy()
    assert small[0, 0] == want[0, 0]
    assert int((small[0, 1:] >= 0).sum()) == min(4, int(want[0, 0]))


@pytest.mark.parametrize("layout", ["sorted", "duplicates", "empty_rows"])
def test_affine_device_planes_on_the_card(cuda, layout):
    """assign_alleles_affine_device on CUDA tensors (the refpos plane formed
    on the card, then the planes kernel) == on CPU tensors, both planes."""
    d = layouts.make(layout, n_rows=3000, n_vars=2000, contig=600_000)
    arrays = layouts.affine_planes_inputs(d) + (d["vpos"], d["ind"], d["ni"])
    want = K.assign_alleles_affine_device(*[_t(x) for x in arrays], 10)
    before = K.LAUNCHES["planes_table"]
    got = K.assign_alleles_affine_device(*[_t(x, cuda) for x in arrays], 10)
    torch.cuda.synchronize()
    assert K.LAUNCHES["planes_table"] == before + 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    assert int((want[0] >= 0).sum()) > 0


def _planes_modes(arrays, device):
    """(name, counter, thunk) of every planes mode on `device`."""
    tx = [_t(x, device) for x in arrays]
    refpos, vpos = arrays[2], arrays[3]
    ws = _t(K.plan_windows_plane(refpos, vpos, 256), device)
    table = K._entry_table(*tx)
    N, M = refpos.shape[0], len(vpos)
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    seen = np.unique(refpos[refpos > 0])
    rng = np.random.default_rng(1)
    pick = np.sort(rng.choice(len(seen), 122, replace=False))
    rx = tx[:3] + [_t(seen[pick].astype(np.int32), device),
                   _t(rng.integers(1, 9, size=(122, 2)).astype(np.uint8),
                      device), _t(np.full(122, 2, np.int8), device)]
    rtable = K._entry_table(*rx)
    on_card = torch.device(device).type == "cuda"

    def windowed():
        if on_card:
            return K._launch_planes("planes_launch", "planes", *tx[:3], 10,
                                    ws, (K._WIN, 256), table, (0,))
        return K.planes_plain(*tx[:3], 10, ws, K._WIN, 256, table)

    def cmp():
        if on_card:
            return K._launch_planes("planes_cmp_launch", "planes_cmp",
                                    *tx[:3], 10, ws, (256,), table)
        return K.planes_cmp_plain(*tx[:3], 10, ws, 256, table)

    def resident():
        if on_card:
            return K._launch_planes("planes_launch", "planes_resident",
                                    *rx[:3], 10, zero, (122, N), rtable, (1,))
        return K.planes_plain(*rx[:3], 10, zero, 122, N, rtable)
    return (("windowed", "planes", windowed), ("cmp", "planes_cmp", cmp),
            ("whole_table", "planes_table" if M > K._WIN else "planes",
             lambda: K.assign_alleles_device(*tx, 10)),
            ("resident", "planes_resident", resident))


@pytest.mark.parametrize("layout", layouts.PLANES_NAMES)
def test_planes_kernels_match_plain(cuda, layout):
    """Every mode of the planes kernels (windowed search, cmp, whole table,
    resident table) == its plain version, on an L that is no multiple of
    4 and one that is none of 16, spliced and descending rows, duplicate
    table positions and a window past the table's end; 3001 rows, no
    multiple of the row block."""
    arrays = layouts.planes_layout(layout, n_rows=3001)
    wants = {name: fn() for name, _, fn in _planes_modes(arrays, "cpu")}
    for name, counter, fn in _planes_modes(arrays, cuda):
        before = K.LAUNCHES[counter]
        got = fn()
        torch.cuda.synchronize()
        assert K.LAUNCHES[counter] == before + 1
        assert int((wants[name][0] >= 0).sum()) > 0
        for g, w in zip(got, wants[name]):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("entry", ["gather", "cmp", "resident"])
def test_cuda_planes_match_plain(cuda, entry):
    """The public entries on the card == on the CPU, tests/test_kernels.py's
    layouts."""
    rng = np.random.default_rng(5)
    if entry == "resident":
        M, N, L, contig = 100, 300, 128, 20_000
        starts = np.sort(rng.integers(1, contig - contig // 30, size=N))
    else:
        M, N, L, contig = 4000, 768, 128, 3_000_000
        starts = np.sort(np.concatenate([
            rng.integers(lo, lo + 20_000, size=N // 3)
            for lo in rng.integers(1, contig - 20_000 - L, size=3)]))
    vpos = np.sort(rng.choice(np.arange(1, contig, dtype=np.int32), size=M,
                              replace=False)).astype(np.int32)
    refpos = starts.astype(np.int32)[:, None] + np.arange(L, dtype=np.int32)
    refpos[rng.random((N, L)) < 0.05] = 0
    arrays = (rng.integers(1, 16, size=(N, L)).astype(np.uint8),
              rng.integers(0, 40, size=(N, L)).astype(np.uint8), refpos, vpos,
              rng.integers(1, 9, size=(M, 2)).astype(np.uint8),
              np.full(M, 2, np.int8))
    counter = {"gather": "planes", "cmp": "planes_cmp",
               "resident": "planes_resident"}[entry]

    def run(device):
        tx = [_t(x, device) for x in arrays]
        if entry == "resident":
            return K.assign_alleles_pallas(*tx, 10)
        return K.assign_alleles_pallas_windowed(*tx, 10, algo=entry)
    want = run("cpu")
    before = K.LAUNCHES[counter]
    got = run(cuda)
    torch.cuda.synchronize()
    assert K.LAUNCHES[counter] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_dispatcher_on_the_card_matches_host(cuda, tmp_path, monkeypatch):
    """assign_alleles_auto on the card == the host mapper on a datagen
    fixture with spliced and indel reads: the pre-filter dropped rows, only
    filled columns were fetched, every upload left pinned memory."""
    from phaser_tpu_torch.engine.varmap import build_variant_table
    from phaser_tpu_torch.io import bam as bamio
    from phaser_tpu_torch.io import vcf as vcfio
    from phaser_tpu_torch.mapper import dispatch as D
    from phaser_tpu_torch.testing import datagen

    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=71, contigs=("chr20",), contig_len=120000,
        n_variants_per_contig=25, n_reads_per_contig=3000, frac_spliced=0.3,
        frac_indel_reads=0.2, error_rate=0.01)
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
             if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = build_variant_table("chr20", hs.pool["chr20"], include_indels=True)
    bd = bamio.read_bam(bam)
    bd = bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0))
    want = D.assign_alleles_auto(bd, vt, baseq=10, device="host")
    D.reset_stats()
    K.reset_launches()
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cuda")
    for f in ("read_idx", "var_idx", "allele_code"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.allele_strs == want.allele_strs and len(want) > 20
    st = D.STATS
    assert 0 < st["rows_kept"] < st["rows_in"] // 2
    assert st["uploads_pinned"] == st["uploads"] > 0
    assert st["columns_fetched"] == st["columns_needed"] \
        <= len(want) + st["parts_fetched"]
    assert sum(K.LAUNCHES.values()) == st["parts_fetched"] > 0


def test_read_spans_on_the_card(cuda, tmp_path, monkeypatch):
    """The tile kernels' shapes in the library are kernels.alleles' (read
    from csrc/alleles.cu); the read_spans kernel == its plain version on
    the reads of every layout of testing/layouts.py and on a datagen
    fixture's reads, there also == the dispatcher's span pass (the merge
    over the decode's span summary), in position order and shuffled; the
    dispatcher on the card == the host mapper, launching the ragged join
    alone."""
    from phaser_tpu_torch.engine.varmap import build_variant_table
    from phaser_tpu_torch.io import bam as bamio
    from phaser_tpu_torch.io import vcf as vcfio
    from phaser_tpu_torch.io.bam import OP_I, OP_N
    from phaser_tpu_torch.mapper import dispatch as D
    from phaser_tpu_torch.testing import datagen

    for kernel, want in (("ragged_join", (K.JOIN_TILE, K.JOIN_OPS,
                                          K.JOIN_STAGE)),
                         ("read_spans", (K.SPAN_TILE, 0, K.SPAN_STAGE))):
        sh = K.tile_shape(kernel)
        assert (sh["tile_rows"], sh["op_stage"], sh["table_stage"]) == want
    for layout in layouts.NAMES:
        d = layouts.make(layout, n_rows=3000, n_vars=2000, contig=600_000)
        pos, co, cig = layouts.ragged_inputs(d)[:3]
        args = [_t(x) for x in (pos, co.astype(np.int64), cig,
                                layouts.padded_table(d)[0])]
        np.testing.assert_array_equal(
            K.read_spans(*[a.to(cuda) for a in args], OP_I, OP_N).cpu(),
            K.read_spans(*args, OP_I, OP_N))
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=72, contigs=("chr20",), contig_len=60000,
        n_variants_per_contig=60, n_reads_per_contig=4000, frac_spliced=0.3,
        frac_indel_reads=0.2, error_rate=0.01)
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
             if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = build_variant_table("chr20", hs.pool["chr20"], include_indels=True)
    bd = bamio.read_bam(bam)
    bd = bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0))
    dev_pos = vt.pos[vt.is_simple]
    vpos = np.full(-(-len(dev_pos) // 4) * 4, 2 ** 31 - 1, np.int32)
    vpos[:len(dev_pos)] = dev_pos
    for part in (bd, bd.select(np.random.default_rng(1).permutation(
            len(bd)))):
        args = [_t(x) for x in (part.pos, part.cigar_off,
                                part.cigar_flat.view(np.int32), vpos)]
        want = K.read_spans(*args, OP_I, OP_N)
        got = K.read_spans(*[a.to(cuda) for a in args], OP_I, OP_N)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        flags = got.cpu().numpy()
        for bit, b in zip((K.SPAN_INS, K.SPAN_SPLICED, K.SPAN_NEAR),
                          D._read_spans(part, dev_pos)):
            np.testing.assert_array_equal((flags & bit) != 0, b)
    host = D.assign_alleles_auto(bd, vt, baseq=10, device="host")
    K.reset_launches()
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cuda")
    for f in ("read_idx", "var_idx", "allele_code"):
        np.testing.assert_array_equal(getattr(got, f), getattr(host, f))
    assert {k for k, n in K.LAUNCHES.items() if n} == {"ragged_join"}


@pytest.mark.parametrize("program", ["affine_nibble", "delta_nibble", "plane"])
def test_cuda_kernel_matches_jax(tmp_path, cuda, program):
    """On the card: the CUDA kernel == JAX's jnp program on a datagen
    fixture, after a (read, var) sort.  Needs jax beside the card."""
    pytest.importorskip("jax")
    import test_torch_alleles as A
    N, _, jax_plain, port, plans = A.CASES[program](tmp_path)
    cap = 1 << 13
    want = np.asarray(jax_plain(cap))
    before = K.LAUNCHES[program]
    outs = [port(cap, planned, cuda) for planned in plans]
    torch.cuda.synchronize()
    assert K.LAUNCHES[program] == before + len(plans)
    for got in outs:
        assert got.device.type == "cuda"
        _assert_same_hits(got.cpu().numpy(), want)


def test_cuda_affine_planes_matches_jax(tmp_path, cuda):
    """On the card: assign_compact_affine == JAX's jnp program on
    pack_affine's planes of real reads.  Needs jax beside the card."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import test_torch_alleles as A
    from phaser_tpu.kernels import alleles as J
    bd, _ = A._pack_affine_reads(tmp_path)
    codes, quals, ia, start, lo, hi = K.pack_affine(bd)
    start, lo, hi = (np.where(ia, x, 0).astype(np.int32)
                     for x in (start, lo, hi))
    d = layouts.make("sorted", n_vars=3000, contig=100_000)
    args = (codes, quals, start, lo, hi)
    want = np.asarray(J.assign_compact_affine(
        *[jnp.asarray(x) for x in args + (d["vpos"], d["ind"], d["ni"])],
        10, 1 << 13))
    before = K.LAUNCHES["affine_planes"]
    got = K.assign_compact_affine(
        *[_t(x, cuda) for x in args],
        tuple(_t(x, cuda) for x in layouts.padded_table(d)), 10, 1 << 13)
    torch.cuda.synchronize()
    assert K.LAUNCHES["affine_planes"] == before + 1
    _assert_same_hits(got.cpu().numpy(), want)


def test_cuda_affine_masked_matches_jax(tmp_path, cuda):
    pytest.importorskip("jax")
    import test_torch_alleles as A
    N, jax_plain, port = A._affine_masked_case(tmp_path)
    cap = 1 << 13
    want = np.asarray(jax_plain(cap))
    before = K.LAUNCHES["affine_masked"]
    got = port(cap, cuda)
    torch.cuda.synchronize()
    assert K.LAUNCHES["affine_masked"] == before + 1
    _assert_same_hits(got.cpu().numpy(), want)


# ---------------------------------------------------------------------------
# the sharded step's kernels: band_counts (csrc/mesh.cu), binom_cdf and
# conflict_prune (csrc/stats.cu)
# ---------------------------------------------------------------------------

def _planes_with_repeats(N, L, M, seed):
    """(vidx, allele) planes with rows in no order, a variant repeated
    inside every row and 30% non-hits (vidx -1, allele 3)."""
    rng = np.random.default_rng(seed)
    vidx = rng.integers(0, M, (N, L)).astype(np.int32)
    vidx[:, 5] = vidx[:, 2]
    allele = rng.integers(0, 3, (N, L)).astype(np.int32)
    miss = rng.random((N, L)) < 0.3
    vidx[miss], allele[miss] = -1, 3
    return vidx, allele


@pytest.mark.parametrize("shape", [(3001, 100, 500, 8), (517, 1000, 4000, 8),
                                   (2048, 128, 300, 3), (1000, 64, 50, 0)])
def test_band_counts_kernel_matches_plain(cuda, shape):
    """band_counts on the card == its plain version (integers, tolerance 0):
    an L that is no multiple of 32, an L that takes fewer warps a block,
    band 0 (counts alone); one launch counted."""
    from phaser_tpu_torch.dist import mesh as TM
    N, L, M, band = shape
    vidx, allele = _planes_with_repeats(N, L, M, seed=N)
    want = TM.band_counts(_t(vidx), _t(allele), M, band)
    before = TM.LAUNCHES["band_counts"]
    got = TM.band_counts(_t(vidx, cuda), _t(allele, cuda), M, band)
    torch.cuda.synchronize()
    assert TM.LAUNCHES["band_counts"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert int(want[0].sum()) > 0


@pytest.mark.parametrize("band", [0, 1, 8, 16])
@pytest.mark.parametrize("name", layouts.BAND_NAMES)
def test_band_counts_kernel_on_its_branches(cuda, name, band):
    """band_counts on the card == its plain version (tolerance 0) on the
    inputs its design branches on (testing/layouts.band_planes: rows whose
    variants decrease, variants repeated in a row, sorted rows over many
    shared-memory windows and the same rows reversed, rows of 6,144 bases
    and of 77); one launch counted, and the blocks that took the window:
    some on sorted rows (of 6,144 bases only at band 0: two such rows span
    more variants than a wider band's window holds), none on reversed
    rows."""
    from phaser_tpu_torch.dist import mesh as TM
    vidx, allele, M = layouts.band_planes(name)
    want = TM.band_counts(_t(vidx), _t(allele), M, band)
    TM.reset_launches()
    got = TM.band_counts(_t(vidx, cuda), _t(allele, cuda), M, band)
    stats = TM.read_stats()
    assert TM.LAUNCHES["band_counts"] == 1 and stats["blocks"] > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert int(want[0].sum()) > 0
    if band:
        assert int(want[1].sum()) > 0
    if name in ("sorted", "descending_in_row", "odd_length") or \
            (name == "long_rows" and band == 0):
        assert stats["window_blocks"] > 0, stats
    if name == "reversed":
        assert stats["window_blocks"] == 0, stats


@pytest.mark.parametrize("m", [7120, 100_000])
def test_band_prune_matches_three_call_tail(cuda, m):
    """band_prune on the card == the three calls it replaces (band_configs,
    noise_from_counts, prune_mask's plain version) on the same CUDA
    tensors: p within 1e-12, prune and uncertain equal; two launches
    counted; and equal to the tail on the CPU."""
    from phaser_tpu_torch.kernels import stats as S
    counts, pair = layouts.band_tail(m, 8, seed=m)
    c, b = _t(counts, cuda), _t(pair, cuda)
    want = S.conflict_prune_plain(*S.band_configs(b),
                                  S.noise_from_counts(c), 0.01)
    on_cpu = S.band_prune(_t(counts), _t(pair), 0.01)
    before = S.LAUNCHES["conflict_prune"]
    got = S.band_prune(c, b, 0.01)
    torch.cuda.synchronize()
    assert S.LAUNCHES["conflict_prune"] == before + 2
    assert got[0].dtype == torch.float64 and tuple(got[0].shape) == (m, 8)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=0, atol=1e-12)
    for g, w, h in zip(got[1:], want[1:], on_cpu[1:]):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        np.testing.assert_array_equal(g.cpu().numpy(), h.numpy())
    assert 0 < int(want[1].sum()) < want[1].numel()


def test_band_prune_of_an_empty_band_launches_nothing(cuda):
    from phaser_tpu_torch.kernels import stats as S
    counts = torch.ones((5, 3), dtype=torch.int32, device=cuda)
    pair = torch.zeros((5, 0, 9), dtype=torch.int32, device=cuda)
    before = S.LAUNCHES["conflict_prune"]
    p, prune, unc = S.band_prune(counts, pair, 0.01)
    assert S.LAUNCHES["conflict_prune"] == before
    assert tuple(p.shape) == tuple(prune.shape) == (5, 0)


def test_sharded_step_on_the_card_matches_cpu(cuda):
    """sharded_phasing_step on a 2-shard mesh on the card == on the CPU
    (scaling_bench's dense layout): counts, pair and scores equal, prune
    equal; the path launched planes_table, band_counts and band_prune's
    two connection-test kernels."""
    from phaser_tpu_torch.dist import mesh as TM
    from phaser_tpu_torch.dist.scaling_bench import _gen
    from phaser_tpu_torch.kernels import stats as S
    args = _gen(4096, 128, 2048)
    want = TM.sharded_phasing_step(TM.make_mesh(2, device="cpu"), *args, 10)
    K.reset_launches()
    TM.reset_launches()
    S.reset_launches()
    got = TM.sharded_phasing_step(TM.make_mesh(2, device=cuda), *args, 10)
    torch.cuda.synchronize()
    assert K.LAUNCHES["planes_table"] == 2
    assert TM.LAUNCHES["band_counts"] == 2
    assert S.LAUNCHES["conflict_prune"] == 2   # band_prune's two launches
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert int(want[1].sum()) > 0 and 0 < int(want[2].sum())


def test_binom_cdf_kernel_matches_plain(cuda):
    """binom_cdf on the card == its plain version on the same CUDA tensors
    within 1e-12 (float64 both, one lgamma), and within 1e-10 of the plain
    version on the CPU (whose lgamma differs in the last bits of terms that
    reach 1e5 at n = 10,000), with the edge rules (k >= n, k < 0, p of 0
    and 1, fractional k)."""
    from phaser_tpu_torch.kernels import stats as S
    rng = np.random.default_rng(3)
    n = rng.integers(0, 10_000, 20_000).astype(np.float64)
    k = np.floor(n * rng.random(20_000)) + rng.integers(-2, 3, 20_000)
    k[::97] += 0.5
    p = rng.uniform(0.0, 1.0, 20_000)
    p[::101], p[::103] = 0.0, 1.0
    on_cpu = S.binom_cdf(_t(k), _t(n), _t(p)).numpy()
    want = S.binom_cdf_plain(_t(k, cuda), _t(n, cuda), _t(p, cuda))
    before = S.LAUNCHES["binom_cdf"]
    got = S.binom_cdf(_t(k, cuda), _t(n, cuda), _t(p, cuda))
    torch.cuda.synchronize()
    assert S.LAUNCHES["binom_cdf"] == before + 1
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.cpu().numpy(), on_cpu, rtol=0, atol=1e-10)


def test_conflict_prune_kernel_matches_plain(cuda):
    """The fused conflict test on the card == its plain version: p within
    1e-12, prune and uncertain equal (no p lies within 1e-12 of these
    thresholds), the noise rate read from the card."""
    from phaser_tpu_torch.kernels import stats as S
    rng = np.random.default_rng(4)
    a = rng.integers(0, 60, 50_000).astype(np.int32)
    b = rng.integers(0, 12, 50_000).astype(np.int32)
    o = rng.integers(0, 9, 50_000).astype(np.int32)
    a[::11] = b[::11] = 0
    o[::13] = 0
    for thr in (0.01, 0.2):
        want = S.prune_mask(_t(a), _t(b), _t(o), 0.0037, thr)
        noise = torch.tensor(0.0037, dtype=torch.float64, device=cuda)
        before = S.LAUNCHES["conflict_prune"]
        got = S.prune_mask(_t(a, cuda), _t(b, cuda), _t(o, cuda), noise, thr)
        torch.cuda.synchronize()
        assert S.LAUNCHES["conflict_prune"] == before + 1
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   rtol=0, atol=1e-12)
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
        assert 0 < int(want[1].sum()) < len(a)


def _live_case(case, seed=5):
    """(k, n, p) float64 numpy inputs of binom_cdf with a given share of
    elements left for the fraction after the edge rules."""
    rng = np.random.default_rng(seed)
    if case == "edges":
        k = np.array([0., 5., 5., -1., 3., 3., 2.7, 0., 7., 4., 9.5, -0.5])
        n = np.array([0., 5., 4., 3., 10., 10., 9., 12., 9., 4., 10., 6.])
        p = np.array([0.5, 0.5, 0.5, 0.5, 0.0, 1.0, 0.3, 0.02, 0.999, 0.7,
                      0.9, 0.4])
        return k, n, p
    if case == "n_100000":
        n = np.full(2000, 100_000.0)
        p = rng.uniform(0.001, 0.999, 2000)
        return np.floor(n * p), n, p
    if case == "binom_long":
        k, n, p = layouts.binom_long(65_536, seed=1)
        return k.astype(np.float64), n.astype(np.float64), p
    size = 56_960
    n = rng.integers(1, 80, size).astype(np.float64)
    k = np.floor(n * rng.random(size))
    p = rng.uniform(0.97, 0.994, size)
    share = {"all_live": 1.0, "live_1.5": 0.015, "none_live": 0.0}[case]
    dead = rng.random(size) >= share
    k[dead] = np.where(rng.random(int(dead.sum())) < 0.5, n[dead], -1.0)
    return k, n, p


@pytest.mark.parametrize("case", ["edges", "all_live", "live_1.5",
                                  "none_live", "binom_long", "n_100000"])
def test_binom_cdf_kernel_on_its_live_shares(cuda, case):
    """binom_cdf on the card == its plain version within 1e-12 on the edge
    rules, with every element, 1.5% of them and none left for a fraction,
    on layouts.binom_long's long fractions and at n = 100,000 at the mean
    (237 terms); one launch counted."""
    from phaser_tpu_torch.kernels import stats as S
    k, n, p = (_t(x, cuda) for x in _live_case(case))
    want = S.binom_cdf_plain(k, n, p)
    terms = S.binom_cdf_terms(k, n, p)
    before = S.LAUNCHES["binom_cdf"]
    got = S.binom_cdf(k, n, p)
    torch.cuda.synchronize()
    assert S.LAUNCHES["binom_cdf"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-12)
    if case == "none_live":
        assert int(terms.max()) == 0
    elif case == "n_100000":
        assert int(terms.max()) >= 200
    else:
        assert int(terms.max()) > 0


def test_binom_cdf_kernel_takes_operands_as_they_come(cuda):
    """int32 k and n, k non-contiguous, p with stride 0, p a 0-d tensor and
    a Python float: the kernel reads each in place and gives the float64
    contiguous call's values bit for bit, within 1e-12 of the plain
    version."""
    from phaser_tpu_torch.kernels import stats as S
    rng = np.random.default_rng(9)
    n = rng.integers(0, 200, (400, 8)).astype(np.int32)
    kk = (n * rng.random(n.shape)).astype(np.int32)
    wide = np.zeros((400, 16), np.int32)
    wide[:, ::2] = kk
    k_strided = _t(wide, cuda)[:, ::2]
    assert not k_strided.is_contiguous()
    ps = 0.9817
    p0 = torch.tensor(ps, dtype=torch.float64, device=cuda)
    ref = S.binom_cdf(_t(kk.astype(np.float64), cuda),
                      _t(n.astype(np.float64), cuda),
                      torch.full(n.shape, ps, dtype=torch.float64,
                                 device=cuda))
    want = S.binom_cdf_plain(_t(kk, cuda), _t(n, cuda), p0)
    for k, p in ((_t(kk, cuda), p0), (k_strided, p0),
                 (_t(kk, cuda), p0.expand(n.shape)),
                 (k_strided, ps), (_t(kk, cuda).t().contiguous().t(), p0)):
        got = S.binom_cdf(k, _t(n, cuda), p)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    np.testing.assert_allclose(ref.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-12)


def test_conflicting_config_p_on_the_card(cuda):
    """conflicting_config_p on CUDA tensors (one binom_cdf launch that
    reads the int32 counts and the noise rate on the card and takes the
    edge rules: one device activity a call) == the plain conflict test
    within 1e-12, with its edge rules exact; a Python-float noise rate and
    int64 counts give the same p; floating-point counts raise."""
    from phaser_tpu_torch.kernels import stats as S
    from phaser_tpu_torch.utils.trace import device_activity
    counts, pair = layouts.band_tail(7120, 8, seed=3)
    c, b = _t(counts, cuda), _t(pair, cuda)
    cfg = S.band_configs(b)
    noise = S.noise_from_counts(c)
    want = S.conflict_terms(*cfg, noise)[0]
    before = S.LAUNCHES["binom_cdf"]
    got = S.conflicting_config_p(*cfg, noise)
    torch.cuda.synchronize()
    assert S.LAUNCHES["binom_cdf"] == before + 1
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-12)
    edge = (want == 0) | (want == 1)
    assert torch.equal(got[edge], want[edge]) and int(edge.sum()) > 0
    assert torch.equal(S.conflicting_config_p(*(t.long() for t in cfg),
                                              float(noise)), got)
    seen = device_activity(lambda: S.conflicting_config_p(*cfg, noise), 5)
    assert seen is not None and seen[1] == 1, seen
    with pytest.raises(ValueError, match="integer counts"):
        S.conflicting_config_p(cfg[0].double(), cfg[1], cfg[2], noise)


@pytest.mark.parametrize("inputs", ["band_tail_7120", "band_tail_100000",
                                    "band_long"])
def test_band_prune_kernel_holds_its_plain_version(cuda, inputs):
    """band_prune on the card against band_prune_plain: p within 1e-12,
    prune equal wherever |p - threshold| > 1e-12, and two device
    activities a call (the profiler, utils/trace.device_activity)."""
    from phaser_tpu_torch.kernels import stats as S
    from phaser_tpu_torch.utils.trace import device_activity
    if inputs == "band_long":
        counts, pair = layouts.band_long(8192, 8, seed=2)
    else:
        m = int(inputs.rsplit("_", 1)[1])
        counts, pair = layouts.band_tail(m, 8, seed=m)
    c, b = _t(counts, cuda), _t(pair, cuda)
    want = S.band_prune_plain(c, b, 0.01)
    got = S.band_prune(c, b, 0.01)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=0, atol=1e-12)
    sure = (want[0] - 0.01).abs() > 1e-12
    assert torch.equal(got[1][sure], want[1][sure])
    seen = device_activity(lambda: S.band_prune(c, b, 0.01), 5)
    assert seen is not None and seen[1] == 2, seen


def test_lgamma_table_is_the_kernels_lgamma(cuda):
    """The prefactor's log-factorial table: torch.lgamma's values, each
    replaced by the kernels' own lgamma where the two differ (counted)."""
    from phaser_tpu_torch.kernels import stats as S
    table = S.lgamma_table(cuda)
    mismatches = S.lgamma_table_mismatches(cuda)
    torch_lg = torch.arange(S.LGAMMA_TABLE_SIZE, dtype=torch.float64,
                            device=cuda).lgamma()
    assert table.numel() == S.LGAMMA_TABLE_SIZE
    assert torch.isfinite(table[1:]).all() and float(table[1]) == 0.0
    assert int((table != torch_lg).sum()) == mismatches


def test_span_holds_the_kernel_it_waits_for(cuda, tmp_path):
    """Under a profiler of CUDA activity only (the benchmark's), the kineto
    state reads enabled on this thread, so a span records; a span around
    torch.cuda._sleep and a synchronize holds the kernel: its interval in
    the Chrome trace (ts + baseTimeNanoseconds) lies inside the span mapped
    to unix time through its run's anchor, within 0.5 ms."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from phaser_tpu_torch.utils import trace
    trace.clear_spans()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch._C._autograd._profiler_enabled()
        with trace.span("sleep") as sp:
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    data = json.load(open(path))
    base = data["baseTimeNanoseconds"]
    kernels = [e for e in data["traceEvents"] if e.get("cat") == "kernel"]
    assert sp is not None and len(kernels) == 1, kernels
    s = float(kernels[0]["ts"]) * 1e3 + base
    e = s + float(kernels[0]["dur"]) * 1e3
    lo, hi = trace.unix_interval(sp)
    assert lo - 5e5 <= s and e <= hi + 5e5, (s - lo, hi - e)
    assert e - s > 1e6
    trace.clear_spans()


def test_profile_dir_trace_of_a_run_on_the_card(cuda, tmp_path, monkeypatch):
    """PHASER_TPU_PROFILE_DIR on the card: one Chrome trace a CLI run with
    the card's operations (CUDA activity only, no CPU ops) and the run's
    spans on the same axis; every device operation, and the longest idle
    gap between two of them, falls under a named child of `phaser run`."""
    import contextlib
    import io
    import json

    from phaser_tpu_torch.cli import phaser_main
    from phaser_tpu_torch.testing import datagen
    from phaser_tpu_torch.utils import trace
    vcf, bam, data = datagen.write_fixture_dir(
        str(tmp_path), seed=51, contigs=("chr20",), contig_len=20000,
        n_variants_per_contig=100, n_reads_per_contig=1500)
    prof = tmp_path / "prof"
    monkeypatch.setenv("PHASER_TPU_PROFILE_DIR", str(prof))
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    argv = ["--vcf", vcf, "--bam", bam, "--sample", data.sample,
            "--mapq", "10", "--baseq", "10", "--paired_end", "1",
            "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        for k in range(2):
            assert phaser_main.main(argv + ["--o", str(tmp_path / "o")]) == 0
    files = sorted(os.listdir(str(prof)))
    assert len(files) == 2
    ev = json.load(open(str(prof / files[-1])))["traceEvents"]
    assert not any(e.get("cat") in ("cpu_op", "python_function")
                   for e in ev)
    dev = sorted((e for e in ev if e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: float(e["ts"]))
    spans = [e for e in ev if e.get("cat") == "phaser_span"]
    run, = [e for e in spans if e["name"] == "phaser run"]
    kids = [e for e in spans if e["args"]["parent"] == run["args"]["id"]]
    assert dev and any(e["name"] == "#2 allele assignment" for e in kids)

    def under(t):
        return [e["name"] for e in kids
                if e["ts"] <= t <= e["ts"] + e["dur"]]
    for e in dev:
        assert run["ts"] <= float(e["ts"]) <= run["ts"] + run["dur"], e
    gaps = [(float(b["ts"]) - float(a["ts"]) - float(a["dur"]),
             float(a["ts"]) + float(a["dur"]), float(b["ts"]))
            for a, b in zip(dev, dev[1:])]
    if gaps:
        _, g0, g1 = max(gaps)
        assert under(g0) or under(g1)
    trace.clear_spans()
