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


FUSED = {
    "affine_nibble": (layouts.affine_inputs, K.assign_compact_affine_nibble,
                      ()),
    "affine_masked": (layouts.masked_inputs, K.assign_compact_affine_masked,
                      ()),
    "delta_nibble": (layouts.delta_inputs, K.assign_compact_delta_nibble, ()),
    "plane": (layouts.plane_inputs, K.assign_compact_plane, (10,)),
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


def test_sharded_step_on_the_card_matches_cpu(cuda):
    """sharded_phasing_step on a 2-shard mesh on the card == on the CPU
    (scaling_bench's dense layout): counts, pair and scores equal, prune
    equal; the path launched planes_table, band_counts and
    conflict_prune."""
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
    assert S.LAUNCHES["conflict_prune"] == 1
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
