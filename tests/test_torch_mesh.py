"""phaser_tpu_torch.dist.mesh (the sharded step) against phaser_tpu.dist.mesh
on the same numpy inputs: the port's 8-shard local mesh on the CPU against
JAX's 8-device virtual CPU mesh (tests/conftest.py).  Counts, pair band and
scores are integers and must be equal (tolerance 0); pruning must be equal
outside the band where JAX's float32 p-value is not sure (|p - threshold|
<= 1e-3 by scipy).  band_counts_plain, the plain version of the
band_counts kernel, is also held against a per-row Python loop on rows with
repeated variants and in no order."""

import numpy as np
import pytest
import torch

from phaser_tpu.dist import mesh as JM
from phaser_tpu_torch.dist import dryrun
from phaser_tpu_torch.dist import mesh as TM
from phaser_tpu_torch.dist.scaling_bench import _gen
from phaser_tpu_torch.testing import layouts


def _kernels_166(seed=0, N=64, L=128, M=50, span=5000):
    """tests/test_kernels.py:166-176 (and :197-222 with seed 3, M 32, span
    3000): random codes, sorted random refpos (variants repeat in a row)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, (N, L)).astype(np.uint8)
    refpos = np.sort(rng.integers(1, span, (N, L)).astype(np.int32), axis=1)
    vpos = np.sort(rng.choice(np.arange(1, span), M, replace=False)
                   ).astype(np.int32)
    ind = rng.integers(1, 15, (M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    return codes, quals, refpos, vpos, ind, ni


INPUTS = {
    "test_kernels_166": lambda: _kernels_166(),
    "test_kernels_197": lambda: _kernels_166(seed=3, M=32, span=3000),
    # scaling_bench's dense layout: a variant about every 8 bp
    "dense": lambda: _gen(256, 128, 512),
    "dryrun": lambda: dryrun._example_tensors(n_reads=64, read_len=128,
                                              n_vars=64, seed=1),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_sharded_allele_counts_matches_jax(name):
    args = INPUTS[name]()
    want = np.asarray(JM.sharded_allele_counts(JM.make_mesh(8), *args, 10))
    got = TM.sharded_allele_counts(TM.make_mesh(8, device="cpu"), *args, 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_sharded_phasing_step_matches_jax(name):
    args = INPUTS[name]()
    thr = 0.01
    want = [np.asarray(x) for x in JM.sharded_phasing_step(
        JM.make_mesh(8), *args, 10, cc_threshold=thr)]
    got = [x.numpy() for x in TM.sharded_phasing_step(
        TM.make_mesh(8, device="cpu"), *args, 10, cc_threshold=thr)]
    for what, g, w in zip(("counts", "pair", "scores"), got[:2] + got[3:],
                          want[:2] + want[3:]):
        np.testing.assert_array_equal(g, w, err_msg=what)
    _, p_exact = dryrun._host_prune(want[0], want[1], thr)
    sure = np.abs(p_exact - thr) > 1e-3
    np.testing.assert_array_equal(got[2][sure], want[2][sure])
    assert got[2].dtype == bool and got[2].shape == (len(args[3]), 8)
    if name == "dense":
        assert want[1].sum() > 1000 and 0 < got[2].sum() < got[2].size
        assert want[3].max() > 0


def test_sharded_step_shards_sum_to_one_shard():
    """The shards' merge is exact: 1, 2 and 8 local shards agree."""
    args = INPUTS["dense"]()
    outs = [[x.numpy() for x in TM.sharded_phasing_step(
        TM.make_mesh(n, device="cpu"), *args, 10)] for n in (1, 2, 8)]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)


def _row_loop(vidx, allele, n_vars, band):
    counts = np.zeros((n_vars, 3), np.int64)
    pair = np.zeros((n_vars, band, 9), np.int64)
    for v_row, a_row in zip(vidx, allele):
        hits = [(v, a) for v, a in zip(v_row, a_row) if a < 3]
        for v, a in hits:
            counts[v, a] += 1
        for v1, a1 in hits:
            for v2, a2 in hits:
                if 1 <= v2 - v1 <= band:
                    pair[v1, v2 - v1 - 1, a1 * 3 + a2] += 1
    return counts, pair


@pytest.mark.parametrize("band", [0, 1, 3, 8])
def test_band_counts_plain_matches_row_loop(band, monkeypatch):
    """Rows in no order, with variants repeated inside a row (each
    position pair counts), non-hits as vidx -1 / allele 3; a chunk of
    fewer rows than the plane has."""
    rng = np.random.default_rng(band)
    N, L, M = 37, 24, 30
    vidx = rng.integers(0, M, (N, L)).astype(np.int32)
    vidx[:, 5] = vidx[:, 2]                      # repeated in every row
    allele = rng.integers(0, 3, (N, L)).astype(np.int32)
    miss = rng.random((N, L)) < 0.3
    vidx[miss], allele[miss] = -1, 3
    vidx[4], allele[4] = -1, 3                   # a row without hits
    monkeypatch.setattr(TM, "PLAIN_CHUNK_ELEMENTS", 5 * L * L)
    counts, pair = TM.band_counts(torch.from_numpy(vidx),
                                  torch.from_numpy(allele), M, band)
    want_c, want_p = _row_loop(vidx, allele, M, band)
    assert counts.dtype == pair.dtype == torch.int32
    assert tuple(pair.shape) == (M, band, 9)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(pair.numpy(), want_p)
    if band:
        assert want_p.sum() > 0


def _row_loop_np(vidx, allele, n_vars, band):
    """_row_loop with each row's pairs formed by numpy."""
    counts = np.zeros((n_vars, 3), np.int64)
    pair = np.zeros((n_vars, band, 9), np.int64)
    for v_row, a_row in zip(vidx, allele):
        h = a_row < 3
        v, a = v_row[h].astype(np.int64), a_row[h].astype(np.int64)
        np.add.at(counts, (v, a), 1)
        if band:
            d = v[None, :] - v[:, None]
            i, j = np.nonzero((d >= 1) & (d <= band))
            np.add.at(pair, (v[i], d[i, j] - 1, a[i] * 3 + a[j]), 1)
    return counts, pair


@pytest.mark.parametrize("band", [0, 1, 8, 16])
@pytest.mark.parametrize("name", layouts.BAND_NAMES)
def test_band_counts_plain_on_kernel_branches(name, band):
    """band_counts_plain against a row loop on the inputs the kernel's
    design branches on (testing/layouts.band_planes): rows whose variants
    decrease, a variant repeated in a row, position-sorted rows spanning
    many shared-memory windows and the same rows reversed, L = 6,144 and
    L = 77; tolerance 0."""
    vidx, allele, M = layouts.band_planes(name)
    counts, pair = TM.band_counts(torch.from_numpy(vidx),
                                  torch.from_numpy(allele), M, band)
    want_c, want_p = _row_loop_np(vidx, allele, M, band)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(pair.numpy(), want_p)
    assert want_c.sum() > 0 and (band == 0 or want_p.sum() > 0)
    if name == "sorted":
        # the rows reach far more variants than one block's window holds
        assert int(vidx.max()) - int(vidx[vidx >= 0].min()) > 2000


def test_band_counts_of_no_rows():
    e = torch.empty((0, 128), dtype=torch.int32)
    counts, pair = TM.band_counts(e, e, 7, 8)
    assert counts.sum() == 0 and tuple(pair.shape) == (7, 8, 9)


def test_band_counts_refuses_bad_planes():
    v = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        TM.band_counts(v, v.to(torch.int64), 3, 2)
    with pytest.raises(ValueError):
        TM.band_counts(v, v[:, :4], 3, 2)
    with pytest.raises(ValueError):
        TM.band_counts(v, v, 3, -1)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_band_prune_matches_jax_outside_its_uncertain_band(name):
    """The step's connection-test tail, band_prune (plain on the CPU), on
    the merged counts and band of each input: its decisions equal
    phaser_tpu's noise_from_counts + prune_mask outside the pairs JAX's
    float32 marks uncertain, and its p within JAX's 2e-4."""
    from phaser_tpu.kernels import stats as J
    from phaser_tpu_torch.kernels import stats as S
    args = INPUTS[name]()
    thr = 0.01
    counts, pair = TM._sharded_counts(
        TM.make_mesh(2, device="cpu"),
        TM._step_inputs(TM.make_mesh(2, device="cpu"), *args), 10, 8)
    p, prune, uncertain = (x.numpy() for x in S.band_prune(counts, pair,
                                                           thr))
    b = pair.numpy().astype(np.float32)
    jp, jprune, junc = (np.asarray(x) for x in J.prune_mask(
        b[:, :, 0] + b[:, :, 4], b[:, :, 1] + b[:, :, 3],
        b[:, :, (2, 5, 6, 7, 8)].sum(axis=2),
        J.noise_from_counts(counts.numpy()), thr))
    np.testing.assert_array_equal(prune[~junc], jprune[~junc])
    np.testing.assert_allclose(p, jp, rtol=0, atol=2e-4)
    assert p.shape == prune.shape == uncertain.shape == (len(args[3]), 8)
    assert int(counts.sum()) > 0


def test_mesh_helpers_match_jax():
    a = np.arange(21).reshape(7, 3)
    for mult in (1, 4, 7, 8):
        np.testing.assert_array_equal(TM.pad_to_multiple(a, mult, fill=-1),
                                      JM.pad_to_multiple(a, mult, fill=-1))
    mesh = TM.make_mesh(4, device="cpu")
    assert (mesh.n_shards, mesh.device.type, mesh.group) == (4, "cpu", None)
    with pytest.raises(ValueError):
        TM.shard_reads(mesh, a)
    (t,) = TM.shard_reads(mesh, TM.pad_to_multiple(a, 4))
    assert tuple(t.shape) == (8, 3) and t.device.type == "cpu"
    with pytest.raises(ValueError):
        TM.make_mesh(0, device="cpu")


def test_make_mesh_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        TM.make_mesh(2)
