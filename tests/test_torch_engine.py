"""phaser_tpu_torch's engine device stages against phaser_tpu: #3 pair
counting (kernels.paircount + engine.connections), #4 components
(kernels.components + engine.blocks) and the #5 2^n scorer
(kernels.phasescore + engine.phasing), each on the CPU device (the torch
code the GPU runs).  Every comparison is of integers or of exactly equal
floats, tolerance 0."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datagen
from phaser_tpu.engine import blocks as jax_blocks
from phaser_tpu.engine import phasing as jax_phasing
from phaser_tpu.engine.connections import \
    build_connections as jax_build_connections
from phaser_tpu.engine import hits as jax_hits
from phaser_tpu.engine import varmap as jax_varmap
from phaser_tpu.io import bam as jax_bamio
from phaser_tpu.io import vcf as jax_vcfio
from phaser_tpu.kernels import components as jax_components
from phaser_tpu.kernels import paircount as jax_paircount
from phaser_tpu.kernels import phasescore as jax_phasescore
from phaser_tpu.mapper import host as jax_host
from phaser_tpu_torch.engine import (blocks, connections, hits, phasing,
                                     varmap)
from phaser_tpu_torch.io import bam as bamio
from phaser_tpu_torch.io import vcf as vcfio
from phaser_tpu_torch.kernels import components, paircount, phasescore
from phaser_tpu_torch.mapper import host

PORT = (vcfio, varmap, bamio, host, hits)
JAX = (jax_vcfio, jax_varmap, jax_bamio, jax_host, jax_hits)

CPU = torch.device("cpu")


def _variant_reads(tmp_path, side=PORT):
    """tests/test_kernels.py:122-131's fixture as VariantReads, built with
    the port's modules or (side=JAX) with phaser_tpu's from the same files."""
    vcfio, varmap, bamio, host, hits = side
    vcf, bam, _ = datagen.write_fixture_dir(
        str(tmp_path), seed=2, contigs=("chr20",), contig_len=20000,
        n_variants_per_contig=80, n_reads_per_contig=1200,
        frac_indel_reads=0.0)
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
             if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = varmap.build_variant_table("chr20", hs.pool["chr20"])
    bd = bamio.read_bam(bam)
    chunk = bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0))
    found = host.assign_alleles(chunk, vt, baseq=10)
    rows = hits.build_contig_rows(vt, [(0, chunk, found)], {0: None}, {0: 0})
    return hits.build_variant_reads(rows, [])


@pytest.mark.parametrize("K", [4, 24])
def test_paircount_matches_jax(tmp_path, K):
    vr = _variant_reads(tmp_path)
    n = len(vr.vt)
    var_mat, allele_mat, overflow = paircount.pack_read_hits(
        vr.h_uid, vr.h_var, vr.h_allele, K)
    for a, b in zip((var_mat, allele_mat, overflow),
                    jax_paircount.pack_read_hits(vr.h_uid, vr.h_var,
                                                 vr.h_allele, K)):
        np.testing.assert_array_equal(a, b)
    assert var_mat.shape[0] > 100
    pairs = paircount.emit_pairs(torch.from_numpy(var_mat),
                                 torch.from_numpy(allele_mat), K)
    jpairs = jax_paircount.emit_pairs(jnp.asarray(var_mat),
                                      jnp.asarray(allele_mat), K)
    for a, b in zip(pairs, jpairs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    keys, counts, n_uniq = paircount.count_pair_configs(*pairs, n)
    jkeys, jcounts, jn = jax_paircount.count_pair_configs(
        *jpairs, n, max_pairs=4096)
    jn = int(jn)
    assert n_uniq == jn > 50
    assert keys.shape == (n_uniq,) and counts.shape == (n_uniq, 9)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys[:jn]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts[:jn]))


def _assert_same_connections(got, want):
    for f in ("var_a", "var_b", "c_supporting", "c_total", "p_value",
              "chosen_config", "pruned", "var_rank"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.p_display == want.p_display
    assert got.phase_concordant == want.phase_concordant
    assert got.adj == want.adj
    assert got.allele_conn == want.allele_conn


def test_build_connections_gate_zero_matches_jax(tmp_path, monkeypatch):
    """With the gate at 0 every contig counts pairs on the device, with K
    caps that send some reads to the host combos."""
    vr = _variant_reads(tmp_path)
    want = jax_build_connections(_variant_reads(tmp_path, JAX), 0.002, 0.01,
                                 device="host")
    monkeypatch.setattr(connections, "DEVICE_PAIR_GATE", 0)
    for max_k in (2, 24):
        monkeypatch.setattr(connections, "MAX_K", max_k)
        before = dict(connections.COUNTS)
        got = connections.build_connections(vr, 0.002, 0.01, device="cpu")
        _assert_same_connections(got, want)
        assert connections.COUNTS["device_calls"] == \
            before["device_calls"] + 1
        host_reads = connections.COUNTS["host_reads"] - before["host_reads"]
        assert (host_reads > 0) == (max_k == 2), host_reads
    host = connections.build_connections(vr, 0.002, 0.01, device="host")
    _assert_same_connections(host, want)


class _FakeVT:
    """Minimal variant-table stand-in for build_connections."""

    def __init__(self, n):
        self._n = n
        self.phases = ["-"] * n          # skip phase-concordance branches
        self.ind_alleles = [("A", "G")] * n

    def __len__(self):
        return self._n


def test_build_connections_crosses_device_gate():
    """tests/test_components.py:75-106: a >= 200k-pair workload takes the
    device pair count at the default gate and matches phaser_tpu's host
    path."""
    rng = np.random.default_rng(1)
    n_vars = 5000
    n_reads = 250_000
    v1 = rng.integers(0, n_vars, n_reads)
    v2 = np.minimum(v1 + 1 + rng.integers(0, 200, n_reads), n_vars - 1)
    ok = v1 != v2
    v1, v2 = v1[ok], v2[ok]
    uid = np.arange(len(v1), dtype=np.int64)
    rv_uid = np.repeat(uid, 2)
    rv_var = np.stack([v1, v2], 1).ravel().astype(np.int64)
    allele = rng.integers(0, 2, size=2 * len(v1)).astype(np.int64)
    vr = SimpleNamespace(vt=_FakeVT(n_vars), rv_uid=rv_uid, rv_var=rv_var,
                         h_uid=rv_uid, h_var=rv_var, h_allele=allele)
    want = jax_build_connections(vr, 0.002, 0.01, device="host")
    before = connections.COUNTS["device_calls"]
    got = connections.build_connections(vr, 0.002, 0.01, device="cpu")
    assert want.n_pairs >= connections.DEVICE_PAIR_GATE
    assert connections.COUNTS["device_calls"] == before + 1
    _assert_same_connections(got, want)


def _host_components(ea, eb):
    touched = sorted(set(ea.tolist()) | set(eb.tolist()))
    parent = {v: v for v in touched}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(ea.tolist(), eb.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    comps = {}
    for v in touched:
        comps.setdefault(find(v), set()).add(v)
    return sorted(tuple(sorted(c)) for c in comps.values())


@pytest.mark.parametrize("seed", range(3))
def test_components_match_jax(seed):
    """tests/test_components.py's random graphs: the same member lists in
    the same order as phaser_tpu's kernel, and the union-find's sets."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        n = int(rng.integers(10, 400))
        e = int(rng.integers(1, 1200))
        ea = rng.integers(0, n, e).astype(np.int64)
        eb = rng.integers(0, n, e).astype(np.int64)
        got = components.connected_components(ea, eb, CPU)
        assert got == jax_components.connected_components(ea, eb, n)
        assert sorted(tuple(c) for c in got) == _host_components(ea, eb)
    # a path graph needs many label rounds
    path = np.arange(999, dtype=np.int64)
    rev = path[::-1].copy()
    assert components.connected_components(rev, rev + 1, CPU) == \
        [list(range(1000))]


def test_find_blocks_gate_zero_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    n = 500
    adj = {}
    for _ in range(900):
        a, b = map(int, rng.integers(0, n, 2))
        if a == b:
            continue
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    conn = SimpleNamespace(adj=adj,
                           var_rank=rng.permutation(n).astype(np.int64))
    vt = SimpleNamespace(pos=rng.integers(0, 10**6, n).astype(np.int64))
    want = jax_blocks.find_blocks(conn, vt, device="host")
    monkeypatch.setattr(blocks, "_DEVICE_EDGE_GATE", 0)
    before = blocks.COUNTS["device_calls"]
    assert blocks.find_blocks(conn, vt, device="cpu") == want
    assert blocks.COUNTS["device_calls"] == before + 1
    assert blocks.find_blocks(conn, vt, device="host") == want
    assert blocks.COUNTS["device_calls"] == before + 1


def _random_ac(rng, n, density=3):
    ac = {}
    for _ in range(n * density):
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        a, b = rng.integers(0, 2, 2)
        ac.setdefault((int(i), int(a)), set()).add((int(j), int(b)))
        ac.setdefault((int(j), int(b)), set()).add((int(i), int(a)))
    return ac


def _adjacency(ac, n):
    M = np.zeros((2 * n, 2 * n), np.float32)
    for (v, a), conns in ac.items():
        for (w, b) in conns:
            M[v * 2 + a, w * 2 + b] = 1
    return M


@pytest.mark.parametrize("n", [2, 3, 5, 8, 16, 18])
def test_enumerate_scores_matches_jax(n):
    rng = np.random.default_rng(n)
    M = _adjacency(_random_ac(rng, n), n)
    got = phasescore.enumerate_scores(torch.from_numpy(M), n)
    want = np.asarray(jax_phasescore.enumerate_scores(jnp.asarray(M), n))
    assert got.shape == (1 << (n - 1),)
    np.testing.assert_array_equal(got.numpy(), want)
    if n <= 8:
        configs = ["0" + format(b, "0%db" % (n - 1)) if n > 1 else "0"
                   for b in range(1 << (n - 1))]
        np.testing.assert_array_equal(
            got.numpy().astype(np.int64),
            jax_phasing._score_configs(list(range(n)), _random_ac(
                np.random.default_rng(n), n), configs))


def test_batched_scores_match_jax():
    rng = np.random.default_rng(9)
    adj = [_adjacency(_random_ac(rng, n), n) for n in (3, 5, 3, 6, 5)]
    Ms = np.stack([adj[0], adj[2]])
    np.testing.assert_array_equal(
        phasescore.enumerate_scores_batched(torch.from_numpy(Ms), 3).numpy(),
        np.asarray(jax_phasescore.enumerate_scores_batched(
            jnp.asarray(Ms), 3)))
    for got, want in zip(phasescore.score_blocks_host(adj, CPU),
                         jax_phasescore.score_blocks_host(adj)):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def _chain_ac(rng, n, flip):
    """Allele edges of a read-consistent chain with longer links: a unique
    best config, unless `flip` drops the second half's edges and its
    configs tie."""
    truth = rng.integers(0, 2, n)
    ac = {}

    def link(i, j, same):
        for a in (0, 1):
            b = a if same else 1 - a
            ac.setdefault((i, a), set()).add((j, b))
            ac.setdefault((j, b), set()).add((i, a))
    for i in range(n - 1):
        link(i, i + 1, truth[i] == truth[i + 1])
    for i in range(0, n - 3, 3):
        link(i, i + 3, truth[i] == truth[i + 3])
    if flip:
        ac = {k: set(v) for k, v in ac.items() if k[0] < n // 2}
        ac = {k: {c for c in v if c[0] < n // 2} for k, v in ac.items()}
    return ac


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("flip", [False, True])
def test_sub_block_phase_device_matches_jax(n, flip):
    """At n >= 16 phaser_tpu scores on its device; the port scores with
    device="cpu" and must return the same strings, sentinel included."""
    rng = np.random.default_rng(n + 2 * flip)
    variants = list(range(100, 100 + n))
    ac = {(v + 100, a): {(w + 100, b) for (w, b) in conns}
          for (v, a), conns in _chain_ac(rng, n, flip).items()}
    want = jax_phasing.sub_block_phase(variants, ac)
    before = phasing.COUNTS["device_calls"]
    got = phasing.sub_block_phase(variants, ac, device="cpu")
    assert phasing.COUNTS["device_calls"] == before + 1
    assert got == want
    assert ("-" in got[0]) == flip
    assert phasing.sub_block_phase(variants, ac, device="host") == want
    assert phasing.COUNTS["device_calls"] == before + 1


def test_device_stages_raise_without_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    variants = list(range(16))
    ac = _chain_ac(np.random.default_rng(0), 16, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        phasing.sub_block_phase(variants, ac, device="cuda")
    conn = SimpleNamespace(adj={0: {1}, 1: {0}},
                           var_rank=np.arange(2, dtype=np.int64))
    monkeypatch.setattr(blocks, "_DEVICE_EDGE_GATE", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        blocks.find_blocks(conn, SimpleNamespace(pos=np.arange(2)),
                           device="cuda")
