"""phaser_tpu_torch's dispatcher (device="cpu": the kernels' plain PyTorch
versions) against phaser_tpu's assign_alleles_auto(device="host"), the exact
host mapper.  ContigHits must be equal: rows, variants, allele codes and
the multi-base allele strings."""

import os

import numpy as np
import pytest
import torch

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
from phaser_tpu_torch.mapper import host as H

FIXTURES = {
    "indel_multiallelic": dict(
        seed=52, contigs=("chr20",), contig_len=15000,
        n_variants_per_contig=80, n_reads_per_contig=900,
        include_indel_variants=True, frac_indel_reads=0.2,
        frac_multiallelic=0.15),
    "spliced": dict(
        seed=61, contigs=("chr20",), contig_len=20000,
        n_variants_per_contig=100, n_reads_per_contig=1200,
        frac_spliced=0.4, error_rate=0.01),
}


@pytest.fixture(autouse=True)
def _cap_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PHASER_TPU_TORCH_CACHE", str(tmp_path / "cache"))


def _read(vcf, bam, vcfio, varmap, bamio):
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
             if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = varmap.build_variant_table("chr20", hs.pool["chr20"],
                                    include_indels=True)
    bd = bamio.read_bam(bam)
    return bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0)), vt


def _load(tmp_path, name):
    """(bd, vt) built by the port's io and engine, and a `want(bd_sel, **kw)`
    that runs phaser_tpu's host dispatcher on phaser_tpu's own objects from
    the same files (bd_sel: None, or row indices of a chunk)."""
    vcf, bam, _ = datagen.write_fixture_dir(str(tmp_path), **FIXTURES[name])
    bd, vt = _read(vcf, bam, vcfio, varmap, bamio)
    jbd, jvt = _read(vcf, bam, jax_vcfio, jax_varmap, jax_bamio)

    def want(sel=None, device="host", **kw):
        sub = jbd if sel is None else jbd.select(sel)
        return jax_dispatch.assign_alleles_auto(sub, jvt, baseq=10,
                                                device=device, **kw)
    return bd, vt, want


def _assert_equal_hits(got, want):
    np.testing.assert_array_equal(got.read_idx, want.read_idx)
    np.testing.assert_array_equal(got.var_idx, want.var_idx)
    np.testing.assert_array_equal(got.allele_code, want.allele_code)
    assert got.allele_strs == want.allele_strs


OLD_ROUTES = ("affine_nibble", "delta_nibble", "plane", "affine_masked")


@pytest.fixture
def spy(monkeypatch):
    """Counts plain-version runs per program, and (under "rows") the rows
    the ragged join took."""
    calls = dict.fromkeys(OLD_ROUTES + ("ragged_join",), 0)
    rows = []
    for name in list(calls):
        orig = getattr(K, name + "_plain")

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            if _name == "ragged_join":
                rows.append(int(a[0].shape[0]))
            return _orig(*a, **kw)
        monkeypatch.setattr(K, name + "_plain", wrapped)
    calls["rows"] = rows
    return calls


def _only_ragged(spy):
    """#2 ran the ragged join and none of the packed routes' programs."""
    assert spy["ragged_join"] > 0, spy
    assert not any(spy[k] for k in OLD_ROUTES), spy


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("kw", [dict(), dict(isize_cutoff=400),
                                dict(splice=False)])
def test_dispatch_cpu_matches_host(tmp_path, spy, fixture, kw):
    bd, vt, jax_host = _load(tmp_path, fixture)
    want = jax_host(**kw)
    D.reset_stats()
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu", **kw)
    _assert_equal_hits(got, want)
    assert len(want) > 100
    if fixture == "indel_multiallelic":
        assert want.allele_strs  # multi-base alleles went to the host path
    # every kept row went through the ragged join, once
    _only_ragged(spy)
    assert sum(spy["rows"]) == D.STATS["rows_kept"] > 0


@pytest.mark.parametrize("nibble_packer", [True, False])
def test_dispatcher_plans_no_window(tmp_path, monkeypatch, spy,
                                    nibble_packer):
    """The ragged join finds its table ranges itself: the dispatcher calls
    no window planner and no packer, with the nibble packer and without it
    (where phaser_tpu takes the masked-affine program)."""
    bd, vt, jax_host = _load(tmp_path, "indel_multiallelic")

    def planned(*a, **k):
        raise AssertionError("the dispatcher planned a window or packed")
    for name in ("plan_windows_plane", "_plan_from_bounds", "pack_reads",
                 "pack_affine_masked", "pack_delta_nibble",
                 "pack_codes_quals") + (() if nibble_packer else
                                        ("pack_affine_nibble",)):
        monkeypatch.setattr(K, name, planned)
    if nibble_packer:
        monkeypatch.setattr(K, "pack_affine_nibble", planned)
    _assert_equal_hits(
        D.assign_alleles_auto(bd, vt, baseq=10, device="cpu"), jax_host())
    _only_ragged(spy)


def test_whole_table_and_overflow_paths(tmp_path, monkeypatch, spy):
    """Hit-capacity overflow (the chunk relaunched on its device with the
    exact counts, no host rerun) keeps the hits equal."""
    bd, vt, jax_host = _load(tmp_path, "indel_multiallelic")
    want = jax_host()

    host_rows = []
    monkeypatch.setattr(D, "assign_alleles",
                        lambda sub, *a, **k: host_rows.append(len(sub)) or
                        H.assign_alleles(sub, *a, **k))
    adaptive_cap = D._adaptive_cap
    monkeypatch.setattr(D, "_adaptive_cap", lambda key, n: 2)
    base = {k: spy[k] for k in OLD_ROUTES + ("ragged_join",)}
    pend = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu", defer=True)
    monkeypatch.setattr(D, "_adaptive_cap", adaptive_cap)
    launched = {k: spy[k] - base[k] for k in OLD_ROUTES + ("ragged_join",)}
    host_launch = list(host_rows)
    before = D.RELAUNCHES["capacity"]
    _assert_equal_hits(pend.resolve(), want)
    assert D.RELAUNCHES["capacity"] == before + 1
    # the relaunch ran the ragged join again and sent the host mapper only
    # the remainders it sent the first time
    _only_ragged(spy)
    assert spy["ragged_join"] - base["ragged_join"] == \
        2 * launched["ragged_join"] > 0, (spy, base, launched)
    assert host_rows == host_launch + host_launch


def test_table_slices(tmp_path, monkeypatch, spy):
    """Tables above the packed-hit layout's limit launch in slices."""
    bd, vt, jax_host = _load(tmp_path, "spliced")
    want = jax_host()
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu")
    one = {"ragged_join": spy["ragged_join"], "rows": list(spy["rows"])}
    monkeypatch.setattr(D, "_MAX_TABLE", 16)
    sliced = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu")
    _assert_equal_hits(got, want)
    _assert_equal_hits(sliced, want)
    n_slices = -(-len(vt) // 16)
    assert n_slices > 4
    # one chunk of reads, uploaded once, launched once a table slice
    _only_ragged(spy)
    assert spy["ragged_join"] == one["ragged_join"] * (1 + n_slices)
    assert spy["rows"] == one["rows"] * (1 + n_slices)


def test_deferred_resolve_all(tmp_path):
    """Launch several chunks, then resolve them with one copy."""
    bd, vt, jax_host = _load(tmp_path, "spliced")
    parts = np.array_split(np.arange(len(bd)), 3)
    chunks = [bd.select(p) for p in parts]
    pend = [D.assign_alleles_auto(c, vt, baseq=10, device="cpu", defer=True)
            for c in chunks]
    for p in pend:
        p.wait()
    for got, p in zip(D.resolve_all(pend), parts):
        _assert_equal_hits(got, jax_host(p))


def test_cap_file_is_the_ports_own(tmp_path, monkeypatch):
    assert D._cap_path() == str(tmp_path / "cache" / "hit_caps.json")
    monkeypatch.delenv("PHASER_TPU_TORCH_CACHE")
    assert D._cap_path().endswith(
        os.path.join(".cache", "phaser_tpu_torch", "hit_caps.json"))


def test_fails_loud_without_gpu_or_native_packer(tmp_path, monkeypatch, spy):
    """No GPU: cuda and auto raise, in the dispatcher and in every entry
    point and stage that takes a device (auto routes #2 and #4 to the host
    mapper, but still asks for the card: no silent retreat).  No nibble
    packer: the route is the same ragged join, with hits equal the
    host's (phaser_tpu takes its masked-affine program there)."""
    from types import SimpleNamespace

    from phaser_tpu_torch.engine import blocks, connections, phasing
    from phaser_tpu_torch.engine.pipeline import run_phaser
    bd, vt, jax_host = _load(tmp_path, "spliced")
    if not torch.cuda.is_available():
        vr = SimpleNamespace(vt=vt, rv_uid=np.zeros(0, np.int64),
                             rv_var=np.zeros(0, np.int64),
                             h_uid=np.zeros(0, np.int64),
                             h_var=np.zeros(0, np.int64),
                             h_allele=np.zeros(0, np.int64))
        conn = SimpleNamespace(adj={0: {1}, 1: {0}},
                               var_rank=np.arange(2, dtype=np.int64))
        for dev in ("cuda", "auto"):
            for call in (
                    lambda: D.assign_alleles_auto(bd, vt, baseq=10,
                                                  device=dev),
                    lambda: run_phaser(vcf="x.vcf", bam="x.bam",
                                       sample="s", o=str(tmp_path / "o"),
                                       mapq=10, baseq=10, paired_end=1,
                                       device=dev),
                    lambda: connections.build_connections(vr, 0.01, 0.01,
                                                          device=dev),
                    lambda: blocks.find_blocks(conn, vt, device=dev),
                    lambda: phasing.sub_block_phase([0, 1], {},
                                                    device=dev)):
                with pytest.raises(RuntimeError, match="CUDA"):
                    call()
    want = jax_host()
    monkeypatch.setattr(K, "pack_affine_nibble", lambda *a, **k: None)
    _assert_equal_hits(D.assign_alleles_auto(bd, vt, baseq=10, device="cpu"),
                       want)
    _only_ragged(spy)


class _NoDeltaLib:
    """The native library without pack_delta_nibble_native."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name == "pack_delta_nibble_native":
            raise AttributeError(name)
        return getattr(self._lib, name)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("lib", ["none", "no_delta"])
def test_dispatch_without_native_packers(tmp_path, monkeypatch, spy, fixture,
                                         lib):
    """Without the native library (the numpy span pass and row gather;
    phaser_tpu's numpy packers, masked-affine and plane programs) and
    without only its delta packer (phaser_tpu's non-affine reads to its
    plane program), the port's hits equal the host mapper's and
    phaser_tpu's dispatcher's, through the same ragged join."""
    from phaser_tpu.io import native as jax_native
    bd, vt, jax_host = _load(tmp_path, fixture)
    want = jax_host()
    real = native.get_lib()
    assert real is not None
    stub = None if lib == "none" else _NoDeltaLib(real)
    monkeypatch.setattr(native, "get_lib", lambda: stub)
    jax_real = jax_native.get_lib()
    monkeypatch.setattr(jax_native, "get_lib", lambda: None if stub is None
                        else _NoDeltaLib(jax_real))
    assert K.pack_delta_nibble(bd, 10) is None
    got = D.assign_alleles_auto(bd, vt, baseq=10, device="cpu")
    _assert_equal_hits(got, want)
    _assert_equal_hits(jax_host(device="auto"), want)
    _only_ragged(spy)


def test_pack_reads_numpy_matches_native(tmp_path, monkeypatch):
    from phaser_tpu.kernels import alleles as J
    vcf, bam, _ = datagen.write_fixture_dir(str(tmp_path),
                                            **FIXTURES["spliced"])
    bd, _ = _read(vcf, bam, vcfio, varmap, bamio)
    jbd, _ = _read(vcf, bam, jax_vcfio, jax_varmap, jax_bamio)
    want = K.pack_reads(bd)
    cq = K.pack_codes_quals(bd)
    am = K.pack_affine_masked(bd, 10)
    for a, b in zip(am, J.pack_affine_masked(jbd, 10)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    for a, b in zip(K.pack_reads(bd), want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(K.pack_codes_quals(bd), cq):
        np.testing.assert_array_equal(a, b)
    assert K.pack_affine_masked(bd, 10) is None
