"""The dry run of the sharded pipeline (the port of the repository's
__graft_entry__.py, which stays as phaser_tpu's).

entry(device)             -> (fn, example_args): the single-device forward
                             step of the flagship pipeline (allele
                             assignment + per-variant allelic count
                             reduction) and its inputs on `device`.
dryrun_multichip(n, dev)  -> a local mesh of n shards on `dev`: one sharded
                             step (reads split n ways, the variant table
                             whole in every shard, summed counts) on small
                             shapes, ASSERTED against an independent numpy
                             recomputation; then the sharded FULL-engine
                             path (dist.engine_multihost, position-shard
                             threads) on a small synthetic fixture, whose
                             outputs must be byte-identical to the
                             single-process host engine's.

    python -m phaser_tpu_torch.dist.dryrun [--shards 4] [--device cuda]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _example_tensors(n_reads=256, read_len=128, n_vars=128, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (n_reads, read_len)).astype(np.uint8)
    quals = rng.integers(0, 42, (n_reads, read_len)).astype(np.uint8)
    starts = rng.integers(1, 40000, (n_reads, 1)).astype(np.int32)
    refpos = starts + np.arange(read_len, dtype=np.int32)[None, :]
    vpos = np.sort(rng.choice(np.arange(1, 41000, dtype=np.int32), n_vars,
                              replace=False))
    ind_codes = rng.integers(1, 15, (n_vars, 2)).astype(np.uint8)
    n_ind = np.full(n_vars, 2, np.int8)
    return codes, quals, refpos, vpos, ind_codes, n_ind


def entry(device="cuda"):
    """(forward, example_args): allele assignment and the (M, 3) count
    reduction of one device, the inputs already on `device`."""
    import torch

    from ..kernels.alleles import assign_alleles_device
    from ..mapper.dispatch import resolve_device
    from .mesh import band_counts

    dev = resolve_device(device)
    codes, quals, refpos, vpos, ind_codes, n_ind = _example_tensors()
    n_vars = vpos.shape[0]

    def forward(codes, quals, refpos, vpos, ind_codes, n_ind):
        vidx, allele = assign_alleles_device(codes, quals, refpos, vpos,
                                             ind_codes, n_ind, 10)
        return band_counts(vidx, allele, n_vars, 0)[0]

    example_args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                         for x in (codes, quals, refpos, vpos, ind_codes,
                                   n_ind))
    return forward, example_args


def _host_counts_band(codes, quals, refpos, vpos, ind_codes, n_ind,
                      baseq, band):
    """Pure-numpy recomputation of sharded_phasing_step's merged outputs:
    per-(variant, allele-class) counts and the banded within-read pair
    configuration tensor."""
    masked = np.where(quals >= baseq, codes, np.uint8(15))
    vidx = np.searchsorted(vpos, refpos, side="left").astype(np.int64)
    M = len(vpos)
    safe = np.minimum(vidx, M - 1)
    hit = (refpos > 0) & (vidx < M) & (vpos[safe] == refpos) & (masked != 15)
    a0 = ind_codes[safe, 0]
    a1 = ind_codes[safe, 1]
    ni = n_ind[safe]
    allele = np.where((masked == a0) & (ni > 0), 0,
                      np.where((masked == a1) & (ni > 1), 1, 2))
    allele = np.where(hit, allele, 3)
    counts = np.zeros((M, 3), np.int64)
    np.add.at(counts, (vidx[hit], allele[hit]), 1)
    pair = np.zeros((M, band, 9), np.int64)
    vi = np.where(hit, vidx, 0)
    vo = vi[:, :, None]
    vj = vi[:, None, :]
    ai = allele[:, :, None]
    aj = allele[:, None, :]
    d = vj - vo
    ok = (ai < 3) & (aj < 3) & (d >= 1) & (d <= band)
    vo_b = np.broadcast_to(vo, ok.shape)
    ai_b = np.broadcast_to(ai, ok.shape)
    aj_b = np.broadcast_to(aj, ok.shape)
    np.add.at(pair, (vo_b[ok], d[ok] - 1, ai_b[ok] * 3 + aj_b[ok]), 1)
    return counts, pair


def _host_scores(pair, K, band):
    """Brute-force recomputation of the dry run's phase-config scoring:
    rebuild the allele adjacency from the merged band exactly as
    dist.mesh.sharded_phasing_step does, then score every leading-zero
    config as v^T M v directly."""
    M2 = np.zeros((2 * K, 2 * K), np.float64)
    for dd in range(min(band, K - 1)):
        cis = (pair[:K - dd - 1, dd, 0] + pair[:K - dd - 1, dd, 4]) > 0
        for i in range(K - dd - 1):
            j = i + dd + 1
            v = float(cis[i])
            M2[i * 2, j * 2] = v
            M2[j * 2, i * 2] = v
            M2[i * 2 + 1, j * 2 + 1] = v
            M2[j * 2 + 1, i * 2 + 1] = v
    S = 1 << (K - 1)
    out = np.zeros(S, np.float64)
    for cfg in range(S):
        bits = [0] + [(cfg >> (K - 2 - i)) & 1 for i in range(K - 1)]
        v = np.zeros(2 * K)
        for i, b in enumerate(bits):
            v[i * 2 + b] = 1.0
        out[cfg] = v @ M2 @ v
    return out


def _host_prune(counts, pair, threshold):
    """scipy recomputation of the on-card connection tests: merged-count
    noise, banded connection test (phaser.py:1649), prune = p < threshold."""
    from scipy.stats import binom
    matches = (counts[:, 0] + counts[:, 1]).astype(float)
    mis = counts[:, 2].astype(float)
    tot = np.maximum(matches + mis, 1.0)
    use = (matches > 0) & (mis / tot < 0.05)
    bm, bmm = matches[use].sum(), mis[use].sum()
    noise_e = bmm / max((bm + bmm) * 2.0, 1.0)
    cfg_a = pair[:, :, 0] + pair[:, :, 4]
    cfg_b = pair[:, :, 1] + pair[:, :, 3]
    other = (pair[:, :, 2] + pair[:, :, 5] + pair[:, :, 6] +
             pair[:, :, 7] + pair[:, :, 8])
    sup = np.maximum(cfg_a, cfg_b)
    tot_p = cfg_a + cfg_b + other
    p = binom.cdf(sup, tot_p, 1 - (6 * noise_e + 10 * noise_e ** 2))
    p = np.where(tot_p - sup > 0, p, 1.0)
    p = np.where(sup == 0, 0.0, p)
    return p < threshold, p


def _dryrun_engine_values(n_shards: int, device="cuda") -> None:
    """Run the sharded FULL engine (thread transport of the same reduce
    protocol the multi-process path uses) on a synthetic BAM + VCF fixture
    on `device`, and assert every output file equals the single-process
    host engine's byte for byte."""
    import tempfile

    from ..engine.output_stage import PhaserOptions
    from ..engine.pipeline import run_phaser
    from ..io import bgzf
    from ..testing import datagen
    from .engine_multihost import run_phaser_sharded_threads

    with tempfile.TemporaryDirectory() as tmp:
        vcf, bam, _ = datagen.write_fixture_dir(
            tmp, seed=13, contigs=("chr21", "chr22"),
            n_variants_per_contig=40, n_reads_per_contig=300)
        kw = dict(vcf=vcf, bam=bam, sample="SAMPLE1", mapq="10", baseq=10,
                  paired_end="1", opts=PhaserOptions(), log=lambda *a: None)
        run_phaser(o=os.path.join(tmp, "single"), device="host", **kw)
        # the sharded leg runs the device path over POSITION-RANGE shards
        # (n_shards can exceed the fixture's 2 contigs): every shard
        # thread decodes its weight-balanced ranges, drives `device`
        # through mapper.dispatch, and ships non-owned contigs' rows to
        # their owner; the host run above is the parity oracle
        res = run_phaser_sharded_threads(n_shards=n_shards, device=device,
                                         position_shards=True,
                                         o=os.path.join(tmp, "sharded"), **kw)
        assert len(res.shard_device) == n_shards
        assert any(d > 0.0 for d, _ in res.shard_device), (
            "no shard reported device-path time under device=%r: %r"
            % (device, res.shard_device))
        for sfx in ("haplotypes.txt", "haplotypic_counts.txt",
                    "allelic_counts.txt", "variant_connections.txt",
                    "allele_config.txt"):
            a = open(os.path.join(tmp, "single." + sfx)).read()
            b = open(os.path.join(tmp, "sharded." + sfx)).read()
            assert a == b, "sharded engine output %s diverged" % sfx
        a = bgzf.read_text_auto(os.path.join(tmp, "single.vcf.gz"))
        b = bgzf.read_text_auto(os.path.join(tmp, "sharded.vcf.gz"))
        assert a == b, "sharded engine phased VCF diverged"


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded step on a local mesh of `n_devices` shards on `device`
    against the numpy recomputation, then the sharded engine leg with
    min(n_devices, 4) shards.  Raises AssertionError on any difference."""
    from .mesh import connection_p_values, make_mesh, sharded_phasing_step

    mesh = make_mesh(n_devices, device=device)
    n_reads = 8 * n_devices
    baseq, band, K = 10, 8, 8
    codes, quals, refpos, vpos, ind_codes, n_ind = _example_tensors(
        n_reads=n_reads, read_len=128, n_vars=64, seed=1)
    cc_threshold = 0.01
    step = sharded_phasing_step(
        mesh, codes, quals, refpos, vpos, ind_codes, n_ind, baseq,
        band=band, score_block=K, cc_threshold=cc_threshold)
    p = connection_p_values(step[0], step[1]).cpu().numpy()
    counts, pair, prune, scores = (x.cpu().numpy() for x in step)

    # ---- value assertions vs independent numpy recomputation
    exp_counts, exp_pair = _host_counts_band(codes, quals, refpos, vpos,
                                             ind_codes, n_ind, baseq, band)
    np.testing.assert_array_equal(counts, exp_counts)
    np.testing.assert_array_equal(pair, exp_pair)
    assert exp_counts.sum() > 0, "dry-run fixture produced no hits"
    exp_scores = _host_scores(exp_pair, K, band)
    np.testing.assert_allclose(scores, exp_scores, atol=1e-4)

    # on-card pruning decisions vs host scipy (outside the refinement band
    # around the threshold, decisions must agree exactly)
    exp_prune, exp_p = _host_prune(exp_counts, exp_pair, cc_threshold)
    sure = np.abs(exp_p - cc_threshold) > 1e-3
    np.testing.assert_array_equal(prune[sure], exp_prune[sure])
    # and, in float64, the p-values themselves (phaser_tpu's float32 ones
    # could not be held to scipy)
    np.testing.assert_allclose(p, exp_p, rtol=0, atol=1e-10)

    # ---- the sharded FULL-engine path, values vs the host engine
    _dryrun_engine_values(min(n_devices, 4), device)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="phaser_tpu_torch.dist.dryrun")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    counts = fn(*example)
    dryrun_multichip(args.shards, args.device)
    print("DRYRUN_OK shards=%d device=%s entry_hits=%d"
          % (args.shards, args.device, int(counts.sum())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
