"""Where cis_var's torch engine on the card overtakes its numpy engine, as a
user meets it: each run a fresh `python -m phaser_tpu_torch.cli.cis_var_main`
process, so Python, numpy, scipy and (for torch) `import torch` and CUDA
start-up are all inside the wall.

    python -m phaser_tpu_torch.testing.cis_var_crossover [--pairs 30,100,300]
        [--bs 10000] [--samples 300] [--genes 2000] [--reps 2]

On inputs of the pop benchmark's shape (testing/popdata.py), for each pair
count the two engines run in turns (numpy, torch, torch, numpy for two
repetitions); each engine's walls are fitted by least squares to
wall = fixed + per_pair x pairs, and the crossover is the pair count where
the two lines meet, printed with pairs x bs, the quantity
`analysis/cis_var.AUTO_CROSSOVER` holds.  Prints one JSON line last.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fit(ps, walls):
    a = np.vstack([np.ones(len(ps)), np.asarray(ps, float)]).T
    (fixed, per_pair), *_ = np.linalg.lstsq(a, np.asarray(walls, float),
                                            rcond=None)
    return float(fixed), float(per_pair)


def _run(argv, cwd):
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "phaser_tpu_torch.cli.cis_var_main"] + argv,
                         cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError("cis_var failed: " + res.stdout[-2000:] +
                           res.stderr[-2000:])
    return wall


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", default="30,100,300")
    p.add_argument("--bs", type=int, default=10000)
    p.add_argument("--samples", type=int, default=300)
    p.add_argument("--genes", type=int, default=2000)
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA GPU", file=sys.stderr)
        return 1
    from ..cli import expr_matrix_main
    from . import popdata
    pair_counts = [int(x) for x in args.pairs.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        d, features = popdata.make_gene_ae_dir(tmp, rng, args.samples,
                                               args.genes)
        mat = os.path.join(tmp, "matrix")
        assert expr_matrix_main.main(["--gene_ae_dir", d, "--features",
                                      features, "--o", mat]) == 0
        vcf, pairs, smap = popdata.make_cis_var_inputs(
            tmp, rng, args.samples, args.genes, max(pair_counts))
        walls = {"numpy": {}, "torch": {}}
        for n in pair_counts:
            sub = popdata.head_pairs(pairs, n, os.path.join(
                tmp, "pairs_%d.txt" % n))
            base = ["--bed", mat + ".gw_phased.bed.gz", "--vcf", vcf,
                    "--pairs", sub, "--map", smap, "--bs", str(args.bs),
                    "--bs_seed", "7"]
            for rep in range(args.reps):
                order = ("numpy", "torch") if rep % 2 == 0 else \
                    ("torch", "numpy")
                for eng in order:
                    flags = ["--engine", eng] + (
                        ["--device", "cuda"] if eng == "torch" else [])
                    w = _run(base + flags + ["--o", os.path.join(
                        tmp, "%s_%d.txt" % (eng, n))], tmp)
                    walls[eng].setdefault(n, []).append(w)
                    print("   pairs %5d  %-5s  %.3f s   [%s]"
                          % (n, eng, w, smi), flush=True)
    fits = {}
    for eng, by_n in walls.items():
        ps = [n for n in pair_counts for _ in by_n[n]]
        ws = [w for n in pair_counts for w in by_n[n]]
        fits[eng] = _fit(ps, ws)
    (fn, sn), (ft, st) = fits["numpy"], fits["torch"]
    cross = (ft - fn) / (sn - st) if sn > st else float("inf")
    record = {
        "device": smi, "bs": args.bs, "samples": args.samples,
        "genes": args.genes, "walls_s": walls,
        "fit_s": {k: {"fixed": v[0], "per_pair": v[1]}
                  for k, v in fits.items()},
        "crossover_pairs": cross, "crossover_pairs_x_bs": cross * args.bs,
    }
    print("   numpy: %.3f s + %.4f s a pair; torch: %.3f s + %.4f s a pair; "
          "crossover %.1f pairs (pairs x bs %.0f)"
          % (fn, sn, ft, st, cross, cross * args.bs))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
