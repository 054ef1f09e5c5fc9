"""Makes one cell's inputs from its configuration, its traffic mix and a
seed: `<sample>.vcf.gz` with its `.tbi`, one coordinate-sorted BAM with its
`.bai` for each BAM of the configuration, and `manifest.json`, which
records what was made.  The same seed gives the same files.

    python benchmark/gen/make.py CONFIG.json TRAFFIC.json SEED OUT_DIR

`inputs(cfg, mix, seed)` returns the arrays the files are written from;
the plain reference reads those and not the files."""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    __package__ = "gen"

from . import bam as bamw        # noqa: E402
from . import vcf as vcfw        # noqa: E402
from .genes import lay_out       # noqa: E402
from .reads import simulate      # noqa: E402
from .sites import make_donor    # noqa: E402


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *key]))


def inputs(cfg: dict, mix: dict, seed: int):
    """(donor, [ReadSet of each BAM in the configuration's order])."""
    r0, r1 = cfg["region"][0] - 1, cfg["region"][1]
    rna = [b for b in cfg["bams"] if b["kind"] == "rna"]
    genes = None
    if rna:
        genes = lay_out(mix["bams"][rna[0]["name"]], r0, r1, _rng(seed, 1))
    donor = make_donor(cfg, _rng(seed, 2), genes)
    sets = [simulate(b, mix["bams"][b["name"]], donor, genes,
                     _rng(seed, 3, i)) for i, b in enumerate(cfg["bams"])]
    return donor, sets


def make(cfg: dict, mix: dict, seed: int, out: str, threads: int = 8) -> dict:
    t0 = time.perf_counter()
    os.makedirs(out, exist_ok=True)
    donor, sets = inputs(cfg, mix, seed)
    t1 = time.perf_counter()
    vcf = os.path.join(out, cfg["sample"] + ".vcf.gz")
    vcfw.write(vcf, cfg, donor, threads)
    bams, sizes = [], []
    for b, rs in zip(cfg["bams"], sets):
        p = os.path.join(out, b["name"] + ".bam")
        sizes.append(bamw.write(p, cfg, b, rs, threads))
        bams.append(p)
    # on disk before the window opens, so that no write-back of the inputs
    # runs beside the measured passes
    t2 = time.perf_counter()
    for p in [vcf, vcf + ".tbi"] + bams + [p + ".bai" for p in bams]:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    man = {"seed": int(seed), "vcf": os.path.basename(vcf),
           "bams": [os.path.basename(p) for p in bams],
           "reads": [len(rs) for rs in sets],
           "uncompressed_bytes": sizes,
           "file_bytes": {os.path.basename(p): os.path.getsize(p)
                          for p in [vcf, vcf + ".tbi"] + bams +
                          [p + ".bai" for p in bams]},
           "simulate_s": t1 - t0, "write_s": t2 - t1,
           "sync_s": time.perf_counter() - t2}
    with open(os.path.join(out, "manifest.json"), "w") as fh:
        json.dump(man, fh, indent=1)
    return man


if __name__ == "__main__":
    cfg_path, mix_path, seed, out = sys.argv[1:5]
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(mix_path) as f:
        mix = json.load(f)
    print(json.dumps(make(cfg, mix, int(seed), out)))
