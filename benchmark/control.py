"""The lower-precision control of a cell's comparison: the plain reference
put in the program's place with the connection test's p-values in float32
(the configuration states float64), compared as a run's outputs are, on
each seed given.  Its readings are the upper ends of the limits in the
configuration's `limits`; it needs no card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))


def readings(cell, seed: int) -> dict:
    from gen.make import inputs
    from reference.compare import compare
    from reference.pipeline import run
    donor, sets = inputs(cell.config, cell.traffic, seed)
    work = tempfile.mkdtemp(prefix="phaser_control_")
    try:
        run(cell.config, donor, sets, os.path.join(work, "want"))
        run(cell.config, donor, sets, os.path.join(work, "got"),
            p_dtype=np.float32)
        out = compare(os.path.join(work, "got"), os.path.join(work, "want"),
                      got_vcf=".vcf")
    finally:
        shutil.rmtree(work)
    limits = cell.config["limits"]
    out["correct"] = all(out[k] <= limits[k] for k in out)
    out["seed"] = seed
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [BENCH, os.getcwd()]
    from harness.cell import load
    cell = load(os.getcwd(), BENCH, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
