"""FULL-engine scaling benchmark: strong + weak scaling of the
position-sharded multiprocess engine on a deliberately SKEWED fixture (the
port of phaser_tpu/dist/engine_scaling_bench.py).

BASELINE.json's target is >=80% scaling efficiency at 2 hosts for the
complete engine.  This harness simulates n single-core hosts on one
machine by pinning each engine process to its own core (taskset), runs the
full engine (phaser_tpu_torch.dist.engine_multihost --position-shards
--device D) at
n = 1, 2[, 4], verifies every output file byte-identical to the
single-process run, and records:

  strong efficiency(n) = T1 / (n * Tn)        (fixed workload)
  weak   efficiency(n) = T1(W) / Tn(n * W)    (workload scaled with n)

Tn = max over shards of the engine's internal wall_s (run_phaser only;
the rank-0 output merge is excluded consistently — it is O(output bytes),
identical at every n).  CAVEAT recorded in the artifact: single-machine
core pinning is a lower bound for real multi-host efficiency (shared
memory bandwidth, shared page cache), but an honest model of per-host
compute; collectives ride loopback Gloo rather than DCN.  With
--device cuda (the default) every process drives the same card.

Usage:
  python -m phaser_tpu_torch.dist.engine_scaling_bench \
      [--reads 200000] [--out BENCH_scaling.json] [--ns 1,2,4] [--weak]
      [--device cuda|cpu|host]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TEXT = ["haplotypes.txt", "haplotypic_counts.txt", "allelic_counts.txt",
        "variant_connections.txt", "allele_config.txt"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gen_fixture(td: str, total_pairs: int, seed: int):
    """Skewed 3-contig fixture: 60/25/15% of reads; variant density
    matches read share so block structure is realistic everywhere."""
    from ..testing import datagen
    shares = (0.6, 0.25, 0.15)
    reads = [int(total_pairs * s) for s in shares]
    lens = [max(200_000, r * 12) for r in reads]
    nvar = [max(60, r // 40) for r in reads]
    return datagen.write_fixture_dir(
        td, seed=seed, contigs=("chr1", "chr2", "chr3"),
        contig_len=lens, n_variants_per_contig=nvar,
        n_reads_per_contig=reads, error_rate=0.01)


def _run_n(vcf: str, bam: str, prefix: str, n: int, pin: bool,
           device: str):
    """Launch n engine processes (position shards), return the per-shard
    internal wall_s list (imbalance must stay visible in the artifact —
    round-4 verdict #8)."""
    port = _free_port()
    procs = []
    n_cores = os.cpu_count() or 1
    for pid in range(n):
        cmd = []
        if pin:
            cmd = ["taskset", "-c", str(pid % n_cores)]
        cmd += [sys.executable, "-m",
                "phaser_tpu_torch.dist.engine_multihost",
                "--bam", bam, "--vcf", vcf, "--sample", "SAMPLE1",
                "--o", prefix, "--num-processes", str(n),
                "--process-id", str(pid), "--position-shards",
                "--coordinator", "localhost:%d" % port, "--device", device]
        env = dict(os.environ)
        procs.append(subprocess.Popen(cmd, cwd=_REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    walls = []
    for p in procs:
        out, _ = p.communicate(timeout=3600)
        if p.returncode != 0:
            raise RuntimeError(out[-3000:])
        m = re.search(r"wall_s=([0-9.]+)", out)
        walls.append(float(m.group(1)))
    return walls


def _snapshot(prefix: str):
    from ..io import bgzf
    out = {}
    for sfx in TEXT:
        with open(prefix + "." + sfx) as f:
            out[sfx] = f.read()
    out["vcf"] = bgzf.read_text_auto(prefix + ".vcf.gz")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=200_000,
                    help="total read PAIRS in the strong-scaling fixture")
    ap.add_argument("--ns", default="")
    ap.add_argument("--weak", action="store_true",
                    help="also run weak scaling (fixture scaled with n)")
    ap.add_argument("--no-pin", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "cpu", "host"),
                    help="the engine processes' --device (they share one "
                         "card under cuda)")
    args = ap.parse_args(argv)
    pin = not args.no_pin
    n_cores = os.cpu_count() or 1
    if args.ns:
        ns = [int(x) for x in args.ns.split(",")]
    else:
        # only n <= cores rows belong in the artifact: pinned
        # oversubscription measures scheduler thrash, not scaling
        # (round-4 n=4 rows on a 2-core box read as 0.29 "efficiency")
        ns = [n for n in (1, 2, 4, 8) if n <= n_cores]
    dropped = [n for n in ns if n > n_cores]
    if dropped and pin:
        print("# NOTE: n>cores rows (%s) are oversubscription noise on a "
              "%d-core box; recording them under 'oversubscribed'"
              % (dropped, n_cores), file=sys.stderr)

    result = {
        "workload": "skewed 3-contig fixture (60/25/15%% of reads), "
                    "full engine, position shards, outputs verified "
                    "byte-identical at every n",
        "device": args.device,
        "cores": n_cores, "pinned": pin,
        "caveat": "n processes pinned to distinct cores on ONE machine "
                  "simulate n single-core hosts; collectives ride "
                  "loopback Gloo. Lower bound for real multi-host "
                  "(shared memory bandwidth here).",
        "timing": "max over shards of run_phaser internal wall_s "
                  "(rank-0 output merge excluded at every n)",
        "strong": {}, "weak": {},
        "oversubscribed": {}, "oversubscribed_weak": {},
        "oversubscribed_note": "rows with n > cores under pinning measure "
                               "scheduler thrash, not scaling; excluded "
                               "from strong/weak",
    }

    # SCALE_FIXTURE_DIR caches the generated fixtures across invocations
    # (generation is pure-python and slower than the runs themselves)
    cache_dir = os.environ.get("SCALE_FIXTURE_DIR", "")
    ctx = tempfile.TemporaryDirectory() if not cache_dir else None
    td = ctx.name if ctx else cache_dir
    os.makedirs(td, exist_ok=True)
    try:
        fx = os.path.join(td, "fx%d" % args.reads)
        os.makedirs(fx, exist_ok=True)
        t0 = time.perf_counter()
        if not os.path.isfile(os.path.join(fx, "sample.bam")):
            _gen_fixture(fx, args.reads, seed=99)
        vcf = os.path.join(fx, "sample.vcf.gz")
        bam = os.path.join(fx, "sample.bam")
        print("# fixture: %d pairs in %.1fs" % (args.reads,
                                                time.perf_counter() - t0),
              file=sys.stderr)
        # warmup pass: page cache for the fresh fixture and the built
        # libraries (a first-ever run otherwise contaminates whichever n
        # runs first)
        _run_n(vcf, bam, os.path.join(td, "warm"), min(ns), pin,
               args.device)
        want = None
        t1 = None
        for n in ns:
            prefix = os.path.join(td, "s%d" % n)
            runs = [_run_n(vcf, bam, prefix, n, pin, args.device)
                    for _ in range(2)]
            shard_walls = min(runs, key=max)
            w = max(shard_walls)
            snap = _snapshot(prefix)
            if want is None:
                want = snap
                t1 = w
            else:
                for k in want:
                    assert snap[k] == want[k], \
                        "output %s diverged at n=%d" % (k, n)
            eff = t1 / (n * w)
            dest = result["strong" if n <= n_cores or not pin
                          else "oversubscribed"]
            dest[str(n)] = {
                "wall_s": round(w, 3), "efficiency": round(eff, 4),
                "shard_wall_s": [round(x, 3) for x in shard_walls],
                "runs": 2}
            print("# strong n=%d wall=%.3fs eff=%.3f shards=%s"
                  % (n, w, eff, [round(x, 2) for x in shard_walls]),
                  file=sys.stderr)

        if args.weak:
            for n in ns:
                if n == 1:
                    if "1" in result["strong"]:
                        result["weak"]["1"] = dict(
                            result["strong"]["1"], efficiency=1.0)
                    continue
                wtd = os.path.join(td, "weakfx%d_%d" % (args.reads, n))
                os.makedirs(wtd, exist_ok=True)
                if not os.path.isfile(os.path.join(wtd, "sample.bam")):
                    _gen_fixture(wtd, args.reads * n, seed=99 + n)
                wv = os.path.join(wtd, "sample.vcf.gz")
                wb = os.path.join(wtd, "sample.bam")
                runs = [_run_n(wv, wb, os.path.join(wtd, "o"), n, pin,
                               args.device) for _ in range(2)]
                shard_walls = min(runs, key=max)
                w = max(shard_walls)
                eff = t1 / w
                dest = result["weak" if n <= n_cores or not pin
                              else "oversubscribed_weak"]
                dest[str(n)] = {
                    "wall_s": round(w, 3), "efficiency": round(eff, 4),
                    "shard_wall_s": [round(x, 3) for x in shard_walls]}
                print("# weak n=%d wall=%.3fs eff=%.3f" % (n, w, eff),
                      file=sys.stderr)
    finally:
        if ctx is not None:
            ctx.cleanup()

    e2 = result["strong"].get("2", {}).get("efficiency")
    result["headline"] = {
        "metric": "engine_strong_scaling_efficiency_2",
        "value": e2, "target": 0.8}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
