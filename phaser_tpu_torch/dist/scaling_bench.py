"""Weak-scaling harness for the sharded allele-count step (the port of
phaser_tpu/dist/scaling_bench.py).

BASELINE.json's multi-host target is >= 80% scaling efficiency at 2 hosts.
For each rank count N in --devices this starts N rank processes in one Gloo
group; each runs dist.mesh.sharded_allele_counts (allele assignment on its
own rows, then the all_reduce merge) on a FIXED per-rank read batch (weak
scaling), and the step time is the slowest rank's.  It reports

    efficiency(N) = throughput(N) / (N * throughput(1))

CAVEAT: on one machine with one card (an H100 here) the N ranks share that
card and its host, as phaser_tpu's virtual CPU devices share the host's
cores; the number is then a LOWER bound that validates the collective path
and measures its overhead, not scaling across cards or hosts.

Usage:
    python -m phaser_tpu_torch.dist.scaling_bench [--devices 1,2,4,8]
        [--reads-per-device 2048] [--read-len 128] [--variants 512]
        [--iters 8] [--device cuda|cpu]

Prints a `CHILD_RESULT {...}` line per N (from its rank 0) and, last, ONE
JSON line:
    {"metric": "weak_scaling_efficiency", "value": eff_at_max,
     "unit": "fraction", "per_device": {...}}
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

CHILD_TIMEOUT_S = 900
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _gen(n_reads: int, read_len: int, n_vars: int, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    span = max(4 * read_len, n_vars * 8)
    codes = rng.integers(0, 16, (n_reads, read_len)).astype(np.uint8)
    quals = rng.integers(0, 42, (n_reads, read_len)).astype(np.uint8)
    start = rng.integers(1, span, n_reads).astype(np.int32)
    refpos = start[:, None] + np.arange(read_len, dtype=np.int32)[None, :]
    vpos = np.sort(rng.choice(np.arange(1, span + read_len), n_vars,
                              replace=False)).astype(np.int32)
    ind = rng.integers(1, 15, (n_vars, 2)).astype(np.uint8)
    ni = np.full(n_vars, 2, np.int8)
    return codes, quals, refpos, vpos, ind, ni


def run_child(n_devices: int, rank: int, coordinator: str,
              reads_per_device: int, read_len: int, n_vars: int, iters: int,
              baseq: int = 10, device: str = "cuda") -> dict:
    """One rank of an N-rank run: its rows of _gen(N * reads_per_device)
    on `device`, `iters` timed steps after one warm step.  Returns the
    result with the slowest rank's step time (the same on every rank)."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..mapper.dispatch import require_device
    from .mesh import make_mesh, shard_reads, sharded_allele_counts

    require_device(device)
    grouped = n_devices > 1
    if grouped:
        dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                                rank=rank, world_size=n_devices,
                                timeout=timedelta(seconds=CHILD_TIMEOUT_S))
    try:
        mesh = make_mesh(device=device,
                         group=dist.group.WORLD if grouped else None)
        n_reads = reads_per_device * n_devices
        codes, quals, refpos, vpos, ind, ni = _gen(n_reads, read_len, n_vars)
        own = slice(rank * reads_per_device, (rank + 1) * reads_per_device)
        codes, quals, refpos = shard_reads(mesh, codes[own], quals[own],
                                           refpos[own])

        def sync():
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
        counts = sharded_allele_counts(mesh, codes, quals, refpos, vpos, ind,
                                       ni, baseq)
        sync()   # warm: the library's load, the first launches
        if grouped:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            counts = sharded_allele_counts(mesh, codes, quals, refpos, vpos,
                                           ind, ni, baseq)
        sync()
        dt = torch.tensor([(time.perf_counter() - t0) / iters],
                          dtype=torch.float64)
        if grouped:
            dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        dt = float(dt[0])
        total = int(counts.sum())
    finally:
        if grouped:
            dist.destroy_process_group()
    res = {"n_devices": n_devices, "reads": n_reads, "step_s": dt,
           "reads_per_s": n_reads / dt, "hits": total,
           "device": str(mesh.device)}
    if mesh.device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(mesh.device)
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(n: int, args) -> dict:
    """N rank processes of one group; rank 0's CHILD_RESULT."""
    coordinator = "localhost:%d" % _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs, logs = [], []
    try:
        for rank in range(n):
            # output to files: a full pipe would stall a rank in a collective
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "phaser_tpu_torch.dist.scaling_bench",
                 "--child", str(n), "--rank", str(rank), "--coordinator",
                 coordinator, "--device", args.device,
                 "--reads-per-device", str(args.reads_per_device),
                 "--read-len", str(args.read_len),
                 "--variants", str(args.variants),
                 "--iters", str(args.iters)],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
                text=True))
        rcs = [p.wait(timeout=CHILD_TIMEOUT_S) for p in procs]
        outs = []
        for fh in logs:
            fh.seek(0)
            outs.append(fh.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    if rcs != [0] * n:
        sys.stderr.write("\n".join(o[-2000:] for o in outs))
        raise RuntimeError("ranks for %d devices exited %s" % (n, rcs))
    line = [l for l in outs[0].splitlines()
            if l.startswith("CHILD_RESULT ")][-1]
    print(line, flush=True)
    return json.loads(line[len("CHILD_RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phaser_tpu_torch.dist.scaling_bench")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--reads-per-device", type=int, default=2048)
    ap.add_argument("--read-len", type=int, default=128)
    ap.add_argument("--variants", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        res = run_child(args.child, args.rank, args.coordinator,
                        args.reads_per_device, args.read_len, args.variants,
                        args.iters, device=args.device)
        if args.rank == 0:
            print("CHILD_RESULT " + json.dumps(res))
        return 0

    device_counts = [int(x) for x in args.devices.split(",")]
    per: dict = {}
    for n in device_counts:
        per[n] = _run_ranks(n, args)

    base = per[device_counts[0]]["reads_per_s"] / device_counts[0]
    for n, r in per.items():
        r["efficiency"] = r["reads_per_s"] / (n * base)
    n_max = max(device_counts)
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": round(per[n_max]["efficiency"], 4),
        "unit": "fraction",
        "per_device": per,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
