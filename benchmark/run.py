"""One run of one cell of phaser_tpu_torch's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as setup_s, from process start): the port imported, its
libraries loaded and CUDA initialised; the cell's inputs made from the
seed by a child process (benchmark/gen/make.py) or found in the checkout's
cache; one whole pass, untimed.  The window: passes back to back, each one
in-process call of the port's CLI (`phaser_tpu_torch.cli.phaser_main.main`)
with the configuration's flags and `--device cuda`, writing into a new
directory of its own under TMPDIR; once `--seconds` have passed, the pass
in flight finishes and counts.  After the window: every pass's outputs
must hash equal to the last pass's, the last pass's outputs are compared
with the plain reference (benchmark/reference) run over the arrays the
inputs were written from, and one JSON line is printed.  With `--trace 1`
the window runs under torch.profiler (CUDA activity) and the line carries
the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(BENCH, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "phaser_tpu")
OUTPUTS = ("allelic_counts.txt", "variant_connections.txt", "haplotypes.txt",
           "allele_config.txt", "haplotypic_counts.txt", "vcf.gz")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))


T_PROCESS = time.perf_counter() - process_age()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (phaser_tpu_torch is not phaser_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def set_environment() -> None:
    """Fixed cache directories inside the checkout, for every build and
    kernel cache the program or its libraries may keep."""
    os.environ["PHASER_TPU_TORCH_CACHE"] = os.path.join(CACHE, "port")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def cell_inputs(cell, seed: int) -> tuple:
    """(directory, manifest) of the cell's inputs for this seed, made by a
    child process unless the cache holds them; the cache keeps one seed a
    cell."""
    base = os.path.join(CACHE, "inputs", cell.name)
    out = os.path.join(base, str(seed))
    man = os.path.join(out, "manifest.json")
    if not os.path.exists(man):
        if os.path.isdir(base):
            shutil.rmtree(base)
        os.makedirs(base)
        tmp = out + ".part"
        cfg_file = {c["name"]: c["file"] for c in cell.spec["configs"]}[
            cell.workload["config"]]
        subprocess.run(
            [sys.executable, os.path.join(BENCH, "gen", "make.py"),
             os.path.join(cell.root, cfg_file),
             os.path.join(BENCH, "traffic", cell.workload["traffic"] + ".json"),
             str(seed), tmp], check=True, stdout=subprocess.DEVNULL)
        os.replace(tmp, out)
    with open(man) as fh:
        return out, json.load(fh)


def pass_argv(cell, inputs: str, man: dict, device: str) -> list:
    cfg = cell.config
    return (["--bam", ",".join(os.path.join(inputs, b) for b in man["bams"]),
             "--vcf", os.path.join(inputs, man["vcf"]),
             "--sample", cfg["sample"]] + list(cfg["flags"]) +
            ["--device", device])


def file_hashes(prefix: str) -> dict:
    out = {}
    for f in OUTPUTS:
        p = prefix + "." + f
        if os.path.exists(p):
            with open(p, "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def run(args, device: str = "cuda", require_card: bool = True,
        root: str = None, log=sys.stderr) -> dict:
    """One run of the cell; returns the result line's object (without the
    checks' print).  The CPU tests call it with device "cpu" and no card."""
    root = root or os.getcwd()
    sys.path[:0] = [BENCH, root]
    from harness import cell as cellmod
    from harness import stages, window
    cell = cellmod.load(root, BENCH, args.workload)
    chips = int(cell.workload["chips"])
    set_environment()
    import torch
    if require_card and (not torch.cuda.is_available() or
                         torch.cuda.device_count() < chips):
        raise SystemExit("needs %d CUDA device(s); torch sees %d"
                         % (chips, torch.cuda.device_count()
                            if torch.cuda.is_available() else 0))
    from phaser_tpu_torch.cli import phaser_main
    from phaser_tpu_torch.utils import build
    build.get_io_lib()
    if device == "cuda":
        build.get_lib()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    startup_s = time.perf_counter() - T_PROCESS

    t = time.perf_counter()
    inputs, man = cell_inputs(cell, args.seed)
    inputs_s = time.perf_counter() - t
    argv = pass_argv(cell, inputs, man, device)
    work = tempfile.mkdtemp(prefix="phaser_bench_")
    rcs = []

    def one_pass(k):
        d = os.path.join(work, "pass_%d" % k)
        os.makedirs(d)
        with open(os.path.join(d, "stdout.txt"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            rcs.append(phaser_main.main(argv + ["--o", d + "/o"]))

    t = time.perf_counter()
    one_pass(-1)                                   # the warm pass
    warm_s = time.perf_counter() - t
    warm_rc = rcs.pop()
    shutil.rmtree(os.path.join(work, "pass_-1"))
    tracer = None
    if args.trace and device == "cuda":
        from harness.trace import DeviceTrace
        tracer = DeviceTrace()
        tracer.start()
    setup_s = time.perf_counter() - T_PROCESS
    cpu0 = os.times()
    t0, spans = window.run_window(one_pass, args.seconds)
    cpu1 = os.times()
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    trace = None
    if tracer is not None:
        events = tracer.stop(os.path.join(work, "trace.json"))
        from harness.trace import breakdown, busy_seconds
        trace = {"events": events, "busy_s": busy_seconds(events),
                 "window_s": spans[-1][1] - t0,
                 "breakdown": breakdown(events, len(spans))}
    bad_modules = forbidden_modules()
    if bad_modules:
        print("loaded in this process: %s" % ", ".join(bad_modules),
              file=log)
        raise SystemExit(3)
    mem_peak = torch.cuda.max_memory_reserved() if device == "cuda" else 0

    # after the window: hashes, stage lines, the reference, the checks
    n = len(spans)
    last = os.path.join(work, "pass_%d" % (n - 1), "o")
    want = file_hashes(last)
    passes_differ = sum(file_hashes(os.path.join(work, "pass_%d" % k, "o"))
                        != want for k in range(n))
    last_dir = os.path.dirname(last)
    pass_bytes = sum(os.path.getsize(os.path.join(last_dir, f))
                     for f in os.listdir(last_dir))
    stage_secs = []
    for k in range(n):
        with open(os.path.join(work, "pass_%d" % k, "stdout.txt")) as fh:
            stage_secs.append(stages.parse(fh.read()))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    from gen.make import inputs as make_inputs
    from reference.compare import compare
    from reference.pipeline import join_work, run as ref_run
    donor, sets = make_inputs(cell.config, cell.traffic, args.seed)
    ref_dir = os.path.join(work, "reference")
    os.makedirs(ref_dir)
    ref_run(cell.config, donor, sets, os.path.join(ref_dir, "o"))
    cmp = compare(last, os.path.join(ref_dir, "o"))
    work_per_bam = None
    if trace is not None:
        work_per_bam = join_work(cell.config, donor, sets)
    reference_s = time.perf_counter() - t
    del donor, sets
    shutil.rmtree(work)

    limits = cell.config["limits"]
    checks = {"rows_differ": cmp["rows_differ"],
              "real_gap": cmp["real_gap"],
              "files_missing": cmp["files_missing"],
              "passes_differ": passes_differ,
              "failed_passes": sum(rc != 0 for rc in rcs) + (warm_rc != 0)}
    correct = all(checks[k] <= limits[k] for k in checks)
    ctx = {"setup_s": setup_s, "startup_s": startup_s, "inputs_s": inputs_s,
           "reads_per_pass": sum(man["reads"]), "t0": t0, "spans": spans,
           "stages": stage_secs, "peak_rss_bytes": peak_rss,
           "trace": trace, "join_work": work_per_bam}
    metrics = cellmod.read_metrics(cell, bool(args.trace), ctx)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    result = {"correct": bool(correct), "attempted": n,
              "failed": int(sum(rc != 0 for rc in rcs)),
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu",
                         "kind": kind, "count": chips,
                         "memory_peak_bytes": int(mem_peak)}}
    if trace is not None:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["info"] = {"startup_s": startup_s, "inputs_s": inputs_s,
                      "warm_s": warm_s, "reference_s": reference_s,
                      "pass_bytes": pass_bytes,
                      "window_cpu_s": (cpu1.user + cpu1.system) -
                      (cpu0.user + cpu0.system),
                      "passes": n, "pass_s": [e - s for s, e in spans]}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    args = p.parse_args(argv)
    result = run(args)
    for k, c in result["checks"].items():
        print("check %s %r limit %r" % (k, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
