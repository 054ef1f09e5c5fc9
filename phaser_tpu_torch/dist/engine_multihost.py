"""Sharded runs of the port's engine: the phaser_tpu_torch counterpart of
phaser_tpu/dist/engine_multihost.py.

A shard is a range of the VCF's contigs, or a weight-balanced (contig,
position-range) plan; each shard runs the COMPLETE engine
(`engine.pipeline.run_phaser`) with a `dist_reduce` reducer for its global
merge points (AS quantile, row exchange, row offsets, noise, block base),
and the per-shard outputs merge into files byte-identical to the
single-process run.

From phaser_tpu, whose module top is JAX-free, this module imports the
reducer logic (`_ReducerBase`, `_ThreadGroup`, `ThreadReducer`,
`RecordingReducer`), the shard split and the output merge.  It copies
`replay_journal` and `_merge_results`, which build the port's
`PhaserResult`, and ports the runners:

  run_phaser_sharded_threads  N engine threads in one process; on
                              --device cuda they share the one card
  run_phaser_multihost        one engine per process, collectives over
                              torch.distributed (MultihostReducer)
  run_phaser_multiproc        the CLI's --threads N --device host: spawns
                              N `python -m` workers of this module

MultihostReducer runs on Gloo, not NCCL: the payloads are pickled host
objects, and several ranks may share one GPU, which NCCL does not allow.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional

from phaser_tpu.dist.engine_multihost import (  # noqa: F401 (re-exported)
    EMPTY_SHARD, RecordingReducer, ThreadReducer, _ReducerBase, _ThreadGroup,
    _shard_chrom, _shard_outputs_complete, merge_shard_outputs,
    split_contigs)
from phaser_tpu.engine.output_stage import PhaserOptions
from phaser_tpu.engine.slow_mode import list_contigs

from ..engine.pipeline import NoReadsMatched, PhaserResult, run_phaser

# seconds a process waits in one collective (and to join the group) before
# the run fails: a peer that hangs fails the run instead of holding it
DEFAULT_TIMEOUT_S = 3600.0


def replay_journal(base: _ReducerBase, path: str) -> PhaserResult:
    """Re-emit a completed shard's journaled collective payloads in their
    original order (outputs are already on disk) and return its result.
    Live peers doing a full re-run interoperate transparently: the engine's
    collective call sequence is deterministic, so the replayed payloads
    land exactly where the original run's would (phaser_tpu
    dist/engine_multihost.py:302-314)."""
    with open(path, "rb") as fh:
        data = pickle.load(fh)
    for p in data["payloads"]:
        base._allgather(p)
    d = dict(data["result"])
    d["shard_device"] = [tuple(x) for x in d.get("shard_device", [])]
    return PhaserResult(**d)


def _merge_results(per_shard: List[PhaserResult]) -> PhaserResult:
    """phaser_tpu dist/engine_multihost.py:487-505."""
    total = PhaserResult()
    for r in per_shard:
        total.total_reads += r.total_reads
        total.het_count += r.het_count
        total.phased_variants += r.phased_variants
        total.unphased_count += r.unphased_count
        total.covered_count += r.covered_count
        total.dropped_connections += r.dropped_connections
        total.unphased_phased += r.unphased_phased
        total.phase_corrections += r.phase_corrections
    # block_count is a running global index; the final value is the max
    total.n_blocks = max((r.n_blocks for r in per_shard), default=0)
    total.noise_e = per_shard[0].noise_e if per_shard else 0.0
    # per-shard device fractions: (device_s, wall_s)
    total.shard_device = [(r.device_s, r.wall_s) for r in per_shard]
    total.device_s = sum(r.device_s for r in per_shard)
    total.wall_s = max((r.wall_s for r in per_shard), default=0.0)
    return total


def _warm_up(device) -> None:
    """Device start-up in one thread, before any shard exists: raises
    without a card for --device cuda, and initialises CUDA and builds (or
    loads) the kernel library once instead of N shards racing to it."""
    if device in ("host", "off"):
        return
    from ..mapper.dispatch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        from ..kernels.alleles import _kernels
        torch.cuda.init()
        _kernels()


# ---------------------------------------------------------------------------
# reducers

class MultihostReducer(_ReducerBase):
    """Cross-process allgather over the default torch.distributed group
    (Gloo): `all_gather_object` pickles each payload (noise terms,
    AS-score histograms, row bundles, output state).  Without a process
    group (one process) it returns [payload]."""

    def __init__(self, rank_of: Dict[str, int]):
        import torch.distributed as dist
        if dist.is_initialized():
            self.shard_id = dist.get_rank()
            self.n_shards = dist.get_world_size()
        else:
            self.shard_id, self.n_shards = 0, 1
        self.rank_of = rank_of

    def _allgather(self, payload):
        if self.n_shards == 1:
            return [payload]
        import torch.distributed as dist
        out = [None] * self.n_shards
        dist.all_gather_object(out, payload)
        return out


# ---------------------------------------------------------------------------
# runners

def run_phaser_sharded_threads(*, n_shards: int, vcf: str, bam: str,
                               sample: str, o: str, mapq: str, baseq: int,
                               paired_end: str, chrom: str = "",
                               opts: Optional[PhaserOptions] = None,
                               device: str = "host",
                               position_shards: bool = False, log=print,
                               **kw) -> PhaserResult:
    """In-process sharded run: n_shards engine threads + ThreadReducer
    (phaser_tpu dist/engine_multihost.py:516-583).

    On --device cuda every shard drives the one card through
    mapper.dispatch: each shard's launches are serial within its own
    thread, on that thread's current (default) stream, and the packer
    scratch buffers are thread-local (kernels.alleles._reuse_buf), so
    shards interleave launches without aliasing.  A shard that fails
    aborts its peers' collectives and the run raises."""
    opts = opts or PhaserOptions()
    _warm_up(device)
    contigs = chrom.split(",") if chrom else list_contigs(vcf)
    plans = None
    if position_shards:
        # weight-balanced (contig, position-range) shards: n_shards may
        # exceed n_contigs, skewed contigs split at window granularity
        from phaser_tpu.dist.shard_plan import plan_shards
        n_shards = max(1, n_shards)
        plans = plan_shards(bam, contigs, n_shards)
    else:
        n_shards = max(1, min(n_shards, len(contigs)))
    log("     sharded engine: %d %s shards (threads, device=%s)"
        % (n_shards, "position" if position_shards else "contig", device))
    assign = split_contigs(contigs, n_shards)
    rank_of = {c: i for i, c in enumerate(contigs)}
    group = _ThreadGroup(n_shards)
    results: List[Optional[PhaserResult]] = [None] * n_shards
    errors: List = []

    def worker(sid: int):
        red = ThreadReducer(group, sid, rank_of)
        try:
            results[sid] = run_phaser(
                vcf=vcf, bam=bam, sample=sample, o=o + ".shard%d" % sid,
                mapq=mapq, baseq=baseq, paired_end=paired_end,
                chrom="" if plans else _shard_chrom(assign, sid),
                shard_plan=plans[sid] if plans else None,
                opts=opts, device=device,
                dist_reduce=red, split_outputs=True,
                log=log if sid == 0 else (lambda *a: None), **kw)
        except BaseException as e:  # noqa: BLE001 - must unblock peers
            errors.append((sid, e))
            group.abort()

    threads = [threading.Thread(target=worker, args=(s,), daemon=True)
               for s in range(n_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        sid, e = errors[0]
        if isinstance(e, NoReadsMatched):
            # the noise is reduced globally, so every shard fails here
            # together; the type tells slow mode the contig has nothing to
            # phase
            raise NoReadsMatched("shard %d failed: %s" % (sid, e)) from e
        if not isinstance(e, threading.BrokenBarrierError):
            raise RuntimeError("shard %d failed: %s" % (sid, e)) from e
        raise RuntimeError("sharded run aborted") from e
    merge_shard_outputs(o, n_shards, opts)
    return _merge_results([r for r in results if r is not None])


def run_phaser_multihost(*, vcf: str, bam: str, sample: str, o: str,
                         mapq: str, baseq: int, paired_end: str,
                         num_processes: int, process_id: int,
                         coordinator: str = "localhost:9711",
                         chrom: str = "",
                         opts: Optional[PhaserOptions] = None,
                         device: str = "host",
                         position_shards: bool = False,
                         resume: bool = False,
                         timeout_s: float = DEFAULT_TIMEOUT_S, log=print,
                         **kw) -> PhaserResult:
    """One engine shard per process; rank 0 merges after a barrier
    (phaser_tpu dist/engine_multihost.py:586-660).

    The processes join a Gloo group at tcp://`coordinator` (rank 0 listens
    there) with a `timeout_s` bound on every collective; the group is
    destroyed on every exit path.  position_shards=True computes the SAME
    weight-balanced (contig, position-range) plan on every process from the
    BAM index.  resume=True: a rank whose previous run completed (journal +
    outputs on disk) replays its journaled collective payloads instead of
    recomputing; ranks without a journal re-run in full; the two
    interoperate, so after a partial failure only the lost shards are
    recomputed."""
    import torch.distributed as dist

    if device not in ("host", "off"):
        # fail before joining the group when the card is asked for and
        # absent
        from ..mapper.dispatch import resolve_device
        resolve_device(device)
    if num_processes > 1:
        dist.init_process_group(
            "gloo", init_method="tcp://" + coordinator, rank=process_id,
            world_size=num_processes, timeout=timedelta(seconds=timeout_s))
    try:
        opts = opts or PhaserOptions()
        contigs = chrom.split(",") if chrom else list_contigs(vcf)
        plans = None
        if position_shards:
            from phaser_tpu.dist.shard_plan import plan_shards
            plans = plan_shards(bam, contigs, num_processes)
        assign = split_contigs(contigs, min(num_processes, len(contigs)))
        rank_of = {c: i for i, c in enumerate(contigs)}
        red = MultihostReducer(rank_of)
        # lines the shards up at the same start line before the engine
        red.barrier()
        prefix = o + ".shard%d" % process_id
        jpath = prefix + ".ckpt"
        from phaser_tpu.dist.block_exchange import balance_blocks_enabled
        delegated = plans is not None and num_processes > 1 \
            and balance_blocks_enabled()
        if resume and os.path.isfile(jpath) and \
                _shard_outputs_complete(prefix, opts, delegated=delegated):
            log("     shard %d: replaying journal (outputs already complete)"
                % process_id)
            res = replay_journal(red, jpath)
        else:
            rec = RecordingReducer(red)
            res = run_phaser(
                vcf=vcf, bam=bam, sample=sample, o=prefix,
                mapq=mapq, baseq=baseq, paired_end=paired_end,
                chrom="" if plans else _shard_chrom(assign, process_id),
                shard_plan=plans[process_id] if plans else None,
                opts=opts, device=device,
                dist_reduce=rec, split_outputs=True,
                log=log if process_id == 0 else (lambda *a: None), **kw)
            rec.dump(jpath, res)
            if os.environ.get("PHASER_TPU_TEST_EXIT_BEFORE_BARRIER") == "1":
                # deterministic failure injection for the resume tests: die
                # with this shard's work on disk but the job unmerged
                os._exit(17)
        red.barrier()   # every shard's files are on disk before the merge
        if process_id == 0:
            merge_shard_outputs(o, red.n_shards, opts)
        return res
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _wait_all(procs) -> List[int]:
    """Waits for every process.  As soon as one exits non-zero the others
    are killed (they would wait in a collective until the group's timeout).
    Returns the indices of the processes that failed on their own."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
        if failed or all(c == 0 for c in codes):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            return failed
        time.sleep(0.1)


def run_phaser_multiproc(n_procs: int, *, vcf: str, bam: str, sample: str,
                         o: str, mapq: str, baseq: int, paired_end: str,
                         opts: PhaserOptions, device: str = "host",
                         resume: bool = False,
                         timeout_s: float = DEFAULT_TIMEOUT_S, log=print,
                         **kw) -> PhaserResult:
    """The CLI's --threads N --device host: spawn n_procs position-sharded
    engine processes (the fork-free equivalent of the reference's
    `--threads` pool, phaser.py:2077-2094) and merge on rank 0, outputs
    byte-identical to a single-process run (phaser_tpu
    dist/engine_multihost.py:663-738).  The full argument surface
    (blacklists, isize, every PhaserOptions field) travels to the workers
    as a JSON spec.  A worker that fails has its peers killed, and the run
    raises with its output."""
    import json
    import socket
    import subprocess
    import sys
    import tempfile

    # build any missing BAM index, and the kernels for --device cuda, ONCE
    # before spawning: the workers would otherwise race to the same builds
    from phaser_tpu.io.bam_index import ensure_bai
    for b in bam.split(","):
        if b:
            ensure_bai(b)
    _warm_up(device)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spec = dict(vcf=vcf, bam=bam, sample=sample, o=o, mapq=mapq,
                baseq=baseq, paired_end=paired_end, device=device,
                position_shards=True, resume=resume,
                coordinator="localhost:%d" % port,
                num_processes=n_procs, timeout_s=timeout_s,
                opts=dataclasses.asdict(opts), **kw)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs, logs = [], []
    try:
        for pid in range(n_procs):
            # worker output goes to files, not pipes: a full pipe would
            # stall a worker inside the run
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "phaser_tpu_torch.dist.engine_multihost",
                 "--spec-json", json.dumps(dict(spec, process_id=pid))],
                cwd=repo, stdout=logs[-1], stderr=subprocess.STDOUT,
                text=True))
        failed = _wait_all(procs)
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
    if failed:
        raise RuntimeError("engine shard(s) %s failed:\n%s" % (
            ", ".join(str(i) for i in failed),
            "\n".join("--- shard %d (exit %d):\n%s"
                      % (i, procs[i].returncode, outs[i][-3000:])
                      for i in failed)))
    total = PhaserResult()
    for out in outs:
        done = [l for l in out.splitlines()
                if l.startswith("MULTIHOST_ENGINE_DONE")]
        if done:
            f = dict(kv.split("=", 1) for kv in done[0].split()[1:])
            total.total_reads += int(f["reads"])
            total.noise_e = float(f["noise"])
            total.het_count += int(f["het"])
            total.phased_variants += int(f["phased"])
            total.shard_device.append((float(f["device_s"]),
                                       float(f["wall_s"])))
    # rank 0's stage log, minus its shard-local run summary (replaced by
    # the merged totals below)
    for line in outs[0].splitlines():
        if line.startswith(("MULTIHOST_ENGINE_DONE", "     COMPLETED using",
                            "     PHASED ")):
            continue
        log(line)
    log("     COMPLETED using %d reads across %d processes"
        % (total.total_reads, n_procs))
    if total.het_count:
        log("     PHASED  %d of %d all variants (= %f) with at least one "
            "other variant" % (total.phased_variants, total.het_count,
                               float(total.phased_variants) /
                               float(total.het_count)))
    return total


def _done_line(process_id: int, res: PhaserResult) -> str:
    return ("MULTIHOST_ENGINE_DONE shard=%d reads=%d noise=%.8f "
            "device_s=%.3f wall_s=%.3f het=%d phased=%d"
            % (process_id, res.total_reads, res.noise_e, res.device_s,
               res.wall_s, res.het_count, res.phased_variants))


def _mp_main(argv=None) -> int:
    import argparse
    import json
    import sys
    # JSON-spec worker mode (run_phaser_multiproc): the full engine
    # argument surface in one blob, bypassing the flag parser
    raw_argv = argv if argv is not None else sys.argv[1:]
    if len(raw_argv) >= 2 and raw_argv[0] == "--spec-json":
        spec = json.loads(raw_argv[1])
        opts = PhaserOptions(**spec.pop("opts"))
        res = run_phaser_multihost(opts=opts, **spec)
        print(_done_line(spec["process_id"], res))
        return 0
    ap = argparse.ArgumentParser(prog="phaser_tpu_torch.dist.engine_multihost")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--vcf", required=True)
    ap.add_argument("--sample", required=True)
    ap.add_argument("--o", required=True)
    ap.add_argument("--mapq", default="10")
    ap.add_argument("--baseq", type=int, default=10)
    ap.add_argument("--paired_end", default="1")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:9711",
                    help="host:port where rank 0 listens for the group")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds a collective may wait for a peer")
    ap.add_argument("--chr", default="")
    ap.add_argument("--device", default="host",
                    choices=("cuda", "cpu", "host"),
                    help="cuda drives this process's GPU (processes may "
                         "share one) through mapper.dispatch, exactly like "
                         "the single-process engine; cpu runs the kernels' "
                         "plain PyTorch versions; host runs host code only")
    ap.add_argument("--position-shards", action="store_true",
                    help="weight-balanced (contig, position-range) shards "
                         "from the BAM index instead of whole contigs")
    ap.add_argument("--resume", action="store_true",
                    help="replay this shard's .ckpt journal when its "
                         "previous run completed (skip recompute)")
    args = ap.parse_args(argv)
    res = run_phaser_multihost(
        vcf=args.vcf, bam=args.bam, sample=args.sample, o=args.o,
        mapq=args.mapq, baseq=args.baseq, paired_end=args.paired_end,
        num_processes=args.num_processes, process_id=args.process_id,
        coordinator=args.coordinator, timeout_s=args.timeout,
        chrom=args.chr, device=args.device,
        position_shards=args.position_shards, resume=args.resume)
    print(_done_line(args.process_id, res))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_mp_main())
