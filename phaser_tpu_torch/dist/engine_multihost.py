"""Sharded runs of the port's engine: the phaser_tpu_torch counterpart of
phaser_tpu/dist/engine_multihost.py.

A shard is a range of the VCF's contigs, or a weight-balanced (contig,
position-range) plan; each shard runs the COMPLETE engine
(`engine.pipeline.run_phaser`) with a `dist_reduce` reducer for its global
merge points (AS quantile, row exchange, row offsets, noise, block base),
and the per-shard outputs merge into files byte-identical to the
single-process run.

The reducer logic (`_ReducerBase`, `_ThreadGroup`, `ThreadReducer`,
`RecordingReducer`), the shard split, `replay_journal`, `_merge_results`
and the output merge are unchanged copies of phaser_tpu's; its jax
collectives are replaced by the ported runners:

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
import heapq
import os
import pickle
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine.output_stage import PhaserOptions
from ..engine.pipeline import NoReadsMatched, PhaserResult, run_phaser
from ..engine.slow_mode import _stream_vcf_body, list_contigs

# seconds a process waits in one collective (and to join the group) before
# the run fails: a peer that hangs fails the run instead of holding it
DEFAULT_TIMEOUT_S = 3600.0


# chrom sentinel for a shard with no contigs (more processes than contigs):
# matches no contig but keeps the shard participating in every collective
EMPTY_SHARD = "\x00none"


ALLELIC_COUNTS_HEADER = ("contig\tposition\tvariantID\trefAllele\taltAllele"
                         "\trefCount\taltCount\ttotalCount\n")


def split_contigs(contigs: Sequence[str], n_shards: int) -> List[List[str]]:
    """Contiguous contig ranges (global order preserved), sizes balanced."""
    base, rem = divmod(len(contigs), n_shards)
    out, i = [], 0
    for s in range(n_shards):
        k = base + (1 if s < rem else 0)
        out.append(list(contigs[i:i + k]))
        i += k
    return out


class _ReducerBase:
    """The four engine merge points in terms of one allgather primitive.

    Subclasses provide `_allgather(payload) -> List[payload]` (per-shard
    payloads in shard order), `shard_id`, `n_shards`, and `rank_of`
    (contig name -> global contig rank).
    """

    shard_id: int
    n_shards: int
    rank_of: Dict[str, int]

    def _allgather(self, payload):
        raise NotImplementedError

    def noise(self, bm: int, bmm: int) -> Tuple[int, int]:
        parts = self._allgather(("noise", int(bm), int(bmm)))
        return (sum(p[1] for p in parts), sum(p[2] for p in parts))

    # distributed exact quantile: O(bins + boundary bucket) traffic instead
    # of allgathering every shard's full per-read score vector (at WGS
    # scale that is GBs per BAM through the collective)
    _AS_SMALL = 8192      # below this total count, one full gather is fine
    _AS_BINS = 4096

    def as_percentile(self, scores, q: float) -> Optional[float]:
        """Exact distributed percentile, BIT-IDENTICAL to
        np.percentile(concat(all shards' scores), q) (linear method):

          1. allgather (count, min, max);
          2. allgather fixed-edge histograms; locate the bucket(s) holding
             the two order statistics numpy's linear interpolation reads;
          3. allgather only those buckets' values and reproduce numpy's
             lerp arithmetic (including its t >= 0.5 reformulation) on the
             exact order statistics.

        The reference concatenates all mapper outputs in the parent and
        takes numpy.percentile (reference phaser/phaser.py:540-553);
        every shard returns the same float here."""
        v = np.asarray(scores, np.float64)
        stats = self._allgather((
            "as_stats", int(v.size),
            float(v.min()) if v.size else np.inf,
            float(v.max()) if v.size else -np.inf))
        n = sum(p[1] for p in stats)
        if n == 0:
            return None
        gmin = min(p[2] for p in stats)
        gmax = max(p[3] for p in stats)
        if n <= self._AS_SMALL:
            parts = self._allgather(("as_all", v))
            allv = np.concatenate([p[1] for p in parts])
            return float(np.percentile(allv, q))
        # numpy's virtual index for the default 'linear' method, replicated
        # expression-for-expression ((n - 1) * q — NOT the algebraically
        # equal _compute_virtual_index form, which rounds differently)
        qf = np.true_divide(q, 100)
        pos = (n - 1) * qf
        if pos >= n - 1:
            k0 = k1 = n - 1
            gamma = 0.0
        elif pos < 0:
            k0 = k1 = 0
            gamma = 0.0
        else:
            k0 = int(np.floor(pos))
            k1 = k0 + 1
            gamma = pos - np.floor(pos)
        if gmin == gmax:
            # degenerate span: every value is identical — all shards agree
            # on (n, gmin, gmax), so every shard takes this branch together
            return float(gmin)
        B = self._AS_BINS
        edges = np.linspace(gmin, gmax, B + 1)
        if v.size:
            idx = np.clip(np.searchsorted(edges, v, side="right") - 1,
                          0, B - 1)
            hist = np.bincount(idx, minlength=B)
        else:
            idx = np.zeros(0, np.int64)
            hist = np.zeros(B, np.int64)
        parts = self._allgather(("as_hist", hist.astype(np.int64)))
        total = np.sum([p[1] for p in parts], axis=0)
        cum = np.cumsum(total)
        b0 = int(np.searchsorted(cum, k0, side="right"))
        b1 = int(np.searchsorted(cum, k1, side="right"))
        below = int(cum[b0 - 1]) if b0 > 0 else 0
        mine = v[(idx >= b0) & (idx <= b1)] if v.size else v
        parts = self._allgather(("as_vals", mine))
        pool = np.sort(np.concatenate([p[1] for p in parts]))
        a = pool[k0 - below]
        b = pool[k1 - below]
        # numpy _lerp: a + (b-a)*t, recomputed as b - (b-a)*(1-t) when
        # t >= 0.5 — replicated so the result is bit-identical
        diff = b - a
        if gamma >= 0.5:
            r = b - diff * (1.0 - gamma)
        else:
            r = a + diff * gamma
        return float(r)

    def row_offsets(self, entries) -> List[int]:
        """entries: [(bam_i, contig, entry_i, n_rows)] in this shard's scan
        order. Returns the global row-sequence start offset per entry —
        identical to the offsets the single-process bam-major scan
        (engine.pipeline) would have assigned."""
        local = [(b, self.rank_of[c], e, int(n)) for b, c, e, n in entries]
        parts = self._allgather(("rows", local))
        tagged = []
        for sid, p in enumerate(parts):
            for k, (b, r, e, n) in enumerate(p[1]):
                tagged.append(((b, r, e), sid, k, n))
        tagged.sort(key=lambda t: t[0])
        seq = 0
        mine: Dict[int, int] = {}
        for _, sid, k, n in tagged:
            if sid == self.shard_id:
                mine[k] = seq
            seq += n
        return [mine[k] for k in range(len(entries))]

    def exchange_rows(self, outgoing, owned) -> list:
        """Position-sharded runs: move mapper-row bundles of
        decoded-but-not-owned contigs to their owner shard.

        outgoing: [(contig, bam_i, range_rank, bundle)] produced by this
        shard for contigs it does not own; returns the same-shaped list of
        every shard's entries whose contig is in `owned` (shard-order
        iteration keeps duplicates impossible: each (contig, bam, rank)
        is produced by exactly one decoder).  Implemented over the one
        allgather primitive; at 2-8 shards the all-to-all overhead over a
        true point-to-point is a small constant factor on row bundles
        (hits are ~1-2% of read bytes)."""
        parts = self._allgather(("rows_x", outgoing))
        mine = []
        for p in parts:
            for t in p[1]:
                if t[0] in owned:
                    mine.append(t)
        return mine

    def block_base(self, n_blocks: int) -> int:
        parts = self._allgather(("blocks", int(n_blocks)))
        return sum(p[1] for p in parts[: self.shard_id])

    def exchange_blocks(self, outgoing) -> list:
        """outgoing: [(block_index, delegate_sid, bundle)] produced by
        this shard (the owner of those blocks). Returns [(block_index,
        bundle)] assigned to THIS shard, sorted by block index — the
        ownership-balanced #6 path (dist.block_exchange)."""
        parts = self._allgather(("blocks_x6", outgoing))
        mine = [(bi, bundle) for p in parts for (bi, d, bundle) in p[1]
                if d == self.shard_id]
        mine.sort(key=lambda t: t[0])
        return mine

    def exchange_state(self, piece: dict) -> list:
        """Allgather the per-shard OutputState pieces so every shard can
        format VCF body rows for its decode ranges (ownership-balanced #7;
        pickle preserves the shared variants-list identities the writer's
        per-block cache keys on)."""
        parts = self._allgather(("state", piece))
        return [p[1] for p in parts]

    def barrier(self) -> None:
        self._allgather(("barrier",))


class _ThreadGroup:
    """Shared state for in-process shard threads: one reusable allgather
    slot guarded by a double barrier (write-all, read-all)."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.data: List = [None] * n

    def allgather(self, shard_id: int, payload):
        self.data[shard_id] = payload
        self.barrier.wait()
        out = list(self.data)
        self.barrier.wait()   # everyone has read before the slot is reused
        return out

    def abort(self) -> None:
        self.barrier.abort()


class ThreadReducer(_ReducerBase):
    def __init__(self, group: _ThreadGroup, shard_id: int,
                 rank_of: Dict[str, int]):
        self.group = group
        self.shard_id = shard_id
        self.n_shards = group.n
        self.rank_of = rank_of

    def _allgather(self, payload):
        return self.group.allgather(self.shard_id, payload)


class RecordingReducer(_ReducerBase):
    """Wrap a reducer and journal every collective payload this shard
    sends.  A shard whose engine run completes dumps the journal next to
    its outputs (`<o>.shardK.ckpt`); a later resume REPLAYS the journal —
    re-emitting bit-identical collective contributions so re-running
    peers see exactly the values of the original run — instead of
    recomputing the shard (shard-failure recovery)."""

    def __init__(self, base: _ReducerBase):
        self.base = base
        self.shard_id = base.shard_id
        self.n_shards = base.n_shards
        self.rank_of = base.rank_of
        self.payloads: List = []

    def _allgather(self, payload):
        self.payloads.append(payload)
        return self.base._allgather(payload)

    def dump(self, path: str, res: PhaserResult) -> None:
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "wb") as fh:
            pickle.dump({"payloads": self.payloads,
                         "result": dataclasses.asdict(res)}, fh)
        os.replace(tmp, path)


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


def _shard_outputs_complete(prefix: str, opts: PhaserOptions,
                            delegated: bool = False) -> bool:
    need = ["haplotypes.txt", "haplotypic_counts.txt",
            "variant_connections.txt", "allele_config.txt",
            "singletons.haplotypes.part",
            "singletons.haplotypic_counts.part", "allelic_counts.part"]
    if delegated:
        # position-sharded multi-shard runs emit block rows as keyed parts
        need += ["blocks.haplotypes.part", "blocks.haplotypic_counts.part",
                 "blocks.allele_config.part"]
    ok = all(os.path.isfile(prefix + "." + s) for s in need)
    if ok and opts.write_vcf == 1:
        # position-sharded runs write body-only pieces; contig-sharded
        # runs write whole per-shard VCFs
        ok = os.path.isfile(prefix + ".vcfbody.gz") or \
            os.path.isfile(prefix + ".vcf.gz")
    return ok


def _keyed_iter(path: str):
    with open(path) as f:
        for ln in f:
            k, rest = ln.split("\t", 1)
            yield int(k), rest


def _merge_keyed(paths: List[str], out) -> None:
    """k-way merge of per-shard key-sorted '.part' files; stable for equal
    keys (multi-bam rows of one singleton share a first_seen key)."""
    streams = [_keyed_iter(p) for p in paths if os.path.isfile(p)]
    for _, line in heapq.merge(*streams, key=lambda t: t[0]):
        out.write(line)


def _concat_with_header(paths: List[str], out_path: str) -> None:
    import shutil
    with open(out_path, "w") as out:
        wrote_header = False
        for p in paths:
            if not os.path.isfile(p):
                continue
            with open(p) as fh:
                first = fh.readline()
                if first and not wrote_header:
                    out.write(first)
                    wrote_header = True
                shutil.copyfileobj(fh, out)


def merge_shard_outputs(o: str, n_shards: int, opts: PhaserOptions,
                        cleanup: bool = True) -> None:
    """Assemble per-shard outputs into the final files, matching the
    single-process run byte-for-byte (section order per
    engine.output_stage: block rows in global contig order, then singleton
    rows in global first_seen order)."""
    from ..io import bgzf, tabix

    pre = [o + ".shard%d" % s for s in range(n_shards)]

    # block sections: either whole per-shard sections concatenate
    # (contig-sharded runs) or delegated keyed `.blocks.*.part` rows merge
    # back into global block order (position-sharded ownership-balanced
    # #6); singleton sections always merge by first_seen key
    for sfx, blk_sfx, part_sfx in (
            ("haplotypes.txt", "blocks.haplotypes.part",
             "singletons.haplotypes.part"),
            ("haplotypic_counts.txt", "blocks.haplotypic_counts.part",
             "singletons.haplotypic_counts.part")):
        _concat_with_header([p + "." + sfx for p in pre], o + "." + sfx)
        with open(o + "." + sfx, "a") as out:
            _merge_keyed([p + "." + blk_sfx for p in pre], out)
            _merge_keyed([p + "." + part_sfx for p in pre], out)

    _concat_with_header([p + ".variant_connections.txt" for p in pre],
                        o + ".variant_connections.txt")
    _concat_with_header([p + ".allele_config.txt" for p in pre],
                        o + ".allele_config.txt")
    with open(o + ".allele_config.txt", "a") as out:
        _merge_keyed([p + ".blocks.allele_config.part" for p in pre], out)

    with open(o + ".allelic_counts.txt", "w") as out:
        out.write(ALLELIC_COUNTS_HEADER)
        _merge_keyed([p + ".allelic_counts.part" for p in pre], out)

    # --output_network targets one variant: at most one shard produced them
    for sfx in ("network.links.txt", "network.nodes.txt"):
        for p in pre:
            if os.path.isfile(p + "." + sfx):
                os.replace(p + "." + sfx, o + "." + sfx)
                break

    if opts.write_vcf == 1:
        gz = o + ".vcf.gz"
        hdr = pre[0] + ".vcfhdr.gz"
        if os.path.isfile(hdr):
            # ownership-balanced parts: header (shard 0) + body pieces in
            # shard order (shards hold contiguous global position spans,
            # so plain concatenation reproduces the single-process bytes)
            with bgzf.BgzfWriter(gz) as w:
                _stream_vcf_body(hdr, w, include_header=True)
                for p in pre:
                    path = p + ".vcfbody.gz"
                    if os.path.isfile(path):
                        _stream_vcf_body(path, w, include_header=False)
        else:
            with bgzf.BgzfWriter(gz) as w:
                emitted = False
                for p in pre:
                    path = p + ".vcf.gz"
                    if not os.path.isfile(path):
                        continue
                    _stream_vcf_body(path, w, include_header=not emitted)
                    emitted = True
        tabix.build_vcf_index(gz)

    if cleanup:
        for p in pre:
            for sfx in ("haplotypes.txt", "haplotypic_counts.txt",
                        "variant_connections.txt", "allele_config.txt",
                        "singletons.haplotypes.part",
                        "singletons.haplotypic_counts.part",
                        "allelic_counts.part", "vcf.gz", "vcf.gz.tbi",
                        "vcf.gz.csi", "vcfbody.gz", "vcfhdr.gz", "ckpt",
                        "blocks.haplotypes.part",
                        "blocks.haplotypic_counts.part",
                        "blocks.allele_config.part"):
                path = p + "." + sfx
                if os.path.isfile(path):
                    os.remove(path)


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


def _shard_chrom(assign: List[List[str]], sid: int) -> str:
    my = assign[sid] if sid < len(assign) else []
    return ",".join(my) if my else EMPTY_SHARD


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

        from ..utils import build
        torch.cuda.init()
        build.get_lib()


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
                               device: str = "cuda",
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
        from .shard_plan import plan_shards
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
                         device: str = "cuda",
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

    # fail before joining the group when the card is asked for and absent
    from ..mapper.dispatch import require_device
    require_device(device)
    if num_processes > 1:
        dist.init_process_group(
            "gloo", init_method="tcp://" + coordinator, rank=process_id,
            world_size=num_processes, timeout=timedelta(seconds=timeout_s))
    try:
        opts = opts or PhaserOptions()
        contigs = chrom.split(",") if chrom else list_contigs(vcf)
        plans = None
        if position_shards:
            from .shard_plan import plan_shards
            plans = plan_shards(bam, contigs, num_processes)
        assign = split_contigs(contigs, min(num_processes, len(contigs)))
        rank_of = {c: i for i, c in enumerate(contigs)}
        red = MultihostReducer(rank_of)
        # lines the shards up at the same start line before the engine
        red.barrier()
        prefix = o + ".shard%d" % process_id
        jpath = prefix + ".ckpt"
        from .block_exchange import balance_blocks_enabled
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
                         opts: PhaserOptions, device: str = "cuda",
                         resume: bool = False,
                         timeout_s: float = DEFAULT_TIMEOUT_S, log=print,
                         **kw) -> PhaserResult:
    """The CLI's --threads N --device host (the library default is the
    card, like every entry point): spawn n_procs position-sharded
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
    from ..io.bam_index import ensure_bai
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
    ap.add_argument("--device", default="cuda",
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
