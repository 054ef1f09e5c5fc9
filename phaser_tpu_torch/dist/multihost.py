"""Multi-process execution scaffolding (the port of
phaser_tpu/dist/multihost.py).

The reference is strictly single-node (fork pool + temp files, SURVEY
§2.4).  The mapping here, over torch.distributed:

  1. `initialize()` -> a Gloo process group (env- or argument-driven);
  2. each process decodes its own BAM and owns one position shard of the
     reads (a read belongs to the shard that holds its leftmost position);
  3. `global_read_tensors()` puts a process's rows on its device; unlike
     phaser_tpu's global arrays they stay local to the rank;
  4. `dist.mesh.sharded_phasing_step` runs one shard a rank and merges the
     count tensors with all_reduce.

Every process may share one card: the group is Gloo (NCCL refuses two
ranks on one GPU) and the counts go through host memory for the merge.
phaser_tpu pads every process's rows to a common (rows, L) before it
assembles global arrays; torch needs no common shape, so each rank packs
its reads at its own width and a rank whose shard holds no read still joins
the all_reduce with zero counts.

    python -m phaser_tpu_torch.dist.multihost --bam B --vcf V --sample S \\
        --num-processes 2 --process-id K --coordinator localhost:PORT \\
        [--device cuda|cpu] [--o counts.json]

Rank 0 prints `MULTIHOST_RESULT {"n_vars": ..., "total_hits": ...,
"counts": [...]}` and writes the same JSON to --o.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np

GLOO_TIMEOUT_S = 300.0   # seconds a collective waits for a peer


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = GLOO_TIMEOUT_S) -> None:
    """A Gloo process group from the arguments, else from
    PHASER_TPU_NUM_PROCESSES, PHASER_TPU_COORDINATOR (host:port, rank 0
    listens there) and PHASER_TPU_PROCESS_ID; nothing with one process."""
    if num_processes is None:
        num_processes = int(os.environ.get("PHASER_TPU_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    import torch.distributed as dist
    coordinator = coordinator_address or os.environ.get(
        "PHASER_TPU_COORDINATOR", "localhost:9701")
    rank = process_id if process_id is not None else int(
        os.environ.get("PHASER_TPU_PROCESS_ID", "0"))
    dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                            rank=rank, world_size=num_processes,
                            timeout=timedelta(seconds=timeout_s))


def position_shards(contig_length: int, n_shards: int,
                    halo: int = 1000) -> Sequence[Tuple[int, int]]:
    """Half-open position ranges per shard, halo-extended on the right so
    fragments spanning a boundary are fully visible to the left owner
    (phaser_tpu dist/multihost.py:47-60).  multiprocess_allele_counts uses
    halo = 0: every read in exactly one shard."""
    step = -(-contig_length // n_shards)
    out = []
    for i in range(n_shards):
        lo = i * step
        hi = min((i + 1) * step + halo, contig_length)
        out.append((lo, hi))
    return out


def local_read_selection(bd, shard: Tuple[int, int]) -> np.ndarray:
    """Indices of reads owned by this process's position shard."""
    lo, hi = shard
    pos = bd.pos.astype(np.int64)
    return np.flatnonzero((pos >= lo) & (pos < hi))


def global_read_tensors(mesh, codes: np.ndarray, quals: np.ndarray,
                        refpos: np.ndarray):
    """This process's read planes as tensors on the mesh's device
    (phaser_tpu dist/multihost.py:70-88): on a group mesh each rank keeps
    its own rows, and the step's all_reduce is what joins them."""
    from .mesh import shard_reads
    return shard_reads(mesh, codes, quals, refpos)


def run_sharded_step(mesh, codes, quals, refpos, vpos, ind_codes, n_ind,
                     baseq: int):
    """The sharded pipeline step over this process's rows."""
    from .mesh import sharded_phasing_step
    g_codes, g_quals, g_refpos = global_read_tensors(mesh, codes, quals,
                                                     refpos)
    return sharded_phasing_step(mesh, g_codes, g_quals, g_refpos, vpos,
                                ind_codes, n_ind, baseq)


def table_arrays(vt):
    """(vpos int32, ind_codes, n_ind) of a variant table without both
    entries of a duplicated position (the engine's device-table rule:
    duplicates resolve on the host)."""
    pos = vt.pos.astype(np.int32)
    keep = np.ones(len(pos), bool)
    d = np.diff(pos) == 0
    keep[1:] &= ~d
    keep[:-1] &= ~d
    return pos[keep], vt.ind_codes[keep], vt.n_ind[keep]


def device_table(vcf: str, sample: str, contig: str):
    """table_arrays of the first contig's het sites."""
    from ..engine.varmap import build_variant_table
    from ..io import vcf as vcfio

    sample_column = vcfio.sample_column_map(vcf)[sample]
    filtered = [l for l in vcfio.het_filtered_lines(vcf, sample_column,
                                                    contig or None, None)
                if not l.startswith("#")]
    hs = vcfio.parse_het_sites(filtered, contig, ["_", ":"], True)
    c = next(iter(hs.pool))
    return table_arrays(build_variant_table(c, hs.pool[c]))


def multiprocess_allele_counts(bam: str, vcf: str, sample: str,
                               num_processes: int, process_id: int,
                               coordinator: str = "localhost:9701",
                               baseq: int = 10, mapq: int = 10,
                               device: str = "cuda",
                               contig: str = "",
                               timeout_s: float = GLOO_TIMEOUT_S
                               ) -> np.ndarray:
    """Every process owns one position shard of the reads, packs its own
    rows, and the (n_vars, 3) count tensor merges with an all_reduce over
    Gloo (phaser_tpu dist/multihost.py:102-184).  Returns the merged
    counts, equal on every process.  `mapq` is unused, as in phaser_tpu.
    Raises before joining the group when `device` is the card and there
    is none."""
    import torch.distributed as dist

    from ..io import bam as bamio
    from ..kernels.alleles import pack_reads
    from ..mapper.dispatch import require_device
    from .mesh import make_mesh, sharded_allele_counts

    require_device(device)
    grouped = num_processes > 1
    if grouped:
        initialize(coordinator, num_processes, process_id, timeout_s)
    try:
        vpos, ind, ni = device_table(vcf, sample, contig)
        bd = bamio.read_bam(bam)
        span = int(bd.pos.max()) + 1 if len(bd) else 1
        shard = position_shards(span, num_processes, halo=0)[process_id]
        hi = shard[1] if process_id < num_processes - 1 else span
        rows = local_read_selection(bd, (shard[0], hi))
        codes, quals, refpos = pack_reads(bd, rows=rows)
        mesh = make_mesh(device=device,
                         group=dist.group.WORLD if grouped else None)
        counts = sharded_allele_counts(mesh, codes, quals, refpos, vpos, ind,
                                       ni, baseq)
        return counts.cpu().numpy()
    finally:
        if grouped:
            dist.destroy_process_group()


def _mp_main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(prog="phaser_tpu_torch.dist.multihost")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--vcf", required=True)
    ap.add_argument("--sample", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:9701")
    ap.add_argument("--baseq", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--contig", default="")
    ap.add_argument("--timeout", type=float, default=GLOO_TIMEOUT_S,
                    help="seconds a collective waits for a peer")
    ap.add_argument("--o", default="")
    args = ap.parse_args(argv)
    counts = multiprocess_allele_counts(
        args.bam, args.vcf, args.sample, args.num_processes,
        args.process_id, coordinator=args.coordinator, baseq=args.baseq,
        device=args.device, contig=args.contig, timeout_s=args.timeout)
    if args.process_id == 0:
        payload = json.dumps({"n_vars": int(counts.shape[0]),
                              "total_hits": int(counts.sum()),
                              "counts": counts.tolist()})
        if args.o:
            with open(args.o, "w") as f:
                f.write(payload + "\n")
        print("MULTIHOST_RESULT " + payload)
    return 0


if __name__ == "__main__":
    import sys as _sys
    _sys.exit(_mp_main())
