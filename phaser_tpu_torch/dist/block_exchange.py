"""Delegate per-block OUTPUT FORMATTING across shards.

Graph stages (connections/blocks/phasing) must run on the contig OWNER —
they need whole-contig state — but formatting a phased block's output rows
(`engine.output_stage.process_block`) only needs that block's slice of the
variant table, its allele-connection sets, and its read lists.  A
60%-weight contig's owner would otherwise format 60% of every block
section (round-4 verdict #3; the phased-VCF body is already balanced by
decode ranges).

Owners bundle each block's slice (`bundle_block`), blocks spread
round-robin by GLOBAL block index through one allgather, and every shard
formats its share against light shim objects (`BlockVt`/`BlockVr`/
`BlockConn`) that answer exactly the lookups `process_block` performs —
so the byte-exact writer logic runs unchanged.  Rows are emitted into
keyed part files (key = global block index) and the merge interleaves
them back into the single-process order.

Reference behavior preserved: output row order of
reference phaser/phaser.py:832-1243 (blocks in processing order,
then singleton sections).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def balance_blocks_enabled() -> bool:
    """Opt-in (PHASER_TPU_BALANCE_BLOCKS=1): delegating block formatting
    moves ~the block sections' string work off the owners, but the bundle
    exchange BROADCASTS every block's read lists through the one-allgather
    primitive — measured net-negative at 2 shards on loopback (the
    formatting it moves is cheaper than the pickle+transfer). Enable on
    high shard counts or string-heavy configurations (wide blocks,
    --output_read_ids); outputs are byte-identical either way."""
    import os
    return os.environ.get("PHASER_TPU_BALANCE_BLOCKS") == "1"


def delegate_of(block_index: int, n_shards: int) -> int:
    """Deterministic balanced assignment: global index round-robin."""
    return block_index % n_shards


class BlockVt:
    """vt shim for one block: local indices 0..k-1."""

    __slots__ = ("chrom", "pos", "unique_ids", "rsids_out", "ind_alleles",
                 "phases", "mafs", "all_alleles")

    def __init__(self, chrom, pos, unique_ids, rsids_out, ind_alleles,
                 phases, mafs, all_alleles):
        self.chrom = chrom
        self.pos = pos
        self.unique_ids = unique_ids
        self.rsids_out = rsids_out
        self.ind_alleles = ind_alleles
        self.phases = phases
        self.mafs = mafs
        self.all_alleles = all_alleles


class _UidNames:
    """uid -> name accessor (only uids appearing in this block ship)."""

    __slots__ = ("m",)

    def __init__(self, m: Dict[int, bytes]):
        self.m = m

    def __getitem__(self, u: int) -> bytes:
        return self.m[int(u)]


class _RowsShim:
    __slots__ = ("uid_names",)

    def __init__(self, uid_names: "_UidNames"):
        self.uid_names = uid_names


class BlockVr:
    """vr shim: read_set / haplo_list over the block's shipped lists."""

    __slots__ = ("vt", "rows", "_read_sets", "_haplo")

    def __init__(self, vt: BlockVt, read_sets, haplo, uid_names):
        self.vt = vt
        self.rows = _RowsShim(_UidNames(uid_names))
        self._read_sets = read_sets     # (local_v, allele) -> np.ndarray
        self._haplo = haplo             # (local_v, allele, bam) -> arr|None

    def read_set(self, v: int, a: int) -> np.ndarray:
        return self._read_sets[(int(v), int(a))]

    def haplo_list(self, v: int, a: int, bam_i: int):
        return self._haplo.get((int(v), int(a), int(bam_i)))


class BlockConn:
    __slots__ = ("allele_conn",)

    def __init__(self, allele_conn):
        self.allele_conn = allele_conn


def bundle_block(vr, conn, phased, n_bams: int,
                 need_names: bool) -> dict:
    """Owner side: extract everything process_block reads for ONE block,
    remapped to local variant indices."""
    vt = vr.vt
    v_idx = [v for v, _ in phased]
    local = {v: i for i, v in enumerate(v_idx)}
    k = len(v_idx)
    ac_out = {}
    for i, v in enumerate(v_idx):
        for a in (0, 1):
            conns = conn.allele_conn.get((v, a))
            if not conns:
                continue
            # only pairs inside the block affect supporting/total (the
            # writer intersects with block-member sets)
            s = {(local[w], b) for (w, b) in conns if w in local}
            if s:
                ac_out[(i, a)] = s
    read_sets = {}
    haplo = {}
    names: Dict[int, bytes] = {}
    for i, v in enumerate(v_idx):
        for a in (0, 1):
            rs = vr.read_set(v, a)
            read_sets[(i, a)] = rs
            if need_names:
                for u in rs.tolist():
                    if u not in names:
                        names[u] = bytes(vr.rows.uid_names[int(u)])
            for b in range(n_bams):
                hl = vr.haplo_list(v, a, b)
                if hl is not None:
                    haplo[(i, a, b)] = hl
    return {
        "chrom": vt.chrom,
        "pos": np.asarray([int(vt.pos[v]) for v in v_idx], np.int64),
        "unique_ids": [vt.unique_ids[v] for v in v_idx],
        "rsids_out": [vt.rsids_out[v] for v in v_idx],
        "ind_alleles": [vt.ind_alleles[v] for v in v_idx],
        "phases": [vt.phases[v] for v in v_idx],
        "mafs": [vt.mafs[v] for v in v_idx],
        "all_alleles": [vt.all_alleles[v] for v in v_idx],
        "ac": ac_out,
        "read_sets": read_sets,
        "haplo": haplo,
        "names": names,
        "phased": [(local[v], a) for v, a in phased],
        "k": k,
    }


def unbundle_block(b: dict) -> Tuple[BlockVr, BlockConn, list]:
    vt = BlockVt(b["chrom"], b["pos"], b["unique_ids"], b["rsids_out"],
                 b["ind_alleles"], b["phases"], b["mafs"],
                 b["all_alleles"])
    vr = BlockVr(vt, b["read_sets"], b["haplo"], b["names"])
    return vr, BlockConn(b["ac"]), b["phased"]
