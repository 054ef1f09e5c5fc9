"""Haplotype-block discovery: a frozen copy of the host route of
phaser_tpu_torch/engine/blocks.py (`find_blocks`, `_host_blocks`), with
the device path left out.
"""

from __future__ import annotations

from typing import Dict, List, Set

from .connections import ContigConnections


def find_blocks(conn: ContigConnections, vt) -> List[List[int]]:
    """Blocks as lists of table indices (phaser_tpu engine/blocks.py:23-51).

    Order: by first overlap-key rank among members (reference seed order).
    Within a block: (int(pos), table index)."""
    adj = conn.adj
    if not adj:
        return []

    blocks = _host_blocks(adj)

    rank = conn.var_rank
    blocks.sort(key=lambda mem: min(int(rank[v]) for v in mem))
    out = []
    for mem in blocks:
        mem = sorted(mem, key=lambda v: (int(vt.pos[v]), v))
        out.append(mem)
    return out


def _host_blocks(adj: Dict[int, Set[int]]) -> List[List[int]]:
    parent: Dict[int, int] = {v: v for v in adj}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, nbrs in adj.items():
        for b in nbrs:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

    comps: Dict[int, List[int]] = {}
    for v in adj:
        comps.setdefault(find(v), []).append(v)
    return list(comps.values())



