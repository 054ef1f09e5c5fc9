"""Haplotype-block discovery (the port of phaser_tpu/engine/blocks.py).

`find_blocks` and `_device_blocks` are copies whose device path is this
package's torch label propagation (kernels.components) on a CUDA or CPU
device: at or above the edge gate the components come from the device, or
the call raises.  `_host_blocks` is an unchanged copy.
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from ..utils.counters import bump
from .connections import ContigConnections

# device label propagation pays off only on big graphs
# (phaser_tpu engine/blocks.py:20)
_DEVICE_EDGE_GATE = 100_000
# device calls
COUNTS = {"device_calls": 0}
# --device auto labels components on the host.  chip_smoke.py phase 5
# (NVIDIA H100 80GB HBM3, 700.00 W; stage walls, card against host, means
# of three runs): 102,644 edges 0.2849 / 0.3229, 0.3881 / 0.3995, 0.2771 /
# 0.3016 s with single calls 0.17-0.52 s either way, 969,224 edges 3.5865 /
# 3.5493, 3.3139 / 3.3978, 3.7339 / 3.8838 s: inside the calls' spread,
# and the card's own seconds are 0.001-0.004 s of them (the adjacency's
# flattening on the host is both routes' work)
AUTO_ON_CARD = False


def find_blocks(conn: ContigConnections, vt,
                device: str = "cuda") -> List[List[int]]:
    """Blocks as lists of table indices (phaser_tpu engine/blocks.py:23-51).

    Order: by first overlap-key rank among members (reference seed order).
    Within a block: (int(pos), table index)."""
    from ..mapper.dispatch import require_device
    require_device(device)
    adj = conn.adj
    if not adj:
        return []

    n_edges = sum(len(nbrs) for nbrs in adj.values())  # 2x undirected count
    from ..mapper.dispatch import stage_device
    device = stage_device(device, AUTO_ON_CARD)
    if device not in ("host", "off") and n_edges >= _DEVICE_EDGE_GATE:
        blocks = _device_blocks(adj, device)
    else:
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


def _device_blocks(adj: Dict[int, Set[int]], device) -> List[List[int]]:
    """Flattens the adjacency to an edge list and labels its components on
    `device` (phaser_tpu engine/blocks.py:74-97)."""
    from ..kernels.components import connected_components
    from ..mapper.dispatch import resolve_device

    dev = resolve_device(device)
    bump(COUNTS, "device_calls")
    ea = []
    eb = []
    for a, nbrs in adj.items():
        for b in nbrs:
            if a < b:  # one direction suffices for an undirected CC
                ea.append(a)
                eb.append(b)
    if not ea:
        # isolated self-connected keys only; treat each as its own block
        return [[v] for v in adj]
    from ..utils.trace import DeviceClock
    clock = DeviceClock(dev)
    comps = connected_components(np.asarray(ea, np.int64),
                                 np.asarray(eb, np.int64), dev, clock)
    clock.collect()
    # vertices present in adj but in no a<b edge (possible only if adj held
    # a vertex with an empty neighbor set) become singletons
    seen = {v for mem in comps for v in mem}
    comps.extend([v] for v in adj if v not in seen)
    return comps
