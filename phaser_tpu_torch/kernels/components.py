"""Connected components on the GPU (the port of
phaser_tpu/kernels/components.py, torch code on the tensors' device).

Min-label propagation over the edge list with pointer jumping: each round
every vertex takes the minimum label over its edges (scatter_reduce "amin"
over both ends), then two label[label[v]] hops compress paths, so the loop
ends after O(log n) rounds, each with one device-to-host check.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch


def label_components(edge_a: torch.Tensor, edge_b: torch.Tensor, n: int
                     ) -> torch.Tensor:
    """edge_a / edge_b: (E,) int64 vertex ids in [0, n), undirected.
    Returns (n,) int64 labels: the minimum vertex id of each vertex's
    component (phaser_tpu kernels/components.py:25-51)."""
    lab = torch.arange(n, dtype=torch.int64, device=edge_a.device)
    while True:
        m = torch.minimum(lab[edge_a], lab[edge_b])
        nxt = lab.clone()
        nxt.scatter_reduce_(0, edge_a, m, "amin")
        nxt.scatter_reduce_(0, edge_b, m, "amin")
        nxt = nxt[nxt]
        nxt = nxt[nxt]
        if torch.equal(nxt, lab):
            return lab
        lab = nxt


def connected_components(edge_a: np.ndarray, edge_b: np.ndarray,
                         device, clock=None) -> List[List[int]]:
    """Components of the (edge_a, edge_b) graph over the vertices that
    appear in an edge, labelled on `device`.  One member list per
    component, components in order of their smallest vertex, members
    ascending (phaser_tpu kernels/components.py:61-81).  `clock` (a
    utils.trace.DeviceClock) spans the uploads, the labelling and the
    fetch."""
    if len(edge_a) == 0:
        return []
    # compact vertex ids so the label array is sized to touched vertices
    verts = np.unique(np.concatenate([edge_a, edge_b]))
    ia = np.searchsorted(verts, edge_a)
    ib = np.searchsorted(verts, edge_b)
    with clock.span() if clock is not None else contextlib.nullcontext():
        labels = label_components(torch.from_numpy(ia).to(device),
                                  torch.from_numpy(ib).to(device),
                                  len(verts)).cpu().numpy()
    # a label is its component's smallest compact id, so a stable sort by
    # label lists components in first-appearance order
    order = np.argsort(labels, kind="stable")
    cuts = np.flatnonzero(np.diff(labels[order])) + 1
    return [g.tolist() for g in np.split(verts[order], cuts)]
