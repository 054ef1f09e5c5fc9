"""Pair-configuration counting on the GPU (the port of
phaser_tpu/kernels/paircount.py, torch code on the tensors' device).

Turns deduplicated (read, variant, allele) hits into per-variant-pair 3x3
configuration counts, the device form of engine.connections's host
segment sum:
  1. pack_read_hits (numpy) groups hits by read into (R, K) matrices; reads
     with more than K hits are returned for the host combos;
  2. emit_pairs gathers the K(K-1)/2 intra-read hit pairs per read (-1 pads);
  3. count_pair_configs sorts the int64 keys (vi*M + vj)*9 + ai*3 + aj and
     counts runs with unique_consecutive.  Its results have exact sizes, so
     there is no max_pairs bound and no overflow branch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def emit_pairs(var_mat: torch.Tensor, allele_mat: torch.Tensor, K: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """var_mat / allele_mat: (R, K) int64 with -1 padding.  Returns flat
    (pair_lo, pair_hi, a_lo, a_hi) of length R*K*(K-1)/2, pair_lo = -1 on
    invalid pairs (phaser_tpu kernels/paircount.py:26-44)."""
    ii, jj = torch.triu_indices(K, K, 1, device=var_mat.device)
    v1 = var_mat[:, ii]
    v2 = var_mat[:, jj]
    a1 = allele_mat[:, ii]
    a2 = allele_mat[:, jj]
    valid = (v1 >= 0) & (v2 >= 0) & (v1 != v2)
    swap = v1 > v2
    lo = torch.where(swap, v2, v1)
    hi = torch.where(swap, v1, v2)
    al = torch.where(swap, a2, a1)
    ah = torch.where(swap, a1, a2)
    lo = torch.where(valid, lo, -1)
    return lo.reshape(-1), hi.reshape(-1), al.reshape(-1), ah.reshape(-1)


def count_pair_configs(pair_lo: torch.Tensor, pair_hi: torch.Tensor,
                       a_lo: torch.Tensor, a_hi: torch.Tensor, n_vars: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Aggregates emitted pairs into unique-pair 3x3 count rows
    (phaser_tpu kernels/paircount.py:47-93).  Returns (pair_keys (U,) int64
    = vi * n_vars + vj in ascending order, counts (U, 9) int64 indexed by
    ai * 3 + aj, U)."""
    valid = pair_lo >= 0
    key = ((pair_lo[valid] * n_vars + pair_hi[valid]) * 9
           + a_lo[valid] * 3 + a_hi[valid])
    run_key, run_count = torch.unique_consecutive(torch.sort(key).values,
                                                  return_counts=True)
    pair_keys, pair_id = torch.unique_consecutive(run_key // 9,
                                                  return_inverse=True)
    counts = torch.zeros((pair_keys.shape[0], 9), dtype=torch.int64,
                         device=key.device)
    counts[pair_id, run_key % 9] = run_count
    return pair_keys, counts, int(pair_keys.shape[0])


def pack_read_hits(uid: np.ndarray, var: np.ndarray, allele: np.ndarray,
                   K: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Groups hits by read into (R, K) matrices (-1 pad).  Returns
    (var_mat, allele_mat, overflow_uids): reads with more than K hits are
    returned for the host combos (phaser_tpu kernels/paircount.py:96-121)."""
    order = np.argsort(uid, kind="stable")
    u, v, a = uid[order], var[order], allele[order]
    if len(u) == 0:
        return (np.full((0, K), -1, np.int64), np.full((0, K), -1, np.int64),
                np.zeros(0, np.int64))
    starts = np.flatnonzero(np.concatenate(([True], u[1:] != u[:-1])))
    counts = np.diff(np.concatenate((starts, [len(u)])))
    ok = counts <= K
    R = int(ok.sum())
    # scatter all kept hits at once: row = rank of the hit's group among
    # kept groups, col = offset within the group
    grp = np.cumsum(np.concatenate(([0], (u[1:] != u[:-1]).astype(np.int64))))
    within = np.arange(len(u), dtype=np.int64) - starts[grp]
    kept_rank = np.cumsum(ok) - 1
    sel = ok[grp]
    var_mat = np.full((R, K), -1, np.int64)
    allele_mat = np.full((R, K), -1, np.int64)
    var_mat[kept_rank[grp[sel]], within[sel]] = v[sel]
    allele_mat[kept_rank[grp[sel]], within[sel]] = a[sel]
    overflow = u[starts[~ok]]
    return var_mat, allele_mat, np.asarray(overflow, np.int64)
