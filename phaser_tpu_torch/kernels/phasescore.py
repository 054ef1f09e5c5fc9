"""2^(n-1) haplotype-configuration scoring on the GPU (the port of
phaser_tpu/kernels/phasescore.py, torch code on the tensors' device).

score(config) = v^T M v over the 2n x 2n allele adjacency: every
complement class of a sub-block is scored by one (S x 2n) @ (2n x 2n)
product and a row-wise dot.  The product runs in float64, so the integer
scores stay exact (below 2^53) with no process-global setting: float64
has no TF32 mode, whereas a float32 product would need
`torch.backends.cuda.matmul.allow_tf32` switched off, a flag that the
shard threads of one process share and could flip under each other.
S x 2n float64 is 6.7 GB at n = 25 (two such buffers live at once): a
block that does not fit the card raises.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _one_hot_configs(n: int, device) -> torch.Tensor:
    """(S, 2n) float64 one-hot of all configs with a leading 0: column
    2i + allele; variant i+1's allele is bit (n-2-i) of the config index,
    MSB first (phaser_tpu kernels/phasescore.py:27-38)."""
    S = 1 << max(n - 1, 0)
    cfg = torch.arange(S, dtype=torch.int64, device=device)
    bits = torch.zeros((S, n), dtype=torch.int64, device=device)
    if n > 1:
        shifts = torch.arange(n - 2, -1, -1, dtype=torch.int64, device=device)
        bits[:, 1:] = (cfg[:, None] >> shifts[None, :]) & 1
    idx = 2 * torch.arange(n, device=device)[None, :] + bits
    V = torch.zeros((S, 2 * n), dtype=torch.float64, device=device)
    V.scatter_(1, idx, 1.0)
    return V


def enumerate_scores(M: torch.Tensor, n: int) -> torch.Tensor:
    """Scores of all 2^(n-1) leading-zero configs of one sub-block
    (phaser_tpu kernels/phasescore.py:20-40).  M: (2n, 2n) allele
    adjacency.  Returns (2^(n-1),) float64 on M's device."""
    V = _one_hot_configs(n, M.device)
    E = V @ M.to(torch.float64)
    return E.mul_(V).sum(dim=1)


def enumerate_scores_batched(Ms: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 2n, 2n) -> (B, 2^(n-1)) float64 for same-size sub-blocks
    (phaser_tpu kernels/phasescore.py:43-46)."""
    V = _one_hot_configs(n, Ms.device)
    E = torch.matmul(V[None], Ms.to(torch.float64))
    return E.mul_(V[None]).sum(dim=2)


def score_blocks_host(adjacencies: Sequence[np.ndarray], device
                      ) -> List[np.ndarray]:
    """Scores a batch of sub-blocks of any sizes on `device`, bucketed by
    size.  Returns int64 scores per block in input order (phaser_tpu
    kernels/phasescore.py:49-62)."""
    by_n = {}
    for i, M in enumerate(adjacencies):
        by_n.setdefault(M.shape[0] // 2, []).append(i)
    out: List[np.ndarray] = [None] * len(adjacencies)
    for n, idxs in by_n.items():
        Ms = torch.from_numpy(np.stack([adjacencies[i] for i in idxs]).astype(
            np.float64)).to(device)
        scores = enumerate_scores_batched(Ms, n).cpu().numpy()
        for k, i in enumerate(idxs):
            out[i] = scores[k].astype(np.int64)
    return out
