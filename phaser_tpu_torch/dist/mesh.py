"""Genomic sharding of the read rows (the port of phaser_tpu/dist/mesh.py).

The reference's parallelism is a fork pool over contigs with parent-side
merges (phaser.py:2077-2094, 558-586).  Here the data-parallel axis is
genomic: read rows are split into shards, each shard computes its count
tensors, and the counts are summed.  phaser_tpu runs the shards as one
`shard_map` program over a device mesh with `psum` merges; torch has no such
program, so a `Mesh` names how the shards run:

- `group=None`: `n_shards` shards of the rows run in turn in this process,
  on one device, and are summed (the counterpart of phaser_tpu's 8-device
  virtual CPU mesh in its tests);
- a `torch.distributed` group: every rank holds its own rows and runs one
  shard of them; the merge is `all_reduce(SUM)`.  Ranks that share one card
  cannot use NCCL (it refuses two ranks on one GPU), so the group is Gloo
  and the int32 counts go through host memory for the collective.  Integer
  sums are exact, so the merge is exact either way.

A shard's counts come from two kernels: `assign_alleles_device` (the
planes kernel in its whole-table mode, kernels/alleles.py) and
`band_counts` (csrc/mesh.cu `band_counts_kernel`), which replaces the jnp
scatter-adds of the JAX shard body and never forms its (N, L, L) pair grid.
After the merge the connection tests stay on the card
(kernels/stats.py: `noise_from_counts`, then the fused `conflict_prune`
kernel), and the phase configurations of the first `score_block` variants
are scored by kernels/phasescore.py.  `connection_p_values` gives the
tests' p-values themselves (the `binom_cdf` kernel).  On CPU tensors every
kernel runs its plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import build
from ..utils.counters import bump

# kernel launches of band_counts (CUDA launches only)
LAUNCHES = {"band_counts": 0}
PLAIN_CHUNK_ELEMENTS = 1 << 26   # (rows, L, L) elements a plain chunk forms


def reset_launches() -> None:
    LAUNCHES["band_counts"] = 0


@dataclass(frozen=True)
class Mesh:
    """How the shards of a step run: `n_shards` local shards in turn
    (group None) or one shard on each rank of a torch.distributed group."""
    n_shards: int
    device: torch.device
    group: Optional[object] = None


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              group=None) -> Mesh:
    """A mesh on `device` (phaser_tpu dist/mesh.py:22-26): `n_devices`
    local shards (default 1), or with a torch.distributed `group` one
    shard a rank (n_devices, if given, must be the group's size).  Raises
    when `device` is the card and there is none."""
    from ..mapper.dispatch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is not None:
        import torch.distributed as dist
        size = dist.get_world_size(group)
        if n_devices is not None and n_devices != size:
            raise ValueError("a group of %d ranks runs %d shards, not %d"
                             % (size, size, n_devices))
        return Mesh(size, dev, group)
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError("a mesh needs at least one shard, not %d" % n)
    return Mesh(n, dev, None)


_NP = {torch.uint8: np.uint8, torch.int8: np.int8, torch.int32: np.int32}


def _tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=_NP[dtype])).to(dev)


def shard_reads(mesh: Mesh, *arrays) -> Tuple[torch.Tensor, ...]:
    """(N, ...) read-major arrays as tensors on the mesh's device
    (phaser_tpu dist/mesh.py:29-33).  On a local mesh N must be divisible
    by the shard count (callers pad, `pad_to_multiple`); on a group mesh
    the arrays are this rank's own rows."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if mesh.group is None and n % mesh.n_shards:
            raise ValueError("%d rows do not split into %d shards (pad them)"
                             % (n, mesh.n_shards))
        out.append(a.to(mesh.device) if isinstance(a, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(a)).to(
                       mesh.device))
    return tuple(out)


def pad_to_multiple(a: np.ndarray, mult: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    n = a.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


# ---------------------------------------------------------------------------
# band_counts: a shard's allele counts and banded pair counts
# ---------------------------------------------------------------------------

def _hits(vidx: torch.Tensor, allele: torch.Tensor, n_vars: int
          ) -> torch.Tensor:
    return (allele >= 0) & (allele < 3) & (vidx >= 0) & (vidx < n_vars)


def band_counts_plain(vidx: torch.Tensor, allele: torch.Tensor, n_vars: int,
                      band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX shard body's counts written in torch (phaser_tpu
    dist/mesh.py:166-187): the (rows, L, L) broadcast, over chunks of rows
    so that a chunk forms at most PLAIN_CHUNK_ELEMENTS elements."""
    dev = vidx.device
    N, L = vidx.shape
    hit = _hits(vidx, allele, n_vars)
    flat = vidx[hit].long() * 3 + allele[hit].long()
    counts = torch.zeros(n_vars * 3, dtype=torch.int64, device=dev)
    counts.index_add_(0, flat, torch.ones_like(flat))
    pair = torch.zeros(n_vars * band * 9, dtype=torch.int64, device=dev)
    if band > 0 and N and L:
        rows = max(1, PLAIN_CHUNK_ELEMENTS // (L * L))
        for r0 in range(0, N, rows):
            v = vidx[r0:r0 + rows]
            a = allele[r0:r0 + rows]
            h = hit[r0:r0 + rows]
            d = v[:, None, :] - v[:, :, None]            # v[l2] - v[l1]
            ok = h[:, :, None] & h[:, None, :] & (d >= 1) & (d <= band)
            r, i, j = torch.nonzero(ok, as_tuple=True)
            idx = ((v[r, i].long() * band + d[r, i, j].long() - 1) * 9 +
                   a[r, i].long() * 3 + a[r, j].long())
            pair.index_add_(0, idx, torch.ones_like(idx))
    return (counts.view(n_vars, 3).to(torch.int32),
            pair.view(n_vars, band, 9).to(torch.int32))


def band_counts(vidx: torch.Tensor, allele: torch.Tensor, n_vars: int,
                band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A shard's (n_vars, 3) allele counts and (n_vars, band, 9) pair
    counts, both int32, from its (N, L) int32 vidx / allele planes
    (assign_alleles_device's outputs).  band = 0 gives the counts alone.
    On CUDA tensors the band_counts kernel; on CPU tensors its plain
    version."""
    dev = vidx.device
    if vidx.dim() != 2 or vidx.shape != allele.shape:
        raise ValueError("vidx %s and allele %s must be (N, L) planes of one "
                         "shape" % (tuple(vidx.shape), tuple(allele.shape)))
    for name, t in (("vidx", vidx), ("allele", allele)):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError("%s must be int32 on %s, not %s on %s"
                             % (name, dev, t.dtype, t.device))
    if band < 0 or n_vars < 0:
        raise ValueError("band %d and n_vars %d must be >= 0"
                         % (band, n_vars))
    if dev.type == "cpu":
        return band_counts_plain(vidx, allele, n_vars, band)
    if dev.type != "cuda":
        raise ValueError("band_counts takes CPU or CUDA tensors, not %s"
                         % dev)
    N, L = vidx.shape
    if N * L >= (1 << 31) or n_vars * max(band, 1) * 9 >= (1 << 31):
        raise ValueError("planes of %d x %d or %d variants x band %d exceed "
                         "the kernel's int32 indexing" % (N, L, n_vars, band))
    if L > 6144:
        raise ValueError("rows of %d bases exceed the kernel's shared-memory "
                         "row (6,144 bases)" % L)
    P, I = ctypes.c_void_p, ctypes.c_int
    counts = torch.empty((n_vars, 3), dtype=torch.int32, device=dev)
    pair = torch.empty((n_vars, band, 9), dtype=torch.int32, device=dev)
    v, a = vidx.contiguous(), allele.contiguous()
    build.launch("band_counts_launch", [P, P, I, I, I, I, P, P, P],
                 (v.data_ptr(), a.data_ptr(), N, L, n_vars, band,
                  counts.data_ptr(), pair.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream))
    bump(LAUNCHES, "band_counts")
    return counts, pair


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------

def _step_inputs(mesh: Mesh, codes, quals, refpos, vpos, ind_codes, n_ind):
    dev = mesh.device
    return (_tensor(codes, torch.uint8, dev), _tensor(quals, torch.uint8, dev),
            _tensor(refpos, torch.int32, dev), _tensor(vpos, torch.int32, dev),
            _tensor(ind_codes, torch.uint8, dev),
            _tensor(n_ind, torch.int8, dev))


def _shard_ranges(mesh: Mesh, n_rows: int):
    if mesh.group is not None:
        return [(0, n_rows)]
    if n_rows % mesh.n_shards:
        raise ValueError("%d rows do not split into %d shards (pad them)"
                         % (n_rows, mesh.n_shards))
    step = n_rows // mesh.n_shards
    return [(s * step, (s + 1) * step) for s in range(mesh.n_shards)]


def _merge(mesh: Mesh, *tensors: torch.Tensor) -> None:
    """Sums each tensor over the group's ranks, in place (psum)."""
    if mesh.group is None:
        return
    import torch.distributed as dist
    for t in tensors:
        host = t.cpu() if t.device.type != "cpu" else t
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
        if host is not t:
            t.copy_(host)


def _sharded_counts(mesh: Mesh, inputs, baseq: int, band: int):
    from ..kernels.alleles import assign_alleles_device
    codes, quals, refpos, vpos, ind, ni = inputs
    n_vars = int(vpos.shape[0])
    counts = pair = None
    for lo, hi in _shard_ranges(mesh, codes.shape[0]):
        vidx, allele = assign_alleles_device(codes[lo:hi], quals[lo:hi],
                                             refpos[lo:hi], vpos, ind, ni,
                                             baseq)
        c, p = band_counts(vidx, allele, n_vars, band)
        if counts is None:
            counts, pair = c, p
        else:
            counts += c
            pair += p
    _merge(mesh, counts, pair)
    return counts, pair


def band_configs(pair: torch.Tensor):
    """(cis, trans, other) support of every banded pair: configurations
    0+4, 1+3 and the other five (phaser_tpu dist/mesh.py:111-114)."""
    cfg_a = pair[:, :, 0] + pair[:, :, 4]
    cfg_b = pair[:, :, 1] + pair[:, :, 3]
    other = (pair[:, :, 2] + pair[:, :, 5] + pair[:, :, 6] +
             pair[:, :, 7] + pair[:, :, 8])
    return cfg_a, cfg_b, other


def connection_p_values(counts: torch.Tensor, pair: torch.Tensor
                        ) -> torch.Tensor:
    """(M, band) float64 p-values of the connection tests on merged counts
    (the column variant_connections.txt prints), on the tensors' device:
    the noise rate, then conflicting_config_p (the binom_cdf kernel on the
    card)."""
    from ..kernels.stats import conflicting_config_p, noise_from_counts
    return conflicting_config_p(*band_configs(pair),
                                noise_from_counts(counts))


def sharded_phasing_step(mesh: Mesh, codes, quals, refpos, vpos, ind_codes,
                         n_ind, baseq: int, band: int = 8,
                         score_block: int = 8, cc_threshold: float = 0.01):
    """One full sharded pipeline step (phaser_tpu dist/mesh.py:47-135):

      per shard: allele assignment -> per-(variant, allele-class) counts and
      banded pair-configuration counts (variant pairs within `band` table
      entries, a dense (M, band, 9) band) -> summed over the shards ->
      on the card: the global noise estimate from the merged counts, the
      banded connection tests and pruning (kernels/stats.py) -> the
      2^(K-1) phase-configuration scores of the first K = `score_block`
      variants.

    codes / quals (N, L) uint8, refpos (N, L) int32, vpos (M,) int32,
    ind_codes (M, 2) uint8, n_ind (M,) int8; numpy arrays or tensors.  On a
    local mesh the rows are all of them, split into equal shards; on a
    group mesh they are this rank's.  Returns (counts (M, 3) int32,
    pair (M, band, 9) int32, prune (M, band) bool, scores (2^(K-1),)
    float64), all on the mesh's device and equal on every rank."""
    from ..kernels.phasescore import enumerate_scores
    from ..kernels.stats import noise_from_counts, prune_mask

    inputs = _step_inputs(mesh, codes, quals, refpos, vpos, ind_codes, n_ind)
    counts, pair = _sharded_counts(mesh, inputs, baseq, band)

    _, prune, _ = prune_mask(*band_configs(pair), noise_from_counts(counts),
                             cc_threshold)

    # a cis-support allele adjacency of the first K variants from the merged
    # band (dryrun._host_scores rebuilds it on the host)
    K = score_block
    adj = torch.zeros((2 * K, 2 * K), dtype=torch.float64,
                      device=mesh.device)
    for dd in range(min(band, K - 1)):
        cis = ((pair[:K - dd - 1, dd, 0] + pair[:K - dd - 1, dd, 4]) > 0
               ).to(torch.float64)
        i = torch.arange(cis.shape[0], device=mesh.device)
        j = i + dd + 1
        for x, y in ((2 * i, 2 * j), (2 * j, 2 * i), (2 * i + 1, 2 * j + 1),
                     (2 * j + 1, 2 * i + 1)):
            adj[x, y] = cis
    scores = enumerate_scores(adj, K)
    return counts, pair, prune, scores


def sharded_allele_counts(mesh: Mesh, codes, quals, refpos, vpos, ind_codes,
                          n_ind, baseq: int) -> torch.Tensor:
    """Per-shard allele assignment and the (n_vars, 3) int32 count tensor
    summed over the shards (phaser_tpu dist/mesh.py:138-167; the merge of
    phaser.py:558-586 as one reduction)."""
    inputs = _step_inputs(mesh, codes, quals, refpos, vpos, ind_codes, n_ind)
    return _sharded_counts(mesh, inputs, baseq, 0)[0]
