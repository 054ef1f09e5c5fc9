"""Allele assignment on the GPU: the port of phaser_tpu/kernels/alleles.py.

The dispatcher's fused programs (unpack + classify + compact), each a
hand-written CUDA kernel in csrc/alleles.cu beside a plain PyTorch version:

  assign_compact_affine_nibble  affine reads, nibble-packed masked plane
  assign_compact_affine_masked  affine reads, 1 B/base masked plane (no
                                nibble packer)
  assign_compact_delta_nibble   D / split-M reads, nibble plane + int16 delta
  assign_compact_plane          N-spliced reads / delta overflow, refpos plane

All four are range joins: they find each row's table range themselves (on
the card, in the CUDA kernels) and take no window; the delta-nibble program
takes the packer's per-row [rp_min, rp_max] for it.
Each returns the packed-hit buffer of phaser_tpu's `_pack_hits`:
int32 (2, capacity + 1), out[0, 0] = n_hits (exact
even past capacity), row 0 = read index within the launch, row 1 =
(var << 8) | (masked base << 4) | allele.  The CUDA kernels compact with
atomics, so hit order is free; callers sort.

The kernel-level entries keep phaser_tpu's public layout (codes/quals (N, L)
uint8, refpos (N, L) int32, vpos (M,) int32, ind_codes (M, 2) uint8, n_ind
(M,) int8) and return the (N, L) int32 vidx / allele planes:
assign_alleles_device (whole table), assign_alleles_pallas_windowed (planned
256-entry windows, algo "gather" or "cmp") and assign_alleles_pallas (table
resident in shared memory), plus compact_hits.

A wrapper runs the plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises.

The numpy packers and the refpos-plane planner below are copies of
phaser_tpu's, without the options no caller here uses; its two planners for
the affine and delta programs have no caller in a package whose fused
programs take no window, and are not copied.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.counters import bump

OTHER = 2
NO_HIT = 3
_WIN = 256  # table window entries per read block
_INT32_MAX = int(np.iinfo(np.int32).max)

# kernel launches per wrapper (CUDA launches only; plain runs do not count)
LAUNCHES = {"affine_nibble": 0, "delta_nibble": 0, "plane": 0,
            "affine_masked": 0, "planes": 0, "planes_resident": 0,
            "planes_cmp": 0, "planes_table": 0}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


Table = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host-side packing and window planning (copied from phaser_tpu)
# ---------------------------------------------------------------------------

_pack_tls = threading.local()  # per-thread scratch for concurrent packers


def _reuse_buf(tag: str, n: int, L: int, dtype) -> np.ndarray:
    """Cached (n, L) scratch view; grown geometrically, pages stay hot.
    Thread-local: safe under concurrent shard-engine packers."""
    bufs = getattr(_pack_tls, "bufs", None)
    if bufs is None:
        bufs = _pack_tls.bufs = {}
    need = n * L
    flat = bufs.get(tag)
    if flat is None or flat.size < need:
        cap = max(need, 2 * (flat.size if flat is not None else 0), 1)
        flat = np.empty(cap, dtype)
        bufs[tag] = flat
    return flat[:need].reshape(n, L)


def _native_lib():
    from ..io import native as native_mod
    return native_mod.get_lib()


def _read_arrays(bd):
    ptr = ctypes.c_void_p
    arrs = (np.ascontiguousarray(bd.pos, np.int32),
            np.ascontiguousarray(bd.cigar_flat, np.uint32),
            np.ascontiguousarray(bd.cigar_off, np.int64),
            np.ascontiguousarray(bd.seq_flat, np.uint8),
            np.ascontiguousarray(bd.qual_flat, np.uint8),
            np.ascontiguousarray(bd.seq_off, np.int64))
    return arrs, [a.ctypes.data_as(ptr) for a in arrs]


@functools.lru_cache(maxsize=None)
def _n_threads() -> int:
    # asked once: os.cpu_count() costs about half a millisecond in a
    # container, and a dispatcher call asks a dozen times
    return min(os.cpu_count() or 1, 8)


def _plane_width(bd, rows=None) -> int:
    if rows is None:
        lens = np.diff(bd.seq_off)
    else:
        lens = bd.seq_off[rows + 1] - bd.seq_off[rows]
    L = int(lens.max() if len(lens) else 1)
    return ((L + 127) // 128) * 128


def _rows_arg(bd, rows):
    """(n, rows as a contiguous int64 array or None, its pointer or None)
    for a native packer: output row i is read rows[i], or read i."""
    if rows is None:
        return len(bd), None, None
    rows = np.ascontiguousarray(rows, np.int64)
    return len(rows), rows, rows.ctypes.data_as(ctypes.c_void_p)


def _pack_reads_numpy(bd, codes, quals, refpos) -> None:
    """Fills the zeroed (N, L) planes from the BamData (phaser_tpu
    kernels/alleles.py:161-169)."""
    from ..mapper.host import expand_refpos

    n = len(bd)
    lens = np.diff(bd.seq_off)
    rp_flat, _, _ = expand_refpos(bd)
    idx = np.arange(len(bd.seq_flat)) - np.repeat(bd.seq_off[:-1], lens)
    rows = np.repeat(np.arange(n), lens)
    codes[rows, idx] = bd.seq_flat
    quals[rows, idx] = bd.qual_flat
    refpos[rows, idx] = rp_flat


def pack_reads(bd, rows=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, quals, refpos) padded (N, L) planes, L a multiple of 128:
    phaser_tpu's pack_reads (kernels/alleles.py:114-169), the native packer
    or, without it, numpy.  With `rows` (read indices) only those reads are
    packed, row i from read rows[i], without gathering them first; the
    other packers take it likewise."""
    n, rows, rows_p = _rows_arg(bd, rows)
    L = _plane_width(bd, rows)
    codes = np.zeros((n, L), np.uint8)
    quals = np.zeros((n, L), np.uint8)
    refpos = np.zeros((n, L), np.int32)
    if n == 0:
        return codes, quals, refpos
    lib = _native_lib()
    if lib is None:
        if rows is not None:
            bd = bd.select(rows)
        _pack_reads_numpy(bd, codes, quals, refpos)
        return codes, quals, refpos
    ptr = ctypes.c_void_p
    keep, p = _read_arrays(bd)
    lib.pack_reads_native(
        n, rows_p, *p, L, codes.ctypes.data_as(ptr),
        quals.ctypes.data_as(ptr), refpos.ctypes.data_as(ptr), _n_threads())
    return codes, quals, refpos


def pack_codes_quals(bd, reuse: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """codes/quals planes only, for the masked-affine path, where refpos is
    rebuilt on the device (phaser_tpu kernels/alleles.py:530-560)."""
    n = len(bd)
    L = _plane_width(bd)
    lib = _native_lib() if n else None
    if lib is not None and hasattr(lib, "pack_codes_quals_native"):
        if reuse:
            codes = _reuse_buf("codes", n, L, np.uint8)
            quals = _reuse_buf("quals", n, L, np.uint8)
        else:
            codes = np.empty((n, L), np.uint8)
            quals = np.empty((n, L), np.uint8)
        ptr = ctypes.c_void_p
        seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
        qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
        soff = np.ascontiguousarray(bd.seq_off, np.int64)
        lib.pack_codes_quals_native(
            n, seq.ctypes.data_as(ptr), qual.ctypes.data_as(ptr),
            soff.ctypes.data_as(ptr), L, codes.ctypes.data_as(ptr),
            quals.ctypes.data_as(ptr), _n_threads())
        return codes, quals
    codes = np.zeros((n, L), np.uint8)
    quals = np.zeros((n, L), np.uint8)
    if n:
        _pack_reads_numpy(bd, codes, quals, np.zeros((n, L), np.int32))
    return codes, quals


def pack_affine_masked(bd, baseq: int, reuse: bool = False, rows=None):
    """One-pass native masked-plane packing + affine classification
    (phaser_tpu kernels/alleles.py:454-491): (n, L) uint8 with 15 where the
    base is masked.  Returns (mcodes, is_affine, start, lo, hi) or None
    without the native library."""
    n, rows, rows_p = _rows_arg(bd, rows)
    L = _plane_width(bd, rows)
    lib = _native_lib() if n else None
    if lib is None or not hasattr(lib, "pack_affine_masked_native"):
        return None
    if reuse:
        mcodes = _reuse_buf("mcodes", n, L, np.uint8)
    else:
        mcodes = np.empty((n, L), np.uint8)
    is_aff = np.empty(n, np.uint8)
    start = np.empty(n, np.int32)
    lo = np.empty(n, np.int32)
    hi = np.empty(n, np.int32)
    ptr = ctypes.c_void_p
    keep, p = _read_arrays(bd)
    lib.pack_affine_masked_native(
        n, rows_p, *p, baseq, L, mcodes.ctypes.data_as(ptr),
        is_aff.ctypes.data_as(ptr), start.ctypes.data_as(ptr),
        lo.ctypes.data_as(ptr), hi.ctypes.data_as(ptr), _n_threads())
    return mcodes, is_aff.astype(bool), start, lo, hi


def pack_affine_nibble(bd, baseq: int, reuse: bool = False, rows=None):
    """One-pass native nibble-packed masked plane + affine classification:
    (n, L/2) uint8, two masked base nibbles per byte (even base low).
    Returns (ncodes, is_affine, start, lo, hi) or None without the native
    library.  With reuse=True ncodes is a view of cached scratch,
    invalidated by the next call."""
    n, rows, rows_p = _rows_arg(bd, rows)
    L = _plane_width(bd, rows)
    lib = _native_lib() if n else None
    if lib is None or not hasattr(lib, "pack_affine_nibble_native"):
        return None
    Lh = L // 2
    if reuse:
        ncodes = _reuse_buf("ncodes", n, Lh, np.uint8)
    else:
        ncodes = np.empty((n, Lh), np.uint8)
    is_aff = np.empty(n, np.uint8)
    start = np.empty(n, np.int32)
    lo = np.empty(n, np.int32)
    hi = np.empty(n, np.int32)
    ptr = ctypes.c_void_p
    keep, p = _read_arrays(bd)
    lib.pack_affine_nibble_native(
        n, rows_p, *p, baseq, Lh, ncodes.ctypes.data_as(ptr),
        is_aff.ctypes.data_as(ptr), start.ctypes.data_as(ptr),
        lo.ctypes.data_as(ptr), hi.ctypes.data_as(ptr), _n_threads())
    return ncodes, is_aff.astype(bool), start, lo, hi


def pack_delta_nibble(bd, baseq: int, reuse: bool = False, rows=None):
    """int16 delta-encoded refpos packing for deletion / split-M reads:
    (n, L/2) masked nibble plane + (n, L) int16 delta plane.  Returns
    (ncodes, delta, ok, start, rp_min, rp_max) or None without the native
    library; rows with ok=False (affine / N/I/P / delta overflow) must be
    routed to other paths."""
    n, rows, rows_p = _rows_arg(bd, rows)
    L = _plane_width(bd, rows)
    lib = _native_lib() if n else None
    if lib is None or not hasattr(lib, "pack_delta_nibble_native"):
        return None
    Lh = L // 2
    if reuse:
        ncodes = _reuse_buf("d_ncodes", n, Lh, np.uint8)
        delta = _reuse_buf("d_delta", n, L, np.int16)
    else:
        ncodes = np.empty((n, Lh), np.uint8)
        delta = np.empty((n, L), np.int16)
    ok = np.empty(n, np.uint8)
    start = np.empty(n, np.int32)
    rp_min = np.empty(n, np.int32)
    rp_max = np.empty(n, np.int32)
    ptr = ctypes.c_void_p
    keep, p = _read_arrays(bd)
    lib.pack_delta_nibble_native(
        n, rows_p, *p, baseq, Lh, ncodes.ctypes.data_as(ptr),
        delta.ctypes.data_as(ptr), ok.ctypes.data_as(ptr),
        start.ctypes.data_as(ptr), rp_min.ctypes.data_as(ptr),
        rp_max.ctypes.data_as(ptr), _n_threads())
    return ncodes, delta, ok.astype(bool), start, rp_min, rp_max


def _plan_from_bounds(pmin_rows, pmax_rows, vpos_host, n_rows: int,
                      block_rows: int):
    """Per-block window offsets from per-row [min, max] positions (int64,
    int64-max / 0 for rows without positions)."""
    R = block_rows
    n_blocks = -(-n_rows // R)
    pad = n_blocks * R - n_rows
    if pad:
        pmin_rows = np.pad(pmin_rows, (0, pad),
                           constant_values=np.iinfo(np.int64).max)
        pmax_rows = np.pad(pmax_rows, (0, pad))
    pmin = pmin_rows.reshape(n_blocks, R).min(axis=1)
    pmax = pmax_rows.reshape(n_blocks, R).max(axis=1)
    M = len(vpos_host)
    lo_idx = np.searchsorted(vpos_host, pmin, side="left")
    hi_idx = np.searchsorted(vpos_host, pmax, side="right")
    ws = np.minimum(lo_idx & ~np.int64(127), max((M - 1) & ~127, 0))
    if np.any(hi_idx - ws > _WIN):
        return None
    return ws.astype(np.int32)


def plan_windows_plane(refpos_host: np.ndarray, vpos_host: np.ndarray,
                       block_rows: int = 256):
    """Window planning from an (N, L) refpos plane, for the unfused windowed
    entry.  Returns the (n_blocks,) int32 128-aligned window offsets, or
    None when a block's variant band exceeds the 256-entry window."""
    N = refpos_host.shape[0]
    rp_pos = np.where(refpos_host > 0, refpos_host, _INT32_MAX)
    smin = rp_pos.min(axis=1).astype(np.int64) if N else np.zeros(0, np.int64)
    smax = refpos_host.max(axis=1).astype(np.int64) if N else \
        np.zeros(0, np.int64)
    return _plan_from_bounds(smin, smax, vpos_host, N, block_rows)


def decode_packed_hits(full: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray, int]:
    """Decode a fetched packed-hit buffer.  Returns (read_idx, var_idx,
    allele_class, base_code, n_hits); n_hits may exceed the capacity
    (overflow: the hit arrays are then empty and the caller relaunches)."""
    cap = int(full.shape[1]) - 1
    full = full.astype(np.int64)
    nh = int(full[0, 0])
    if nh > cap:
        return (np.zeros(0, np.int64),) * 2 + \
            (np.zeros(0, np.int16),) * 2 + (nh,)
    body = full[:, 1:1 + nh]
    r = body[0]
    v = body[1] >> 8
    a = (body[1] & 0xF).astype(np.int16)
    mc = ((body[1] >> 4) & 0xF).astype(np.int16)
    return r, v, a, mc, nh


def padded_table(vt, dev_vidx: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(vpos, a0, a1, n_ind) int32 of the device-eligible variants, padded
    to a power of two (at least 8) with INT32_MAX positions and zero codes,
    exactly as phaser_tpu's dispatcher pads its table."""
    M = int(dev_vidx.size)
    Mp = _next_pow2(max(M, 8))
    vpos = np.full(Mp, _INT32_MAX, np.int32)
    vpos[:M] = vt.pos[dev_vidx]
    a0 = np.zeros(Mp, np.int32)
    a1 = np.zeros(Mp, np.int32)
    ni = np.zeros(Mp, np.int32)
    a0[:M] = vt.ind_codes[dev_vidx, 0]
    a1[:M] = vt.ind_codes[dev_vidx, 1]
    ni[:M] = vt.n_ind[dev_vidx]
    return vpos, a0, a1, ni


def device_table(vt, dev_vidx: np.ndarray, device) -> Table:
    """padded_table as int32 tensors on `device`."""
    return tuple(torch.from_numpy(x).to(device)
                 for x in padded_table(vt, dev_vidx))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _allele_plain(masked: torch.Tensor, k: torch.Tensor,
                  table: Table) -> torch.Tensor:
    """Allele class of observed codes `masked` against table entries k:
    0 / 1 = the individual's allele index, else OTHER."""
    _, a0, a1, ni = table
    return torch.where(
        (masked == a0[k]) & (ni[k] > 0), 0,
        torch.where((masked == a1[k]) & (ni[k] > 1), 1, OTHER))


def _lookup_plain(masked: torch.Tensor, refpos: torch.Tensor,
                  ws: torch.Tensor, win: int, block_rows: int,
                  table: Table) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(hit, table index, allele) planes: a base hits the table entry equal
    to its refpos when that entry lies in its row block's window
    [ws[b], ws[b] + win).  The planners put every position a block can hit
    at or after its window start, so the global lower bound is the window's
    own lower bound."""
    vpos, a0, a1, ni = table
    mp = vpos.shape[0]
    N = refpos.shape[0]
    cand = torch.searchsorted(vpos, refpos.contiguous())
    safe = cand.clamp_max(mp - 1)
    rows = torch.arange(N, device=refpos.device)
    w0 = ws.long()[rows // block_rows][:, None]
    hit = ((refpos > 0) & (masked != 15) & (cand >= w0) &
           (cand < torch.clamp(w0 + win, max=mp)) & (vpos[safe] == refpos))
    allele = _allele_plain(masked, safe, table)
    return hit, safe, allele


def _pack_pairs(rows: torch.Tensor, words: torch.Tensor, capacity: int,
                device) -> torch.Tensor:
    """_pack_hits from (row, word) pairs already in row-major order: n_hits
    exact past capacity."""
    n = int(rows.numel())
    out = torch.full((2, capacity + 1), -1, dtype=torch.int32, device=device)
    out[0, 0] = n
    k = min(n, capacity)
    out[0, 1:1 + k] = rows[:k].to(torch.int32)
    out[1, 1:1 + k] = words[:k].to(torch.int32)
    return out


def _base_index(L: int, device) -> torch.Tensor:
    return torch.arange(L, dtype=torch.int32, device=device)[None, :]


def _ragged(k0: torch.Tensor, k1: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expands per-row index ranges [k0, k1) into (row, k) candidate pairs,
    rows ascending and k ascending within a row."""
    cnt = (k1 - k0).clamp_min(0)
    rows = torch.repeat_interleave(
        torch.arange(cnt.shape[0], device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = k0[rows] + (torch.arange(rows.shape[0], device=cnt.device) -
                    first[rows])
    return rows, k


def _first_of_equal(k: torch.Tensor, k0_of: torch.Tensor,
                    vpos: torch.Tensor) -> torch.Tensor:
    """Of table entries at one position only the first is a hit (what a
    per-base lower-bound search finds)."""
    return (k == k0_of) | (vpos[k] != vpos[(k - 1).clamp_min(0)])


def _classify_entries(k: torch.Tensor, masked: torch.Tensor,
                      table: Table) -> torch.Tensor:
    """Packed hit words of candidates: table index k, observed code."""
    return (k << 8) | (masked.long() << 4) | \
        _allele_plain(masked, k, table).long()


def _affine_plain(code_at, L: int, start, lo, hi, table: Table,
                  capacity: int) -> torch.Tensor:
    """The range join of the affine kernels: row r covers positions
    [p0, p0 + span), so its candidates are the table entries in that range;
    the base under entry k is i0 + vpos[k] - p0 and its masked code is
    code_at(rows, base)."""
    vpos = table[0]
    lo_, hi_ = lo.long(), hi.long()
    i0 = lo_.clamp_min(0)
    span = (hi_.clamp_max(L) - i0).clamp_min(0)
    p0 = start.long() + (i0 - lo_)
    k0 = torch.searchsorted(vpos, p0.to(torch.int32).contiguous())
    k1 = torch.searchsorted(vpos, (p0 + span).clamp_max(_INT32_MAX)
                            .to(torch.int32).contiguous())
    rows, k = _ragged(k0, torch.where(span > 0, k1, k0))
    p = vpos[k].long()
    code = code_at(rows, i0[rows] + (p - p0[rows]))
    keep = (code != 15) & (p > 0) & _first_of_equal(k, k0[rows], vpos)
    rows, k, code = rows[keep], k[keep], code[keep]
    return _pack_pairs(rows, _classify_entries(k, code, table), capacity,
                       start.device)


def affine_nibble_plain(ncodes, start, lo, hi, table: Table,
                        capacity: int) -> torch.Tensor:
    """_affine_plain on the nibble plane: a base's code is one nibble of one
    byte (even base low)."""
    def nibble_at(rows, i):
        byte = ncodes[rows, i >> 1].to(torch.int32)
        return torch.where((i & 1) == 1, byte >> 4, byte & 0xF)
    return _affine_plain(nibble_at, 2 * ncodes.shape[1], start, lo, hi,
                         table, capacity)


def affine_masked_plain(mcodes, start, lo, hi, table: Table,
                        capacity: int) -> torch.Tensor:
    """_affine_plain on the 1 B/base masked plane."""
    return _affine_plain(lambda rows, i: mcodes[rows, i].to(torch.int32),
                         mcodes.shape[1], start, lo, hi, table, capacity)


_PLAIN_CAND_CHUNK = 1 << 19  # candidates compared with their rows at once


def _join_plain(k0, k1, positions_of, code_at, L: int, table: Table,
                capacity: int) -> torch.Tensor:
    """The range join of the delta and plane kernels: row r's candidates are
    the table entries [k0[r], k1[r]) (the first of each position); a
    candidate hits every base of the row at its position.
    positions_of(rows) is the (len(rows), L) refpos plane of those rows
    (<= 0 never hits) and code_at(rows, base) the masked code of a matched
    base, read only there; 15 emits nothing."""
    vpos = table[0]
    rows, k = _ragged(k0, k1)
    first = _first_of_equal(k, k0[rows], vpos)
    rows, k = rows[first], k[first]
    hit_rows, hit_base, hit_k = [], [], []
    for s in range(0, int(rows.numel()), _PLAIN_CAND_CHUNK):
        r, kk = rows[s:s + _PLAIN_CAND_CHUNK], k[s:s + _PLAIN_CAND_CHUNK]
        p = vpos[kk][:, None]
        c, i = torch.nonzero((positions_of(r) == p) & (p > 0), as_tuple=True)
        hit_rows.append(r[c])
        hit_base.append(i)
        hit_k.append(kk[c])
    if hit_rows:
        rows, base, k = (torch.cat(hit_rows), torch.cat(hit_base),
                         torch.cat(hit_k))
    else:
        rows = base = k = torch.zeros(0, dtype=torch.long, device=k0.device)
    masked = code_at(rows, base)
    keep = masked != 15
    rows, base, k, masked = rows[keep], base[keep], k[keep], masked[keep]
    order = torch.argsort(rows * max(L, 1) + base)  # row-major, as _pack_hits
    rows, k, masked = rows[order], k[order], masked[order]
    return _pack_pairs(rows, _classify_entries(k, masked, table), capacity,
                       k0.device)


def delta_nibble_plain(ncodes, start, delta, rp_min, rp_max, table: Table,
                       capacity: int) -> torch.Tensor:
    """The range join of the delta_nibble kernel: a row's candidates are the
    table entries in [rp_min, rp_max]; each base of a candidate row at a
    candidate's position looks up its own nibble, so a clipped base (delta
    0, nibble 15) that shares a position with an aligned base emits
    nothing."""
    vpos = table[0]
    L = 2 * ncodes.shape[1]
    i = _base_index(L, start.device)
    k0 = torch.searchsorted(vpos, rp_min.clamp_min(1).contiguous())
    k1 = torch.searchsorted(vpos, rp_max.contiguous(), right=True)

    def positions_of(rows):
        return start[rows][:, None] + i + delta[rows].to(torch.int32)

    def nibble_at(rows, base):
        byte = ncodes[rows, base >> 1].to(torch.int32)
        return torch.where((base & 1) == 1, byte >> 4, byte & 0xF)
    return _join_plain(k0, torch.where(rp_max > 0, k1, k0), positions_of,
                       nibble_at, L, table, capacity)


def _masked_plane(codes, quals, baseq: int) -> torch.Tensor:
    return torch.where(quals.to(torch.int32) >= baseq, codes.to(torch.int32),
                       15)


def plane_plain(codes, quals, refpos, baseq: int, table: Table,
                capacity: int) -> torch.Tensor:
    """The range join of the plane kernel: a row's candidates are the table
    entries between its smallest positive and its largest position; codes /
    quals are read only where a position matched."""
    vpos = table[0]
    has = refpos > 0
    pmin = torch.where(has, refpos, _INT32_MAX).amin(dim=1)
    pmax = torch.where(has, refpos, 0).amax(dim=1)
    k0 = torch.searchsorted(vpos, pmin.contiguous())
    k1 = torch.searchsorted(vpos, pmax.contiguous(), right=True)

    def masked_at(rows, base):
        return torch.where(quals[rows, base].to(torch.int32) >= baseq,
                           codes[rows, base].to(torch.int32), 15)
    return _join_plain(k0, torch.where(pmax > 0, k1, k0),
                       lambda rows: refpos[rows], masked_at, refpos.shape[1],
                       table, capacity)


def planes_plain(codes, quals, refpos, baseq: int, ws, win: int,
                 block_rows: int, table: Table
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vidx, allele) planes: the lower bound in the row block's window;
    with ws = [0] and win = M, phaser_tpu's jnp assign_alleles_device."""
    N, L = refpos.shape
    if table[0].shape[0] == 0:
        dev = refpos.device
        return (torch.full((N, L), -1, dtype=torch.int32, device=dev),
                torch.full((N, L), NO_HIT, dtype=torch.int32, device=dev))
    hit, idx, allele = _lookup_plain(_masked_plane(codes, quals, baseq),
                                     refpos, ws, win, block_rows, table)
    return (torch.where(hit, idx, -1).to(torch.int32),
            torch.where(hit, allele, NO_HIT).to(torch.int32))


def planes_cmp_plain(codes, quals, refpos, baseq: int, ws, block_rows: int,
                     table: Table) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vidx, allele) planes of the compare-all body: the LAST table entry
    in the row block's 256-entry window whose position equals refpos.  On
    unique positions this is planes_plain's lower bound."""
    vpos, a0, a1, ni = table
    mp = vpos.shape[0]
    N = refpos.shape[0]
    masked = _masked_plane(codes, quals, baseq)
    rows = torch.arange(N, device=refpos.device)
    w0 = ws.long()[rows // block_rows][:, None]
    last = torch.searchsorted(vpos, refpos.contiguous(), right=True) - 1
    k = torch.minimum(last, torch.clamp(w0 + _WIN, max=mp) - 1)
    safe = k.clamp_min(0)
    hit = ((refpos > 0) & (masked != 15) & (k >= w0) &
           (vpos[safe] == refpos))
    allele = _allele_plain(masked, safe, table)
    return (torch.where(hit, safe, -1).to(torch.int32),
            torch.where(hit, allele, NO_HIT).to(torch.int32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {  # each launcher's C signature (csrc/alleles.cu)
    "affine_nibble_launch": [_P] * 4 + [_I, _I] + [_P] * 4 + [_I, _P, _I, _P],
    "delta_nibble_launch": [_P] * 5 + [_I, _I] + [_P] * 4 + [_I, _P, _I, _P],
    "plane_launch": [_P] * 3 + [_I, _I, _I] + [_P] * 4 + [_I, _P, _I, _P],
    "affine_masked_launch": [_P] * 4 + [_I, _I] + [_P] * 4 + [_I, _P, _I, _P],
    "planes_launch": [_P] * 3 + [_I, _I, _I, _P, _I, _I] + [_P] * 4 +
    [_I, _I, _P, _P, _P],
    "planes_cmp_launch": [_P] * 3 + [_I, _I, _I, _P, _I] + [_P] * 4 +
    [_I, _P, _P, _P],
}


def _on_cuda(dev: torch.device) -> bool:
    """False: run the plain version (CPU tensors); True: launch the kernel."""
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError("allele kernels take CPU or CUDA tensors, not %s" % dev)


def _check(name: str, t: torch.Tensor, dtype, shape: Sequence[int],
           dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, dev))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _check_table(table: Table, dev: torch.device) -> torch.device:
    """Checks the four int32 (mp,) table columns; returns `dev` with its
    index filled in."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mp = int(table[0].shape[0])
    for k, t in zip(("vpos", "a0", "a1", "n_ind"), table):
        _check(k, t, torch.int32, (mp,), dev)
    if mp >= (1 << 23):
        raise ValueError("table of %d entries exceeds the packed-hit "
                         "layout's 2^23 variant limit" % mp)
    return dev


def _check_join_table(table: Table) -> None:
    """What the range-join kernels' 16-byte loads need of a CUDA table: a
    length that is a multiple of 4 (padded_table gives a power of two) and
    16-byte aligned columns."""
    mp = int(table[0].shape[0])
    if mp == 0 or mp % 4:
        raise ValueError("table of %d entries: the range-join kernels need "
                         "a padded table (a non-zero multiple of 4)" % mp)
    for k, t in zip(("vpos", "a0", "a1", "n_ind"), table):
        if t.data_ptr() % 16:
            raise ValueError("table column %s is not 16-byte aligned" % k)


def _check_size(n_rows: int, L: int, capacity: int) -> None:
    # the kernels index planes with int32 (a launch holds <= 262144 rows)
    if n_rows * L >= (1 << 31):
        raise ValueError("plane of %d x %d bases exceeds int32 indexing"
                         % (n_rows, L))
    if not 1 <= capacity < (1 << 30):
        raise ValueError("capacity %d out of range" % capacity)


def _new_packed(capacity: int, dev: torch.device) -> torch.Tensor:
    """The packed-hit buffer of a launch; its launcher fills it with -1 and
    zeroes the hit counter on the kernel's stream."""
    return torch.empty((2, capacity + 1), dtype=torch.int32, device=dev)


def _launch(fn_name: str, args) -> None:
    from ..utils import build
    build.launch(fn_name, _ARGTYPES[fn_name], args)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def assign_compact_affine_nibble(ncodes: torch.Tensor, start: torch.Tensor,
                                 lo: torch.Tensor, hi: torch.Tensor,
                                 table: Table, capacity: int
                                 ) -> torch.Tensor:
    """Affine reads: ncodes (N, L/2) uint8 nibble plane (pad 0xFF);
    start/lo/hi (N,) int32 with refpos = start + (i - lo) on [lo, hi).
    The table must be position-sorted; each row's table range is found by
    the program itself."""
    dev = ncodes.device
    N, Lh = ncodes.shape
    _check("ncodes", ncodes, torch.uint8, (N, Lh), dev)
    for k, t in (("start", start), ("lo", lo), ("hi", hi)):
        _check(k, t, torch.int32, (N,), dev)
    _check_table(table, dev)
    _check_size(N, 2 * Lh, capacity)
    if not _on_cuda(dev):
        return affine_nibble_plain(ncodes, start, lo, hi, table, capacity)
    _check_join_table(table)
    out = _new_packed(capacity, dev)
    vpos, a0, a1, ni = table
    _launch("affine_nibble_launch", (
        ncodes.data_ptr(), start.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        N, Lh, vpos.data_ptr(), a0.data_ptr(), a1.data_ptr(), ni.data_ptr(),
        vpos.shape[0], out.data_ptr(), capacity, _stream(dev)))
    bump(LAUNCHES, "affine_nibble")
    return out


def assign_compact_delta_nibble(ncodes: torch.Tensor, start: torch.Tensor,
                                delta: torch.Tensor, rp_min: torch.Tensor,
                                rp_max: torch.Tensor, table: Table,
                                capacity: int) -> torch.Tensor:
    """Deletion / split-M reads: ncodes (N, L/2) uint8, start (N,) int32,
    delta (N, L) int16 with refpos = start + i + delta[i] where the
    nibble != 15; rp_min / rp_max (N,) int32 as pack_delta_nibble returns
    them.  The contract: every unmasked base's position lies in
    [rp_min, rp_max]; a row with rp_max <= 0 emits nothing.  The table must
    be position-sorted; each row's table range is found by the program
    itself from those two numbers."""
    dev = ncodes.device
    N, Lh = ncodes.shape
    _check("ncodes", ncodes, torch.uint8, (N, Lh), dev)
    for k, t in (("start", start), ("rp_min", rp_min), ("rp_max", rp_max)):
        _check(k, t, torch.int32, (N,), dev)
    _check("delta", delta, torch.int16, (N, 2 * Lh), dev)
    _check_table(table, dev)
    _check_size(N, 2 * Lh, capacity)
    if not _on_cuda(dev):
        return delta_nibble_plain(ncodes, start, delta, rp_min, rp_max, table,
                                  capacity)
    _check_join_table(table)
    # the kernel loads a delta row as 8-byte words (4 x int16)
    if Lh % 2:
        raise ValueError("delta plane width %d is not a multiple of 4"
                         % (2 * Lh))
    if delta.data_ptr() % 16:
        raise ValueError("delta is not 16-byte aligned")
    out = _new_packed(capacity, dev)
    vpos, a0, a1, ni = table
    _launch("delta_nibble_launch", (
        ncodes.data_ptr(), start.data_ptr(), delta.data_ptr(),
        rp_min.data_ptr(), rp_max.data_ptr(), N, Lh, vpos.data_ptr(),
        a0.data_ptr(), a1.data_ptr(), ni.data_ptr(), vpos.shape[0],
        out.data_ptr(), capacity, _stream(dev)))
    bump(LAUNCHES, "delta_nibble")
    return out


def assign_compact_plane(codes: torch.Tensor, quals: torch.Tensor,
                         refpos: torch.Tensor, baseq: int, table: Table,
                         capacity: int) -> torch.Tensor:
    """Refpos-plane reads: codes/quals (N, L) uint8, refpos (N, L) int32
    (0 = unaligned), L a non-zero multiple of 4; masked = code where
    qual >= baseq, else 15.  The table must be position-sorted; each row's
    table range is found by the program itself."""
    dev = codes.device
    N, L = codes.shape
    _check("codes", codes, torch.uint8, (N, L), dev)
    _check("quals", quals, torch.uint8, (N, L), dev)
    _check("refpos", refpos, torch.int32, (N, L), dev)
    if L == 0 or L % 4:
        raise ValueError("plane width %d is not a non-zero multiple of 4" % L)
    _check_table(table, dev)
    _check_size(N, L, capacity)
    if not _on_cuda(dev):
        return plane_plain(codes, quals, refpos, baseq, table, capacity)
    _check_join_table(table)
    if refpos.data_ptr() % 16:
        raise ValueError("refpos is not 16-byte aligned")
    out = _new_packed(capacity, dev)
    vpos, a0, a1, ni = table
    _launch("plane_launch", (
        codes.data_ptr(), quals.data_ptr(), refpos.data_ptr(), N, L,
        int(baseq), vpos.data_ptr(), a0.data_ptr(), a1.data_ptr(),
        ni.data_ptr(), vpos.shape[0], out.data_ptr(), capacity,
        _stream(dev)))
    bump(LAUNCHES, "plane")
    return out


def assign_compact_affine_masked(mcodes: torch.Tensor, start: torch.Tensor,
                                 lo: torch.Tensor, hi: torch.Tensor,
                                 table: Table, capacity: int
                                 ) -> torch.Tensor:
    """Affine reads from the 1 B/base masked plane (BASEQ applied, 15 =
    masked): mcodes (N, L) uint8, start/lo/hi (N,) int32 with
    refpos = start + (i - lo) on [lo, hi).  phaser_tpu's jnp
    assign_compact_affine_masked (kernels/alleles.py:246-259).  The table
    must be position-sorted; each row's table range is found by the program
    itself."""
    dev = mcodes.device
    N, L = mcodes.shape
    _check("mcodes", mcodes, torch.uint8, (N, L), dev)
    for k, t in (("start", start), ("lo", lo), ("hi", hi)):
        _check(k, t, torch.int32, (N,), dev)
    _check_table(table, dev)
    _check_size(N, L, capacity)
    if not _on_cuda(dev):
        return affine_masked_plain(mcodes, start, lo, hi, table, capacity)
    _check_join_table(table)
    out = _new_packed(capacity, dev)
    vpos, a0, a1, ni = table
    _launch("affine_masked_launch", (
        mcodes.data_ptr(), start.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        N, L, vpos.data_ptr(), a0.data_ptr(), a1.data_ptr(), ni.data_ptr(),
        vpos.shape[0], out.data_ptr(), capacity, _stream(dev)))
    bump(LAUNCHES, "affine_masked")
    return out


# ---------------------------------------------------------------------------
# kernel-level entries (phaser_tpu's public layout, vidx / allele planes)
# ---------------------------------------------------------------------------

# shared memory per block for the resident table (4 x int32 per entry)
_MAX_RESIDENT = (227 * 1024) // 16


def _entry_table(codes, quals, refpos, vpos, ind_codes, n_ind) -> Table:
    """Checks the entry's planes and returns its table as four contiguous
    int32 (M,) tensors (vpos, allele 0 code, allele 1 code, n_ind)."""
    dev = codes.device
    N, L = codes.shape
    _check("codes", codes, torch.uint8, (N, L), dev)
    _check("quals", quals, torch.uint8, (N, L), dev)
    _check("refpos", refpos, torch.int32, (N, L), dev)
    M = vpos.shape[0]
    _check("vpos", vpos, torch.int32, (M,), dev)
    _check("ind_codes", ind_codes, torch.uint8, (M, 2), dev)
    _check("n_ind", n_ind, torch.int8, (M,), dev)
    if N * L >= (1 << 31):
        raise ValueError("plane of %d x %d bases exceeds int32 indexing"
                         % (N, L))
    return (vpos, ind_codes[:, 0].to(torch.int32).contiguous(),
            ind_codes[:, 1].to(torch.int32).contiguous(),
            n_ind.to(torch.int32))


def _launch_planes(fn_name: str, counter: str, codes, quals, refpos,
                   baseq: int, ws: torch.Tensor, window: tuple, table: Table,
                   mode: tuple = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches a planes kernel: `window` holds the ints between ws and the
    table ((win, block_rows) or (block_rows,)), `mode` those after mp.

    A warp of these kernels takes 512 consecutive bases of the planes at a
    time.  When L is a multiple of 4 and refpos and both outputs are
    16-byte aligned (fresh torch allocations are), positions are loaded and
    results stored as 16-byte vectors; any other L or alignment takes the
    scalar instantiation, chosen by the launcher.  A window (`win` <= 256
    entries from ws[b]) is staged in shared memory by 16-byte copies where
    ws[b] is a multiple of 4 and the table columns are 16-byte aligned,
    else entry by entry; a wider `win` must be the whole table (ws = [0])."""
    dev = codes.device
    N, L = codes.shape
    vidx = torch.empty((N, L), dtype=torch.int32, device=dev)
    allele = torch.empty((N, L), dtype=torch.int32, device=dev)
    vpos, a0, a1, ni = table
    _launch(fn_name, (codes.data_ptr(), quals.data_ptr(), refpos.data_ptr(),
                      N, L, int(baseq), ws.data_ptr()) + window +
            (vpos.data_ptr(), a0.data_ptr(), a1.data_ptr(), ni.data_ptr(),
             vpos.shape[0]) + mode +
            (vidx.data_ptr(), allele.data_ptr(), _stream(dev)))
    bump(LAUNCHES, counter)
    return vidx, allele


def assign_alleles_device(codes: torch.Tensor, quals: torch.Tensor,
                          refpos: torch.Tensor, vpos: torch.Tensor,
                          ind_codes: torch.Tensor, n_ind: torch.Tensor,
                          baseq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-base hit classification against the whole table (phaser_tpu
    kernels/alleles.py:33-63).  codes/quals (N, L) uint8, refpos (N, L)
    int32 (0 = unaligned), vpos (M,) sorted int32, ind_codes (M, 2) uint8,
    n_ind (M,) int8.  Returns (vidx, allele) (N, L) int32: vidx = the
    lower-bound table index of a hit, else -1; allele 0/1 = individual
    allele index, 2 = OTHER, 3 = NO_HIT.  On CUDA tensors: the planes
    kernel with one whole-table window, counted as "planes_table" where
    that is the whole-table mode (M > 256, `planes_table_kernel`), else as
    "planes" (a table that fits one window)."""
    table = _entry_table(codes, quals, refpos, vpos, ind_codes, n_ind)
    N, L = codes.shape
    M = vpos.shape[0]
    ws = torch.zeros(1, dtype=torch.int32, device=codes.device)
    if not _on_cuda(codes.device) or M == 0 or N == 0:
        return planes_plain(codes, quals, refpos, baseq, ws, M, max(N, 1),
                            table)
    return _launch_planes("planes_launch",
                          "planes_table" if M > _WIN else "planes", codes,
                          quals, refpos, baseq, ws, (M, max(N, 1)), table,
                          (0,))


def compact_hits(vidx: torch.Tensor, allele: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Stream-compact per-base hits into (read, var, allele) int32 triplets
    of length `capacity`, -1 padded, in row-major order (phaser_tpu
    kernels/alleles.py:66-89).  Returns (read_idx, var_idx, allele_class,
    n_hits); n_hits is exact past capacity."""
    N, L = vidx.shape
    flat = torch.nonzero(allele.reshape(-1) < NO_HIT).squeeze(1)
    n = int(flat.numel())
    k = min(n, capacity)
    out = torch.full((3, capacity), -1, dtype=torch.int32, device=vidx.device)
    out[0, :k] = (flat[:k] // L).to(torch.int32)
    out[1, :k] = vidx.reshape(-1)[flat[:k]]
    out[2, :k] = allele.reshape(-1)[flat[:k]]
    return out[0], out[1], out[2], n


def assign_alleles_pallas_windowed(codes: torch.Tensor, quals: torch.Tensor,
                                   refpos: torch.Tensor, vpos: torch.Tensor,
                                   ind_codes: torch.Tensor,
                                   n_ind: torch.Tensor, baseq: int,
                                   block_rows: int = 256,
                                   refpos_host: Optional[np.ndarray] = None,
                                   vpos_host: Optional[np.ndarray] = None,
                                   algo: str = "gather"
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """assign_alleles_device through planned 256-entry table windows
    (phaser_tpu kernels/alleles.py:813-876).  Windows are planned on the
    host from a CPU copy of refpos (`refpos_host`, else copied here) and of
    vpos (`vpos_host`).  Where no plan fits (N or M zero, L % 128 != 0, or
    a block's variant band overflows the window) this returns
    assign_alleles_device, as phaser_tpu does.

    algo="gather" searches the window (the planes kernel); algo="cmp"
    compares every window entry (the planes_cmp kernel), where the LAST
    equal entry wins: the two agree on tables with unique positions, which
    the dispatcher guarantees (duplicate positions go to the host mapper)."""
    if algo not in ("gather", "cmp"):
        raise ValueError("algo must be 'gather' or 'cmp', not %r" % (algo,))
    table = _entry_table(codes, quals, refpos, vpos, ind_codes, n_ind)
    N, L = codes.shape
    M = vpos.shape[0]
    if N == 0 or M == 0 or L % 128 != 0:
        return assign_alleles_device(codes, quals, refpos, vpos, ind_codes,
                                     n_ind, baseq)
    R = min(block_rows, max(N, 1))
    rp = refpos.cpu().numpy() if refpos_host is None else refpos_host
    vp = vpos.cpu().numpy() if vpos_host is None else vpos_host
    ws = plan_windows_plane(rp, vp, R)
    if ws is None:
        return assign_alleles_device(codes, quals, refpos, vpos, ind_codes,
                                     n_ind, baseq)
    ws = torch.from_numpy(ws).to(codes.device)
    if algo == "cmp":
        if not _on_cuda(codes.device):
            return planes_cmp_plain(codes, quals, refpos, baseq, ws, R, table)
        return _launch_planes("planes_cmp_launch", "planes_cmp", codes, quals,
                              refpos, baseq, ws, (R,), table)
    if not _on_cuda(codes.device):
        return planes_plain(codes, quals, refpos, baseq, ws, _WIN, R, table)
    return _launch_planes("planes_launch", "planes", codes, quals, refpos,
                          baseq, ws, (_WIN, R), table, (0,))


def assign_alleles_pallas(codes: torch.Tensor, quals: torch.Tensor,
                          refpos: torch.Tensor, vpos: torch.Tensor,
                          ind_codes: torch.Tensor, n_ind: torch.Tensor,
                          baseq: int, block_rows: int = 256
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """assign_alleles_device with the whole table resident (phaser_tpu
    kernels/alleles.py:1062-1118): when next_pow2(M) <= L the planes kernel
    stages the table in shared memory; wider tables go to
    assign_alleles_pallas_windowed, as in phaser_tpu."""
    table = _entry_table(codes, quals, refpos, vpos, ind_codes, n_ind)
    N, L = codes.shape
    M = vpos.shape[0]
    if _next_pow2(M) > L:
        return assign_alleles_pallas_windowed(codes, quals, refpos, vpos,
                                              ind_codes, n_ind, baseq,
                                              block_rows=block_rows)
    ws = torch.zeros(1, dtype=torch.int32, device=codes.device)
    if not _on_cuda(codes.device) or M == 0 or N == 0:
        return planes_plain(codes, quals, refpos, baseq, ws, M, max(N, 1),
                            table)
    if M > _MAX_RESIDENT:
        raise ValueError("a resident table of %d entries exceeds shared "
                         "memory (%d entries)" % (M, _MAX_RESIDENT))
    return _launch_planes("planes_launch", "planes_resident", codes, quals,
                          refpos, baseq, ws, (M, max(N, 1)), table, (1,))
