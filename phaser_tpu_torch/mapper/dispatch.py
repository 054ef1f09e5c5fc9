"""GPU/host dispatch for allele assignment (the port of
phaser_tpu/mapper/dispatch.py).

The GPU kernels (kernels.alleles) take the common cases: affine reads as a
nibble-packed masked plane with refpos rebuilt on the device (a 1 B/base
masked plane when the native nibble packer is missing), deletion / split-M
reads as nibble plane + int16 delta, and N-spliced reads (or delta overflow,
or every non-affine read when the delta packer is missing) as an explicit
refpos plane.  The affine-nibble and plane kernels find each row's table
range on the card; only the delta-nibble path still plans table windows on
the host.  The exact host mapper (mapper.host) keeps the remainder: insertion reads, multi-base
alleles and duplicate-position table entries.  Row union and order equal
the pure host path.

Before any per-read work the device side drops every read whose reference
span holds no device-eligible variant (`_read_spans`; the span's end can
only be too large, so a dropped read has no hit); packers, uploads and
kernels see the kept rows only and hits map back through each part's
`row_map`.  Uploads go through pinned staging buffers (`_Stager`).

`assign_alleles_auto(..., defer=True)` launches and returns a PendingHits;
`resolve()` (or `resolve_all` over many chunks) fetches every part's hit
counter in one small copy, then only the filled columns of the packed
buffers in one more, and merges them with the host parts.

`device` is "host" (exact host mapper), "cuda"/"auto" (the CUDA kernels;
raises without a GPU) or "cpu" (the kernels' plain PyTorch versions on CPU
tensors, the test path), or a torch.device.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..engine.varmap import VariantTable
from ..io.bam import (BamData, OP_EQ, OP_H, OP_I, OP_M, OP_N, OP_S, OP_X)
from ..kernels.alleles import _n_threads
from ..kernels.alleles import _next_pow2
from .host import ContigHits, assign_alleles

from ..utils.counters import bump

_SUB_ROWS = 1 << 18          # max reads per kernel launch
# max table entries per launch: the packed-hit word holds a table index
# below 2^23 and the table pads to a power of two; larger tables launch
# in slices
_MAX_TABLE = 1 << 22
_cap_feedback: dict = {}     # (kind, pow2 row bucket, L) -> max hits observed
_cap_loaded = False
_cap_lock = threading.Lock()  # guards the table, its load and the cap file
# chunks relaunched on their device after a hit-capacity overflow
RELAUNCHES = {"capacity": 0}


# what the last calls did, for the smoke and the tests: reads offered to the
# device side / kept by the pre-filter / dropped; packed-hit buffers fetched,
# their columns copied back / needed (min(n_hits, cap) + 1 a part) /
# allocated; host-to-device copies, and those from pinned memory
STATS = {"rows_in": 0, "rows_kept": 0, "rows_dropped": 0,
         "parts_fetched": 0, "columns_fetched": 0, "columns_needed": 0,
         "columns_allocated": 0,
         "uploads": 0, "uploads_pinned": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _per_read_sum(vals: np.ndarray, cigar_off: np.ndarray) -> np.ndarray:
    """Sum of the per-op `vals` over each read's ops (0 for a read without
    ops, which `reduceat` alone would give its neighbour's first op)."""
    out = np.zeros(len(cigar_off) - 1, np.int64)
    has_ops = cigar_off[:-1] < cigar_off[1:]
    if has_ops.any():
        # reads without ops own no entry of vals, so the segments of the
        # others are consecutive
        out[has_ops] = np.add.reduceat(vals.astype(np.int64),
                                       cigar_off[:-1][has_ops])
    return out


def _read_op_masks(bd: BamData):
    opc = (bd.cigar_flat & 0xF)
    has_ins = _per_read_sum(opc == OP_I, bd.cigar_off) > 0
    has_n = _per_read_sum(opc == OP_N, bd.cigar_off) > 0
    return has_ins, has_n


def _read_spans(bd: BamData, dev_pos: np.ndarray):
    """(has_ins, has_n, near) per read.  `near`: a position of the sorted
    `dev_pos` (1-based) lies in [pos + 1, pos + total], total the sum of ALL
    the read's CIGAR op lengths.  BamData has no end column; this end can
    only be too large (clips and insertions count as reference bases), so
    a read that is not `near` has no aligned base on a device variant.
    bd.pos is 0-based.  One native pass, else numpy."""
    n = len(bd)
    dev_pos = np.ascontiguousarray(dev_pos, np.int64)
    from ..io import native as native_mod
    lib = native_mod.get_lib()
    if lib is not None and hasattr(lib, "read_spans_native"):
        out = [np.empty(n, np.uint8) for _ in range(3)]
        arrs = (np.ascontiguousarray(bd.pos, np.int32),
                np.ascontiguousarray(bd.cigar_flat, np.uint32),
                np.ascontiguousarray(bd.cigar_off, np.int64))
        ptr = ctypes.c_void_p
        lib.read_spans_native(
            n, *[a.ctypes.data_as(ptr) for a in arrs], len(dev_pos),
            dev_pos.ctypes.data_as(ptr), *[o.ctypes.data_as(ptr) for o in out],
            _n_threads())
        return tuple(o.view(bool) for o in out)
    has_ins, has_n = _read_op_masks(bd)
    first = bd.pos.astype(np.int64) + 1
    last = bd.pos.astype(np.int64) + _per_read_sum(bd.cigar_flat >> 4,
                                                   bd.cigar_off)
    near = np.searchsorted(dev_pos, first, side="left") < \
        np.searchsorted(dev_pos, last, side="right")
    return has_ins, has_n, near


def _affine_params(bd: BamData):
    """Per-read affine classification: reads whose CIGAR is one contiguous
    M/=/X run plus end clips (S/H) have refpos[i] = pos+1 + (i - lo) on
    [lo, hi) and 0 elsewhere. Returns (is_affine, start, lo, hi); reads
    classified non-affine (D/N/I/P or split M runs) are simply routed to
    the refpos-plane or host paths — classification is conservative."""
    n = len(bd)
    opc = (bd.cigar_flat & 0xF).astype(np.int64)
    oplen = (bd.cigar_flat >> 4).astype(np.int64)
    ops_per_read = np.diff(bd.cigar_off)
    op_read = np.repeat(np.arange(n), ops_per_read)
    within = np.arange(len(opc)) - np.repeat(bd.cigar_off[:-1], ops_per_read)

    is_m = (opc == OP_M) | (opc == OP_EQ) | (opc == OP_X)
    allowed = is_m | (opc == OP_S) | (opc == OP_H)
    has_bad = np.zeros(n, bool)
    np.logical_or.at(has_bad, op_read, ~allowed)

    n_m = np.zeros(n, np.int64)
    np.add.at(n_m, op_read, is_m.astype(np.int64))
    first_m = np.full(n, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_m, op_read[is_m], within[is_m])
    last_m = np.full(n, -1, np.int64)
    np.maximum.at(last_m, op_read[is_m], within[is_m])
    contig_m = (n_m >= 1) & (last_m - first_m + 1 == n_m)
    is_affine = ~has_bad & contig_m

    lo = np.zeros(n, np.int64)
    lead_s = (opc == OP_S) & (within < first_m[op_read])
    np.add.at(lo, op_read[lead_s], oplen[lead_s])
    m_total = np.zeros(n, np.int64)
    np.add.at(m_total, op_read[is_m], oplen[is_m])
    start = bd.pos.astype(np.int64) + 1
    return is_affine, start.astype(np.int32), lo.astype(np.int32), \
        (lo + m_total).astype(np.int32)


def resolve_device(device) -> torch.device:
    """torch.device for a non-host `device` argument; "auto" means "cuda".
    Raises RuntimeError when CUDA is asked for and unavailable."""
    if isinstance(device, str) and device == "auto":
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r needs a CUDA GPU, but torch.cuda.is_available() is "
            "False (use --device host or --device cpu)" % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % str(device))
    return dev


def _cap_path() -> str:
    import os
    base = os.environ.get("PHASER_TPU_TORCH_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "phaser_tpu_torch")
    return os.path.join(base, "hit_caps.json")


def _cap_load() -> None:
    """Fills the feedback table from the cap file once per process.  The
    flag is set only after the table is filled, under the lock, so a shard
    thread never sizes its launches from a half-read table."""
    global _cap_loaded
    with _cap_lock:
        if _cap_loaded:
            return
        import json
        try:
            with open(_cap_path()) as f:
                for k, v in json.load(f).items():
                    kind, np_, l_ = k.rsplit(":", 2)
                    _cap_feedback[(kind, int(np_), int(l_))] = int(v)
        except (OSError, ValueError):
            pass
        _cap_loaded = True


def _cap_save() -> None:
    """Atomic write (tmp + os.replace), merged with the on-disk contents so
    concurrent processes don't drop each other's learned caps."""
    import json
    import os
    import tempfile
    try:
        merged = dict(_cap_feedback)
        try:
            with open(_cap_path()) as f:
                for k, v in json.load(f).items():
                    kind, np_, l_ = k.rsplit(":", 2)
                    kk = (kind, int(np_), int(l_))
                    merged[kk] = max(int(v), merged.get(kk, 0))
        except (OSError, ValueError):
            pass
        os.makedirs(os.path.dirname(_cap_path()), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_cap_path()),
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"%s:%d:%d" % k: v for k, v in merged.items()}, f)
        os.replace(tmp, _cap_path())
    except OSError:
        pass


def _adaptive_cap(fb_key, n_elems: int) -> int:
    """Packed-hit capacity for a launch bucket: elements/32 until a resolve
    reports real hit counts, then 8x the bucket's maximum.  An overflow
    relaunches the chunk on its device once the exact counts are recorded.
    Feedback persists in $PHASER_TPU_TORCH_CACHE/hit_caps.json."""
    _cap_load()
    seen = _cap_feedback.get(fb_key, 0)
    if seen:
        return _next_pow2(max(8 * seen, 8192))
    return _next_pow2(max(n_elems // 32, 8192))


def require_device(device) -> None:
    """Raises when `device` asks for the card and there is none; "host" and
    "off" need no device.  What every entry point calls first, so that a
    run without a card fails before it computes anything."""
    if device not in ("host", "off"):
        resolve_device(device)


class PendingHits:
    """Launched GPU work + completed host parts for one chunk.

    resolve() copies the packed hits to the host and merges; it is safe to
    call long after launch (device buffers are held alive here).  When a
    launch's hit count exceeds its capacity, resolve() records every
    launch's exact count and calls `relaunch`, which runs the chunk again on
    the same device with capacities that now hold those counts."""

    def __init__(self, relaunch: Optional[Callable[[], ContigHits]],
                 dev_parts: List[Tuple[torch.Tensor, int, np.ndarray,
                                       np.ndarray, tuple]],
                 host_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 hits_map: dict, done: Optional[torch.cuda.Event] = None,
                 clock=None):
        self._relaunch = relaunch
        # (packed_dev, cap, row_map, dev_vidx, fb_key); row_map: the chunk
        # row of each row of the launch
        self._dev = dev_parts
        self._host = host_parts        # (read_idx, var_idx, codes16)
        self._map = hits_map
        self._done = done              # recorded after the last launch
        self._clock = clock            # DeviceClock of uploads and launches

    def wait(self) -> None:
        """Block until every launched kernel of this chunk has finished."""
        if self._done is not None:
            self._done.synchronize()

    def resolve(self, prefetched: Optional[List[np.ndarray]] = None
                ) -> ContigHits:
        from ..kernels.alleles import decode_packed_hits

        if prefetched is None:
            prefetched = _fetch(self._dev)
        if self._clock is not None:
            self._clock.collect()
        rows_parts = list(self._host)
        overflow = False
        for full, (packed, cap, row_map, dev_vidx, fb_key) in \
                zip(prefetched, self._dev):
            r, v, a, mc, nh = decode_packed_hits(full)
            with _cap_lock:
                if nh > _cap_feedback.get(fb_key, 0):
                    _cap_feedback[fb_key] = nh
                    _cap_save()
            overflow |= nh > cap
            # the observed masked nibble IS the allele code
            rows_parts.append((row_map[r], dev_vidx[v], mc))
        if overflow:
            # the counts stay exact past capacity and are recorded above, so
            # the relaunch's capacities hold every launch's hits (rare)
            if self._relaunch is None:
                raise RuntimeError("hit capacity overflowed again on relaunch")
            bump(RELAUNCHES, "capacity")
            return self._relaunch()

        if not rows_parts:
            return ContigHits(np.zeros(0, np.int64), np.zeros(0, np.int64),
                              np.zeros(0, np.int16))
        all_r = np.concatenate([p[0] for p in rows_parts]).astype(np.int64)
        all_v = np.concatenate([p[1] for p in rows_parts]).astype(np.int64)
        all_c = np.concatenate([p[2] for p in rows_parts]).astype(np.int16)
        order = np.lexsort((all_v, all_r))
        hits = ContigHits(all_r[order], all_v[order], all_c[order])
        if self._map:
            # rows are sorted by (read, variant): find each multi-base
            # allele's rows by its key, not by a pass over every hit
            n_var = int(hits.var_idx.max()) + 1
            rank = hits.read_idx * n_var + hits.var_idx
            keys = np.array(list(self._map), np.int64).reshape(-1, 2)
            want = keys[:, 0] * n_var + keys[:, 1]
            lo = np.searchsorted(rank, want, side="left")
            hi = np.searchsorted(rank, want, side="right")
            found = sorted((newpos, s) for a, b, s in
                           zip(lo.tolist(), hi.tolist(), self._map.values())
                           for newpos in range(a, b))
            for newpos, s in found:  # in row order, as a pass over hits
                hits.allele_strs[newpos] = s
                hits.allele_code[newpos] = -1
        return hits


def _fetch(parts: list) -> List[np.ndarray]:
    """The filled columns of every part's packed-hit buffer, in two
    device->host copies: the hit counters (out[0, 0] of each part), then
    min(n_hits, cap) + 1 columns of each part, concatenated.  A view of
    cap + 1 columns still says overflow to decode_packed_hits (n_hits >
    columns - 1); a shorter one decodes as a buffer of capacity n_hits."""
    if not parts:
        return []
    from ..utils.trace import DeviceClock
    bufs = [pt[0] for pt in parts]
    clock = DeviceClock(bufs[0].device)
    with clock.span():
        counts = torch.stack([b[0, 0] for b in bufs]).cpu().numpy()
    widths = [min(int(n), pt[1]) + 1 for n, pt in zip(counts, parts)]
    with clock.span():
        full = torch.cat([b[:, :w] for b, w in zip(bufs, widths)],
                         dim=1).cpu().numpy()
    clock.collect()
    bump(STATS, "parts_fetched", len(parts))
    bump(STATS, "columns_fetched", int(full.shape[1]))
    bump(STATS, "columns_needed",
         sum(min(int(n), pt[1]) + 1 for n, pt in zip(counts, parts)))
    bump(STATS, "columns_allocated", sum(int(b.shape[1]) for b in bufs))
    views, off = [], 0
    for w in widths:
        views.append(full[:, off:off + w])
        off += w
    return views


class _Stager:
    """Pinned staging buffers of one thread, used in turn.  An array is
    copied into a buffer and from there to the card with a non-blocking
    copy; the buffer's event says when that copy is done, and the next use
    of the buffer waits for it.  The caller's array (a packer's reused
    scratch) is free again as soon as `upload` returns."""

    SLOTS = 4

    def __init__(self):
        self._bufs = [None] * self.SLOTS
        self._events = [None] * self.SLOTS
        self._next = 0

    def upload(self, x: np.ndarray, dev: torch.device, clock) -> torch.Tensor:
        k = self._next
        self._next = (k + 1) % self.SLOTS
        if self._events[k] is not None:
            self._events[k].synchronize()   # the slot's last copy is done
        buf = self._bufs[k]
        if buf is None or buf.numel() < x.nbytes:
            grown = max(x.nbytes, 2 * (buf.numel() if buf is not None else 0),
                        1 << 16)
            buf = self._bufs[k] = torch.empty(grown, dtype=torch.uint8,
                                              pin_memory=True)
        host = buf[:x.nbytes].view(torch.from_numpy(x[:0].ravel()).dtype) \
            .view(x.shape)
        np.copyto(host.numpy(), x)
        out = torch.empty(x.shape, dtype=host.dtype, device=dev)
        with clock.span():
            out.copy_(host, non_blocking=True)
        self._events[k] = torch.cuda.Event()
        self._events[k].record(torch.cuda.current_stream(dev))
        return out


_stage_tls = threading.local()


def _upload(x: np.ndarray, dev: torch.device, clock) -> torch.Tensor:
    """`x` as a tensor on `dev`.  To a card: through this thread's pinned
    staging buffers, non-blocking.  On the CPU the tensor aliases `x`."""
    x = np.ascontiguousarray(x)
    if dev.type == "cpu":
        return torch.from_numpy(x)
    bump(STATS, "uploads")
    if x.nbytes == 0:
        return torch.from_numpy(x).to(dev)
    stager = getattr(_stage_tls, "stager", None)
    if stager is None:
        stager = _stage_tls.stager = _Stager()
    out = stager.upload(x, dev, clock)
    bump(STATS, "uploads_pinned")
    return out


def assign_alleles_auto(bd: BamData, vt: VariantTable, *, baseq: int,
                        splice: bool = True, isize_cutoff: float = 0,
                        device="cuda", defer: bool = False):
    """GPU-accelerated assign_alleles with exact host remainders.

    With defer=True returns a PendingHits (launch only); otherwise returns
    the resolved ContigHits directly."""
    if device in ("host", "off") or len(bd) == 0 or len(vt) == 0:
        hits = assign_alleles(bd, vt, baseq=baseq, splice=splice,
                              isize_cutoff=isize_cutoff)
        return _ResolvedPending(hits) if defer else hits
    dev = resolve_device(device)
    from ..kernels import alleles as K
    from ..utils.trace import DeviceClock

    if np.any(np.diff(vt.pos) < 0):
        raise ValueError("variant table must be position-sorted")

    # device-eligible variants: simple alleles at unique positions
    pos = vt.pos
    dup = np.zeros(len(vt), bool)
    if len(vt) > 1:
        d = np.diff(pos) == 0
        dup[1:] |= d
        dup[:-1] |= d
    dev_var = vt.is_simple & ~dup
    dev_vidx = np.flatnonzero(dev_var)

    has_ins, has_n, near = _read_spans(bd, pos[dev_vidx])
    keep_read = np.ones(len(bd), bool)
    if isize_cutoff != 0:
        keep_read &= np.abs(bd.tlen.astype(np.int64)) <= isize_cutoff
    if not splice:
        keep_read &= ~has_n

    # the device side: eligible reads whose span holds a device variant.
    # Everything below works on these rows and maps back through `kept`.
    dev_read = keep_read & ~has_ins
    kept = np.flatnonzero(dev_read & near)
    n_dev = int(dev_read.sum())
    bump(STATS, "rows_in", n_dev)
    bump(STATS, "rows_kept", int(kept.size))
    bump(STATS, "rows_dropped", n_dev - int(kept.size))
    # torch.from_numpy aliases on the CPU: packer scratch reuse is only safe
    # where the upload is a real copy
    reuse = dev.type == "cuda"

    dev_parts = []
    host_parts = []
    clock = DeviceClock(dev)

    def launch(fn, *args):
        with clock.span():
            return fn(*args)

    if kept.size:
        # the packers fill row i from read kept[i]: no gathered copy of the
        # kept reads (without the native library they gather their own)
        rows = None if kept.size == len(bd) else kept
        # packer order of phaser_tpu (mapper/dispatch.py:308-332): the
        # nibble plane, else the 1 B/base masked plane, else the numpy
        # affine classifier with codes/quals planes masked here
        nibble = K.pack_affine_nibble(bd, baseq, reuse=reuse, rows=rows)
        if nibble is not None:
            mcodes, aff, a_start, a_lo, a_hi = nibble
        else:
            masked = K.pack_affine_masked(bd, baseq, reuse=reuse, rows=rows)
            if masked is not None:
                mcodes, aff, a_start, a_lo, a_hi = masked
            else:
                sub = bd if rows is None else bd.select(rows)
                aff, a_start, a_lo, a_hi = _affine_params(sub)
                codes, quals = K.pack_codes_quals(sub, reuse=reuse)
                mcodes = np.where(quals >= baseq, codes,
                                  np.uint8(15)).astype(np.uint8)
        N, Lw = mcodes.shape
        # bases per row: the nibble plane packs two per byte
        L_bases = 2 * Lw if nibble is not None else Lw
        st_k = np.where(aff, a_start, 0).astype(np.int32)
        lo_k = np.where(aff, a_lo, 0).astype(np.int32)
        hi_k = np.where(aff, a_hi, 0).astype(np.int32)
        plane_all = np.flatnonzero(~aff)

        for t in range(0, dev_vidx.size, _MAX_TABLE):
            tab_vidx = dev_vidx[t:t + _MAX_TABLE]
            table = tuple(_upload(x, dev, clock)
                          for x in K.padded_table(vt, tab_vidx))

            # affine fast path: masked plane (BASEQ pre-applied), refpos
            # rebuilt on the device, in <= _SUB_ROWS-row launches
            for s in range(0, N if aff.any() else 0, _SUB_ROWS):
                e = min(s + _SUB_ROWS, N)
                if not aff[s:e].any():
                    continue
                n_sub = e - s
                args = [_upload(x[s:e], dev, clock)
                        for x in (mcodes, st_k, lo_k, hi_k)]
                # either kernel finds each row's table range on the card
                if nibble is not None:
                    fb_key = ("affine_nib", _next_pow2(max(n_sub, 8)), Lw)
                    cap = _adaptive_cap(fb_key, n_sub * L_bases)
                    packed = launch(K.assign_compact_affine_nibble, *args,
                                    table, cap)
                else:
                    fb_key = ("affine", _next_pow2(max(n_sub, 8)), Lw)
                    cap = _adaptive_cap(fb_key, n_sub * L_bases)
                    packed = launch(K.assign_compact_affine_masked, *args,
                                    table, cap)
                dev_parts.append((packed, cap, kept[s:e], tab_vidx, fb_key))

            for s in range(0, plane_all.size, _SUB_ROWS):
                # non-affine remainder: delta-nibble format for D/split-M
                # reads, refpos plane only for what delta can't carry
                # (N-spliced reads, delta overflow) or for every read when
                # the delta packer is missing
                plane_rows = kept[plane_all[s:s + _SUB_ROWS]]
                dn = K.pack_delta_nibble(bd, baseq, reuse=reuse,
                                         rows=plane_rows)
                if dn is not None:
                    ncd, dlt, okm, dst, rmn, rmx = dn
                    ok_idx = np.flatnonzero(okm)
                else:
                    ok_idx = np.zeros(0, np.int64)
                if ok_idx.size:
                    Nd = ok_idx.size
                    Ld = dlt.shape[1]
                    # the packer's per-row [rp_min, rp_max] is all the
                    # kernel needs to find each row's table range
                    fb_key = ("delta_nib", _next_pow2(max(Nd, 8)), Ld)
                    cap_d = _adaptive_cap(fb_key, Nd * Ld)
                    packed_d = launch(
                        K.assign_compact_delta_nibble,
                        *[_upload(x[ok_idx], dev, clock)
                          for x in (ncd, dst, dlt, rmn, rmx)], table, cap_d)
                    dev_parts.append((packed_d, cap_d, plane_rows[ok_idx],
                                      tab_vidx, fb_key))
                if dn is not None:
                    plane_rows = plane_rows[~okm]
                    if plane_rows.size == 0:
                        continue
                codes2, quals2, refpos2 = K.pack_reads(bd, rows=plane_rows)
                N2, L2 = codes2.shape
                fb_key = ("plane", _next_pow2(max(N2, 8)), L2)
                cap2 = _adaptive_cap(fb_key, N2 * L2)
                packed2 = launch(
                    K.assign_compact_plane, _upload(codes2, dev, clock),
                    _upload(quals2, dev, clock), _upload(refpos2, dev, clock),
                    baseq, table, cap2)
                dev_parts.append((packed2, cap2, plane_rows, tab_vidx,
                                  fb_key))
    done = None
    if dev.type == "cuda" and dev_parts:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))

    # host remainder 1: insertion reads vs all variants
    hits_map = {}
    ins_sel = np.flatnonzero(has_ins & keep_read)
    if ins_sel.size:
        sub = bd.select(ins_sel)
        h = assign_alleles(sub, vt, baseq=baseq, splice=splice,
                           isize_cutoff=isize_cutoff)
        rr = ins_sel[h.read_idx]
        host_parts.append((rr, h.var_idx.copy(), h.allele_code.copy()))
        for row, s in h.allele_strs.items():
            hits_map[(int(rr[row]), int(h.var_idx[row]))] = s

    # host remainder 2: non-device variants vs non-insertion reads
    rem_vidx = np.flatnonzero(~dev_var)
    nonins_sel = np.flatnonzero(~has_ins)
    if rem_vidx.size and nonins_sel.size:
        sub_vt = VariantTable(
            chrom=vt.chrom, pos=vt.pos[rem_vidx],
            unique_ids=[vt.unique_ids[i] for i in rem_vidx],
            rs_ids=[vt.rs_ids[i] for i in rem_vidx],
            all_alleles=[vt.all_alleles[i] for i in rem_vidx],
            ref_len=vt.ref_len[rem_vidx],
            geno_strings=[vt.geno_strings[i] for i in rem_vidx],
            maf_strs=[vt.maf_strs[i] for i in rem_vidx])
        sub_vt.finalize()
        sub = bd.select(nonins_sel)
        h = assign_alleles(sub, sub_vt, baseq=baseq, splice=splice,
                           isize_cutoff=isize_cutoff)
        rr = nonins_sel[h.read_idx]
        vv = rem_vidx[h.var_idx]
        host_parts.append((rr, vv, h.allele_code.copy()))
        for row, s in h.allele_strs.items():
            hits_map[(int(rr[row]), int(vv[row]))] = s

    def _relaunch():
        # the same call, so the same pre-filter
        again = assign_alleles_auto(bd, vt, baseq=baseq, splice=splice,
                                    isize_cutoff=isize_cutoff, device=dev,
                                    defer=True)
        if isinstance(again, PendingHits):
            again._relaunch = None  # its capacities hold the exact counts
        return again.resolve()

    pending = PendingHits(_relaunch, dev_parts, host_parts, hits_map, done,
                          clock)
    return pending if defer else pending.resolve()


class _ResolvedPending:
    """PendingHits-compatible wrapper around an already-resolved result."""

    def __init__(self, hits: ContigHits):
        self._hits = hits

    def wait(self) -> None:
        pass

    def resolve(self, prefetched=None) -> ContigHits:
        return self._hits


def resolve_all(pendings: List) -> List[ContigHits]:
    """Resolve many launched chunks with one fetch (`_fetch`: two
    device->host copies over all their parts)."""
    parts = []
    for p in pendings:
        if isinstance(p, PendingHits):
            parts.extend(p._dev)
    views = _fetch(parts)

    out: List[ContigHits] = []
    vi = 0
    for p in pendings:
        if isinstance(p, PendingHits):
            k = len(p._dev)
            out.append(p.resolve(prefetched=views[vi:vi + k]))
            vi += k
        else:
            out.append(p.resolve())
    return out
