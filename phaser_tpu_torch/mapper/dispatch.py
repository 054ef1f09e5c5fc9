"""GPU/host dispatch for allele assignment (the port of
phaser_tpu/mapper/dispatch.py).

One device route carries every non-insertion read: the reads go to the
card as BAM decode stores them (pos, the ragged CIGAR words, one byte of
seq and one of qual a base), and the ragged_join kernel
(kernels.alleles.assign_compact_ragged) finds each read's reference
positions from its CIGAR and its table range on the card.  phaser_tpu's
dispatcher packs the reads on the host into padded planes first (a nibble
plane with refpos rebuilt on the device for affine reads, nibble + int16
delta planes for D / split-M reads, an explicit refpos plane for the
rest): TPU shapes, which the port keeps as library entries on no path
here.  The exact host mapper (mapper.host) keeps the remainder: insertion
reads, multi-base alleles and duplicate-position table entries.  Row union
and order equal the pure host path.

Before any per-read work the device side drops every read whose reference
span holds no device-eligible variant (`_read_spans`; the span's end can
only be too large, so a dropped read has no hit); the gather, the uploads
and the kernel see the kept rows only, and hits map back through each
part's `row_map`.  A launch's reads are gathered straight into this
thread's pinned staging (`_Stager`) and cross to the card in one copy.

`assign_alleles_auto(..., defer=True)` launches and returns a PendingHits;
`resolve()` (or `resolve_all` over many chunks) fetches every part's hit
counter in one small copy, then only the filled columns of the packed
buffers in one more, and merges them with the host parts.

`device` is "host" (exact host mapper), "cuda" (the CUDA kernel; raises
without a GPU), "auto" (AUTO_ON_CARD's route: the card or the host
mapper, by the H100 measurements beside it; raises without a GPU all the
same), "cpu" (the kernel's plain PyTorch version on CPU tensors, the test
path), or a torch.device.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..engine.varmap import VariantTable
from ..io.bam import BamData, OP_I, OP_N
from ..kernels.alleles import SPAN_INS, SPAN_SPLICED
from ..kernels.alleles import _n_threads
from ..kernels.alleles import _next_pow2
from .host import ContigHits, assign_alleles

from ..utils.counters import bump

# max reads per kernel launch: the ragged join takes a block a 256-read
# tile, so a launch's rows are bounded by its pinned staging (about 210 B
# a read at 100 bp), not by the kernel; a chromosome's kept reads (332,907
# of 5M in chip_smoke.py phase 3) take one launch a table slice
_SUB_ROWS = 1 << 19
# max bases (and CIGAR ops) per launch: the kernel's row offsets are int32
_SUB_BASES = 1 << 30
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
# allocated; host-to-device copies, and those from pinned memory; the
# waits for a pinned staging buffer whose last copy was still running
STATS = {"rows_in": 0, "rows_kept": 0, "rows_dropped": 0,
         "parts_fetched": 0, "columns_fetched": 0, "columns_needed": 0,
         "columns_allocated": 0,
         "uploads": 0, "uploads_pinned": 0, "stager_waits": 0}


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
    the read's CIGAR op lengths.  This end can only be too large (clips and
    insertions count as reference bases), so a read that is not `near` has
    no aligned base on a device variant.  bd.pos is 0-based.  From the span
    summary the native BAM decode writes (BamData.span_end / span_flags: a
    merge with the table, the fastest of the three ways chip_smoke.py
    phase 3 times, a kernel among them), else one native pass over the
    CIGARs, else numpy."""
    n = len(bd)
    dev_pos = np.ascontiguousarray(dev_pos, np.int64)
    from ..io import native as native_mod
    lib = native_mod.get_lib()
    ptr = ctypes.c_void_p
    if bd.span_end is not None and hasattr(lib, "near_sorted_native"):
        near = np.empty(n, np.uint8)
        lib.near_sorted_native(
            n, np.ascontiguousarray(bd.pos, np.int32).ctypes.data_as(ptr),
            np.ascontiguousarray(bd.span_end, np.int32).ctypes.data_as(ptr),
            len(dev_pos), dev_pos.ctypes.data_as(ptr),
            near.ctypes.data_as(ptr), _n_threads())
        return ((bd.span_flags & SPAN_INS) != 0,
                (bd.span_flags & SPAN_SPLICED) != 0, near.view(bool))
    if hasattr(lib, "read_spans_native"):
        out = [np.empty(n, np.uint8) for _ in range(3)]
        arrs = (np.ascontiguousarray(bd.pos, np.int32),
                np.ascontiguousarray(bd.cigar_flat, np.uint32),
                np.ascontiguousarray(bd.cigar_off, np.int64))
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


def resolve_device(device) -> torch.device:
    """torch.device for a non-host `device` argument; "auto" asks for the
    card ("cuda"): a stage that `auto` routes to the host never calls this.
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


# --device auto sends #2 allele assignment to the card (True) or to the host
# mapper (False): the card only where its wall beat the host's in every run.
# chip_smoke.py phase 3, the 5M-read call in turns on NVIDIA H100 80GB HBM3,
# 700.00 W, two runs: this route 0.0559-0.0696 s (means 0.0629, 0.0568),
# the host mapper 0.0379-0.0665 s (means 0.0423, 0.0460)
AUTO_ON_CARD = False


def stage_device(device, on_card: bool):
    """The device of one stage: `auto` by the stage's route (on_card: the
    card, "cuda"; else the host code, "host"), any other device as given.
    The entry points ask for the card first (require_device), so `auto`
    without one raises before any stage runs."""
    if isinstance(device, str) and device == "auto":
        return "cuda" if on_card else "host"
    return device


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
        if all_r.size == 0 or (all_r.max() < (1 << 31) and
                               all_v.max() < (1 << 27)):
            # one sort of packed (read, variant, code + 1) keys: the order
            # of a lexsort by (read, variant), whose pairs are unique
            key = (all_r << 32) | (all_v << 5) | (all_c + 1).astype(np.int64)
            key.sort()
            hits = ContigHits(key >> 32, (key >> 5) & ((1 << 27) - 1),
                              ((key & 31) - 1).astype(np.int16))
        else:
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
    """Pinned staging buffers of one thread, used in turn.  A caller
    `reserve`s a buffer, fills it and `send`s it to the card with a
    non-blocking copy; the buffer's event says when that copy is done, and
    the next use of the buffer waits for it.  `upload` does the three for a
    numpy array, which is free again as soon as it returns."""

    SLOTS = 4

    def __init__(self):
        self._bufs = [None] * self.SLOTS
        self._events = [None] * self.SLOTS
        self._next = 0

    def reserve(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        """(slot, pinned uint8 buffer of nbytes) whose last copy is done."""
        k = self._next
        self._next = (k + 1) % self.SLOTS
        done = self._events[k]
        if done is not None and not done.query():
            bump(STATS, "stager_waits")
            done.synchronize()              # the slot's last copy is done
        buf = self._bufs[k]
        if buf is None or buf.numel() < nbytes:
            grown = max(nbytes, 2 * (buf.numel() if buf is not None else 0),
                        1 << 16)
            buf = self._bufs[k] = torch.empty(grown, dtype=torch.uint8,
                                              pin_memory=True)
        return k, buf[:nbytes]

    def send(self, k: int, host: torch.Tensor, dev: torch.device,
             clock) -> torch.Tensor:
        """Slot k's filled buffer `host` (or a view of it) on `dev`."""
        out = torch.empty(host.shape, dtype=host.dtype, device=dev)
        with clock.span():
            out.copy_(host, non_blocking=True)
        self._events[k] = torch.cuda.Event()
        self._events[k].record(torch.cuda.current_stream(dev))
        bump(STATS, "uploads")
        bump(STATS, "uploads_pinned")
        return out

    def upload(self, x: np.ndarray, dev: torch.device, clock) -> torch.Tensor:
        k, buf = self.reserve(x.nbytes)
        host = buf.view(torch.from_numpy(x[:0].ravel()).dtype).view(x.shape)
        host.copy_(torch.from_numpy(x))   # torch copies in parallel
        return self.send(k, host, dev, clock)


_stage_tls = threading.local()


def _stager() -> _Stager:
    stager = getattr(_stage_tls, "stager", None)
    if stager is None:
        stager = _stage_tls.stager = _Stager()
    return stager


def _upload(x: np.ndarray, dev: torch.device, clock) -> torch.Tensor:
    """`x` as a tensor on `dev`.  To a card: through this thread's pinned
    staging buffers, non-blocking.  On the CPU the tensor aliases `x`."""
    x = np.ascontiguousarray(x)
    if dev.type == "cpu":
        return torch.from_numpy(x)
    if x.nbytes == 0:
        bump(STATS, "uploads")
        return torch.from_numpy(x).to(dev)
    return _stager().upload(x, dev, clock)


def _row_offsets(bd: BamData, rows: np.ndarray):
    """(CIGAR, base) int64 offsets from 0 of the reads `rows` laid end to
    end, len(rows) + 1 each (the lengths by the native library's threads,
    else numpy)."""
    from ..io import native as native_mod
    lib = native_mod.get_lib()
    rows = np.ascontiguousarray(rows, np.int64)
    out = []
    for off in (bd.cigar_off, bd.seq_off):
        if hasattr(lib, "row_lengths_native"):
            lens = np.empty(len(rows), np.int64)
            off = np.ascontiguousarray(off, np.int64)
            ptr = ctypes.c_void_p
            lib.row_lengths_native(len(rows), rows.ctypes.data_as(ptr),
                                   off.ctypes.data_as(ptr),
                                   lens.ctypes.data_as(ptr), _n_threads())
        else:
            lens = off[rows + 1] - off[rows]
        o = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=o[1:])
        out.append(o)
    return tuple(out)


def _launch_chunks(bd: BamData, kept: np.ndarray):
    """(s, e, offsets) of each launch: the range [s, e) of `kept`, at most
    _SUB_ROWS reads and _SUB_BASES bases and CIGAR ops (a single larger read
    alone), and _row_offsets of its reads."""
    cum = _row_offsets(bd, kept)
    s, out = 0, []
    while s < kept.size:
        e = min(s + _SUB_ROWS, kept.size)
        for c in cum:
            e = min(e, int(np.searchsorted(c, c[s] + _SUB_BASES,
                                           side="right")) - 1)
        e = max(e, s + 1)
        out.append((s, e, tuple(c[s:e + 1] - c[s] for c in cum)))
        s = e
    return out


def _stage_reads(bd: BamData, rows: np.ndarray, dev: torch.device, clock,
                 offsets=None):
    """(pos, cig_off, cigar, seq_off, seq, qual) of the reads `rows` as
    assign_compact_ragged takes them, on `dev` (`offsets`: their
    _row_offsets, computed here when None).  The reads are gathered
    straight into one buffer (this thread's pinned staging, for a card:
    each byte crosses host memory once) that reaches the card in one copy;
    each array is a 16-byte aligned view of it.  The native gather fills
    every part in one threaded pass; without the library numpy does."""
    rows = np.ascontiguousarray(rows, np.int64)
    cig_new, seq_new = _row_offsets(bd, rows) if offsets is None \
        else offsets
    n = len(rows)
    n_ops, n_bases = int(cig_new[-1]), int(seq_new[-1])
    parts = ((np.int32, n), (np.int32, n + 1), (np.uint32, n_ops),
             (np.int32, n + 1), (np.uint8, n_bases), (np.uint8, n_bases))
    starts, total = [], 0
    for dt, cnt in parts:
        starts.append(total)
        total += (np.dtype(dt).itemsize * cnt + 15) & ~15
    if dev.type == "cuda":
        slot, host = _stager().reserve(total)
        buf = host.numpy()
    else:
        buf = np.empty(total, np.uint8)
    views = [buf[a:a + np.dtype(dt).itemsize * cnt].view(dt)
             for a, (dt, cnt) in zip(starts, parts)]
    from ..io import native as native_mod
    lib = native_mod.get_lib()
    if hasattr(lib, "stage_reads_native"):
        srcs = (np.ascontiguousarray(bd.pos, np.int32),
                np.ascontiguousarray(bd.cigar_flat, np.uint32),
                np.ascontiguousarray(bd.cigar_off, np.int64),
                np.ascontiguousarray(bd.seq_flat, np.uint8),
                np.ascontiguousarray(bd.qual_flat, np.uint8),
                np.ascontiguousarray(bd.seq_off, np.int64), cig_new, seq_new)
        ptr = ctypes.c_void_p
        lib.stage_reads_native(
            n, rows.ctypes.data_as(ptr), *[a.ctypes.data_as(ptr)
                                           for a in srcs],
            *[v.ctypes.data_as(ptr) for v in views], _n_threads())
    else:
        pos, cig_off, cigar, seq_off, seq, qual = views
        pos[:] = bd.pos[rows]
        cig_off[:] = cig_new
        seq_off[:] = seq_new
        for flat, off, new, out in ((bd.cigar_flat, bd.cigar_off, cig_new,
                                     cigar),
                                    (bd.seq_flat, bd.seq_off, seq_new, seq),
                                    (bd.qual_flat, bd.seq_off, seq_new,
                                     qual)):
            src = np.repeat(off[rows] - new[:-1], np.diff(new)) + \
                np.arange(int(new[-1]), dtype=np.int64)
            np.take(flat, src, out=out)
    if dev.type == "cuda":
        buf_t = _stager().send(slot, host, dev, clock)
    else:
        buf_t = torch.from_numpy(buf)
    out = []
    for a, (dt, cnt) in zip(starts, parts):
        v = buf_t[a:a + np.dtype(dt).itemsize * cnt]
        # the kernel takes the CIGAR's uint32 words as int32
        out.append(v.view(torch.uint8 if dt == np.uint8 else torch.int32))
    return tuple(out)


def assign_alleles_auto(bd: BamData, vt: VariantTable, *, baseq: int,
                        splice: bool = True, isize_cutoff: float = 0,
                        device="cuda", defer: bool = False):
    """GPU-accelerated assign_alleles with exact host remainders.

    With defer=True returns a PendingHits (launch only); otherwise returns
    the resolved ContigHits directly."""
    require_device(device)
    device = stage_device(device, AUTO_ON_CARD)
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

    dev_parts = []
    host_parts = []
    clock = DeviceClock(dev)

    def launch(fn, *args):
        with clock.span():
            return fn(*args)

    if kept.size:
        tables = []
        for t in range(0, dev_vidx.size, _MAX_TABLE):
            tab_vidx = dev_vidx[t:t + _MAX_TABLE]
            tables.append((tab_vidx, tuple(
                _upload(x, dev, clock)
                for x in K.padded_table(vt, tab_vidx))))
        # each launch's reads cross to the card once, for every table slice
        for s, e, offsets in _launch_chunks(bd, kept):
            rows = kept[s:e]
            reads = _stage_reads(bd, rows, dev, clock, offsets)
            n_bases = int(reads[4].shape[0])
            fb_key = ("ragged", _next_pow2(max(e - s, 8)),
                      _next_pow2(max(n_bases // (e - s), 1)))
            cap = _adaptive_cap(fb_key, n_bases)
            for tab_vidx, table in tables:
                packed = launch(K.assign_compact_ragged, *reads, baseq, table,
                                cap)
                dev_parts.append((packed, cap, rows, tab_vidx, fb_key))
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
    nonins_sel = np.flatnonzero(~has_ins) if rem_vidx.size else rem_vidx
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
