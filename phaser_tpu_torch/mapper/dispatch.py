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

`assign_alleles_auto(..., defer=True)` launches and returns a PendingHits;
`resolve()` (or `resolve_all` over many chunks, one device->host copy)
fetches the packed hits and merges them with the host parts.

`device` is "host" (exact host mapper), "cuda"/"auto" (the CUDA kernels;
raises without a GPU) or "cpu" (the kernels' plain PyTorch versions on CPU
tensors, the test path), or a torch.device.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..engine.varmap import VariantTable
from ..io.bam import (BamData, OP_EQ, OP_H, OP_I, OP_M, OP_N, OP_S, OP_X)
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


def _read_op_masks(bd: BamData):
    opc = (bd.cigar_flat & 0xF)
    ops_per_read = np.diff(bd.cigar_off)
    op_read = np.repeat(np.arange(len(bd)), ops_per_read)
    has_ins = np.zeros(len(bd), bool)
    np.logical_or.at(has_ins, op_read, opc == OP_I)
    has_n = np.zeros(len(bd), bool)
    np.logical_or.at(has_n, op_read, opc == OP_N)
    return has_ins, has_n


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
                 dev_parts: List[Tuple[torch.Tensor, int,
                                       Optional[np.ndarray], np.ndarray, int,
                                       tuple]],
                 host_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 hits_map: dict, done: Optional[torch.cuda.Event] = None):
        self._relaunch = relaunch
        # (packed_dev, cap, row_map, dev_vidx, row_offset, fb_key)
        self._dev = dev_parts
        self._host = host_parts        # (read_idx, var_idx, codes16)
        self._map = hits_map
        self._done = done              # recorded after the last launch

    def wait(self) -> None:
        """Block until every launched kernel of this chunk has finished."""
        if self._done is not None:
            from ..utils.trace import device_section
            with device_section():
                self._done.synchronize()

    def resolve(self, prefetched: Optional[List[np.ndarray]] = None
                ) -> ContigHits:
        from ..kernels.alleles import decode_packed_hits

        rows_parts = list(self._host)
        overflow = False
        for k, (packed, cap, row_map, dev_vidx, offset, fb_key) in \
                enumerate(self._dev):
            if prefetched is not None:
                full = prefetched[k]
            else:
                from ..utils.trace import device_section
                with device_section():
                    full = packed.cpu().numpy()
            r, v, a, mc, nh = decode_packed_hits(full)
            with _cap_lock:
                if nh > _cap_feedback.get(fb_key, 0):
                    _cap_feedback[fb_key] = nh
                    _cap_save()
            overflow |= nh > cap
            vfull = dev_vidx[v]
            codes_out = mc  # the observed masked nibble IS the allele code
            if row_map is not None:
                r = row_map[r]
            elif offset:
                r = r + offset
            rows_parts.append((r, vfull, codes_out))
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
            for newpos, oldpos in enumerate(order):
                key = (int(all_r[oldpos]), int(all_v[oldpos]))
                if key in self._map:
                    hits.allele_strs[newpos] = self._map[key]
                    hits.allele_code[newpos] = -1
        return hits


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


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

    if np.any(np.diff(vt.pos) < 0):
        raise ValueError("variant table must be position-sorted")

    has_ins, has_n = _read_op_masks(bd)
    keep_read = np.ones(len(bd), bool)
    if isize_cutoff != 0:
        keep_read &= np.abs(bd.tlen.astype(np.int64)) <= isize_cutoff
    if not splice:
        keep_read &= ~has_n

    # device-eligible variants: simple alleles at unique positions
    pos = vt.pos
    dup = np.zeros(len(vt), bool)
    if len(vt) > 1:
        d = np.diff(pos) == 0
        dup[1:] |= d
        dup[:-1] |= d
    dev_var = vt.is_simple & ~dup
    dev_vidx = np.flatnonzero(dev_var)

    dev_read = keep_read & ~has_ins
    # torch.from_numpy aliases on the CPU: packer scratch reuse is only safe
    # where the upload is a real copy
    reuse = dev.type == "cuda"

    dev_parts = []
    host_parts = []
    from ..utils.trace import add_device_time
    _t_dev = time.perf_counter()
    if dev_vidx.size and dev_read.any():
        # packer order of phaser_tpu (mapper/dispatch.py:308-332): the
        # nibble plane, else the 1 B/base masked plane, else the numpy
        # affine classifier with codes/quals planes masked here
        nibble = K.pack_affine_nibble(bd, baseq, reuse=reuse)
        if nibble is not None:
            mcodes, is_aff, a_start, a_lo, a_hi = nibble
        else:
            masked = K.pack_affine_masked(bd, baseq, reuse=reuse)
            if masked is not None:
                mcodes, is_aff, a_start, a_lo, a_hi = masked
            else:
                is_aff, a_start, a_lo, a_hi = _affine_params(bd)
                codes, quals = K.pack_codes_quals(bd, reuse=reuse)
                mcodes = np.where(quals >= baseq, codes,
                                  np.uint8(15)).astype(np.uint8)
        aff = dev_read & is_aff
        N, Lw = mcodes.shape
        # bases per row: the nibble plane packs two per byte
        L_bases = 2 * Lw if nibble is not None else Lw
        st_k = np.where(aff, a_start, 0).astype(np.int32)
        lo_k = np.where(aff, a_lo, 0).astype(np.int32)
        hi_k = np.where(aff, a_hi, 0).astype(np.int32)
        plane_all = np.flatnonzero(dev_read & ~is_aff)

        for t in range(0, dev_vidx.size, _MAX_TABLE):
            tab_vidx = dev_vidx[t:t + _MAX_TABLE]
            table = tuple(_upload(x, dev)
                          for x in K.padded_table(vt, tab_vidx))

            # affine fast path: masked plane (BASEQ pre-applied), refpos
            # rebuilt on the device, in <= _SUB_ROWS-row launches
            for s in range(0, N if aff.any() else 0, _SUB_ROWS):
                e = min(s + _SUB_ROWS, N)
                if not aff[s:e].any():
                    continue
                n_sub = e - s
                ss, ls, hs = st_k[s:e], lo_k[s:e], hi_k[s:e]
                args = (_upload(mcodes[s:e], dev), _upload(ss, dev),
                        _upload(ls, dev), _upload(hs, dev))
                # either kernel finds each row's table range on the card
                if nibble is not None:
                    fb_key = ("affine_nib", _next_pow2(max(n_sub, 8)), Lw)
                    cap = _adaptive_cap(fb_key, n_sub * L_bases)
                    packed = K.assign_compact_affine_nibble(*args, table, cap)
                else:
                    fb_key = ("affine", _next_pow2(max(n_sub, 8)), Lw)
                    cap = _adaptive_cap(fb_key, n_sub * L_bases)
                    packed = K.assign_compact_affine_masked(*args, table, cap)
                dev_parts.append((packed, cap, None, tab_vidx, s, fb_key))

            for s in range(0, plane_all.size, _SUB_ROWS):
                # non-affine remainder: delta-nibble format for D/split-M
                # reads, refpos plane only for what delta can't carry
                # (N-spliced reads, delta overflow) or for every read when
                # the delta packer is missing
                plane_sel = plane_all[s:s + _SUB_ROWS]
                sub = bd.select(plane_sel)
                dn = K.pack_delta_nibble(sub, baseq, reuse=reuse)
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
                    packed_d = K.assign_compact_delta_nibble(
                        *[_upload(x[ok_idx], dev)
                          for x in (ncd, dst, dlt, rmn, rmx)], table, cap_d)
                    dev_parts.append((packed_d, cap_d, plane_sel[ok_idx],
                                      tab_vidx, 0, fb_key))
                if dn is not None:
                    rest_idx = np.flatnonzero(~okm)
                    if rest_idx.size == 0:
                        continue
                    plane_sel = plane_sel[rest_idx]
                    sub = sub.select(rest_idx)
                codes2, quals2, refpos2 = K.pack_reads(sub)
                N2, L2 = codes2.shape
                fb_key = ("plane", _next_pow2(max(N2, 8)), L2)
                cap2 = _adaptive_cap(fb_key, N2 * L2)
                packed2 = K.assign_compact_plane(
                    _upload(codes2, dev), _upload(quals2, dev),
                    _upload(refpos2, dev), baseq, table, cap2)
                dev_parts.append((packed2, cap2, plane_sel, tab_vidx, 0,
                                  fb_key))
    done = None
    if dev.type == "cuda" and dev_parts:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
    # device-path time: table/read upload prep + launches (async); the
    # wait/fetch side is accounted in PendingHits.wait / resolve_all
    add_device_time(time.perf_counter() - _t_dev)

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
        again = assign_alleles_auto(bd, vt, baseq=baseq, splice=splice,
                                    isize_cutoff=isize_cutoff, device=dev,
                                    defer=True)
        if isinstance(again, PendingHits):
            again._relaunch = None  # its capacities hold the exact counts
        return again.resolve()

    pending = PendingHits(_relaunch, dev_parts, host_parts, hits_map, done)
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
    """Resolve many launched chunks with ONE device->host copy: every
    pending packed buffer is concatenated on its device and copied once."""
    from ..utils.trace import device_section

    parts = []
    for p in pendings:
        if isinstance(p, PendingHits):
            parts.extend(p._dev)
    views: List[np.ndarray] = []
    with device_section():
        if parts:
            bufs = [pt[0] for pt in parts]
            full = torch.cat(bufs, dim=1).cpu().numpy() if len(bufs) > 1 \
                else bufs[0].cpu().numpy()
            off = 0
            for b in bufs:
                w = int(b.shape[1])
                views.append(full[:, off:off + w])
                off += w

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
