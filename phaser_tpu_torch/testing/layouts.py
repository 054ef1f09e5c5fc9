"""Synthetic read / variant-table layouts that reach every branch of the
range-join kernels (affine_nibble, affine_masked, affine_planes,
delta_nibble, plane, ragged_join):
used by the CPU tests against the JAX programs and, at a larger size, by
chip_smoke.py on the card.

A layout is a dict of numpy arrays: start / lo / hi (N,) int32 affine row
parameters (refpos = start + (i - lo) on [lo, hi)), codes / quals (N, L)
uint8, gap (N,) int32 (a jump in the reference at the middle of the row:
a splice for the plane program, a deletion for the delta program, ignored
by the affine programs; 0 for none), and the table vpos (M,) int32 sorted,
ind (M, 2) uint8, ni (M,) int8.
"""

from __future__ import annotations

import numpy as np

from ..io.bam import OP_D, OP_EQ, OP_H, OP_M, OP_N, OP_P, OP_S, OP_X

NAMES = ["sorted", "random_order", "dense", "L256", "L384", "lo_gt0",
         "empty_rows", "first_last", "one_entry", "table_slice",
         "duplicates", "clip_collide", "long_cigar", "empty_runs",
         "wide_slice", "many_rows"]

# what the last four reach in the tile kernels ragged_join and read_spans
# (csrc/alleles.cu: a tile of JOIN_TILE / SPAN_TILE consecutive rows stages
# at most JOIN_OPS of their CIGAR words (the join) and JOIN_STAGE /
# SPAN_STAGE table entries; kernels.alleles reads the numbers from there):
#   long_cigar  every 7th row's aligned bases written one op each, with a
#               1-base D and a 1-base P after each (about 1,150 ops a row
#               at L = 384): rows past a tile's op stage, and single rows
#               longer than the join's whole stage
#   empty_runs  runs of 48 rows across every multiple of 256 rows (so of
#               1,024 too), in turns 6 rows without ops and 6 rows whose
#               sequence is `*`
#   wide_slice  a variant every few bases, so that a tile's table slice
#               holds about 1,500 entries: past both kernels' stages (and
#               inside the earlier design's 2,048)
#   many_rows   16 x n_rows sorted rows (the sorted layout's density over a
#               16 times longer contig): more rows than one wave of either
#               kernel holds on an H100 at the size chip_smoke.py makes it
_WIDE_SLICE_ENTRIES = 1500

_INT32_MAX = int(np.iinfo(np.int32).max)


def make(name: str, n_rows: int = 300, n_vars: int = 200,
         contig: int = 60_000) -> dict:
    """The layout `name` (one of NAMES, or "big_table": the first launch
    slice, 2^22 entries, of a table above the dispatcher's slice size)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    N, L, M = n_rows, 128, n_vars
    if name == "many_rows":
        N, M, contig = 16 * n_rows, 16 * n_vars, 16 * contig
    if name in ("L256", "L384", "long_cigar"):
        L = 384 if name == "long_cigar" else int(name[1:])
    extra = {}
    lo = np.zeros(N, np.int32)
    hi = np.full(N, L, np.int32)
    if name == "many_rows":
        # without the draw over every position of a long contig
        vpos = np.unique(rng.integers(1, contig, size=M))
    else:
        vpos = np.sort(rng.choice(np.arange(1, contig, dtype=np.int64),
                                  size=M, replace=False))
    start = np.sort(rng.integers(1, contig - 2 * L, size=N))
    gap = np.where(rng.random(N) < 0.5, rng.integers(20, 400, size=N), 0)
    if name == "random_order":
        start = rng.permutation(start)
    elif name == "dense":
        # a variant on every position: a 256-row block's table slice holds
        # far more entries than the kernel stages in shared memory
        vpos = np.arange(1, contig, dtype=np.int64)
    elif name == "lo_gt0":
        lo = rng.integers(1, 20, size=N).astype(np.int32)
        hi = (L - rng.integers(0, 20, size=N)).astype(np.int32)
    elif name == "empty_rows":
        empty = rng.random(N) < 0.3
        hi = np.where(empty, lo, hi).astype(np.int32)
        start = np.where(empty, 0, start)
    elif name == "first_last":
        # variants exactly under rows' first and last aligned bases
        lo = rng.integers(0, 9, size=N).astype(np.int32)
        hi = (L - rng.integers(0, 9, size=N)).astype(np.int32)
        gap[:] = 0
        ends = np.concatenate([start[::3], (start + (hi - lo) - 1)[1::3]])
        vpos = np.unique(np.concatenate([vpos[:50], ends]))
    elif name == "one_entry":
        start = np.sort(rng.integers(1000, 1100, size=N))
        vpos = np.array([1110], np.int64)
    elif name == "table_slice":
        # the second launch slice of a table above 2^22 entries: entries
        # (1 << 22) and up of positions 3, 6, 9, ...
        first = ((1 << 22) + 1) * 3
        vpos = first + 3 * np.arange(M, dtype=np.int64)
        start = np.sort(rng.integers(first - L, first + 3 * M, size=N))
    elif name == "big_table":
        vpos = 3 * np.arange(1, (1 << 22) + 1, dtype=np.int64)
        start = np.sort(rng.integers(1, 3 * (1 << 22), size=N))
    elif name == "duplicates":
        vpos = np.sort(np.concatenate([vpos, vpos[::5], vpos[::10]]))
    elif name == "clip_collide":
        # a short deletion at the middle and a 20-base trailing clip: the
        # clipped base i + gap (delta 0, masked) has the position of the
        # aligned base i, and variants sit under the rows' last aligned bases
        lo = rng.integers(0, 9, size=N).astype(np.int32)
        hi = np.full(N, L - 20, np.int32)
        gap = rng.integers(1, 20, size=N)
        last = start + (hi - lo) - 1 + gap
        vpos = np.unique(np.concatenate([vpos[::4], last[::2],
                                         last[1::4] - 2]))
    elif name == "long_cigar":
        extra["split"] = np.arange(N) % 7 == 2
    elif name == "empty_runs":
        run = (np.arange(N) + 24) % 256 < 48
        no_ops = run & ((np.arange(N) // 6) % 2 == 0)
        extra["no_ops"] = no_ops
        extra["star"] = run & ~no_ops
        hi = np.where(no_ops, lo, hi).astype(np.int32)
    elif name == "wide_slice":
        step = max(1, 256 * contig // (N * _WIDE_SLICE_ENTRIES))
        vpos = np.arange(1, contig, step, dtype=np.int64)
    elif name not in ("sorted", "L256", "L384", "many_rows"):
        raise ValueError("unknown layout %r" % name)
    M = len(vpos)
    return dict(
        start=start.astype(np.int32), lo=lo, hi=hi, gap=gap.astype(np.int32),
        codes=rng.integers(1, 16, size=(N, L)).astype(np.uint8),
        quals=rng.integers(0, 40, size=(N, L)).astype(np.uint8),
        vpos=vpos.astype(np.int32),
        ind=rng.integers(1, 9, size=(M, 2)).astype(np.uint8),
        ni=rng.integers(0, 3, size=M).astype(np.int8), **extra)


def padded_table(d: dict):
    """(vpos, a0, a1, n_ind) int32, padded to a power of two (at least 8)
    with INT32_MAX positions and zero codes, as the dispatcher pads."""
    M = len(d["vpos"])
    mp = 8
    while mp < M:
        mp *= 2
    vpos = np.full(mp, _INT32_MAX, np.int32)
    vpos[:M] = d["vpos"]
    cols = [np.zeros(mp, np.int32) for _ in range(3)]
    cols[0][:M] = d["ind"][:, 0]
    cols[1][:M] = d["ind"][:, 1]
    cols[2][:M] = d["ni"]
    return (vpos, *cols)


def affine_inputs(d: dict, baseq: int = 10):
    """(ncodes, start, lo, hi): the rows as the affine program takes them,
    BASEQ applied and two masked nibbles per byte (even base low)."""
    masked = np.where(d["quals"] >= baseq, d["codes"], 15).astype(np.uint8)
    ncodes = (masked[:, 0::2] | (masked[:, 1::2] << 4)).astype(np.uint8)
    return ncodes, d["start"], d["lo"], d["hi"]


def plane_inputs(d: dict):
    """(codes, quals, refpos): the rows as an explicit refpos plane, spliced
    at the middle where `gap` says so (what the affine program cannot
    carry)."""
    N, L = d["codes"].shape
    i = np.arange(L, dtype=np.int32)[None, :]
    lo, hi = d["lo"][:, None], d["hi"][:, None]
    refpos = d["start"][:, None] + (i - lo) + \
        np.where(i >= L // 2, d["gap"][:, None], 0)
    refpos = np.where((i >= lo) & (i < hi), refpos, 0).astype(np.int32)
    return d["codes"], d["quals"], refpos


def masked_inputs(d: dict, baseq: int = 10):
    """(mcodes, start, lo, hi): the affine rows on the 1 B/base masked plane
    (BASEQ applied, 15 = masked)."""
    mcodes = np.where(d["quals"] >= baseq, d["codes"], 15).astype(np.uint8)
    return mcodes, d["start"], d["lo"], d["hi"]


def affine_planes_inputs(d: dict):
    """(codes, quals, start, lo, hi): the affine rows on the unmasked codes
    and quals planes, as pack_affine writes them (BASEQ applied by the
    program; quals are uniform on [0, 40), so about a quarter of the bases
    lie under a BASEQ of 10)."""
    return d["codes"], d["quals"], d["start"], d["lo"], d["hi"]


def delta_inputs(d: dict, baseq: int = 10):
    """(ncodes, start, delta, rp_min, rp_max): the rows as the delta program
    takes them, with `gap` (clipped to int16) as a deletion at the middle.
    Bases outside [lo, hi) are soft clips: nibble 15 and delta 0, as the
    packer writes them; start is the position base 0 would have.  rp_min /
    rp_max bound the aligned positions (low-quality bases included), both 0
    for a row with no aligned base."""
    N, L = d["codes"].shape
    i = np.arange(L, dtype=np.int32)[None, :]
    lo, hi = d["lo"][:, None], d["hi"][:, None]
    aligned = (i >= lo) & (i < hi)
    masked = np.where(aligned & (d["quals"] >= baseq), d["codes"],
                      15).astype(np.uint8)
    ncodes = (masked[:, 0::2] | (masked[:, 1::2] << 4)).astype(np.uint8)
    gap = np.minimum(d["gap"], 32767)[:, None]
    delta = np.where(aligned & (i >= L // 2), gap, 0).astype(np.int16)
    start = (d["start"] - d["lo"]).astype(np.int32)
    refpos = start[:, None] + i + delta
    some = aligned.any(axis=1)
    rp_min = np.where(some, np.where(aligned, refpos, _INT32_MAX).min(axis=1),
                      0).astype(np.int32)
    rp_max = np.where(some, np.where(aligned, refpos, 0).max(axis=1),
                      0).astype(np.int32)
    return ncodes, start, delta, rp_min, rp_max


def _aligned(n: int, op: int, split: bool):
    """n aligned bases of `op`: one op, or (split) one op a base with a
    1-base D and a 1-base P after every base but the last."""
    if not split:
        return [(n, op)]
    return [x for i in range(n) for x in
            ([(1, op), (1, OP_D), (1, OP_P)] if i < n - 1 else [(1, op)])]


def ragged_reads(d: dict):
    """The rows of a layout as reads (pos0, ops, codes, quals), ops a list
    of (length, op code): lo soft-clipped bases, the aligned run (M, = or
    X) with `gap` as an N (odd rows) or a D (even rows) at the middle, the
    trailing soft clip.  Beside them every branch of a CIGAR walk: hard
    clips at both ends (every 11th row), a P op after the gap (every 13th),
    a sequence of `*` (every 17th row), a sequence 30 bases shorter than
    the CIGAR (every 19th) and one 10 bases longer (every 23rd), and rows
    without an aligned base as all-clip rows or rows without ops.  A
    layout's optional (N,) bool arrays `split` (the aligned run one op a
    base, _aligned), `no_ops` (no ops) and `star` (a sequence of `*`) set
    those rows apart."""
    codes, quals = d["codes"], d["quals"]
    N, L = codes.shape
    mid = L // 2
    none = np.zeros(N, bool)
    split, no_ops, star = (d.get(k, none) for k in ("split", "no_ops",
                                                    "star"))
    out = []
    for r in range(N):
        lo, hi, gap = int(d["lo"][r]), int(d["hi"][r]), int(d["gap"][r])
        run = (OP_M, OP_EQ, OP_X)[r % 3]
        ops = []
        if no_ops[r]:
            pass
        elif hi <= lo:
            ops = [(L, OP_S)] if r % 2 else []
        else:
            if r % 11 == 3:
                ops.append((5, OP_H))
            if lo:
                ops.append((lo, OP_S))
            if gap and lo < mid < hi:
                ops += _aligned(mid - lo, run, split[r]) + \
                    [(gap, OP_N if r % 2 else OP_D)]
                if r % 13 == 5:
                    ops.append((2, OP_P))
                ops += _aligned(hi - mid, OP_M, split[r])
            else:
                ops += _aligned(hi - lo, run, split[r])
            if hi < L:
                ops.append((L - hi, OP_S))
            if r % 11 == 3:
                ops.append((7, OP_H))
        c, q = codes[r], quals[r]
        if r % 17 == 7 or star[r]:
            c, q = c[:0], q[:0]
        elif r % 19 == 4:
            c, q = c[:L - 30], q[:L - 30]
        elif r % 23 == 6:
            c = np.concatenate([c, c[:10]])
            q = np.concatenate([q, q[:10]])
        out.append((int(d["start"][r]) - 1, ops, c, q))
    return out


def ragged_inputs(d: dict):
    """(pos, cig_off, cigar, seq_off, seq, qual): ragged_reads(d) in the
    layout BAM decode stores reads in and assign_compact_ragged takes
    (int32 pos and offsets, the CIGAR's uint32 words as int32, uint8
    bases)."""
    reads = ragged_reads(d)
    n_ops = np.array([len(ops) for _, ops, _, _ in reads], np.int64)
    n_bases = np.array([len(c) for _, _, c, _ in reads], np.int64)
    words = [(ln << 4) | op for _, ops, _, _ in reads for ln, op in ops]
    return (np.array([p for p, _, _, _ in reads], np.int32),
            np.concatenate([[0], np.cumsum(n_ops)]).astype(np.int32),
            np.array(words, np.uint32).view(np.int32),
            np.concatenate([[0], np.cumsum(n_bases)]).astype(np.int32),
            np.concatenate([c for _, _, c, _ in reads]).astype(np.uint8),
            np.concatenate([q for _, _, _, q in reads]).astype(np.uint8))


def ragged_plane(d: dict):
    """(codes, quals, refpos) planes of ragged_reads(d), L a multiple of
    128, by a walk over each read's ops written out here: an M, = or X op
    gives its bases consecutive positions from the read's current reference
    position; I and S take bases, D and N reference positions, H and P
    neither.  A position whose base lies past the read's own stays 0."""
    reads = ragged_reads(d)
    L = max([len(c) for _, _, c, _ in reads] + [1])
    L = -(-L // 128) * 128
    N = len(reads)
    codes = np.zeros((N, L), np.uint8)
    quals = np.zeros((N, L), np.uint8)
    refpos = np.zeros((N, L), np.int32)
    for r, (pos0, ops, c, q) in enumerate(reads):
        codes[r, :len(c)] = c
        quals[r, :len(q)] = q
        g, i = pos0 + 1, 0
        for ln, op in ops:
            if op in (OP_M, OP_EQ, OP_X):
                for k in range(ln):
                    if i + k < len(c):
                        refpos[r, i + k] = g + k
                g += ln
                i += ln
            elif op in (OP_D, OP_N):
                g += ln
            elif op not in (OP_H, OP_P):   # I, S
                i += ln
    return codes, quals, refpos


# ---------------------------------------------------------------------------
# layouts for the unfused planes kernels (planes, planes_cmp)
# ---------------------------------------------------------------------------

PLANES_NAMES = ["odd_width", "spliced_unordered", "dup_positions",
                "table_end", "pair_products"]


def planes_layout(name: str, n_rows: int = 1000):
    """Inputs of the kernel-level entries that reach what the vector planes
    kernels treat apart: (codes, quals, refpos, vpos, ind, ni) in
    phaser_tpu's public layout.  Reads lie in one narrow region per 256 rows, so
    every 256-row block's table band fits the 256-entry window
    (plan_windows_plane succeeds); the default n_rows is no multiple of the
    row block.

      odd_width          L = 122, no multiple of 4 (the kernels' scalar
                         instantiation)
      spliced_unordered  L = 120, no multiple of 16; every third row
                         N-spliced (zeros in the middle, a jump after
                         them), every fifth row descending
      dup_positions      every seventh table entry repeats its predecessor
                         (the search takes the first, cmp the last)
      table_end          a 1003-entry table, reads under its last entries:
                         the last window runs past the table, whose length
                         is no multiple of 4
      pair_products      a 36-entry table under reads around position 5000:
                         the cmp kernel tests a position r against entries
                         in pairs by (e0 - r)(e1 - r) == 0 modulo 2^32, and
                         here pairs (r + 2^20, r + 2^20 + 2^12) and (r' +
                         2^21, r' + 2^21 + 2^11) make that product vanish
                         with neither factor zero, for r = 5000 (itself an
                         entry of an earlier group) and r' = 5005 (no entry)
    """
    rng = np.random.default_rng(sum(map(ord, name)))
    N = n_rows
    if name == "pair_products":
        L = 128
        lows = [5000 + 1000 * a + d for a in range(4)
                for d in (-30, -20, -10, 0, 10, 20, 30, 40)]
        vpos = np.array(lows + [5000 + (1 << 20), 5000 + (1 << 20) + (1 << 12),
                                5005 + (1 << 21), 5005 + (1 << 21) + (1 << 11)],
                        np.int64)
        M = len(vpos)
        starts = np.sort(4900 + np.arange(N) % 90)
        refpos = starts[:, None] + np.arange(L, dtype=np.int64)[None, :]
        refpos[rng.random((N, L)) < 0.05] = 0
        return (rng.integers(1, 16, size=(N, L)).astype(np.uint8),
                rng.integers(0, 40, size=(N, L)).astype(np.uint8),
                refpos.astype(np.int32), vpos.astype(np.int32),
                rng.integers(1, 9, size=(M, 2)).astype(np.uint8),
                np.full(M, 2, np.int8))
    L = {"odd_width": 122, "spliced_unordered": 120}.get(name, 128)
    M = 1003 if name == "table_end" else 4000
    contig = 200_000 if name == "table_end" else 3_000_000
    vpos = np.sort(rng.choice(np.arange(1, contig, dtype=np.int64), size=M,
                              replace=False))
    if name == "dup_positions":
        k = np.arange(5, M, 7)
        vpos[k] = vpos[k - 1]
    if name == "table_end":
        starts = np.sort(rng.integers(vpos[-120] - L, vpos[-1], size=N))
    else:
        # one region per 256-row block, so that no block straddles two
        region_lo = np.sort(rng.integers(1, contig - 21_000 - L,
                                         size=-(-N // 256)))
        starts = np.concatenate([
            np.sort(rng.integers(lo, lo + 20_000, size=256))
            for lo in region_lo])[:N]
    refpos = starts[:, None] + np.arange(L, dtype=np.int64)[None, :]
    if name == "spliced_unordered":
        spliced = np.arange(N) % 3 == 0
        refpos[spliced, 50:] += 300
        refpos[spliced, 40:50] = 0
        flip = np.arange(N) % 5 == 0
        refpos[flip] = refpos[flip, ::-1]
    refpos[rng.random((N, L)) < 0.05] = 0
    codes = rng.integers(1, 16, size=(N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, size=(N, L)).astype(np.uint8)
    ind = rng.integers(1, 9, size=(M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    return (codes, quals, refpos.astype(np.int32), vpos.astype(np.int32), ind,
            ni)


# ---------------------------------------------------------------------------
# the sharded step's planes: inputs on which band_counts' design branches
# ---------------------------------------------------------------------------

BAND_NAMES = ["random_repeats", "descending_in_row", "sorted", "reversed",
              "long_rows", "odd_length"]


def _sorted_band_planes(rng, n_rows, l, spacing, span):
    """Rows sorted by start, a variant every `spacing` bases of the
    reference, 15% of them no hit, alleles at random."""
    start = np.sort(rng.integers(0, span, n_rows))
    pos = start[:, None] + np.arange(l)[None, :]
    keep = (pos % spacing == 0) & (rng.random((n_rows, l)) >= 0.15)
    vidx = np.where(keep, pos // spacing, -1).astype(np.int32)
    allele = np.where(keep, rng.integers(0, 3, (n_rows, l)), 3
                      ).astype(np.int32)
    return vidx, allele, (span + l) // spacing + 1


def band_planes(name: str):
    """(vidx, allele) (N, L) int32 planes and the variant count M of one
    of BAND_NAMES (non-hits vidx -1, allele 3):
      random_repeats     rows in no order, a variant repeated inside every
                         row, 30% non-hits (rows the forward walk refuses);
      descending_in_row  sorted rows, every 5th one reversed along the row
                         (its hit variants decrease) and every 7th with a
                         variant repeated at two positions;
      sorted             3,000 position-sorted rows over 3,000 variants: far
                         more than one block's shared-memory window;
      reversed           the same rows in reverse order (no block takes its
                         window);
      long_rows          4 sorted rows of 6,144 bases (the kernel's longest);
      odd_length         sorted rows of 77 bases (no multiple of 32)."""
    # the reversed rows are the sorted ones
    rng = np.random.default_rng(sum(map(ord, "sorted" if name == "reversed"
                                        else name)))
    if name == "random_repeats":
        N, L, M = 3001, 100, 500
        vidx = rng.integers(0, M, (N, L)).astype(np.int32)
        vidx[:, 5] = vidx[:, 2]
        allele = rng.integers(0, 3, (N, L)).astype(np.int32)
        miss = rng.random((N, L)) < 0.3
        vidx[miss], allele[miss] = -1, 3
        return vidx, allele, M
    if name == "long_rows":
        return _sorted_band_planes(rng, 4, 6144, 16, 20_000)
    if name == "odd_length":
        return _sorted_band_planes(rng, 2000, 77, 5, 12_000)
    vidx, allele, M = _sorted_band_planes(rng, 3000, 128, 8, 24_000)
    if name == "reversed":
        return vidx[::-1].copy(), allele[::-1].copy(), M
    if name == "descending_in_row":
        vidx[::5] = vidx[::5, ::-1]
        allele[::5] = allele[::5, ::-1]
        rep = np.arange(1, len(vidx), 7)
        for r in rep:
            h = np.flatnonzero(vidx[r] >= 0)
            if len(h) > 1:
                vidx[r, h[-1]], allele[r, h[-1]] = vidx[r, h[0]], 1
    elif name != "sorted":
        raise ValueError("no band layout %r" % name)
    return vidx, allele, M


def band_tail(m: int, band: int, seed: int):
    """Merged (m, 3) counts and (m, band, 9) band of int32 for the
    connection-test tail: matches about 40 a variant and mismatches about
    0.4 (a noise rate near 0.5%), cis support about 12 a pair beside a
    little (0.15 each) of every configuration, so that the tests take
    continued fractions and some pairs are pruned."""
    rng = np.random.default_rng(seed)
    counts = np.stack([rng.poisson(20, m), rng.poisson(20, m),
                       rng.poisson(0.4, m)], axis=1).astype(np.int32)
    pair = rng.poisson(0.15, (m, band, 9)).astype(np.int32)
    pair[:, :, (0, 4)] += rng.poisson(6, (m, band, 2)).astype(np.int32)
    counts[::97] = 0
    pair[::89] = 0
    return counts, pair


def binom_long(count: int = 65_536, seed: int = 0):
    """(k int32, n int32, p float64) of `count` binomial cdfs whose
    continued fractions are long (about 35-110 terms): n from 1,000 to
    10,000, p at the connection test's values (p_success 0.97-0.994, noise
    rates of 0.1-0.5%) and k within a standard deviation of the mean n p,
    where the fraction is longest.  The input on which the chain, not the
    launch, sets a binom_cdf kernel's time."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1000, 10_001, count)
    p = rng.uniform(0.97, 0.994, count)
    sd = np.sqrt(n * p * (1 - p))
    k = np.clip(np.rint(n * p + rng.uniform(-1, 1, count) * sd), 0, n - 1)
    return k.astype(np.int32), n.astype(np.int32), p


LONG_NOISE = (6, 2000)   # band_long's noise rate as mismatches / (2 x reads)


def band_long(m: int = 8192, band: int = 8, seed: int = 0):
    """Merged (m, 3) counts and (m, band, 9) band of int32 whose connection
    tests are binom_long's long fractions: every variant 497 + 497 matches
    and 6 mismatches (a noise rate of 6 / 2,000 = 0.3%, p_success 0.98191),
    every pair n from 1,000 to 10,000 reads, k of them cis (configuration
    0, the supporting count) within a standard deviation of the mean and
    the rest in configuration 2."""
    rng = np.random.default_rng(seed)
    e = LONG_NOISE[0] / LONG_NOISE[1]
    ps = 1.0 - (6.0 * e + 10.0 * (e * e))
    counts = np.tile(np.array([497, 497, 6], np.int32), (m, 1))
    n = rng.integers(1000, 10_001, (m, band))
    sd = np.sqrt(n * ps * (1 - ps))
    k = np.clip(np.rint(n * ps + rng.uniform(-1, 1, n.shape) * sd), 1, n - 1)
    pair = np.zeros((m, band, 9), np.int32)
    pair[:, :, 0] = k
    pair[:, :, 2] = n - k
    return counts, pair
