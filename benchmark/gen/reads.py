"""Read pairs of one BAM: fragments drawn from the donor's haplotypes, DNA
uniformly over the region or RNA from the mix's genes, with real insert
sizes, splices, soft clips, duplicates, low-MAPQ and improper pairs for
the engine's filters, a quality model and a sequencing error rate.

The numbers of fragments, duplicates and filtered reads are fixed by the
configuration and the mix; the seed draws where they fall."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sites import NIB

OP_M, OP_N, OP_S = 0, 3, 4
F_PAIRED, F_PROPER, F_REVERSE, F_MREVERSE = 0x1, 0x2, 0x10, 0x20
F_READ1, F_READ2, F_DUP = 0x40, 0x80, 0x400
CHUNK = 1 << 16


@dataclass
class ReadSet:
    """One BAM's records in file (coordinate) order."""
    L: int
    pos: np.ndarray        # int64 0-based first aligned base
    end: np.ndarray        # int64 reference end, exclusive
    flag: np.ndarray       # uint16
    mapq: np.ndarray       # uint8
    mate_pos: np.ndarray   # int64
    tlen: np.ndarray       # int64
    frag: np.ndarray       # int64 name number of the fragment
    cigar: np.ndarray      # uint32 len << 4 | op, all reads
    cig_off: np.ndarray    # int64 (n + 1)
    seq: np.ndarray        # (n, L) uint8 nibble codes
    qual: np.ndarray       # (n, L) uint8 Phred
    as_score: np.ndarray   # uint8 AS:i
    aux2: np.ndarray       # uint8 second tag (NH:i for RNA, NM:i for DNA)
    name_prefix: str
    name_digits: int
    aux2_tag: str

    def __len__(self) -> int:
        return len(self.pos)

    def names(self) -> list:
        fmt = "%s.%0" + str(self.name_digits) + "d"
        return [(fmt % (self.name_prefix, f)).encode()
                for f in self.frag.tolist()]


def _weighted(values, weights, shape, rng) -> np.ndarray:
    """Draws from `values` with `weights` through a 256-entry table."""
    w = np.asarray(weights, float)
    edges = np.round(np.cumsum(w / w.sum()) * 256).astype(int)
    table = np.repeat(np.asarray(values, np.uint8),
                      np.diff(np.concatenate(([0], edges))))
    return table[rng.integers(0, 256, shape, dtype=np.uint8)]


def _exact_mask(n: int, share: float, rng) -> np.ndarray:
    m = np.zeros(n, bool)
    m[rng.permutation(n)[:int(round(n * share))]] = True
    return m


def _tx_blocks(genes, g, a, L):
    """Genomic blocks (starts, lengths: (n, B)) of transcript intervals
    [a, a + L) of genes g."""
    cum = np.concatenate(([0], np.cumsum(genes.exon_len)))
    flat = cum[genes.first_exon[g]] + a
    e = np.searchsorted(cum, flat, side="right") - 1
    rem = np.full(len(g), L, np.int64)
    starts, lens = [], []
    while rem.any():
        bl = np.minimum(rem, cum[e + 1] - flat)
        starts.append(np.where(rem > 0, genes.exon_start[e] + flat - cum[e],
                               0))
        lens.append(np.where(rem > 0, bl, 0))
        flat = flat + bl
        rem = rem - bl
        e = np.minimum(e + 1, len(genes.exon_len) - 1)
    return np.stack(starts, 1), np.stack(lens, 1)


def fragments(bam: dict, mix: dict, donor, genes, rng):
    """(hap, strand, R1 blocks, R2 blocks) of every fragment; duplicates
    copy an earlier fragment's place."""
    L = int(bam["read_length"])
    n = int(mix["reads"]) // 2
    ins_mean, ins_sd = bam["insert"]
    if bam["kind"] == "dna":
        ins = np.clip(np.round(rng.normal(ins_mean, ins_sd, n)), L,
                      bam["insert_max"]).astype(np.int64)
        start = donor.r0 + 1000 + (rng.random(n) * (
            donor.r1 - donor.r0 - 2000 - ins)).astype(np.int64)
        hap = rng.integers(0, 2, n)
        b1s, b1l = start[:, None], np.full((n, 1), L, np.int64)
        b2s, b2l = (start + ins - L)[:, None], np.full((n, 1), L, np.int64)
    else:
        # fragments per gene exactly by share (largest remainders)
        want = genes.share * n
        cnt = np.floor(want).astype(np.int64)
        extra = n - int(cnt.sum())
        cnt[np.argsort(-(want - cnt), kind="stable")[:extra]] += 1
        g = rng.permutation(np.repeat(np.arange(len(cnt)), cnt))
        T = genes.tx_len[g]
        flen = np.clip(np.round(rng.normal(ins_mean, ins_sd, n)), L + 10,
                       np.minimum(T, bam["insert_max"])).astype(np.int64)
        a = (rng.random(n) * (T - flen + 1)).astype(np.int64)
        hap = (rng.random(n) < genes.ratio[g]).astype(np.int64)
        b1s, b1l = _tx_blocks(genes, g, a, L)
        b2s, b2l = _tx_blocks(genes, g, a + flen - L, L)
    strand = rng.integers(0, 2, n)
    dup = _exact_mask(n, bam["dup_share"], rng)
    src = rng.integers(0, n, n)
    src = np.where(dup[src], np.arange(n), src)   # copy an original
    src[~dup] = np.arange(n)[~dup]
    B = max(b1s.shape[1], b2s.shape[1])

    def pad(x):
        return np.pad(x, ((0, 0), (0, B - x.shape[1])))
    return (hap[src], strand[src], dup, pad(b1s)[src], pad(b1l)[src],
            pad(b2s)[src], pad(b2l)[src])


def simulate(bam: dict, mix: dict, donor, genes, rng) -> ReadSet:
    L = int(bam["read_length"])
    hap, strand, dup, b1s, b1l, b2s, b2l = fragments(bam, mix, donor, genes,
                                                     rng)
    nf = len(hap)
    # reads: R1 of every fragment, then R2
    bs = np.concatenate([b1s, b2s])
    bl = np.concatenate([b1l, b2l])
    n = 2 * nf
    hap2 = np.concatenate([hap, hap])
    is_r2 = np.arange(n) >= nf
    fr = np.concatenate([np.arange(nf), np.arange(nf)])
    # soft clips at either end, where the block they cut is long enough
    clip_mask = _exact_mask(n, bam["clip_share"], rng)
    k = rng.integers(1, bam["clip_max"] + 1, n)
    at_start = rng.integers(0, 2, n).astype(bool)
    nb = (bl > 0).sum(1)
    last = nb - 1
    rows = np.arange(n)
    ok = np.where(at_start, bl[:, 0], bl[rows, last]) >= k + 20
    clip_mask &= ok
    s_clip = np.where(clip_mask & at_start, k, 0)
    e_clip = np.where(clip_mask & ~at_start, k, 0)
    bs[:, 0] += s_clip
    bl[:, 0] -= s_clip
    bl[rows, last] -= e_clip
    pos = bs[:, 0]
    end = bs[rows, last] + bl[rows, last]
    # CIGAR: [S] M (N M)* [S]
    n_ops = (s_clip > 0) + 2 * nb - 1 + (e_clip > 0)
    cig_off = np.zeros(n + 1, np.int64)
    np.cumsum(n_ops, out=cig_off[1:])
    cigar = np.zeros(int(cig_off[-1]), np.uint32)
    at = cig_off[:-1].copy()
    m = s_clip > 0
    cigar[at[m]] = (s_clip[m] << 4) | OP_S
    at += m
    for b in range(bs.shape[1]):
        live = b < nb
        if b > 0:
            gap = bs[:, b] - (bs[:, b - 1] + bl[:, b - 1])
            cigar[at[live]] = (gap[live] << 4) | OP_N
            at += live
        cigar[at[live]] = (bl[live, b] << 4) | OP_M
        at += live
    m = e_clip > 0
    cigar[at[m]] = (e_clip[m] << 4) | OP_S
    mm = bam["mapq"]
    mapq = _weighted(mm["values"], mm["weights"], n, rng)
    am = bam["as"]
    drop = _weighted(am["drop"], am["weights"], nf if am["per_pair"] else n,
                     rng)
    if am["per_pair"]:
        drop = np.concatenate([drop, drop])
    as_score = (am["max"] - drop).astype(np.uint8)
    x2 = bam["aux2"]
    aux2 = _weighted(x2["values"], x2["weights"], n, rng)
    # flags: the left read forward unless the strand says otherwise
    improper = np.concatenate([_exact_mask(nf, bam["improper_share"], rng)] * 2)
    st = np.concatenate([strand, strand])
    rev = np.where(is_r2, st == 0, st == 1)
    flag = (F_PAIRED | np.where(is_r2, F_READ2, F_READ1) |
            np.where(rev, F_REVERSE, 0) | np.where(~rev, F_MREVERSE, 0) |
            np.where(improper, 0, F_PROPER) |
            np.where(np.concatenate([dup, dup]), F_DUP, 0)).astype(np.uint16)
    mate = np.concatenate([np.arange(nf, n), np.arange(nf)])
    mate_pos = pos[mate]
    left = np.minimum(pos, mate_pos)
    right = np.maximum(end, end[mate])
    tlen = np.where(pos <= mate_pos, right - left, -(right - left))
    tlen = np.where((pos == mate_pos) & is_r2, -np.abs(tlen), tlen)
    name_no = rng.permutation(nf)[fr]
    # file order; the bases and qualities are drawn in it
    order = np.argsort(pos, kind="stable")
    cig_len = n_ops[order]
    new_off = np.zeros(n + 1, np.int64)
    np.cumsum(cig_len, out=new_off[1:])
    src = np.repeat(cig_off[:-1][order], cig_len) + (
        np.arange(int(new_off[-1])) - np.repeat(new_off[:-1], cig_len))
    bs, bl, nb = bs[order], bl[order], nb[order]
    s_clip, hap2 = s_clip[order], hap2[order]
    # bases: the haplotype from the read's first aligned base less its
    # start clip (clipped bases read the haplotype too), then the blocks
    # after a splice where there are any
    Lr = donor.r1 - donor.r0
    hap_flat = donor.haps.reshape(-1)
    win = np.lib.stride_tricks.sliding_window_view(hap_flat, L)
    seq = win[bs[:, 0] - donor.r0 - s_clip + hap2 * Lr]
    col = np.arange(L)[None, :]
    spliced = np.flatnonzero(nb > 1)
    for c0 in range(0, len(spliced), CHUNK):
        r = spliced[c0:c0 + CHUNK]
        out = seq[r]
        qs = s_clip[r] + bl[r, 0]
        for b in range(1, bs.shape[1]):
            ln = bl[r, b]
            inb = (col >= qs[:, None]) & (col < (qs + ln)[:, None])
            gi = (bs[r, b] - donor.r0 - qs + hap2[r] * Lr)[:, None] + col
            out[inb] = hap_flat[gi[inb]]
            qs += ln
        seq[r] = out
    k_err = rng.binomial(n * L, mix["error_rate"])
    ei = rng.integers(0, n * L, k_err)
    flat = seq.reshape(-1)
    flat[ei] = NIB[(np.searchsorted(NIB, flat[ei]) +
                    rng.integers(1, 4, k_err)) % 4]
    qm = bam["qual"]
    qual = _weighted(qm["values"], qm["weights"], (n, L), rng)
    return ReadSet(
        L=L, pos=pos[order], end=end[order], flag=flag[order],
        mapq=mapq[order], mate_pos=mate_pos[order], tlen=tlen[order],
        frag=name_no[order], cigar=cigar[src], cig_off=new_off,
        seq=seq, qual=qual, as_score=as_score[order],
        aux2=aux2[order], name_prefix=bam["name_prefix"],
        name_digits=len(str(nf)), aux2_tag=x2["tag"])
