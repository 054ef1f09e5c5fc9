"""SAM text parsing into BamData struct-of-arrays.

Used by the standalone mapper CLI (stdin SAM, like the reference's
call_read_variant_map.py) and by tests that feed identical streams to both
implementations.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Tuple

import numpy as np

from .bam import BamData, CHAR_TO_NIBBLE, CIGAR_OPS

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_OP_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}


def parse_sam(lines: Iterable[str]) -> Tuple[BamData, List[str]]:
    """Parse SAM text (header + body) into BamData. Returns (bd, contigs).

    contigs preserves @SQ order (the reference mapper's contig-order oracle,
    read_variant_map.py:28-29).  AS is taken from the first AS tag
    left-to-right (:55-64).
    """
    contigs: List[str] = []
    names: List[bytes] = []
    refid, pos, mapq, flag, tlen = [], [], [], [], []
    as_score, has_as = [], []
    cig_parts, seq_parts, qual_parts = [], [], []
    cigar_counts, seq_lens = [], []
    header_lines: List[str] = []
    cmap = {}

    for line in lines:
        line = line.rstrip("\n")
        if not line:
            continue
        if line[0] == "@":
            header_lines.append(line)
            if line[0:3] == "@SQ":
                nm = line.split("\t")[1].split(":")[1]
                cmap[nm] = len(contigs)
                contigs.append(nm)
            continue
        cols = line.split("\t")
        names.append(cols[0].encode())
        flag.append(int(cols[1]))
        refid.append(cmap.get(cols[2], -1))
        pos.append(int(cols[3]) - 1)
        mapq.append(min(int(cols[4]), 255))
        cig_str = cols[5]
        if cig_str == "*":
            ops = np.zeros(0, np.uint32)
        else:
            ops = np.asarray([(int(n) << 4) | _OP_CODE[o]
                              for n, o in _CIG_RE.findall(cig_str)], np.uint32)
        cig_parts.append(ops)
        cigar_counts.append(len(ops))
        tlen.append(int(cols[8]))
        seq = cols[9]
        seq_parts.append(np.asarray([CHAR_TO_NIBBLE.get(c, 15) for c in seq.upper()],
                                    np.uint8))
        qual_parts.append(np.asarray([ord(c) - 33 for c in cols[10]], np.uint8)
                          if cols[10] != "*" else np.full(len(seq), 255, np.uint8))
        seq_lens.append(len(seq))
        a, ha = 0, False
        for fld in cols[11:]:
            if fld.startswith("AS:"):
                a = int(fld.split(":")[2])
                ha = True
                break
        as_score.append(a)
        has_as.append(ha)

    n = len(names)
    cigar_off = np.zeros(n + 1, np.int64)
    np.cumsum(cigar_counts, out=cigar_off[1:])
    seq_off = np.zeros(n + 1, np.int64)
    np.cumsum(seq_lens, out=seq_off[1:])
    ref_lengths = [0] * len(contigs)
    bd = BamData(
        ref_names=contigs, ref_lengths=ref_lengths,
        header_text="\n".join(header_lines),
        refid=np.asarray(refid, np.int32), pos=np.asarray(pos, np.int32),
        mapq=np.asarray(mapq, np.uint8), flag=np.asarray(flag, np.uint16),
        tlen=np.asarray(tlen, np.int32),
        as_score=np.asarray(as_score, np.int32),
        has_as=np.asarray(has_as, bool), names=names,
        cigar_flat=(np.concatenate(cig_parts) if cig_parts else np.zeros(0, np.uint32)),
        cigar_off=cigar_off,
        seq_flat=(np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8)),
        qual_flat=(np.concatenate(qual_parts) if qual_parts else np.zeros(0, np.uint8)),
        seq_off=seq_off,
    )
    return bd, contigs
