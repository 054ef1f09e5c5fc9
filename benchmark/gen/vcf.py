"""The bgzipped VCF and its tabix index."""

from __future__ import annotations

import numpy as np

from . import bgzf, index


def write(path: str, cfg: dict, donor, threads: int = 8) -> None:
    """Writes path (BGZF, cut every BLOCK_PAYLOAD bytes as bgzip does) and
    path + ".tbi"."""
    data = donor.vcf_text.encode()
    buf = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate(([0], nl[:-1] + 1))
    body = buf[starts] != ord("#")
    cuts = np.arange(0, len(data), bgzf.BLOCK_PAYLOAD)
    cuts, coff = bgzf.write(path, data, cuts, level=6, threads=threads)
    ls = starts[body]
    le = nl[body] + 1
    ref_len = np.array([len(r) for r in donor.ref], np.int64)
    names = [n for n, _ in cfg["header_contigs"]]
    raw = index.tbi(names, names.index(donor.contig), donor.pos - 1,
                    donor.pos - 1 + ref_len,
                    bgzf.virtual_offsets(ls, cuts, coff),
                    bgzf.virtual_offsets(le, cuts, coff))
    bgzf.write(path + ".tbi", raw, np.arange(0, len(raw), bgzf.BLOCK_PAYLOAD),
               level=6, threads=1)
