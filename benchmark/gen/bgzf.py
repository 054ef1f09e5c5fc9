"""BGZF writing for the benchmark's inputs (SAM/BAM specification, section
4.1): the stream is cut into blocks of at most BLOCK_PAYLOAD bytes, each
deflated on its own by a pool of threads (zlib releases the interpreter
lock), and every block boundary is reported so that an index can turn
uncompressed offsets into virtual offsets."""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

BLOCK_PAYLOAD = 0xFF00          # what htslib and bgzip put in a block
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    if len(cdata) + 26 > 0x10000:          # incompressible: store it
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
    head = struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       66, 67, 2, len(cdata) + 25)
    return head + cdata + struct.pack("<II", zlib.crc32(payload),
                                      len(payload))


def record_blocks(starts: np.ndarray, total: int) -> np.ndarray:
    """Uncompressed offsets at which blocks begin, packing whole records
    greedily as htslib does (a record longer than a block is split).
    `starts` are the records' offsets in a stream of `total` bytes."""
    cuts = [0]
    ends = np.append(starts[1:], total)
    while total - cuts[-1] > BLOCK_PAYLOAD:
        lim = cuts[-1] + BLOCK_PAYLOAD
        # the last record that ends within the block
        i = int(np.searchsorted(ends, lim, side="right")) - 1
        nxt = int(ends[i]) if i >= 0 and ends[i] > cuts[-1] else lim
        cuts.append(nxt)
    return np.asarray(cuts, np.int64)


def compress(data, cuts: Sequence[int], level: int, threads: int
             ) -> Tuple[List[bytes], np.ndarray]:
    """(blocks, compressed offset of each block) of `data` cut at `cuts`."""
    view = memoryview(data)
    bounds = list(cuts) + [len(data)]
    pieces = [bytes(view[bounds[i]:bounds[i + 1]])
              for i in range(len(cuts)) if bounds[i + 1] > bounds[i]]
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        blocks = list(pool.map(lambda p: _block(p, level), pieces))
    coff = np.zeros(len(blocks) + 1, np.int64)
    np.cumsum([len(b) for b in blocks], out=coff[1:])
    return blocks, coff


def virtual_offsets(uoff: np.ndarray, cuts: np.ndarray,
                    coff: np.ndarray) -> np.ndarray:
    """Virtual offsets of uncompressed offsets `uoff`, given the blocks'
    uncompressed and compressed starts with the stream's ends appended (as
    `write` returns them).  An offset at a block's end maps to the next
    block's start, as htslib reports it; the stream's end to the EOF
    block."""
    b = np.searchsorted(cuts, uoff, side="right") - 1
    return (coff[b] << 16) | (uoff - cuts[b])


def write(path: str, data, cuts: Sequence[int], level: int = 1,
          threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Writes `data` as BGZF cut at `cuts`; returns the blocks'
    uncompressed and compressed starts, each with the stream's end
    appended."""
    blocks, coff = compress(data, cuts, level, threads)
    with open(path, "wb") as fh:
        for blk in blocks:
            fh.write(blk)
        fh.write(EOF_BLOCK)
    return np.append(np.asarray(cuts, np.int64), len(data)), coff


def read(path: str) -> bytes:
    """The uncompressed stream of a BGZF file (gzip members in turn)."""
    raw = open(path, "rb").read()
    out = []
    off = 0
    while off < len(raw):
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        if xlen != 6 or raw[off + 12:off + 14] != b"BC":
            raise ValueError("not a BGZF block at %d of %s" % (off, path))
        out.append(zlib.decompress(raw[off + 18:off + bsize - 8], -15))
        off += bsize
    return b"".join(out)
