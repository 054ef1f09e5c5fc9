"""BGZF (blocked gzip) codec — pure Python, zlib-backed.

BGZF is the container for BAM, bgzipped VCF, and tabix-indexable text: a
series of gzip members, each <= 64 KiB of uncompressed payload, carrying a
"BC" extra subfield with the compressed block size so readers can seek by
(compressed_offset << 16 | within_block_offset) "virtual offsets".

The reference pipeline shells out to `bgzip`/`tabix` for this
(reference phaser/phaser.py:1851-1853); we implement the format
natively.  A C++ multithreaded fast path lives in io/native; this module is
the always-available fallback and the spec reference for it.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Iterator, List, Tuple

# Fixed 28-byte EOF marker block (empty payload), per SAM spec section 4.1.2.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2B2H")  # magic(2)+CM+FLG, MTIME, XFL, OS, XLEN
MAX_BLOCK_PAYLOAD = 65280  # bgzip default uncompressed bytes per block


class BgzfError(ValueError):
    pass


def _parse_block_header(buf: bytes, off: int) -> Tuple[int, int]:
    """Return (bsize, xlen) for the gzip member starting at `off`.

    bsize = total compressed size of the member (from the BC subfield).
    """
    if buf[off] != 0x1F or buf[off + 1] != 0x8B:
        raise BgzfError("not a gzip stream at offset %d" % off)
    flg = buf[off + 3]
    if not flg & 4:
        raise BgzfError("gzip member lacks FEXTRA; not BGZF")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    xoff = off + 12
    xend = xoff + xlen
    while xoff + 4 <= xend:
        si1, si2, slen = buf[xoff], buf[xoff + 1], struct.unpack_from("<H", buf, xoff + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
            bsize = struct.unpack_from("<H", buf, xoff + 4)[0] + 1
            return bsize, xlen
        xoff += 4 + slen
    raise BgzfError("BGZF BC subfield not found")


def decompress_block(buf: bytes, off: int) -> Tuple[bytes, int]:
    """Decompress one BGZF block at byte offset `off`; return (payload, bsize)."""
    bsize, xlen = _parse_block_header(buf, off)
    cdata_start = off + 12 + xlen
    cdata_end = off + bsize - 8
    isize = struct.unpack_from("<I", buf, off + bsize - 4)[0]
    payload = zlib.decompress(buf[cdata_start:cdata_end], -15, isize or 1)
    if len(payload) != isize:
        raise BgzfError("BGZF ISIZE mismatch")
    return payload, bsize


def block_offsets(buf: bytes) -> List[int]:
    """Compressed byte offset of every block (including the EOF block)."""
    offs = []
    off = 0
    n = len(buf)
    while off < n:
        bsize, _ = _parse_block_header(buf, off)
        offs.append(off)
        off += bsize
    return offs


def decompress_all(buf: bytes) -> bytes:
    """Decompress an entire in-memory BGZF (or plain multi-member gzip) file."""
    out = []
    off = 0
    n = len(buf)
    while off < n:
        payload, bsize = decompress_block(buf, off)
        out.append(payload)
        off += bsize
    return b"".join(out)


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(18)
    if len(head) < 18 or head[0] != 0x1F or head[1] != 0x8B:
        return False
    try:
        _parse_block_header(head + b"\x00" * 8, 0)
        return True
    except (BgzfError, struct.error):
        return False


def is_gzip(path: str) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(2)
    return head == b"\x1f\x8b"


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """Compress <=64KiB payload into one BGZF block."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    bsize = len(cdata) + 26  # 12 hdr + 6 extra + 8 trailer
    if bsize > 0x10000:
        raise BgzfError("compressed block too large")
    hdr = struct.pack(
        "<4BIBBHBBHH",
        0x1F, 0x8B, 8, 4,  # magic, CM=deflate, FLG=FEXTRA
        0,                 # MTIME
        0, 0xFF,           # XFL, OS
        6,                 # XLEN
        66, 67, 2,         # SI1='B', SI2='C', SLEN=2
        bsize - 1,
    )
    trailer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return hdr + cdata + trailer


class BgzfWriter:
    """Streaming BGZF writer tracking virtual offsets (for index building)."""

    def __init__(self, path_or_fh, level: int = 6):
        if isinstance(path_or_fh, (str, os.PathLike)):
            self._fh = open(path_or_fh, "wb")
            self._own = True
        else:
            self._fh = path_or_fh
            self._own = False
        self._level = level
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes written so far

    @property
    def virtual_offset(self) -> int:
        """Virtual offset of the next byte to be written."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_PAYLOAD:
            self._flush_block(MAX_BLOCK_PAYLOAD)

    def _flush_block(self, n: int) -> None:
        # incompressible payloads can exceed the 64 KiB block limit after
        # deflate overhead; shrink the chunk until it fits (bgzip behavior)
        while True:
            chunk = bytes(self._buf[:n])
            try:
                block = compress_block(chunk, self._level)
                break
            except BgzfError:
                n -= 4096
                if n <= 0:
                    raise
        del self._buf[:n]
        self._fh.write(block)
        self._coffset += len(block)

    def flush_block(self) -> None:
        """Force-start a new block (e.g. to align record boundaries)."""
        if self._buf:
            self._flush_block(len(self._buf))

    def close(self) -> None:
        self.flush_block()
        self._fh.write(BGZF_EOF)
        self._coffset += len(BGZF_EOF)
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Random-access BGZF reader over an in-memory buffer.

    Supports sequential reads and seeks to virtual offsets (for tabix/BAI).
    Files of interest (chr-scale VCF/BAM test data) fit in memory; the C++
    path streams.
    """

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self._raw = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as fh:
                self._raw = fh.read()
        self._block_payload = b""
        self._block_coff = -1
        self._within = 0

    def _load_block(self, coff: int) -> None:
        if coff == self._block_coff:
            return
        payload, _ = decompress_block(self._raw, coff)
        self._block_payload = payload
        self._block_coff = coff

    def seek_virtual(self, voff: int) -> None:
        self._load_block(voff >> 16)
        self._within = voff & 0xFFFF

    def tell_virtual(self) -> int:
        return (self._block_coff << 16) | self._within

    def read(self, n: int) -> bytes:
        out = io.BytesIO()
        need = n
        while need > 0:
            if self._block_coff < 0:
                self._load_block(0)
            avail = len(self._block_payload) - self._within
            if avail <= 0:
                nxt = self._next_block_offset()
                if nxt is None:
                    break
                self._load_block(nxt)
                self._within = 0
                continue
            take = min(avail, need)
            out.write(self._block_payload[self._within:self._within + take])
            self._within += take
            need -= take
        return out.getvalue()

    def _next_block_offset(self):
        if self._block_coff < 0:
            return 0
        bsize, _ = _parse_block_header(self._raw, self._block_coff)
        nxt = self._block_coff + bsize
        if nxt >= len(self._raw):
            return None
        # skip EOF-marker/empty blocks transparently
        return nxt

    def read_range(self, vbeg: int, vend: int) -> bytes:
        """Payload bytes between two virtual offsets (end exclusive)."""
        out = []
        coff = vbeg >> 16
        within = vbeg & 0xFFFF
        end_coff = vend >> 16
        end_within = vend & 0xFFFF
        while True:
            payload, bsize = decompress_block(self._raw, coff)
            if coff == end_coff:
                out.append(payload[within:end_within])
                break
            out.append(payload[within:])
            coff += bsize
            within = 0
            if coff >= len(self._raw):
                break
            if coff > end_coff:
                break
        return b"".join(out)

    def read_all_from(self, voff: int) -> bytes:
        self.seek_virtual(voff)
        chunks = [self._block_payload[self._within:]]
        nxt = self._next_block_offset()
        while nxt is not None:
            payload, bsize = decompress_block(self._raw, nxt)
            chunks.append(payload)
            if nxt + bsize >= len(self._raw):
                break
            nxt += bsize
        return b"".join(chunks)


def compress_bytes(data, level: int = 6, eof: bool = True) -> bytes:
    """BGZF-compress a whole buffer; uses the parallel native compressor
    (libdeflate) when available, Python zlib otherwise."""
    from . import native as native_mod
    import numpy as _np
    if isinstance(data, str):
        data = data.encode()
    lib = native_mod.get_lib()
    if lib is not None and hasattr(lib, "bgzf_compress"):
        arr = _np.frombuffer(data, _np.uint8) if not isinstance(
            data, _np.ndarray) else data
        body = _native_compress(lib, arr, level)
        if body is not None:
            return body + BGZF_EOF if eof else body
    parts = []
    data = bytes(data)
    for off in range(0, len(data), 0xFF00):
        parts.append(compress_block(data[off:off + 0xFF00], level))
    if eof:
        parts.append(BGZF_EOF)
    return b"".join(parts)


def _native_compress(lib, arr, level: int, sizes=None):
    """The native compressor's blocks of the uint8 array arr (no EOF
    block), None on failure; `sizes`, an int64 array of one entry per
    block, receives their compressed sizes."""
    import ctypes
    import numpy as _np
    ptr = ctypes.c_void_p
    out = _np.empty(int(lib.bgzf_compress_bound(len(arr))), _np.uint8)
    args = (arr.ctypes.data_as(ptr), len(arr), level, out.ctypes.data_as(ptr),
            min(os.cpu_count() or 1, 8))
    got = lib.bgzf_compress(*args) if sizes is None else \
        lib.bgzf_compress_sized(*args, sizes.ctypes.data_as(ptr))
    return out[:got].tobytes() if got >= 0 else None


def compress_sized(arr, level: int = 6):
    """(compress_bytes(arr, level), compressed sizes, payload sizes) of
    the uint8 array arr, the sizes of every block the stream holds, the EOF
    block last: what places a line in the stream without reading it back.
    Needs the native library."""
    from . import native as native_mod
    import numpy as _np
    n_blocks = -(-len(arr) // MAX_BLOCK_PAYLOAD)
    csizes = _np.zeros(n_blocks + 1, _np.int64)
    body = _native_compress(native_mod.get_lib(), arr, level, csizes)
    if body is None:
        raise BgzfError("native BGZF compression failed")
    csizes[-1] = len(BGZF_EOF)
    usizes = _np.full(n_blocks + 1, MAX_BLOCK_PAYLOAD, _np.int64)
    usizes[-1] = 0
    if n_blocks:
        usizes[-2] = len(arr) - (n_blocks - 1) * MAX_BLOCK_PAYLOAD
    return body + BGZF_EOF, csizes, usizes


def compress_to_path(data: bytes, path: str, level: int = 6) -> None:
    with open(path, "wb") as fh:
        fh.write(compress_bytes(data, level=level))


def read_text_auto(path: str) -> bytes:
    """Read a file that may be plain, gzip, or BGZF; return raw bytes."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":
        try:
            return decompress_all(raw)
        except BgzfError:
            import gzip as _gz
            return _gz.decompress(raw)
    return raw
