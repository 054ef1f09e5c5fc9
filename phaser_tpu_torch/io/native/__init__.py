"""Loader for the native IO library (g++ -O3, zlib, pthreads).

The source is csrc/phaser_io.cc; utils/build.py compiles it at first use
into _build/libphaser_io.so.  A failed build or load raises: the port does
not retreat to pure Python on its own.  PHASER_TPU_NO_NATIVE=1 is the one
explicit way to run without the library (get_lib() then returns None and
every caller takes its numpy / pure-Python path).
"""

from __future__ import annotations

import ctypes
import os
import threading

_lock = threading.Lock()
_lib = None


def get_lib():
    """Returns the ctypes library, or None under PHASER_TPU_NO_NATIVE=1."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("PHASER_TPU_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None:
            return _lib
        from ...utils import build
        lib = build.get_io_lib()
        _declare(lib)
        _lib = lib
    return _lib


def _declare(lib) -> None:
    c = ctypes
    lib.bgzf_total_size.restype = c.c_int64
    lib.bgzf_total_size.argtypes = [c.c_void_p, c.c_int64]
    lib.bgzf_decompress.restype = c.c_int64
    lib.bgzf_decompress.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                    c.c_int]
    lib.bam_parse.restype = c.c_void_p
    lib.bam_parse.argtypes = [c.c_void_p, c.c_int64]
    lib.bam_header_only.restype = c.c_void_p
    lib.bam_header_only.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
    lib.bam_records_parse.restype = c.c_void_p
    lib.bam_records_parse.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
    for fn in ("bam_n_records", "bam_total_cigar", "bam_total_seq",
               "bam_names_size", "bam_refnames_size", "bam_header_size"):
        getattr(lib, fn).restype = c.c_int64
        getattr(lib, fn).argtypes = [c.c_void_p]
    lib.bam_n_refs.restype = c.c_int32
    lib.bam_n_refs.argtypes = [c.c_void_p]
    lib.bam_fill.restype = None
    lib.bam_fill.argtypes = [c.c_void_p] + [c.c_void_p] * 16
    lib.bam_free.restype = None
    lib.bam_free.argtypes = [c.c_void_p]
    lib.exact_assign.restype = c.c_int64
    lib.exact_assign.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_int, c.c_int,
        c.c_int64, c.c_void_p, c.c_void_p,
        c.c_int64, c.c_void_p, c.c_void_p,
        c.c_int64, c.c_void_p, c.c_void_p]
    lib.bgzf_compress_bound.restype = c.c_int64
    lib.bgzf_compress_bound.argtypes = [c.c_int64]
    lib.bgzf_compress.restype = c.c_int64
    lib.bgzf_compress.argtypes = [c.c_void_p, c.c_int64, c.c_int,
                                  c.c_void_p, c.c_int]
    lib.bgzf_compress_sized.restype = c.c_int64
    lib.bgzf_compress_sized.argtypes = [c.c_void_p, c.c_int64, c.c_int,
                                        c.c_void_p, c.c_int, c.c_void_p]
    lib.vcf_scan.restype = c.c_int64
    lib.vcf_scan.argtypes = [c.c_void_p, c.c_int64, c.c_int32, c.c_int64,
                             c.c_void_p, c.c_void_p, c.c_int32] + \
        [c.c_void_p] * 3 + [c.c_int64] + [c.c_void_p] * 5
    lib.vcf_emit.restype = c.c_void_p
    lib.vcf_emit.argtypes = [c.c_void_p, c.c_int64] + [c.c_void_p] * 3 + \
        [c.c_int32, c.c_int32, c.c_void_p, c.c_void_p, c.c_int32,
         c.c_int64] + [c.c_void_p] * 4
    lib.vcf_emit_size.restype = c.c_int64
    lib.vcf_emit_size.argtypes = [c.c_void_p, c.c_int32]
    lib.vcf_emit_data.restype = c.c_void_p
    lib.vcf_emit_data.argtypes = [c.c_void_p, c.c_int32]
    lib.vcf_emit_free.restype = None
    lib.vcf_emit_free.argtypes = [c.c_void_p]
    lib.vcf_tbx_scan.restype = c.c_int64
    lib.vcf_tbx_scan.argtypes = [c.c_void_p, c.c_int64, c.c_int64] + \
        [c.c_void_p] * 7
    lib.bam_scan_v2.restype = c.c_int64
    lib.bam_scan_v2.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                c.c_void_p, c.c_void_p, c.c_void_p]
    lib.bam_parse_v2.restype = c.c_int64
    lib.bam_parse_v2.argtypes = [c.c_void_p, c.c_int64, c.c_int64] + \
        [c.c_void_p] * 16 + [c.c_int]
    lib.near_sorted_native.restype = None
    lib.near_sorted_native.argtypes = [c.c_int64, c.c_void_p, c.c_void_p,
                                       c.c_int64, c.c_void_p, c.c_void_p,
                                       c.c_int]
    lib.map_simple_run.restype = c.c_void_p
    lib.map_simple_run.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int32,
        c.c_int, c.c_int, c.c_void_p, c.c_int]
    lib.map_simple_n.restype = c.c_int64
    lib.map_simple_n.argtypes = [c.c_void_p]
    lib.map_simple_fetch.restype = None
    lib.map_simple_fetch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_void_p]
    lib.scatter_rows.restype = None
    lib.scatter_rows.argtypes = [c.c_int64, c.c_void_p, c.c_void_p,
                                 c.c_int64, c.c_void_p, c.c_int]
    lib.prefault_alloc.restype = c.c_void_p
    lib.prefault_alloc.argtypes = [c.c_int64, c.c_int]
    lib.prefault_free.argtypes = [c.c_void_p]
    lib.pack_reads_native.restype = None
    lib.pack_reads_native.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_int]
    lib.pack_codes_quals_native.restype = None
    lib.pack_codes_quals_native.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_int]
    lib.pack_affine_native.restype = None
    lib.pack_affine_native.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
    lib.pack_affine_masked_native.restype = None
    lib.pack_affine_masked_native.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_int, c.c_int64, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
    lib.pack_affine_nibble_native.restype = None
    lib.pack_affine_nibble_native.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_int, c.c_int64, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
    lib.pack_delta_nibble_native.restype = None
    lib.pack_delta_nibble_native.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_int, c.c_int64, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_int]
    lib.bam_index_scan.restype = c.c_int64
    lib.bam_index_scan.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p]
    lib.read_spans_native.restype = None
    lib.read_spans_native.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
    lib.row_lengths_native.restype = None
    lib.row_lengths_native.argtypes = [c.c_int64, c.c_void_p, c.c_void_p,
                                       c.c_void_p, c.c_int]
    lib.stage_reads_native.restype = None
    lib.stage_reads_native.argtypes = [c.c_int64] + [c.c_void_p] * 15 + \
        [c.c_int]
    for fn in ("gather_ragged_u8", "gather_ragged_u32"):
        g = getattr(lib, fn)
        g.restype = None
        g.argtypes = [c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p,
                      c.c_void_p, c.c_void_p, c.c_int]
