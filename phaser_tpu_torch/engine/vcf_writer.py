"""Phased VCF writer — reproduction of write_vcf
(reference phaser/phaser.py:1661-1855): re-stream the input VCF cut to
the sample column, inject PG/PB/PI/PM/PW/PC (and PS under --gw_phase_vcf 2),
optionally rewrite GT from the genome-wide phase, then bgzip + tabix with our
own codecs.

With the native IO library the writer makes one pass over the text in
memory: the library inflates the VCF, scans its lines (`vcf_scan`: the
contig and position filters, each body line's POS and columns), and writes
every output line into one buffer (`vcf_emit`: the cut, FORMAT extended,
the lines that are not phased tagged); Python formats only the phased
lines; the buffer is compressed and indexed where it lies
(`tabix.vcf_index_from_text`).  Without the library (PHASER_TPU_NO_NATIVE=1),
or for a text the scan does not take, every line goes through the Python
loop, which writes the same files.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from ..io import bgzf, native, tabix
from ..io.vcf import cut_columns, iter_vcf_lines
from ..utils import trace
from ..utils.counters import bump
from ..utils.fmt import list_to_string
from .output_stage import OutputState, PhaserOptions

_TAGS = ("PG", "PB", "PI", "PW", "PC", "PM")

_FORMAT_HEADERS = [
    ("PG", "##FORMAT=<ID=PG,Number=1,Type=String,Description=\"phASER Local Genotype\">"),
    ("PB", "##FORMAT=<ID=PB,Number=1,Type=String,Description=\"phASER Local Block\">"),
    ("PI", "##FORMAT=<ID=PI,Number=1,Type=String,Description=\"phASER Local Block Index (unique for each block)\">"),
    ("PM", "##FORMAT=<ID=PM,Number=1,Type=String,Description=\"phASER Local Block Maximum Variant MAF\">"),
    ("PW", "##FORMAT=<ID=PW,Number=1,Type=String,Description=\"phASER Genome Wide Genotype\">"),
    ("PC", "##FORMAT=<ID=PC,Number=1,Type=String,Description=\"phASER Genome Wide Confidence\">"),
]
_PS_HEADER = ("##FORMAT=<ID=PS,Number=1,Type=String,"
              "Description=\"Phase Set\">")

# body lines written by the native emit and formatted in Python; a
# `#7 vcf write` span records their increase
COUNTS = {"lines_native": 0, "lines_python": 0}

# vcf_scan's line kinds (csrc/phaser_io.cc)
_BODY_GT = 5
_DIGITS = re.compile(r"[0-9]+")


class _Formatter:
    """A body line's output columns: FORMAT extended with the tags, the
    sample column padded and tagged, from the phased state where the line's
    variant is phased.  Counts the GTs the genome-wide phase corrects."""

    def __init__(self, state: OutputState, opts: PhaserOptions,
                 rsid_lookup):
        self._state = state
        self._opts = opts
        self._rsid = rsid_lookup
        self.phased = state.haplotype_lookup
        self._fmt_cache = {}
        self._block_cache = {}
        self.phase_corrections = 0
        self.unphased_phased = 0

    def line(self, vcf_columns: List[str]) -> str:
        """The output line of a body line's cut columns (modified)."""
        chrom = vcf_columns[0]
        pos = int(vcf_columns[1])
        if "GT" in vcf_columns[8]:
            # format strings repeat across lines: parse each DISTINCT
            # one once (gt position, tag indices, extended header) —
            # the per-line .split/.index chain was ~1/3 of #7 time
            cache = self._fmt_cache.get(vcf_columns[8])
            if cache is None:
                fields0 = vcf_columns[8].split(":")
                gt_index = fields0.index("GT")
                vff = list(fields0)
                for tag in ["PG", "PB", "PI", "PW", "PC", "PM"]:
                    if tag not in vff:
                        vff.append(tag)
                cache = (gt_index, len(fields0), ":".join(vff), vff,
                         {t: vff.index(t) for t in _TAGS})
                self._fmt_cache[vcf_columns[8]] = cache
            gt_index, n_fields, fmt_out, vcf_format_fields, tag_idx = \
                cache

            alt_alleles = vcf_columns[4].split(",")
            all_alleles = [vcf_columns[3]] + alt_alleles

            for i in range(9, len(vcf_columns)):
                sample_fields_n = len(vcf_columns[i].split(":"))
                if sample_fields_n != n_fields:
                    vcf_columns[i] += ":" * (n_fields - sample_fields_n)

            vcf_columns[8] = fmt_out

            unique_id = (chrom + self._opts.id_separator + str(pos) +
                         self._opts.id_separator +
                         self._opts.id_separator.join(all_alleles))

            if unique_id in self.phased:
                alleles_out = []
                gw_phase_out = ["", ""]
                variants_lu, hap_pair, block_index = \
                    self._state.haplotype_lookup[unique_id]
                ind_alleles = self._state.ind_alleles[unique_id]
                gw_list = self._state.gw_phase[unique_id]
                for allele in hap_pair.split("|"):
                    allele_base = ind_alleles[int(allele)]
                    vcf_allele_index = all_alleles.index(allele_base)
                    gw_phase = gw_list[int(allele)]
                    if isinstance(gw_phase, int):
                        gw_phase_out[gw_phase] = str(vcf_allele_index)
                    alleles_out.append(str(vcf_allele_index))

                # every variant of a block shares the same variants_lu
                # LIST OBJECT (output_stage stores one list per block):
                # format the block-level strings once per block
                blk = self._block_cache.get(id(variants_lu))
                if blk is None:
                    vl_str = list_to_string(variants_lu)
                    blk = (list_to_string(
                               [self._rsid[v].replace(":", "_")
                                for v in variants_lu]),
                           str(self._state.gw_stat_lookup[vl_str]),
                           self._state.gw_stat_lookup[vl_str],
                           str(self._state.max_maf_lookup[vl_str]))
                    self._block_cache[id(variants_lu)] = blk
                pb_str, pc_str, gw_stat, pm_str = blk

                if "-" not in gw_phase_out:
                    xfields = vcf_columns[9].split(":")
                    new_phase = "|".join(gw_phase_out)
                    if gw_stat >= self._opts.gw_phase_vcf_min_confidence:
                        if "|" in xfields[gt_index] and \
                                xfields[gt_index] != new_phase:
                            self.phase_corrections += 1
                        if "/" in xfields[gt_index] and \
                                xfields[gt_index] != "./." and \
                                xfields[gt_index] != new_phase:
                            self.unphased_phased += 1
                        if self._opts.gw_phase_vcf in (1, 2):
                            xfields[gt_index] = new_phase
                            vcf_columns[9] = ":".join(xfields)
                    if self._opts.gw_phase_vcf == 2 and \
                            gw_stat < self._opts.gw_phase_vcf_min_confidence:
                        xfields[gt_index] = "|".join(alleles_out)
                        vcf_columns[9] = ":".join(xfields)

                sample_fields = vcf_columns[9].split(":")
                sample_fields += [""] * (len(vcf_format_fields) - len(sample_fields))
                sample_fields[tag_idx["PG"]] = "|".join(alleles_out)
                sample_fields[tag_idx["PB"]] = pb_str
                sample_fields[tag_idx["PI"]] = str(block_index)
                sample_fields[tag_idx["PM"]] = pm_str
                sample_fields[tag_idx["PW"]] = "|".join(gw_phase_out)
                sample_fields[tag_idx["PC"]] = pc_str

                if self._opts.gw_phase_vcf == 2 and \
                        gw_stat < self._opts.gw_phase_vcf_min_confidence:
                    if "PS" not in vcf_format_fields:
                        # copy: vcf_format_fields is the cached list
                        vcf_format_fields = vcf_format_fields + ["PS"]
                        vcf_columns[8] += ":PS"
                        sample_fields.append("")
                    sample_fields[vcf_format_fields.index("PS")] = str(block_index)

                vcf_columns[9] = ":".join(sample_fields)
            else:
                genotype = list(vcf_columns[9].split(":")[gt_index])
                if "|" in genotype:
                    genotype.remove("|")
                if "/" in genotype:
                    genotype.remove("/")
                sample_fields = vcf_columns[9].split(":")
                sample_fields += [""] * (len(vcf_format_fields) - len(sample_fields))
                sample_fields[tag_idx["PG"]] = \
                    "/".join(sorted(genotype))
                sample_fields[tag_idx["PB"]] = "."
                sample_fields[tag_idx["PI"]] = "."
                sample_fields[tag_idx["PM"]] = "."
                sample_fields[tag_idx["PW"]] = \
                    vcf_columns[9].split(":")[gt_index]
                sample_fields[tag_idx["PC"]] = "."
                vcf_columns[9] = ":".join(sample_fields)


        return "\t".join(vcf_columns[0:9] + [vcf_columns[9]])


def write_phased_vcf(vcf_path: str, sample_column: int, out_prefix: str,
                     chromosome_of_interest: str, state: OutputState,
                     opts: PhaserOptions, csi_index: bool = False,
                     rsid_lookup=None, pos_ranges=None,
                     body_only: bool = False,
                     write_header_file: bool = False) -> Tuple[int, int]:
    """Returns (unphased_phased, phase_corrections).

    pos_ranges + body_only: ownership-balanced sharded form — write ONLY
    body rows whose (contig, position) falls in this shard's decode
    ranges (`pos_ranges`: contig -> [(lo, hi)) 0-based), to
    `<out_prefix>.vcfbody.gz` with no header; ranges tile each contig and
    shards hold contiguous global spans, so concatenating the per-shard
    bodies in shard order reproduces the single-process byte order.
    write_header_file additionally emits `<out_prefix>.vcfhdr.gz` (the
    processed header block alone) for the merge to prepend."""
    fmt = _Formatter(state, opts, rsid_lookup)
    args = (vcf_path, sample_column, out_prefix, chromosome_of_interest, fmt,
            opts, csi_index, pos_ranges, body_only, write_header_file)
    lib = native.get_lib()
    if lib is None or not _write_native(lib, *args):
        _write_python(*args)
    return fmt.unphased_phased, fmt.phase_corrections


def _write_python(vcf_path, sample_column, out_prefix,
                  chromosome_of_interest, fmt, opts, csi_index, pos_ranges,
                  body_only, write_header_file) -> None:
    """The writer as a loop over the text's lines in Python."""
    out_lines: List[str] = []
    header_lines: List[str] = []
    format_text = ""
    n_body = 0
    chrom_set = set(chromosome_of_interest.split(",")) \
        if chromosome_of_interest != "" else None

    def _emit_header(line: str) -> None:
        if body_only:
            header_lines.append(line)
        else:
            out_lines.append(line)

    chrom_arg = chromosome_of_interest if chromosome_of_interest != "" else None
    for raw_line in iter_vcf_lines(vcf_path, chrom_arg):
        if pos_ranges is not None and raw_line[0:1] != "#":
            # range-sharded body: shards share contigs, so filter BEFORE
            # the per-line cut/split work — a cheap two-field peek keeps
            # each body line's full processing on exactly one shard
            c_, p_, _ = raw_line.split("\t", 2)
            rngs = pos_ranges.get(c_)
            if rngs is None:
                continue
            p0 = int(p_) - 1
            if not any(lo <= p0 < hi for lo, hi in rngs):
                continue
        line = cut_columns(raw_line, sample_column)
        vcf_columns = line.split("\t")
        if "##FORMAT" in line:
            format_text += line + "\n"
            _emit_header(line)
        elif line.startswith("#CHROM"):
            for tag, hdr in _FORMAT_HEADERS:
                if ("##FORMAT=<ID=%s," % tag) not in format_text:
                    _emit_header(hdr)
            if opts.gw_phase_vcf == 2:
                if "##FORMAT=<ID=PS," not in format_text:
                    _emit_header(_PS_HEADER)
            _emit_header("\t".join(vcf_columns[0:9] + [vcf_columns[9]]))
        elif line[0:1] == "#":
            _emit_header(line)
        else:
            chrom = vcf_columns[0]
            pos = int(vcf_columns[1])
            if chrom_set is not None and chrom not in chrom_set:
                continue
            if pos_ranges is not None:
                ranges = pos_ranges.get(chrom)
                if ranges is None or not any(
                        lo <= pos - 1 < hi for lo, hi in ranges):
                    continue
            out_lines.append(fmt.line(vcf_columns))
            n_body += 1

    bump(COUNTS, "lines_python", n_body)
    if body_only:
        if write_header_file:
            bgzf.compress_to_path(
                ("\n".join(header_lines) + "\n").encode(),
                out_prefix + ".vcfhdr.gz")
        body = ("\n".join(out_lines) + "\n").encode() if out_lines \
            else b""
        bgzf.compress_to_path(body, out_prefix + ".vcfbody.gz")
        return
    text = ("\n".join(out_lines) + "\n").encode()
    gz_path = out_prefix + ".vcf.gz"
    bgzf.compress_to_path(text, gz_path)
    if csi_index:
        tabix.build_csi_index(gz_path)
    else:
        tabix.build_vcf_index(gz_path)


def _write_native(lib, vcf_path, sample_column, out_prefix,
                  chromosome_of_interest, fmt, opts, csi_index, pos_ranges,
                  body_only, write_header_file) -> bool:
    """The writer as one native pass over the text in memory; False, with
    nothing written, where the scan does not take the text."""
    with trace.span("vcf inflate"):
        text = _inflate(lib, vcf_path)
    with trace.span("vcf scan"):
        lines = _scan(lib, text, sample_column, chromosome_of_interest,
                      pos_ranges)
    if lines is None:
        return False
    with trace.span("vcf phased"):
        repl_line, repl = _phased_lines(fmt, text, lines, sample_column,
                                        opts.id_separator)
    with trace.span("vcf emit"):
        extra = [hdr for _, hdr in _FORMAT_HEADERS]
        if opts.gw_phase_vcf == 2:
            extra.append(_PS_HEADER)
        hdr, body, counts = _emit(lib, text, lines, sample_column, extra,
                                  body_only, repl_line, repl)
    bump(COUNTS, "lines_native", counts[0])
    bump(COUNTS, "lines_python", counts[1])
    nl = np.frombuffer(b"\n", np.uint8)
    if body_only:
        with trace.span("vcf compress"):
            if write_header_file:
                bgzf.compress_to_path(hdr if len(hdr) else nl,
                                      out_prefix + ".vcfhdr.gz")
            bgzf.compress_to_path(body, out_prefix + ".vcfbody.gz")
        return True
    text_out = body if len(body) else nl
    gz_path = out_prefix + ".vcf.gz"
    with trace.span("vcf compress"):
        gz, csizes, usizes = bgzf.compress_sized(text_out)
        with open(gz_path, "wb") as fh:
            fh.write(gz)
    with trace.span("vcf index"):
        if csi_index:
            tabix.build_csi_index(gz_path)
        else:
            bgzf.compress_to_path(
                tabix.vcf_index_from_text(text_out, csizes, usizes),
                gz_path + ".tbi")
    return True


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _inflate(lib, path: str) -> np.ndarray:
    """The VCF's text as a uint8 array: BGZF inflated by the library's
    threads; plain gzip and plain text as bgzf.read_text_auto reads them."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] != b"\x1f\x8b":
        return np.frombuffer(raw, np.uint8)
    total = lib.bgzf_total_size(raw, len(raw))
    if total >= 0:
        text = np.empty(total, np.uint8)
        if lib.bgzf_decompress(raw, len(raw), _ptr(text),
                               min(os.cpu_count() or 1, 8)) == total:
            return text
    return np.frombuffer(bgzf.read_text_auto(path), np.uint8)


def _scan(lib, text: np.ndarray, sample_column: int,
          chromosome_of_interest: str, pos_ranges):
    """(kind, lstart, lend, pos, cols) of the text's lines, the filters
    applied (`vcf_scan`), or None where the scan does not take the text."""
    chroms = chromosome_of_interest.split(",") \
        if chromosome_of_interest != "" else None
    if pos_ranges is not None:
        contigs = [(c, r) for c, r in pos_ranges.items()
                   if chroms is None or c in chroms]
    elif chroms is not None:
        contigs = [(c, ()) for c in dict.fromkeys(chroms)]
    else:
        contigs = []
    names = [c.encode() for c, _ in contigs]
    contig_buf = np.frombuffer(b"".join(names) or b"\0", np.uint8)
    contig_off = np.cumsum([0] + [len(n) for n in names], dtype=np.int64)
    rng_off = np.cumsum([0] + [len(r) for _, r in contigs], dtype=np.int64)
    rng = np.array([(lo, hi) for _, r in contigs for lo, hi in r],
                   np.int64).reshape(-1, 2)
    rng_lo, rng_hi = np.ascontiguousarray(rng[:, 0]), \
        np.ascontiguousarray(rng[:, 1])
    cap = int(np.count_nonzero(text == 10)) + 1
    kind = np.empty(cap, np.int8)
    lstart, lend, pos = (np.empty(cap, np.int64) for _ in range(3))
    cols = np.empty((cap, 5), np.int32)
    n = lib.vcf_scan(
        _ptr(text), len(text), sample_column,
        len(contigs) if chroms is not None or pos_ranges is not None else -1,
        _ptr(contig_buf), _ptr(contig_off), int(pos_ranges is not None),
        _ptr(rng_off), _ptr(rng_lo), _ptr(rng_hi), cap, _ptr(kind),
        _ptr(lstart), _ptr(lend), _ptr(pos), _ptr(cols))
    if n < 0:
        return None
    return kind[:n], lstart[:n], lend[:n], pos[:n], cols[:n]


def _key_positions(keys, sep: str) -> Optional[np.ndarray]:
    """Every number in the phased variants' ids, a superset of their
    positions: an id is CHROM sep POS sep alleles, so POS is a whole run of
    digits when sep holds none.  None where sep is empty or holds one."""
    if not sep or _DIGITS.search(sep):
        return None
    return np.array(sorted({int(d) for k in keys for d in _DIGITS.findall(k)
                            if len(d) <= 18}), np.int64)


def _phased_lines(fmt: _Formatter, text: np.ndarray, lines, sample_column,
                  sep: str):
    """(line indices, output lines) of the GT lines whose variant is
    phased, formatted by the Python code; candidates by POS first."""
    kind, lstart, lend, pos, cols = lines
    keys = fmt.phased
    cand = np.flatnonzero(kind == _BODY_GT)
    if not keys or not len(cand):
        return [], []
    positions = _key_positions(keys, sep)
    if positions is not None:
        cand = cand[np.isin(pos[cand], positions)]
    idx, out = [], []
    for i, s, p, (c0, _, c2, c3, c4) in zip(
            cand.tolist(), lstart[cand].tolist(), pos[cand].tolist(),
            cols[cand].tolist()):
        uid = sep.join((text[s:s + c0].tobytes().decode(), str(p),
                        text[s + c2 + 1:s + c3].tobytes().decode(),
                        text[s + c3 + 1:s + c4].tobytes().decode()
                        .replace(",", sep)))
        if uid not in keys:
            continue
        line = text[s:lend[i]].tobytes().decode()
        idx.append(i)
        out.append(fmt.line(cut_columns(line, sample_column).split("\t"))
                   .encode())
    return idx, out


def _emit(lib, text, lines, sample_column, extra, body_only, repl_line,
          repl):
    """(header lines, the other lines, [native, copied] body lines) of
    `vcf_emit` as uint8 arrays; the header lines go with the others
    unless body_only."""
    kind, lstart, lend, _, _ = lines
    ex = [h.encode() for h in extra]
    ex_buf = np.frombuffer(b"".join(ex), np.uint8)
    ex_off = np.cumsum([0] + [len(h) for h in ex], dtype=np.int64)
    r_line = np.array(repl_line, np.int64)
    r_buf = np.frombuffer(b"".join(repl) or b"\0", np.uint8)
    r_off = np.cumsum([0] + [len(r) for r in repl], dtype=np.int64)
    counts = np.zeros(2, np.int64)
    h = lib.vcf_emit(_ptr(text), len(kind), _ptr(kind), _ptr(lstart),
                     _ptr(lend), sample_column, len(ex), _ptr(ex_buf),
                     _ptr(ex_off), int(body_only), len(r_line), _ptr(r_line),
                     _ptr(r_off), _ptr(r_buf), _ptr(counts))
    try:
        out = []
        for which in (0, 1):
            arr = np.empty(lib.vcf_emit_size(h, which), np.uint8)
            if len(arr):
                ctypes.memmove(_ptr(arr), lib.vcf_emit_data(h, which),
                               len(arr))
            out.append(arr)
    finally:
        lib.vcf_emit_free(h)
    return out[0], out[1], counts.tolist()
