"""Compares the outputs of a run of the program with the reference's.

Every line of the five text outputs and of the phased VCF is compared
field by field.  A field that differs counts its line as differing,
unless both read as numbers with a fractional part or an exponent (the
p-values, the confidences), whose relative gap is measured instead."""

from __future__ import annotations

import gzip
import math
import os
import re

OUTPUTS = ("allelic_counts.txt", "variant_connections.txt",
           "haplotypes.txt", "allele_config.txt", "haplotypic_counts.txt")
_REAL = re.compile(r"^-?(\d+\.\d*|\d*\.\d+|\d+)(e[-+]?\d+)?$|^-?(nan|inf)$",
                   re.I)


def _real(s: str):
    if _REAL.match(s) and ("." in s or "e" in s.lower() or
                           s.lower().lstrip("-") in ("nan", "inf")):
        return float(s)
    return None


def compare_lines(got: list, want: list):
    """(lines that differ, the widest relative gap of real fields)."""
    differ = abs(len(got) - len(want))
    gap = 0.0
    for a, b in zip(got, want):
        if a == b:
            continue
        fa, fb = a.split("\t"), b.split("\t")
        bad = len(fa) != len(fb)
        for x, y in zip(fa, fb):
            if x == y:
                continue
            rx, ry = _real(x), _real(y)
            if rx is None or ry is None:
                bad = True
            elif not (math.isnan(rx) and math.isnan(ry)):
                g = abs(rx - ry) / max(abs(ry), 1e-300)
                gap = max(gap, g if g == g else math.inf)
        differ += bad
    return differ, gap


def read_lines(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return fh.read().splitlines()


def compare(got_prefix: str, want_prefix: str,
            got_vcf: str = ".vcf.gz") -> dict:
    """{"rows_differ", "real_gap", "files_missing"} of the program's
    outputs at got_prefix against the reference's at want_prefix; the
    phased VCF is `<got_prefix><got_vcf>` (`.vcf` where the reference
    stands in the program's place)."""
    differ, gap, missing = 0, 0.0, 0
    pairs = [(got_prefix + "." + f, want_prefix + "." + f) for f in OUTPUTS]
    pairs.append((got_prefix + got_vcf, want_prefix + ".vcf"))
    for g, w in pairs:
        if not os.path.exists(g):
            missing += 1
            continue
        d, x = compare_lines(read_lines(g), read_lines(w))
        differ += d
        gap = max(gap, x)
    return {"rows_differ": differ, "real_gap": gap, "files_missing": missing}
