"""phASER-POP expression matrix (parity with
reference phaser_pop/phaser_expr_matrix.py): aggregate per-sample gene
AE outputs into genes x samples BED matrices of "aCount|bCount" strings —
one with all counts, one keeping only gw_phased genes ("0|0" otherwise) —
bgzipped + tabix-indexed with our own codecs.

The gene AE files and the features are read, and the matrices written, by
utils.table, which types and formats the cells as phaser_tpu's pandas
calls do (so the outputs are the same bytes); no pandas is needed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..io import bgzf, tabix
from ..utils.table import read_tsv, tsv_text


def _index_bed(path_gz: str) -> None:
    """tabix -p bed equivalent for the matrix files."""
    raw = open(path_gz, "rb").read()
    data = bgzf.decompress_all(raw)
    # the VCF index writer with BED coordinates
    import bisect
    offs: List[int] = []
    plens: List[int] = []
    payloads: List[bytes] = []
    off = 0
    while off < len(raw):
        payload, bsize = bgzf.decompress_block(raw, off)
        offs.append(off)
        plens.append(len(payload))
        payloads.append(payload)
        off += bsize
    uends: List[int] = []
    acc = 0
    for n in plens:
        acc += n
        uends.append(acc)

    def uoff2voff(u: int) -> int:
        bi = bisect.bisect_right(uends, u)
        if bi >= len(offs):
            bi = len(offs) - 1
        return (offs[bi] << 16) | (u - (uends[bi] - plens[bi]))

    names: List[str] = []
    name_idx: Dict[str, int] = {}
    b = tabix.TabixIndexWriter([], fmt=tabix.FMT_GENERIC | tabix.FLAG_UCSC,
                               col_seq=1, col_beg=2, col_end=3)
    pos = 0
    n_total = len(data)
    while pos < n_total:
        nl = data.find(b"\n", pos)
        if nl < 0:
            nl = n_total
        line = data[pos:nl]
        if line and not line.startswith(b"#"):
            cols = line.split(b"\t", 3)
            chrom = cols[0].decode()
            s0, e0 = int(cols[1]), int(cols[2])
            if chrom not in name_idx:
                name_idx[chrom] = len(names)
                names.append(chrom)
                b._bins.append(dict())
                b._linear.append([])
            b.add(name_idx[chrom], s0, max(e0, s0 + 1), uoff2voff(pos),
                  uoff2voff(nl + 1))
        pos = nl + 1
    b.names = names
    b.write(path_gz + ".tbi")


def run_expr_matrix(gene_ae_dir: str, features: str, o: str,
                    log=print) -> None:
    df_features = read_tsv(features, header=False, comment="#")
    gene_list = df_features[3]

    files = sorted(f for f in os.listdir(gene_ae_dir) if ".txt" in f)
    if not files:
        raise RuntimeError("no files read for input")

    sample_cols_all: List[Tuple[str, List[str]]] = []
    sample_cols_phased: List[Tuple[str, List[str]]] = []
    first_frame: Optional[Dict] = None

    for fname in files:
        path = os.path.join(gene_ae_dir, fname)
        df = read_tsv(path)
        if "bam" not in df or "gw_phased" not in df:
            continue
        # canonical sample order: first appearance (reference: set order)
        for xsample in dict.fromkeys(df["bam"]):
            ds = df.where("bam", xsample)
            if ds["name"] != gene_list:
                log("ERROR - %s:%s genes are not in correct order..."
                    % (path, xsample))
                continue
            col_all, col_ph = [], []
            for gw, a, b in zip(ds["gw_phased"], ds["aCount"], ds["bCount"]):
                col_all.append(str(a) + "|" + str(b))
                col_ph.append(str(a) + "|" + str(b) if int(gw) == 1 else "0|0")
            sample_cols_all.append((xsample, col_all))
            sample_cols_phased.append((xsample, col_ph))
            if first_frame is None:
                first_frame = {"#contig": ds["contig"],
                               "start": ds["start"], "stop": ds["stop"],
                               "name": ds["name"]}

    if first_frame is None:
        raise RuntimeError("no usable gene AE files")

    for suffix, cols in ((".bed", sample_cols_all),
                        (".gw_phased.bed", sample_cols_phased)):
        # a sample (or a label) seen again replaces its column in place, as
        # `dfm[sample] = col` does
        dfm = dict(first_frame)
        for sample, col in cols:
            dfm[sample] = col
        text = tsv_text(dfm)
        gz = o + suffix + ".gz"
        bgzf.compress_to_path(text.encode(), gz)
        _index_bed(gz)
