"""phaser_gene_ae-compatible CLI (reference phaser_gene_ae/
phaser_gene_ae.py:9-19)."""

from __future__ import annotations

import argparse
import sys

from ..analysis.gene_ae import run_gene_ae


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phaser_gene_ae")
    p.add_argument("--haplotypic_counts", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--o", required=True)
    p.add_argument("--id_separator", default="_")
    p.add_argument("--gw_cutoff", type=float, default=0.9)
    p.add_argument("--min_cov", type=int, default=0)
    p.add_argument("--min_haplo_maf", type=float, default=0)
    args = p.parse_args(argv)
    try:
        run_gene_ae(args.haplotypic_counts, args.features, args.o,
                    id_separator=args.id_separator, gw_cutoff=args.gw_cutoff,
                    min_cov=args.min_cov, min_haplo_maf=args.min_haplo_maf)
    except ValueError as e:
        from ..utils.failures import write_failure_record
        write_failure_record(args.o, "phaser_gene_ae", e, argv)
        print("ERROR - %s" % e)
        return 1
    from ..utils.failures import clear_failure_record
    clear_failure_record(args.o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
