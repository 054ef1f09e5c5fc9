"""phaser_expr_matrix-compatible CLI (reference phaser_pop/
phaser_expr_matrix.py:11-15)."""

import argparse
import sys

from ..analysis.expr_matrix import run_expr_matrix


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phaser_expr_matrix")
    p.add_argument("--gene_ae_dir", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--t", type=int, default=1)
    p.add_argument("--o", required=True)
    args = p.parse_args(argv)
    try:
        run_expr_matrix(args.gene_ae_dir, args.features, args.o)
    except (ValueError, RuntimeError, FileNotFoundError, OSError) as e:
        from ..utils.failures import write_failure_record
        write_failure_record(args.o, "phaser_expr_matrix", e, argv)
        print("ERROR - %s" % e)
        return 1
    from ..utils.failures import clear_failure_record
    clear_failure_record(args.o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
