"""phaser_annotate-compatible CLI (reference phaser_annotate/
phaser_annotate.py:14-22)."""

import argparse
import sys

from ..analysis.annotate import run_annotate


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phaser_annotate")
    p.add_argument("--geno_vcf")
    p.add_argument("--sample")
    p.add_argument("--af_vcf")
    p.add_argument("--af_field", default="AF")
    p.add_argument("--cadd_file")
    p.add_argument("--o")
    p.add_argument("--threads", type=int, default=1)
    args = p.parse_args(argv)
    if args.o is None:
        print("Error: please specify an output directory.")
        return 1
    try:
        run_annotate(args.geno_vcf, args.sample, args.o,
                     cadd_file=args.cadd_file, af_vcf=args.af_vcf,
                     af_field=args.af_field)
    except (ValueError, RuntimeError, FileNotFoundError, OSError) as e:
        from ..utils.failures import write_failure_record
        write_failure_record(args.o, "phaser_annotate", e, argv)
        print("ERROR - %s" % e)
        return 1
    from ..utils.failures import clear_failure_record
    clear_failure_record(args.o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
