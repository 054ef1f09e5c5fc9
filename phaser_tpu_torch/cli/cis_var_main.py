"""phaser_cis_var-compatible CLI (reference phaser_pop/
phaser_cis_var.py:15-29) on the port. Adds --bs_seed for reproducible
bootstraps, --engine and --device."""

import argparse
import sys

from ..analysis.cis_var import run_cis_var


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phaser_cis_var")
    p.add_argument("--bed", type=str, required=True)
    p.add_argument("--vcf", type=str, required=True)
    p.add_argument("--pairs", type=str, required=True)
    p.add_argument("--map", type=str, required=True)
    p.add_argument("--o", type=str, required=True)
    p.add_argument("--pc", default=1, type=int)
    p.add_argument("--min_cov", type=int, default=8)
    p.add_argument("--chr", type=str, default="")
    p.add_argument("--bs", type=int, default=10000)
    p.add_argument("--ignore_v", type=int, default=0)
    p.add_argument("--t", type=int, default=1)
    p.add_argument("--bs_seed", type=int, default=0)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "numpy", "torch"],
                   help="Bootstrap engine. torch = every pair's draws in "
                        "one batched torch call on --device; numpy = "
                        "per-pair reference-style resampling; auto picks "
                        "torch only with --device cuda and when pairs x bs "
                        "reaches the measured crossover (decided before "
                        "torch is imported). torch with --device cuda "
                        "fails without a GPU. NOTE: the four CI "
                        "lower/upper columns and var_het_pval are "
                        "engine-specific for the same --bs_seed "
                        "(statistically equivalent, not bitwise equal), "
                        "and the torch engine's differ between --device "
                        "cuda and cpu (different random generators); each "
                        "is deterministic per seed on one device. Every "
                        "other column is identical between engines.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the torch engine runs (default cuda)")
    args = p.parse_args(argv)
    try:
        run_cis_var(args.bed, args.vcf, args.pairs, args.map, args.o,
                    pc=args.pc, min_cov=args.min_cov, chrom=args.chr,
                    bs=args.bs, ignore_v=args.ignore_v, bs_seed=args.bs_seed,
                    engine=args.engine, device=args.device)
    except (ValueError, RuntimeError, FileNotFoundError, OSError) as e:
        from ..utils.failures import write_failure_record
        write_failure_record(args.o, "phaser_cis_var", e, argv)
        print("ERROR - %s" % e)
        return 1
    from ..utils.failures import clear_failure_record
    clear_failure_record(args.o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
