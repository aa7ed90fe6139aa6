"""CLI: Shapley initialisation — region ids, permutations, norm factors and
the Shapley estimates with convergence snapshots (replaces reference
final_shapley_value.py)."""
from .common import (base_parser, config_from_args, sample_indices_from_args,
                     split_from_args)


def main(argv=None):
    p = base_parser("Shapley value initialisation")
    p.add_argument("--antithetic", action="store_true",
                   help="sample saved permutations in (pi, reverse pi) "
                        "pairs (off = reference i.i.d. stream)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    from ..attrib.stages import run_shapley_init
    run_shapley_init(cfg, synthetic=args.synthetic,
                     allow_random_init=args.allow_random_init,
                     sample_indices=sample_indices_from_args(args),
                     resume=args.resume, antithetic=args.antithetic,
                     coalition_devices=split_from_args(args),
                     trace_dir=args.trace_dir)


if __name__ == "__main__":
    main()
