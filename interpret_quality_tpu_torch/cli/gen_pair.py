"""CLI: interaction pair, context and adversarial-pose generation (replaces
reference final_gen_pair.py).  Reads the ``<mode>_all/`` enumeration."""
from .common import base_parser, config_from_args, sample_indices_from_args


def main(argv=None):
    p = base_parser("Interaction pair generation")
    p.add_argument("--mode", type=str, default="rotate",
                   choices=["trans", "rotate"])
    p.add_argument("--num_pairs_random", type=int, default=300)
    p.add_argument("--num_save_context_max", type=int, default=100)
    p.add_argument("--ratio", type=float, nargs="+", default=None,
                   help="context-size ratios m/(num_regions-2) "
                        "(reference final_gen_pair.py:335)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    from ..attrib.interactions import RATIOS, run_gen_pair
    run_gen_pair(cfg, mode_name=args.mode, synthetic=args.synthetic,
                 allow_random_init=args.allow_random_init,
                 num_pairs_random=args.num_pairs_random,
                 num_save_context_max=args.num_save_context_max,
                 ratios=tuple(RATIOS if args.ratio is None else args.ratio),
                 sample_indices=sample_indices_from_args(args))


if __name__ == "__main__":
    main()
