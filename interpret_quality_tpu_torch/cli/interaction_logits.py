"""CLI: interaction logits over (pair, context) grids (replaces reference
final_point_binary_interaction_logits.py)."""
from .common import (base_parser, config_from_args, sample_indices_from_args,
                     split_from_args)


def main(argv=None):
    p = base_parser("Interaction logits")
    p.add_argument("--mode", type=str, default="rotate",
                   choices=["trans", "rotate"])
    # selects the interaction_seed<k>/ tree written by gen_pair, apart from
    # this run's own --seed (reference
    # final_point_binary_interaction_logits.py:110,148)
    p.add_argument("--gen_pair_seed", type=int, default=None)
    p.add_argument("--ratio", type=float, nargs="+", default=None,
                   help="context-size ratios to process (reference "
                        "final_point_binary_interaction_logits.py:153)")
    # --resume (base_parser) skips (pose, ratio) outputs that exist
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    from ..attrib.interactions import RATIOS, run_interaction_logits
    run_interaction_logits(cfg, mode_name=args.mode, synthetic=args.synthetic,
                           allow_random_init=args.allow_random_init,
                           ratios=tuple(RATIOS if args.ratio is None
                                        else args.ratio),
                           sample_indices=sample_indices_from_args(args),
                           gen_pair_seed=args.gen_pair_seed,
                           resume=args.resume,
                           coalition_devices=split_from_args(args),
                           trace_dir=args.trace_dir)


if __name__ == "__main__":
    main()
