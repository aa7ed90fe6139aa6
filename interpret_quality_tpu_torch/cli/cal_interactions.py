"""CLI: interaction scores from saved logits, on the host only (replaces
reference final_cal_interactions.py).  It never initialises CUDA, so
``--device`` does not matter here."""
from .common import base_parser, config_from_args, sample_indices_from_args


def main(argv=None):
    p = base_parser("Interaction scores")
    p.add_argument("--mode", type=str, default="rotate",
                   choices=["trans", "rotate"])
    p.add_argument("--output_type", type=str, default="pred",
                   choices=["gt", "pred"])
    # selects the interaction_seed<k>/ tree written by gen_pair
    # (reference final_cal_interactions.py:71,112)
    p.add_argument("--gen_pair_seed", type=int, default=None)
    p.add_argument("--ratio", type=float, nargs="+", default=None,
                   help="context-size ratios to score (reference "
                        "final_cal_interactions.py:117)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    from ..attrib.interactions import RATIOS, run_cal_interactions
    run_cal_interactions(cfg, mode_name=args.mode, synthetic=args.synthetic,
                         output_type=args.output_type,
                         ratios=tuple(RATIOS if args.ratio is None
                                      else args.ratio),
                         sample_indices=sample_indices_from_args(args),
                         gen_pair_seed=args.gen_pair_seed)


if __name__ == "__main__":
    main()
