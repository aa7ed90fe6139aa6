"""CLI: perturbation enumeration (trans / rotate / scale), one entry point
with --mode for the reference's final_{trans,rotate,scale}_center_enum_all.py."""
from .common import (base_parser, config_from_args, sample_indices_from_args,
                     split_from_args)


def main(argv=None, default_mode: str = "trans"):
    p = base_parser("Perturbation enumeration")
    p.add_argument("--mode", type=str, default=default_mode,
                   choices=["trans", "rotate", "scale"])
    p.add_argument("--no_logits", action="store_true",
                   help="skip saving all_logits.pt")
    p.add_argument("--max_poses", type=int, default=None,
                   help="truncate the pose grid (smoke runs; default: the "
                        "full reference grid, 216 trans/rotate, 30 scale)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    from ..attrib.stages import run_enum
    run_enum(cfg, args.mode, synthetic=args.synthetic,
             allow_random_init=args.allow_random_init,
             save_logits=not args.no_logits,
             sample_indices=sample_indices_from_args(args),
             resume=args.resume, max_poses=args.max_poses,
             coalition_devices=split_from_args(args),
             trace_dir=args.trace_dir)


if __name__ == "__main__":
    main()
