"""CLI: smoothness (linearity / planarity / scattering) enumeration
(replaces reference final_smoothness_center_enum_all.py)."""
from .common import (base_parser, config_from_args, sample_indices_from_args,
                     split_from_args)


def main(argv=None):
    p = base_parser("Smoothness enumeration")
    p.add_argument("--modes", type=str, default="linearity,planarity,scattering")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="epochs per (mode, objective) cell (default 50)")
    # --resume (base_parser) skips (sample, mode, objective) cells that exist
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    from ..attrib.smoothness import run_smoothness
    run_smoothness(cfg, modes=tuple(args.modes.split(",")),
                   synthetic=args.synthetic,
                   allow_random_init=args.allow_random_init,
                   sample_indices=sample_indices_from_args(args),
                   max_epochs=args.max_epochs, resume=args.resume,
                   coalition_devices=split_from_args(args))


if __name__ == "__main__":
    main()
