"""CLI: interaction plots, replacing reference plot_interaction.py.  Host
numpy and matplotlib only: it never initialises CUDA."""
from .common import base_parser, config_from_args, sample_indices_from_args


def main(argv=None):
    p = base_parser("Interaction plots")
    p.add_argument("--mode", type=str, default="rotate")
    p.add_argument("--output_type", type=str, default="pred",
                   choices=["gt", "pred"])
    p.add_argument("--plot_mode", type=str, default="all",
                   choices=["all", "single_region_vs_normal_avg",
                            "normal_vs_adv"])
    p.add_argument("--fig_root", type=str, default="figures")
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    from ..pipeline import resolve_dataset
    from ..results.plots import (plot_all_models, plot_normal_vs_adv,
                                 plot_single_region_vs_normal_avg)

    if args.plot_mode == "all":
        print(plot_all_models(args.fig_root))
        return
    _, names = resolve_dataset(cfg, args.synthetic)
    idx = sample_indices_from_args(args)
    if args.plot_mode == "normal_vs_adv":
        print(plot_normal_vs_adv(cfg, args.mode, names, args.output_type,
                                 args.fig_root, sample_indices=idx))
    else:
        print(plot_single_region_vs_normal_avg(
            cfg, args.mode, names, args.output_type, args.fig_root,
            sample_indices=idx))


if __name__ == "__main__":
    main()
