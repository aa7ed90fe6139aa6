"""CLI: results tables (sensitivity / correlation / smoothness), replacing
reference final_result.py; reads the artifact tree the stages wrote.  Host
numpy only: it never initialises CUDA."""
from ..config import MODEL_NAMES
from ..results.tables import MODES_ALL
from .common import base_parser, config_from_args, sample_indices_from_args


def main(argv=None):
    p = base_parser("Results tables")
    p.add_argument("--result_mode", type=str, default="sensitivity",
                   choices=["sensitivity", "correlation", "smoothness"])
    p.add_argument("--all_models", action="store_true")
    args = p.parse_args(argv)

    from ..pipeline import resolve_dataset
    from ..results import (cal_correlation_coef, cal_sensitivity_all_pc,
                           cal_shapley_smoothness_metric)

    model_list = MODEL_NAMES if args.all_models else [args.model]
    for model_name in model_list:
        args.model = model_name
        cfg = config_from_args(args)
        dataset, names = resolve_dataset(cfg, args.synthetic)
        sel = sample_indices_from_args(args)
        if sel is not None:      # restrict to samples that were processed
            names = [names[i] for i in sel]
            dataset = [dataset[i] for i in sel]
        if args.result_mode == "sensitivity":
            for mode in MODES_ALL:
                try:
                    s = cal_sensitivity_all_pc(cfg, mode, names)
                except FileNotFoundError:
                    continue
                print("model: %s, exp: %s — mean normalized range: %.6f±%.6f"
                      % (model_name, mode, s.mean(), s.std(ddof=1)))
        elif args.result_mode == "correlation":
            for mode in ["trans", "rotate", "scale"]:
                try:
                    mean, std = cal_correlation_coef(cfg, mode, names)
                except FileNotFoundError:
                    continue
                print("model: %s, mode: %s — mean Pearson r=%f±%f"
                      % (model_name, mode, mean, std))
        else:
            for mode in ["trans", "rotate"]:
                try:
                    mean, std = cal_shapley_smoothness_metric(
                        cfg, mode, dataset, names)
                except FileNotFoundError:
                    continue
                print("model: %s, mode: %s — smoothness metric=%f±%f"
                      % (model_name, mode, mean, std))


if __name__ == "__main__":
    main()
