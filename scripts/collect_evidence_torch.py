"""Evidence of one (model, dataset) suite run of the PyTorch port, in one
compact JSON (counterpart of ``scripts/collect_evidence.py``).

The reference's persistence API is its artifact tree
(final_shapley_value.py:194-195 of the reference), which lives in the
git-ignored checkpoints/ folder.  This collector condenses what
``bench_torch.py`` and the reports need (Tables 2-4 numbers with
final_result.py semantics, interaction curves, StageTimer sustained rates,
checkpoint accuracy) into ``results/<model>_<dataset|synthetic>_torch.json``,
so a machine without the tree can rebuild the cross-model table and
``bench_torch.py``'s suite projection.  The record has the JAX script's
fields plus ``device``: the card's name and power limit as nvidia-smi
prints them (``--device cuda``, the default; on a machine without nvidia-smi
it raises), or ``cpu``.  ``bench_torch.py`` reads only records whose device
names an NVIDIA card; the committed ``results/<model>_<dataset>.json`` are
the JAX package's TPU evidence and are never written here.

Usage:
    python scripts/collect_evidence_torch.py --model dgcnn --synthetic \
        [--label "..."] [--device cuda|cpu] \
        [--out results/dgcnn_synthetic_torch.json]
"""
import argparse
import json
import os
import sys
import time

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPTS))
sys.path.insert(0, _SCRIPTS)

import numpy as np  # noqa: E402

from interpret_quality_tpu_torch.utils.profiling import \
    device_line  # noqa: E402
from make_results_md_torch import (SMOOTH_MODES,  # noqa: E402
                                   parse_stage_timers, parse_train_log)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--dataset", default="modelnet10")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoints_root", default="./checkpoints")
    p.add_argument("--samples", default=None)
    p.add_argument("--num_points", type=int, default=None)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--label", default="(unlabelled)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the machine the suite ran on: cuda records "
                        "nvidia-smi's name and power limit")
    args = p.parse_args(argv)

    from interpret_quality_tpu_torch.config import ExperimentConfig
    from interpret_quality_tpu_torch.pipeline import resolve_dataset
    from interpret_quality_tpu_torch.results import (
        cal_correlation_coef, cal_sensitivity_all_pc,
        cal_shapley_smoothness_metric)

    extra = {}
    if args.num_samples:
        extra["num_samples"] = args.num_samples
    if args.num_points:
        extra["num_points"] = args.num_points
    cfg = ExperimentConfig(model=args.model, dataset=args.dataset,
                           checkpoints_root=args.checkpoints_root,
                           seed=args.seed, device="cpu", **extra)
    dataset, names = resolve_dataset(cfg, args.synthetic)
    sel = (list(range(len(names))) if args.samples is None
           else [int(s) for s in args.samples.split(",")])
    names_sel = [names[i] for i in sel]
    ds_sel = [dataset[i] for i in sel]

    ev = {
        "model": args.model,
        "dataset": args.dataset,
        "synthetic": bool(args.synthetic),
        "label": args.label,
        "device": device_line(args.device),
        "generated_unix": int(time.time()),
        "samples": sel,
        "num_eval_samples": len(names),
        "orders_per_pose": cfg.num_samples,
    }
    if args.synthetic:
        # distribution version: which synthetic-set morph cap produced these
        # numbers (tables must not silently mix distributions)
        from interpret_quality_tpu_torch.data.datasets import \
            SYNTHETIC_MORPH_ALPHA_MAX
        ev["dataset_version"] = {
            "synthetic_morph_alpha_max": SYNTHETIC_MORPH_ALPHA_MAX}

    tl = parse_train_log(os.path.join(
        os.path.dirname(os.path.dirname(cfg.default_model_path())),
        "run.log"))
    if tl and tl["best"]:
        ev["train"] = {
            "best_epoch": tl["best"][0], "best_acc": tl["best"][1],
            "best_balanced_acc": tl["best"][2],
            "last_epoch": tl["last"][0], "last_acc": tl["last"][1],
        }

    t2 = {}
    for mode in ["trans", "rotate", "scale"] + SMOOTH_MODES:
        try:
            s = cal_sensitivity_all_pc(cfg, mode, names_sel)
        except FileNotFoundError:
            continue
        t2[mode] = {"mean": float(s.mean()),
                    "std": float(s.std(ddof=1)), "n": int(len(s))}
    ev["table2_sensitivity"] = t2

    t3 = {}
    for mode in ["trans", "rotate", "scale"]:
        try:
            mean, std = cal_correlation_coef(cfg, mode, names_sel)
        except FileNotFoundError:
            continue
        t3[mode] = {"mean": float(mean), "std": float(std)}
    ev["table3_correlation"] = t3

    t4 = {}
    for mode in ["trans", "rotate"]:
        try:
            mean, std = cal_shapley_smoothness_metric(cfg, mode, ds_sel,
                                                      names_sel)
        except FileNotFoundError:
            continue
        t4[mode] = {"mean": float(mean), "std": float(std)}
    ev["table4_smoothness"] = t4

    try:
        from interpret_quality_tpu_torch.attrib.interactions import RATIOS
        from interpret_quality_tpu_torch.results.plots import (
            get_interaction_normal_adv_pose, selected_sample_indices)
        _, abs_n, _, abs_a = get_interaction_normal_adv_pose(
            cfg, "rotate", names, "pred", sample_indices=None)
        # true pair count per cloud from a raw per-ratio artifact: the
        # abs_n row count is the number of selected *clouds*
        idx0 = selected_sample_indices(cfg.dataset)[0]
        arr0 = np.load(cfg.exp_folder + "%s/interaction_seed%d/normal/"
                       "ratio0_pred_interaction.npy" % (names[idx0],
                                                        cfg.seed))
        ev["interactions"] = {
            "ratios": [float(r) for r in RATIOS],
            "abs_mean_normal": [float(x) for x in abs_n.mean(0)],
            "abs_mean_adv": [float(x) for x in abs_a.mean(0)],
            "num_samples": int(abs_n.shape[0]),
            "pairs_per_cloud": int(arr0.shape[0]),
            "num_pairs_total": int(abs_n.shape[0] * arr0.shape[0]),
        }
    except Exception as e:  # interaction artifacts optional
        ev["interactions"] = {"incomplete": str(e)[:200]}

    # sustained production rates: detailed (per stage:subfolder) and
    # aggregated by stage prefix (the keys bench_torch.py's suite projection
    # uses)
    timers = parse_stage_timers(cfg.exp_folder, names_sel)
    ev["stage_rates"] = {k: round(v, 1) for k, v in timers.items()}
    agg = {}
    for k, v in timers.items():
        agg.setdefault(k.split(":")[0], []).append(v)
    ev["stage_rates_by_stage"] = {
        k: round(float(np.mean(v)), 1) for k, v in sorted(agg.items())}

    out = args.out or ("results/%s_%s_torch.json" % (
        args.model, "synthetic" if args.synthetic else args.dataset))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if os.path.exists(out):
        # leave the file as it is when nothing but the timestamp moved
        try:
            old = json.load(open(out))
            old.pop("generated_unix", None)
            cmp = dict(ev)
            cmp.pop("generated_unix", None)
            if old == cmp:
                print("unchanged", out)
                return
        except ValueError:
            pass
    with open(out, "w") as f:
        json.dump(ev, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", out)


if __name__ == "__main__":
    main()
