"""Cross-model comparison tables of the PyTorch port's artifact trees
(reference final_result.py --all_models view), appended to a markdown file:
one row per model per Table 2/3/4 metric, collected from whatever per-model
artifact trees exist (counterpart of ``scripts/make_compare_md.py``).

Host only.  It appends to ``RESULTS_torch.md`` by default; the committed
``RESULTS.md`` is the JAX package's.

Usage:
    python scripts/make_compare_md_torch.py --synthetic --samples 0,3,6 \
        [--models dgcnn,gcnn,...] [--out RESULTS_torch.md]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="modelnet10")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoints_root", default="./checkpoints")
    p.add_argument("--samples", default=None,
                   help="per-model sample restriction, e.g. 0,3,6; "
                        "model=samples[;model=samples...] for mixed runs")
    p.add_argument("--models", default=None)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--num_points", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--label", default="(unlabelled)")
    p.add_argument("--out", default="RESULTS_torch.md")
    args = p.parse_args(argv)

    from interpret_quality_tpu_torch.config import (MODEL_NAMES,
                                                    ExperimentConfig)
    from interpret_quality_tpu_torch.pipeline import resolve_dataset
    from interpret_quality_tpu_torch.results import (
        cal_correlation_coef, cal_sensitivity_all_pc,
        cal_shapley_smoothness_metric)
    from interpret_quality_tpu_torch.results.tables import MODES_ALL

    models = (args.models.split(",") if args.models else MODEL_NAMES)

    per_model_sel = {}
    default_sel = None
    if args.samples:
        for part in args.samples.split(";"):
            if "=" in part:
                m, s = part.split("=")
                per_model_sel[m] = [int(x) for x in s.split(",")]
            else:
                default_sel = [int(x) for x in part.split(",")]

    extra = {}
    if args.num_samples:
        extra["num_samples"] = args.num_samples
    if args.num_points:
        extra["num_points"] = args.num_points

    rows = {}          # model -> {metric: "mean ± std"}
    for model in models:
        cfg = ExperimentConfig(model=model, dataset=args.dataset,
                               seed=args.seed,
                               checkpoints_root=args.checkpoints_root,
                               device="cpu", **extra)
        try:
            dataset, names = resolve_dataset(cfg, args.synthetic)
        except Exception:
            continue
        sel = per_model_sel.get(model, default_sel)
        if sel is not None:
            names = [names[i] for i in sel]
            dataset = [dataset[i] for i in sel]
        r = {}
        for mode in MODES_ALL:
            try:
                s = cal_sensitivity_all_pc(cfg, mode, names)
                r[f"sens:{mode}"] = f"{s.mean():.4f} ± {s.std(ddof=1):.4f}"
            except FileNotFoundError:
                pass
        for mode in ["trans", "rotate", "scale"]:
            try:
                mean, std = cal_correlation_coef(cfg, mode, names)
                r[f"corr:{mode}"] = f"{mean:.3f} ± {std:.3f}"
            except FileNotFoundError:
                pass
        for mode in ["trans", "rotate"]:
            try:
                mean, std = cal_shapley_smoothness_metric(cfg, mode,
                                                          dataset, names)
                r[f"smooth:{mode}"] = f"{mean:.4f} ± {std:.4f}"
            except FileNotFoundError:
                pass
        if r:
            rows[model] = r

    if not rows:
        print("no model artifacts found; nothing written")
        return

    lines = []
    w = lines.append
    w(f"# Cross-model comparison — {args.dataset}"
      f"{' (synthetic)' if args.synthetic else ''}")
    w("")
    w(f"Run label: **{args.label}**.  One row per trained model; "
      "reference final_result.py --all_models view.")
    w("")
    for title, keys in [
            ("Table 2 — sensitivity (mean normalized range)",
             [f"sens:{m}" for m in MODES_ALL]),
            ("Table 3 — correlation (Pearson r)",
             ["corr:trans", "corr:rotate", "corr:scale"]),
            ("Table 4 — spatial smoothness",
             ["smooth:trans", "smooth:rotate"])]:
        w(f"## {title}")
        w("")
        cols = [k for k in keys if any(k in r for r in rows.values())]
        w("| model | " + " | ".join(c.split(":")[1] for c in cols) + " |")
        w("|---|" + "---|" * len(cols))
        for model, r in rows.items():
            w(f"| {model} | " + " | ".join(r.get(c, "—") for c in cols)
              + " |")
        w("")

    with open(args.out, "a") as f:
        f.write("\n\n---\n\n")
        f.write("\n".join(lines) + "\n")
    print(f"appended cross-model section ({len(rows)} models) to {args.out}")


if __name__ == "__main__":
    main()
