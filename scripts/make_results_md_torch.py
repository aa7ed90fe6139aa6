"""Collect a completed results-suite run of the PyTorch port
(scripts/run_results_suite_torch.sh) into a markdown summary: training
accuracy, the three result tables (reference final_result.py Tables 2-4
semantics), interaction curves, and stage timings (counterpart of
``scripts/make_results_md.py``, which reads the same artifact tree).

Host only: it reads the tree with numpy and never touches the card.  It
writes a new file, ``RESULTS_torch.md`` by default; the committed
``RESULTS.md`` is the JAX package's.

Usage:
    python scripts/make_results_md_torch.py --model pointnet --synthetic \
        --samples 0,1,...  --label "<card, power limit>" [--out RESULTS_torch.md]
"""
import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

SMOOTH_MODES = ["linearity", "planarity", "scattering"]


def parse_train_log(path):
    if not os.path.exists(path):
        return None
    best, last = None, None
    for line in open(path):
        m = re.match(r"Test (\d+), loss: ([\d.]+), test acc: ([\d.]+), "
                     r"test avg acc: ([\d.]+)", line)
        if m:
            last = (int(m.group(1)), float(m.group(3)), float(m.group(4)))
        else:   # adversarial trainer format: "Test N, test acc: X"
            m = re.match(r"Test (\d+), test acc: ([\d.]+)", line)
            if m:
                last = (int(m.group(1)), float(m.group(2)), float("nan"))
            else:
                continue
        if best is None or last[1] > best[1]:
            best = last
    return {"last": last, "best": best}


def parse_stage_timers(exp_folder, names):
    """StageTimer JSON lines from the per-sample stage logs."""
    out = {}
    for name in names:
        base = exp_folder + name + "/"
        if not os.path.isdir(base):
            continue
        # sample-root log: the shapley-init stage tees its StageTimer line
        # here (no artifact subfolder of its own)
        root_log = os.path.join(base, "log.txt")
        if os.path.exists(root_log):
            for line in open(root_log):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if "items_per_sec" in rec:
                    out.setdefault(rec["stage"].split(":")[0], []).append(
                        rec["items_per_sec"])
        for sub in os.listdir(base):
            subdir = os.path.join(base, sub)
            if not os.path.isdir(subdir):
                continue
            # stage logs live at <sample>/<sub>/log.txt; the smoothness
            # stage nests one deeper: <sample>/<mode>_all/allregion_<obj>/
            logs = [os.path.join(subdir, "log.txt")] + [
                os.path.join(subdir, sub2, "log.txt")
                for sub2 in sorted(os.listdir(subdir))
                if os.path.isdir(os.path.join(subdir, sub2))]
            for log in logs:
                if not os.path.exists(log):
                    continue
                for line in open(log):
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if "items_per_sec" in rec:
                        stage = rec["stage"].split(":")[0] + ":" + sub
                        out.setdefault(stage, []).append(rec["items_per_sec"])
    return {k: float(np.mean(v)) for k, v in sorted(out.items())}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="pointnet")
    p.add_argument("--dataset", default="modelnet10")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoints_root", default="./checkpoints")
    p.add_argument("--samples", default=None)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--num_points", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--label", default="(unlabelled run)")
    p.add_argument("--out", default="RESULTS_torch.md")
    p.add_argument("--append", action="store_true",
                   help="append a new run section to --out instead of "
                        "overwriting")
    args = p.parse_args(argv)

    from interpret_quality_tpu_torch.config import ExperimentConfig
    from interpret_quality_tpu_torch.pipeline import resolve_dataset
    from interpret_quality_tpu_torch.results import (
        cal_correlation_coef, cal_sensitivity_all_pc,
        cal_shapley_smoothness_metric)
    from interpret_quality_tpu_torch.results.plots import \
        get_interaction_normal_adv_pose

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

    lines = []
    w = lines.append
    w(f"# RESULTS — end-to-end run: {args.model} / "
      f"{'synthetic' if args.synthetic else args.dataset}")
    w("")
    w(f"Hardware/run label: **{args.label}**.  Samples: {len(sel)} of "
      f"{len(names)}; {cfg.num_samples} orders per pose estimate.")
    w("")

    # run.log lives next to models/ in the training exp dir; deriving it from
    # the checkpoint path also covers gcnn_adv's _with_all_rot_da folder.
    tl = parse_train_log(os.path.join(
        os.path.dirname(os.path.dirname(cfg.default_model_path())), "run.log"))
    if tl and tl["best"]:
        w("## Training")
        w("")
        w(f"- best test acc **{tl['best'][1]:.4f}** (balanced "
          f"{tl['best'][2]:.4f}) at epoch {tl['best'][0]}; final epoch "
          f"{tl['last'][0]}: acc {tl['last'][1]:.4f} (balanced "
          f"{tl['last'][2]:.4f}).  Checkpoint: "
          f"`{cfg.default_model_path()}`.")
        w("")

    w("## Table 2 — sensitivity (mean normalized range, lower = more "
      "stable)")
    w("")
    w("| perturbation | mean ± std over samples |")
    w("|---|---|")
    for mode in ["trans", "rotate", "scale"] + SMOOTH_MODES:
        try:
            s = cal_sensitivity_all_pc(cfg, mode, names_sel)
        except FileNotFoundError:
            continue
        w(f"| {mode} | {s.mean():.6f} ± {s.std(ddof=1):.6f} |")
    w("")

    w("## Table 3 — correlation (Pearson r: sensitivity vs attribution "
      "intensity)")
    w("")
    w("| perturbation | mean r ± std |")
    w("|---|---|")
    for mode in ["trans", "rotate", "scale"]:
        try:
            mean, std = cal_correlation_coef(cfg, mode, names_sel)
        except FileNotFoundError:
            continue
        w(f"| {mode} | {mean:.4f} ± {std:.4f} |")
    w("")

    w("## Table 4 — spatial smoothness of attributions")
    w("")
    w("| perturbation | metric ± std |")
    w("|---|---|")
    for mode in ["trans", "rotate"]:
        try:
            mean, std = cal_shapley_smoothness_metric(cfg, mode, ds_sel,
                                                      names_sel)
        except FileNotFoundError:
            continue
        w(f"| {mode} | {mean:.4f} ± {std:.4f} |")
    w("")

    try:
        # interactions only run on the selected-sample subset; scanning all
        # 30 eval samples would hit missing artifacts
        # Figure-5 semantics: |E_S[I^(m)]| per pair, averaged over pairs
        # (reference plot_interaction.py:24-56) — the abs_* returns.
        _, abs_n, _, abs_a = get_interaction_normal_adv_pose(
            cfg, "rotate", names, "pred",
            sample_indices=None if args.samples is None else sel)
        w("## Interactions — mean over pairs of |E_S I^(m)| by context "
          "ratio (normal vs rotation-adversarial pose)")
        w("")
        w("| ratio | normal | adv |")
        w("|---|---|---|")
        from interpret_quality_tpu_torch.attrib.interactions import RATIOS
        for i, r in enumerate(RATIOS):
            w(f"| {r:.2f} | {abs_n.mean(0)[i]:.4f} | "
              f"{abs_a.mean(0)[i]:.4f} |")
        w("")
    except (FileNotFoundError, IndexError) as e:
        w(f"(interaction artifacts incomplete: {e})")
        w("")

    timers = parse_stage_timers(cfg.exp_folder, names_sel)
    if timers:
        w("## Stage throughput (masked-coalition forwards/sec, from stage "
          "logs)")
        w("")
        w("| stage | forwards/s |")
        w("|---|---|")
        for k, v in timers.items():
            w(f"| {k} | {v:,.0f} |")
        w("")

    w(f"Artifact tree: `{cfg.exp_folder}` (reference final_result.py-"
      "compatible schema).")
    w("")
    mode = "a" if args.append else "w"
    with open(args.out, mode) as f:
        if args.append:
            f.write("\n\n---\n\n")
        f.write("\n".join(lines))
    print(f"wrote {args.out} ({len(lines)} lines, mode={mode})")


if __name__ == "__main__":
    main()
