"""Measured full-family suite wall-clock of the PyTorch port (counterpart of
``scripts/suite_wallclock.py``): sum the StageTimer records of one family's
artifact tree into measured per-stage hours, and set them against the
derived TITAN-RTX reference proxy for the SAME measured forward counts.

Each StageTimer JSON line records the on-host wall-clock of one timed stage
(device work + host orchestration + artifact writes for that stage), so the
sum is the busy wall-clock of the suite, excluding only process start-up,
the kernels' first build and the bookkeeping between stages.

The proxy (GFLOP table and TITAN envelope) is loaded from
``bench_torch.py`` by file spec, so "measured" speed-ups here and
"projected" ones there share one denominator.  ``hardware`` is nvidia-smi's
name and power limit of the machine that runs this script (``--device
cuda``, the default; it raises where there is no nvidia-smi), or ``cpu``
(``--device cpu``): run it where the suite ran.

    python scripts/suite_wallclock_torch.py [--checkpoints_root ./checkpoints]
        [--out results/suite_wallclock_torch.json] [--device cuda|cpu]

Writes ``--out``; the committed ``results/suite_wallclock.json`` is the JAX
package's TPU record and is never written here.
"""
import argparse
import collections
import glob
import importlib.util
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from interpret_quality_tpu_torch.utils.profiling import \
    device_line  # noqa: E402

MODELS = ["pointnet", "pointnet2", "pointconv", "dgcnn", "gcnn", "gcnn_adv"]

_spec = importlib.util.spec_from_file_location(
    "bench_torch", os.path.join(_REPO, "bench_torch.py"))
_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bench)
GFLOP = _bench.GFLOP_PER_FORWARD
TITAN_EFF = _bench._TITAN_EFF_FLOPS


def family_wallclock(model: str, dataset: str = "modelnet10",
                     checkpoints_root: str = "./checkpoints"):
    root = (f"{checkpoints_root}/exp_MODEL_{model}_DATA_{dataset}_"
            f"POINTNUM_1024_REGIONNUM_32_shapley_test")
    if not os.path.isdir(root):
        return None
    agg = collections.defaultdict(lambda: [0.0, 0.0, 0])  # sec, fwds, n
    for pat in ("*/log.txt", "*/*/log.txt", "*/*/*/log.txt",
                "*/*/*/*/log.txt"):
        for log in glob.glob(f"{root}/{pat}"):
            for line in open(log):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if ("seconds" in rec and "stage" in rec
                        and not rec.get("aborted")):
                    # aborted stages spent chip time but their work was
                    # recomputed by the rerun: counting both would double
                    # the hours while adding zero forwards
                    k = rec["stage"].split(":")[0]
                    agg[k][0] += rec["seconds"]
                    agg[k][1] += rec["seconds"] * rec.get("items_per_sec", 0)
                    agg[k][2] += 1
    if not agg:
        return None
    stages = {k: {"measured_hours": round(s / 3600, 4),
                  "forwards_millions": round(f / 1e6, 2),
                  "stage_records": n}
              for k, (s, f, n) in sorted(agg.items())}
    tot_s = sum(v[0] for v in agg.values())
    tot_f = sum(v[1] for v in agg.values())
    ref_rate = TITAN_EFF / (GFLOP[model] * 1e9)
    ref_h = tot_f / ref_rate / 3600
    return {
        "stages": stages,
        "measured_total_hours": round(tot_s / 3600, 3),
        "measured_total_forwards_millions": round(tot_f / 1e6, 1),
        "ref_proxy_hours_same_forwards": round(ref_h, 3),
        "measured_speedup_vs_ref_proxy": round(ref_h * 3600 / tot_s, 3),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoints_root", default="./checkpoints")
    p.add_argument("--out", default="results/suite_wallclock_torch.json")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the machine the suite ran on: cuda records "
                        "nvidia-smi's name and power limit")
    args = p.parse_args(argv)
    out = {"note": ("measured = sum of StageTimer wall-clock records in the "
                    "family's artifact tree (device + host orchestration + "
                    "artifact writes per stage; excludes start-up, the "
                    "kernels' first build and the bookkeeping between "
                    "stages). ref proxy = the same measured forward "
                    "count at the derived TITAN-RTX envelope "
                    "(16.3 TFLOP/s fp32 x 30% util / bench_torch.py's "
                    "GFLOP per forward; the reference publishes no "
                    "measured throughput)."),
           "hardware": device_line(args.device),
           "families": {}}
    todo = [(m, "modelnet10", m) for m in MODELS]
    todo.append(("pointnet", "shapenet", "pointnet_shapenet"))
    for m, ds, key in todo:
        r = family_wallclock(m, ds, args.checkpoints_root)
        if r:
            out["families"][key] = r
            print(f"{key:18s} measured {r['measured_total_hours']:6.3f} h "
                  f"({r['measured_total_forwards_millions']}M fwds) "
                  f"vs ref proxy {r['ref_proxy_hours_same_forwards']:6.3f} h "
                  f"-> {r['measured_speedup_vs_ref_proxy']}x")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
