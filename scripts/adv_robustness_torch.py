"""Rotation robustness of the GCNN and adv-GCNN checkpoints, on the
PyTorch port (counterpart of ``scripts/adv_robustness.py``).

    python scripts/adv_robustness_torch.py [--device cpu] [--checkpoints_root DIR]
        [--out FILE] [--num_points N] [--rot_draws D] [--num_samples S]

For each model: the clean and balanced accuracy on the held-out synthetic
test split (``SyntheticClouds(num_samples=16, seed=2)``, 1024 points,
batch 16), through ``train.trainer.evaluate`` and ``balanced_accuracy``,
and the accuracy on randomly rotated clouds (axis-angle, alpha in
[-pi/2, pi/2], ``train.adversarial.random_rotation_eval_batch``,
main_cls_adv.py:253-258 of the reference), averaged over 8 draws.  Draw
d's rotations come from a ``torch.Generator`` seeded 1000 + d on the
model's device: the stream differs from ``jax.random``'s, so the rotation
numbers are not expected to match the JAX script's JSON.

Each checkpoint is read as the port's ``model_best.t7`` or, where that is
absent, the JAX package's ``model_best.msgpack``, from the two run folders
the JAX script reads, under ``--checkpoints_root``; a model with neither is
recorded as missing.  Writes ``--out`` (default
``results/gcnn_adv_robustness_torch.json``), with the card's name and power
limit when it runs on the card.  Runs on the card unless ``--device cpu``.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from interpret_quality_tpu_torch.data.datasets import SyntheticClouds  # noqa: E402
from interpret_quality_tpu_torch.models import build_model  # noqa: E402
from interpret_quality_tpu_torch.models.checkpoint import load_checkpoint  # noqa: E402
from interpret_quality_tpu_torch.models.common import resolve_device  # noqa: E402
from interpret_quality_tpu_torch.train.adversarial import \
    random_rotation_eval_batch  # noqa: E402
from interpret_quality_tpu_torch.train.trainer import (  # noqa: E402
    balanced_accuracy, eval_step, evaluate)
from interpret_quality_tpu_torch.utils.profiling import \
    device_line  # noqa: E402

RUNS = {
    "gcnn": "exp_MODEL_gcnn_DATA_modelnet10_POINTNUM_1024_clean/models",
    "gcnn_adv": ("exp_MODEL_gcnn_adv_DATA_modelnet10_POINTNUM_1024"
                 "_clean_with_all_rot_da/models"),
}
NUM_CLASSES, K = 10, 20
NUM_POINTS = 1024
NUM_SAMPLES = 16
ROT_DRAWS = 8  # robustness eval averaged over this many rotation seeds
BATCH_SIZE = 16


def checkpoint_path(root: str, name: str):
    """The run's model_best.t7, else its model_best.msgpack, else None."""
    for suffix in (".t7", ".msgpack"):
        path = os.path.join(root, RUNS[name], "model_best" + suffix)
        if os.path.exists(path):
            return path
    return None


def load_gcnn(path: str, device) -> torch.nn.Module:
    """A GCNN in eval mode on ``device`` with the checkpoint's weights."""
    model = build_model("gcnn", NUM_CLASSES, K)
    model.load_state_dict(load_checkpoint("gcnn", path), strict=True)
    return model.to(device).eval()


def eval_model(model, test_ds, device, batch_size=BATCH_SIZE):
    """(clean accuracy, balanced accuracy) over the test split."""
    _, y_true, y_pred = evaluate(model, test_ds, batch_size, True, device)
    return (float((y_true == y_pred).mean()),
            float(balanced_accuracy(y_true, y_pred)))


def rotated_batches(test_ds, device, rot_draws=ROT_DRAWS,
                    batch_size=BATCH_SIZE):
    """(draw, rotated clouds on ``device``, labels, valid) for every batch
    of every draw, draw d's rotations from a generator seeded 1000 + d."""
    for draw in range(rot_draws):
        generator = torch.Generator(device=device).manual_seed(1000 + draw)
        for data, labels, valid in test_ds.batches(batch_size,
                                                   shuffle=False):
            rot = random_rotation_eval_batch(
                generator, torch.from_numpy(data).to(device))
            yield draw, rot, labels, valid


def eval_rot_robustness(model, test_ds, device, rot_draws=ROT_DRAWS,
                        batch_size=BATCH_SIZE):
    """(mean, std) over the draws of the accuracy on rotated clouds."""
    hits, counts = np.zeros(rot_draws), np.zeros(rot_draws)
    for draw, rot, labels, valid in rotated_batches(test_ds, device,
                                                    rot_draws, batch_size):
        _, preds = eval_step(model, rot, torch.from_numpy(labels).to(device),
                             None, True)
        hits[draw] += int((preds[:valid].cpu().numpy()
                           == labels[:valid]).sum())
        counts[draw] += valid
    accs = hits / counts
    return float(np.mean(accs)), float(np.std(accs))


def run(device, checkpoints_root="checkpoints", num_points=NUM_POINTS,
        rot_draws=ROT_DRAWS, num_samples=NUM_SAMPLES) -> dict:
    """The JSON record of both models."""
    test_ds = SyntheticClouds(num_samples=num_samples, num_points=num_points,
                              seed=2)
    out = {"test_set": (f"SyntheticClouds(num_samples={num_samples}, "
                        f"seed=2) held-out split, {num_points} points"),
           "rot_eval": ("random axis-angle rotation, alpha in [-pi/2,pi/2], "
                        "averaged over %d draws (main_cls_adv.py:253-258), "
                        "torch.Generator seeded 1000 + draw" % rot_draws),
           "device": str(device), "models": {}}
    if device.type == "cuda":
        out["card"] = {"name": torch.cuda.get_device_name(device),
                       "nvidia_smi": device_line("cuda")}
    for name in RUNS:
        path = checkpoint_path(checkpoints_root, name)
        if path is None:
            out["models"][name] = {"error": "checkpoint missing: "
                                   + os.path.join(checkpoints_root,
                                                  RUNS[name], "model_best.*")}
            continue
        model = load_gcnn(path, device)
        acc, bal = eval_model(model, test_ds, device)
        rot_acc, rot_std = eval_rot_robustness(model, test_ds, device,
                                               rot_draws)
        out["models"][name] = {
            "checkpoint": path,
            "clean_acc": acc,
            "clean_balanced_acc": bal,
            "rot_robust_acc_mean": rot_acc,
            "rot_robust_acc_std": rot_std,
        }
        print(f"{name}: clean {acc:.4f} balanced {bal:.4f} "
              f"rot-robust {rot_acc:.4f} +- {rot_std:.4f}")
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--checkpoints_root", default="checkpoints")
    parser.add_argument("--out",
                        default="results/gcnn_adv_robustness_torch.json")
    parser.add_argument("--num_points", type=int, default=NUM_POINTS)
    parser.add_argument("--rot_draws", type=int, default=ROT_DRAWS)
    parser.add_argument("--num_samples", type=int, default=NUM_SAMPLES)
    args = parser.parse_args(argv)
    out = run(resolve_device(args.device), args.checkpoints_root,
              args.num_points, args.rot_draws, args.num_samples)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
