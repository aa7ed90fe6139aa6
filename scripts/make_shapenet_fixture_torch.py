"""Generate a synthetic ShapeNet-Part fixture tree under --data_root, from
the PyTorch port's tables and shapes (counterpart of
``scripts/make_shapenet_fixture.py``; the same RandomState draws, so the
two scripts write byte-equal trees).

Produces `shapenetcore_partanno_segmentation_benchmark_v0/` with the exact
on-disk layout the reference pipeline consumes (`<cat_id>/points/<uuid>.pts`
text files + `train_test_split/shuffled_{split}_file_list.json`, cf.
reference final_data_train.py:181-274, final_data_shapley.py:95-179) so the
full ShapeNet code path — native .pts parser, centre + unit-sphere
normalisation, FPS resampling, training splits, the 30-sample Shapley eval
list (the port's misc/shapenet_train_selected.json) — runs end-to-end at
production scale without the real dataset.  Clouds are drawn from the ten
parametric shape families of the port's `data.datasets.SyntheticClouds`,
one family per category, so trained classifiers have a real 10-way signal.

Usage: python scripts/make_shapenet_fixture_torch.py [--data_root ./data]
       [--train_per_class 80] [--test_per_class 20] [--points 2500]
"""
import argparse
import json
import os
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from interpret_quality_tpu_torch.config import (  # noqa: E402
    SHAPENET_CAT2ID, SHAPENET_CLASS, SHAPENET_ID2CAT)
from interpret_quality_tpu_torch.data.datasets import (  # noqa: E402
    SyntheticClouds, _read_shapenet_selected)


def make_cloud(shapes: SyntheticClouds, label: int, seed: int,
               num_points: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    u, v = rng.rand(num_points), rng.rand(num_points)
    pc = shapes._shape(label, u, v).astype(np.float32)
    pc += 0.02 * rng.randn(num_points, 3).astype(np.float32)
    # leave un-normalised and off-centre: the loaders' centre + unit-sphere
    # normalisation (datasets.py ShapeNet*._load) must do real work
    return pc * rng.uniform(0.5, 2.0) + rng.uniform(-1, 1, size=(1, 3))


def write_pts(path: str, pc: np.ndarray) -> None:
    with open(path, "w") as f:
        for row in pc:
            f.write("%.6f %.6f %.6f\n" % (row[0], row[1], row[2]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--train_per_class", type=int, default=80)
    ap.add_argument("--test_per_class", type=int, default=20)
    ap.add_argument("--points", type=int, default=2500)
    args = ap.parse_args(argv)

    root = os.path.join(args.data_root,
                        "shapenetcore_partanno_segmentation_benchmark_v0")
    classes = dict(zip(sorted(SHAPENET_CLASS), range(len(SHAPENET_CLASS))))
    shapes = SyntheticClouds(num_samples=1)

    # the 30 Shapley-eval shapes, exact uuids from the misc list
    selected = _read_shapenet_selected()
    splits = {"train": [], "test": [], "val": []}
    n_files = 0
    for cat_id, uuid in selected:
        label = classes[SHAPENET_ID2CAT[cat_id]]
        d = os.path.join(root, cat_id, "points")
        os.makedirs(d, exist_ok=True)
        write_pts(os.path.join(d, uuid + ".pts"),
                  make_cloud(shapes, label, zlib.crc32(uuid.encode()),
                             args.points))
        splits["train"].append(f"shape_data/{cat_id}/{uuid}")
        n_files += 1

    for cat_name in SHAPENET_CLASS:
        cat_id = SHAPENET_CAT2ID[cat_name]
        label = classes[cat_name]
        d = os.path.join(root, cat_id, "points")
        os.makedirs(d, exist_ok=True)
        for split, count in (("train", args.train_per_class),
                             ("test", args.test_per_class)):
            for i in range(count):
                uuid = f"fx{label:02d}{split[0]}{i:04d}"
                write_pts(os.path.join(d, uuid + ".pts"),
                          make_cloud(shapes, label,
                                     zlib.crc32(uuid.encode()), args.points))
                splits[split].append(f"shape_data/{cat_id}/{uuid}")
                n_files += 1

    sdir = os.path.join(root, "train_test_split")
    os.makedirs(sdir, exist_ok=True)
    for split, files in splits.items():
        with open(os.path.join(sdir, f"shuffled_{split}_file_list.json"),
                  "w") as f:
            json.dump(files, f)
    print(f"fixture tree: {n_files} .pts files under {root}")


if __name__ == "__main__":
    main()
