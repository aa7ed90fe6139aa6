"""Global constants, per-model batch knobs and experiment configuration.

The port's own copy of ``interpret_quality_tpu/config.py``: the same
constants, knob names and artifact-naming contract (reference
``config.py:2-17``, ``tools/final_util.py:15-68``,
``final_shapley_value.py:194-195``), so both packages write the same
artifact tree.  Added: ``device``.  The two process-global precision
settings of the JAX package are here with their choices, but the port's
defaults are the exact ones (``highest`` products, ``hilo`` gathers: f32 on
the card), where the JAX package's are ``default`` / ``bf16``; they govern
the card only (``models/common.py`` lists every product and its rule).
The JAX package's kNN selection settings (``IQTPU_KNN_SELECT``,
``IQTPU_KNN_LAYOUT``) and its enumeration-plan switch (``IQTPU_ENUM_PLAN``)
are read from the environment at call time, as there; the port's default
selection is the exact one (``two_pass``), where the JAX package's is
``packed``, and it too governs the card only.  Left out: the pose-chunk
knob of the one-dispatch enumeration (a forward of eight PointNet poses
would need more activation memory than the card has) and its pose blocks
(``IQTPU_ENUM_POSE_BLOCK``, which group poses into dispatches for the TPU
host); the enumeration forwards one pose at a time.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

# ---------------------------------------------------------------------------
# Constants (reference: tools/final_util.py:15-27)
# ---------------------------------------------------------------------------
NUM_POINTS = 1024          # points per cloud
NUM_REGIONS = 32           # FPS regions per cloud
NUM_SAMPLES_SAVE = 1000    # permutations saved at Shapley init
NUM_SAMPLES = 100          # permutations used per pose in enumeration
K_FOR_DGCNN = 20           # kNN neighbourhood size for DGCNN/GCNN
BALL_QUERY_COEF = 0.25     # region-neighbourhood ball radius coefficient

# samples used for Shapley evaluation
DATA_MODELNET_SHAPLEY_TEST = "modelnet10_train_final30.txt"
DATA_SHAPENET_SHAPLEY_TEST = "shapenet_train_selected.json"

# samples selected for interaction analysis (reference: final_util.py:26-27)
MODELNET_INTER_SELECTED_SAMPLE = [0, 3, 6, 9, 12, 15, 18, 21, 24, 27]
SHAPENET_INTER_SELECTED_SAMPLE = [0, 3, 6, 9, 12, 15, 19, 21, 24, 27]

# ShapeNet-Part 10-class subset (reference: final_util.py:30-49)
SHAPENET_CLASS = [
    "Bag", "Cap", "Earphone", "Knife", "Laptop",
    "Motorbike", "Mug", "Pistol", "Rocket", "Skateboard",
]
SHAPENET_ID2CAT = {
    "02691156": "Airplane",
    "02773838": "Bag",
    "02954340": "Cap",
    "02958343": "Car",
    "03001627": "Chair",
    "03261776": "Earphone",
    "03467517": "Guitar",
    "03624134": "Knife",
    "03636649": "Lamp",
    "03642806": "Laptop",
    "03790512": "Motorbike",
    "03797390": "Mug",
    "03948459": "Pistol",
    "04099429": "Rocket",
    "04225987": "Skateboard",
    "04379243": "Table",
}
SHAPENET_CAT2ID = {v: k for k, v in SHAPENET_ID2CAT.items()}

MATMUL_PRECISIONS = ("default", "high", "highest")
GATHER_PRECISIONS = ("bf16", "hilo")
MODEL_NAMES = ["pointnet", "pointnet2", "pointconv", "dgcnn", "gcnn", "gcnn_adv"]
# the models the CLIs take: the reference pipeline's, and PCT and PointMLP,
# the port's alone (the tables and plots over every model keep MODEL_NAMES)
PORT_MODEL_NAMES = MODEL_NAMES + ["pct", "pointmlp"]
DATASET_NAMES = ["modelnet10", "shapenet"]
DEVICES = ["cuda", "cpu"]

# ---------------------------------------------------------------------------
# Batch-size knobs.  "shapley_batch_size" is the number of permutation
# orders masked and forwarded together: the forward batch is
# (num_regions+1)*bs clouds of 1024 points.  "interaction_batch_size" is the
# number of (pair, context) cells per forward: the batch is 4*bs clouds.
# ---------------------------------------------------------------------------
CONFIG = {
    "shapley_batch_size": {
        "pointnet2": 50,
        "pointnet": 100,
        "dgcnn": 50,
        "gcnn": 50,
        "pointconv": 50,
        "pct": 50,
        "pointmlp": 50,
    },
    "interaction_batch_size": {
        "pointnet2": 200,
        "pointnet": 400,
        "dgcnn": 200,
        "gcnn": 200,
        "pointconv": 400,
        "pct": 200,
        "pointmlp": 200,
    },
}


# ---------------------------------------------------------------------------
# Precision settings (the JAX package's --matmul_precision and
# --gather_precision; its config.py keeps the gather one as here).  Both are
# process-global: cli.common.config_from_args sets them on every call, and a
# data-parallel rank takes its parent's (parallel.data_parallel.spawn).
#   matmul precision: "highest" f32 products; "high" one TF32 product;
#     "default" one product of bf16-rounded operands, f32 accumulation.
#   gather value parts: 2 ("hilo") gathers f32 values exactly; 1 ("bf16")
#     gathers each value rounded to bf16, to nearest even, in the neighbour
#     kernels whose TPU counterparts split values into bf16 planes.
# ---------------------------------------------------------------------------
_MATMUL_PRECISION = "highest"
_GATHER_VALUE_PARTS = 2


def set_matmul_precision(precision: str) -> None:
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}")
    global _MATMUL_PRECISION
    _MATMUL_PRECISION = precision


def matmul_precision() -> str:
    return _MATMUL_PRECISION


def set_gather_value_parts(parts: int) -> None:
    if parts not in (1, 2):
        raise ValueError(f"gather value parts must be 1 or 2, got {parts!r}")
    global _GATHER_VALUE_PARTS
    _GATHER_VALUE_PARTS = parts


def gather_value_parts() -> int:
    return _GATHER_VALUE_PARTS


# ---------------------------------------------------------------------------
# kNN selection settings (the JAX package's IQTPU_KNN_SELECT and
# IQTPU_KNN_LAYOUT, ops/pallas/neighbors.py knn_select_impl and
# knn_layout_impl), read from the environment at every call.  The six
# selection names fall into three classes, each an exact (key, index)
# selection, ties to the lowest index, on a key made from the f32 distance
# (``ops.precision.selection_keys``):
#   exact   the distance itself (two_pass, argmin);
#   packed  the distance clamped at +0 with the low b bits of its pattern
#           cleared, b = (N - 1).bit_length() for N database rows:
#           distances whose bits agree above the low b tie, so ties reach
#           2^b ulps (packed, succ, hier);
#   bf16    the distance rounded to bf16, to nearest even: distances that
#           round alike tie, so ties reach 2^-7 of a distance (bf16).
# Kernel 3 at layout nq (the JAX package's transposed twin) always takes the
# packed class.  Unlike the JAX package, which takes an unknown name for
# two_pass, an unknown name raises.
# ---------------------------------------------------------------------------
KNN_SELECT_CLASSES = {"two_pass": "exact", "argmin": "exact",
                      "packed": "packed", "succ": "packed", "hier": "packed",
                      "bf16": "bf16"}
KNN_LAYOUTS = ("qn", "nq")
KNN_KERNELS = ("knn", "knn_gather_extrema", "knn_with_density")


def knn_select() -> str:
    """The process's kNN selection setting (IQTPU_KNN_SELECT; the port's
    default is two_pass, the JAX package's packed)."""
    select = os.environ.get("IQTPU_KNN_SELECT", "two_pass")
    if select not in KNN_SELECT_CLASSES:
        raise ValueError(f"IQTPU_KNN_SELECT={select!r}: not one of "
                         f"{sorted(KNN_SELECT_CLASSES)}")
    return select


def knn_layout() -> str:
    """The process's distance-tile layout of kernel 3 (IQTPU_KNN_LAYOUT)."""
    layout = os.environ.get("IQTPU_KNN_LAYOUT", "qn")
    if layout not in KNN_LAYOUTS:
        raise ValueError(f"IQTPU_KNN_LAYOUT={layout!r}: not one of "
                         f"{KNN_LAYOUTS}")
    return layout


def knn_select_class(select: str, layout: str = "qn",
                     kernel: str = "knn") -> str:
    """The selection class (exact, packed or bf16) that ``kernel`` computes
    at the setting ``select`` and kernel 3's ``layout``."""
    if select not in KNN_SELECT_CLASSES:
        raise ValueError(f"unknown kNN selection {select!r}: not one of "
                         f"{sorted(KNN_SELECT_CLASSES)}")
    if layout not in KNN_LAYOUTS:
        raise ValueError(f"unknown kNN layout {layout!r}: not one of "
                         f"{KNN_LAYOUTS}")
    if kernel not in KNN_KERNELS:
        raise ValueError(f"unknown kNN kernel {kernel!r}")
    if kernel == "knn_gather_extrema" and layout == "nq":
        return "packed"         # the nq twin sweeps packed keys only
    return KNN_SELECT_CLASSES[select]


def enum_plan() -> bool:
    """Whether the enumeration reuses each family's pose-invariant graph
    plan (IQTPU_ENUM_PLAN; 0 rebuilds the graph at every pose)."""
    return os.environ.get("IQTPU_ENUM_PLAN", "1") != "0"


def shapley_batch_size(model: str) -> int:
    key = "gcnn" if model == "gcnn_adv" else model
    return CONFIG["shapley_batch_size"][key]


def interaction_batch_size(model: str) -> int:
    key = "gcnn" if model == "gcnn_adv" else model
    return CONFIG["interaction_batch_size"][key]


def num_classes_for(dataset: str) -> int:
    # reference: models/pointnet.py:95-98 — 40 for modelnet40, else 10
    return 40 if dataset == "modelnet40" else 10


# ---------------------------------------------------------------------------
# Experiment configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExperimentConfig:
    """One attribution experiment = (model, dataset) plus sampling knobs.

    Field names follow the reference argparse surface so CLI flags carry over
    (e.g. final_shapley_value.py:178-188).  ``device`` is where the model and
    the engine run: "cuda" (the default) or "cpu".
    """

    model: str = "pointnet"
    dataset: str = "modelnet10"
    seed: int = 1
    softmax_type: str = "modified"        # "normal" | "modified"
    num_points: int = NUM_POINTS
    num_regions: int = NUM_REGIONS
    num_samples_save: int = NUM_SAMPLES_SAVE
    num_samples: int = NUM_SAMPLES
    k: int = K_FOR_DGCNN
    shapley_batch_size: Optional[int] = None
    interaction_batch_size: Optional[int] = None
    checkpoints_root: str = "./checkpoints"
    data_root: str = "./data"
    model_path: Optional[str] = None      # override checkpoint path
    device: str = "cuda"

    def __post_init__(self):
        if self.model not in PORT_MODEL_NAMES:
            raise ValueError(f"unknown model {self.model!r}")
        if self.dataset not in DATASET_NAMES + ["modelnet40"]:
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.device not in DEVICES:
            raise ValueError(f"unknown device {self.device!r}")
        if self.shapley_batch_size is None:
            self.shapley_batch_size = shapley_batch_size(self.model)
        if self.interaction_batch_size is None:
            self.interaction_batch_size = interaction_batch_size(self.model)

    # -- artifact naming contract (reference: final_shapley_value.py:194-195)
    @property
    def exp_folder(self) -> str:
        return "%s/exp_MODEL_%s_DATA_%s_POINTNUM_%d_REGIONNUM_%d_shapley_test/" % (
            self.checkpoints_root, self.model, self.dataset,
            self.num_points, self.num_regions)

    @property
    def train_exp_name(self) -> str:
        # reference: main_cls_seed.py:247
        return "exp_MODEL_%s_DATA_%s_POINTNUM_%d_clean" % (
            self.model, self.dataset, self.num_points)

    @property
    def num_classes(self) -> int:
        return num_classes_for(self.dataset)

    def default_model_path(self) -> str:
        """Checkpoint path per (model, dataset) (reference: final_util.py:52-66),
        as a reference-layout ``.t7`` state dict."""
        if self.model == "gcnn_adv":
            name = ("exp_MODEL_gcnn_adv_DATA_%s_POINTNUM_%d_clean_with_all_rot_da"
                    % (self.dataset, self.num_points))
            fname = "model_399"
        else:
            name = self.train_exp_name
            fname = "model_best"
        return f"{self.checkpoints_root}/{name}/models/{fname}.t7"

    def fps_index_path(self) -> str:
        # reference: final_save_fps.py:54
        return "fps_%s_%d_%d_index_final30.npy" % (
            self.dataset, self.num_points, self.num_regions)
