"""Evaluation and training datasets, host augmentations and the native
host helpers (counterpart of ``interpret_quality_tpu/data``)."""
from .datasets import (
    ModelNetShapleyEval,
    ShapeNetShapleyEval,
    ModelNetTrain,
    ShapeNetTrain,
    SyntheticClouds,
    make_eval_dataset,
    get_folder_name_list,
    farthest_point_sample_np,
)
from . import augment

__all__ = [
    "ModelNetShapleyEval", "ShapeNetShapleyEval", "ModelNetTrain",
    "ShapeNetTrain", "SyntheticClouds", "make_eval_dataset",
    "get_folder_name_list", "farthest_point_sample_np", "augment",
]
