"""The classifiers: PointNet, PointNet++ (MSG), PointConv, DGCNN, GCNN and
adv-GCNN, in eval and in training, and PCT and PointMLP in eval."""
from .dgcnn import DGCNNCls, GCNNCls
from .pct import PCTCls
from .pointconv import PointConvDensityClsSsg
from .pointmlp import PointMLP
from .pointnet import PointNetCls, feature_transform_regularizer
from .pointnet2 import PointNet2ClsMsg
from .registry import (MODEL_REGISTRY, ForwardFn, build_model,
                       make_forward_fn, train_forward)

__all__ = ["DGCNNCls", "GCNNCls", "PCTCls", "PointConvDensityClsSsg",
           "PointMLP", "PointNetCls",
           "PointNet2ClsMsg", "MODEL_REGISTRY", "ForwardFn", "build_model",
           "feature_transform_regularizer", "make_forward_fn",
           "train_forward"]
