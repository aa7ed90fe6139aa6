"""The classifiers: PointNet, PointNet++ (MSG), PointConv, DGCNN, GCNN and
adv-GCNN, eval mode."""
from .dgcnn import DGCNNCls, GCNNCls
from .pointconv import PointConvDensityClsSsg
from .pointnet import PointNetCls
from .pointnet2 import PointNet2ClsMsg
from .registry import MODEL_REGISTRY, ForwardFn, build_model, make_forward_fn

__all__ = ["DGCNNCls", "GCNNCls", "PointConvDensityClsSsg", "PointNetCls",
           "PointNet2ClsMsg", "MODEL_REGISTRY", "ForwardFn", "build_model",
           "make_forward_fn"]
