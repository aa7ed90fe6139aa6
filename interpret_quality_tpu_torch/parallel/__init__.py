"""The coalition split over devices and the data-parallel train step."""
from .data_parallel import (AllReduceSum, DPContext, DPGroup, active,
                            all_reduce_grads, assert_replicated, dp_context,
                            make_dp_train_step, shard_batch, spawn)
from .mesh import SplitForward, coalition_split, make_mesh

__all__ = ["AllReduceSum", "DPContext", "DPGroup", "SplitForward", "active",
           "all_reduce_grads", "assert_replicated", "coalition_split",
           "dp_context", "make_dp_train_step", "make_mesh", "shard_batch",
           "spawn"]
