"""Rank functions of tests/test_torch_data_parallel.py.  They run in the
processes that ``parallel.data_parallel.spawn`` starts, which import them
by name, so they live apart from the test module: that one imports JAX,
these import the port alone."""
import torch

from interpret_quality_tpu_torch.parallel.dryrun import dp_step_rank


def all_reduce_rank(group):
    """y = AllReduceSum(x) with rank r's x = (r + 1) * [0, 1, 2], and the
    gradient of rank r's share (r + 1) * sum(y)."""
    x = (torch.arange(3, dtype=torch.float64) * (group.rank + 1)
         ).requires_grad_()
    y = group.all_reduce(x)
    (y * (group.rank + 1)).sum().backward()
    return {"y": y.detach(), "grad": x.grad}


def dp_step_cases(group, cases):
    """``dryrun.dp_step_rank`` for each case's arguments, in order."""
    return [dp_step_rank(group, *case) for case in cases]
