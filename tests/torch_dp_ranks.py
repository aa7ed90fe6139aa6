"""Rank functions of tests/test_torch_data_parallel.py and
tests/test_torch_cuda.py.  They run in the processes that
``parallel.data_parallel.spawn`` starts, which import them by name, so they
live apart from the test modules: the first imports JAX, and these import
the port alone."""
import contextlib

import torch
from torch.nn.modules.module import register_module_forward_hook

from interpret_quality_tpu_torch.models import dgcnn, pointconv
from interpret_quality_tpu_torch.models.common import Dropout
from interpret_quality_tpu_torch.ops.cuda import launch
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


@contextlib.contextmanager
def recorded_step(f64=False, replay=None):
    """Inside the block, what a step draws and selects is recorded, on the
    CPU: each Dropout's kept values and where its input is nonzero
    (``masks``), and each of DGCNN's kNN calls' query rows and indices
    (``knn``).  With ``replay``, a list of index tensors, the i-th kNN call
    records its own selection and returns the i-th of them.  With ``f64``,
    PointConv's FPS takes an f32 copy of its float64 clouds: the kernel
    takes f32, and clouds that were f32 give the same indices, so a float64
    step runs on the card."""
    rec, knn, fps = {"masks": [], "knn": []}, dgcnn.knn, pointconv.fps

    def hook(module, inputs, output):
        if isinstance(module, Dropout):
            rec["masks"].append(((output != 0).cpu(), (inputs[0] != 0).cpu()))

    def recording_knn(query, database, k, select=None):
        idx = knn(query, database, k, select=select)
        rec["knn"].append((query.detach().cpu(), idx.cpu()))
        if replay is not None:
            return replay[len(rec["knn"]) - 1].to(idx.device)
        return idx
    handle = register_module_forward_hook(hook)
    dgcnn.knn = recording_knn
    if f64:
        pointconv.fps = lambda xyz, npoint: fps(xyz.float().contiguous(),
                                                npoint)
    try:
        yield rec
    finally:
        handle.remove()
        dgcnn.knn, pointconv.fps = knn, fps


def dp_step_cases_on_card(group, cases):
    """``dp_step_cases`` inside ``recorded_step``, each case's result with
    its record (``masks``, ``knn``) and the kernels it launched
    (``launches``)."""
    out = []
    for case in cases:
        launch.reset_launches()
        with recorded_step(case[-1] is torch.float64) as rec:
            res = dp_step_rank(group, *case)
        out.append({**res, **rec, "launches": launch.launches()})
    return out
