"""The data-parallel train step over processes (counterpart of the train
step of ``__graft_entry__.dryrun_multichip`` in the JAX package).

The JAX package shards the batch over a 1-D ``dp`` mesh, replicates the
parameters and runs one jitted step as SPMD.  Every reduction over the
batch axis then spans the whole batch (BatchNorm's statistics, the loss's
mean, PointNet's regulariser) and the dropout masks are drawn for the whole
batch from one key: the step is the single-device step on the whole batch.
DDP would be another step (BatchNorm statistics and dropout streams per
rank), so the port reproduces those semantics by hand:

  * ``spawn`` starts one process per rank, each with a replica of the
    model, and hands each a ``DPGroup`` (rank, world size, process group,
    device);
  * while a step runs its forward, a ``DPContext`` (the group and the
    global batch size) is active and the layers read it (``active``):
    ``models.common.batch_norm`` takes its two passes over the whole batch
    through all-reduced sums, ``Dropout`` draws its mask at the global
    shape and keeps this rank's rows, PointNet's regulariser and the
    weighted loss divide by the global count;
  * each rank's loss is its share of the global loss (the shares sum to
    it), so the all-reduces' backward (a sum of the gradients over ranks)
    and the sum of every parameter's gradient over ranks
    (``all_reduce_grads``) give the gradient of the global loss; not a
    mean, since the loss is already divided by the global count.

With no context active every layer computes what it computes outside a
data-parallel run, bit for bit.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import config
from ..ops.precision import set_matmul_precision

INIT_TIMEOUT = datetime.timedelta(minutes=10)


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of a process group, replicated on
    every rank; its backward is the same sum of the gradients (each rank's
    loss is a share of the global one).  Written out because
    ``torch.distributed.nn.functional.all_reduce`` is deprecated."""

    @staticmethod
    def forward(ctx, tensor: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = tensor.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


@dataclass(frozen=True)
class DPGroup:
    """One rank's view of the data-parallel run."""
    rank: int
    world: int
    process_group: Any
    device: torch.device

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """The differentiable sum of ``tensor`` over the ranks."""
        return AllReduceSum.apply(tensor, self.process_group)


@dataclass(frozen=True)
class DPContext:
    """What the layers read while a data-parallel forward runs."""
    group: DPGroup
    global_batch: int

    @property
    def world(self) -> int:
        return self.group.world

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        return self.group.all_reduce(tensor)

    def rows(self, local_batch: int) -> slice:
        """This rank's rows of a tensor laid out over the global batch."""
        if local_batch * self.world != self.global_batch:
            raise ValueError(f"a part of {local_batch} rows over "
                             f"{self.world} ranks is not the global batch "
                             f"of {self.global_batch}")
        start = self.group.rank * local_batch
        return slice(start, start + local_batch)


_ACTIVE: contextvars.ContextVar[Optional[DPContext]] = \
    contextvars.ContextVar("data_parallel_context", default=None)


def active() -> Optional[DPContext]:
    """The data-parallel context of the running forward, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def dp_context(group: DPGroup, global_batch: int):
    """Make the layers compute over the global batch of ``group`` while the
    block runs."""
    token = _ACTIVE.set(DPContext(group, global_batch))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def shard_batch(tensor: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """This rank's contiguous part of a batch split into equal parts; a
    batch that does not divide by the world size raises, as the JAX
    package's ``NamedSharding`` does."""
    if tensor.shape[0] % group.world:
        raise ValueError(f"a batch of {tensor.shape[0]} does not split into "
                         f"{group.world} equal parts")
    part = tensor.shape[0] // group.world
    return tensor[group.rank * part:(group.rank + 1) * part]


def all_reduce_grads(model: torch.nn.Module, group: DPGroup) -> None:
    """Every parameter's ``.grad`` summed over the ranks, through one
    flattened buffer per dtype."""
    by_dtype = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                        group=group.process_group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def assert_replicated(model: torch.nn.Module, group: DPGroup) -> None:
    """Raise unless the parameters and buffers are the same on every rank:
    per dtype, the sum and the sum of squares of all their values, in
    float64, against the largest over the ranks (a few launches, whatever
    the model's tensor count)."""
    by_dtype = {}
    for t in (*model.parameters(), *model.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t.detach().reshape(-1))
    sums = []
    for flats in by_dtype.values():
        v = torch.cat(flats).double()
        sums += [v.sum(), v.square().sum()]
    sums = torch.stack(sums)
    both = torch.cat([sums, -sums])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group.process_group)
    if not (torch.equal(both[:len(sums)], sums)
            and torch.equal(both[len(sums):], -sums)):
        raise AssertionError(f"rank {group.rank}: the replicas differ")


def make_dp_train_step(model: torch.nn.Module, optimizer, scheduler,
                       model_name: str, group: DPGroup,
                       generator: Optional[torch.Generator] = None):
    """(data, labels, valid) -> (loss, preds): one step of the optimiser on
    this rank's replica, the data-parallel form of
    ``train.trainer.make_train_step``.  ``data`` and ``labels`` are the
    global batch, the same on every rank (a padded tail, rows from
    ``valid`` on, falls on the last ranks); each rank takes its part, runs
    the train forward under the global batch's context and its share of the
    loss, and the summed gradients step every replica alike.  ``generator``
    is seeded alike on every rank.  Returns the global loss and the
    predictions of the whole batch (each rank's rows, gathered), both on
    the device.  Outside ``python -O`` it checks once a call that the
    replicas stayed equal."""
    # imported here: models.common imports this module
    from ..train.trainer import train_loss, valid_weights

    def step(data: torch.Tensor, labels: torch.Tensor, valid: int):
        batch = data.shape[0]
        weights = shard_batch(valid_weights(batch, valid, data.device), group)
        x, y = shard_batch(data, group), shard_batch(labels, group)
        with dp_context(group, batch):
            share, logits = train_loss(model, model_name, x, y, weights,
                                       generator)
        optimizer.zero_grad(set_to_none=True)
        share.backward()
        all_reduce_grads(model, group)
        optimizer.step()
        scheduler.step()
        loss = share.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group.process_group)
        preds = torch.zeros(batch, dtype=torch.int64, device=data.device)
        preds[group.rank * x.shape[0]:(group.rank + 1) * x.shape[0]] = \
            logits.detach().argmax(dim=-1)
        dist.all_reduce(preds, op=dist.ReduceOp.SUM, group=group.process_group)
        if __debug__:
            assert_replicated(model, group)
        return loss, preds

    return step


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               devices: Sequence[torch.device], folder: str,
               precision: Tuple[str, int]) -> None:
    args = torch.load(os.path.join(folder, "args.pt"), weights_only=False)
    store = dist.FileStore(os.path.join(folder, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=INIT_TIMEOUT)
    try:
        device = devices[rank]
        set_matmul_precision(precision[0])      # the parent's settings
        config.set_gather_value_parts(precision[1])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:               # the ranks share the process's threads
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        group = DPGroup(rank, world, dist.group.WORLD, device)
        out = fn(group, *args)
        torch.save(out, os.path.join(folder, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "gloo",
          devices: Optional[Sequence] = None, args: tuple = ()) -> List:
    """Run ``fn(group, *args)`` in ``world`` new processes, one per rank,
    joined in a process group of ``backend`` (``gloo``: CPU or CUDA
    tensors; ``nccl``: one card per rank), and return each rank's result,
    copied to the CPU.  ``devices`` names each rank's device (default: the
    CPU for all).  Processes are spawned, never forked (a forked CUDA
    context is unusable), and meet through a file store in a temporary
    folder, with no network.  A rank that raises makes the call raise;
    the group is destroyed in every rank.  ``fn`` and ``args`` must pickle
    (a module-level function).  Each rank takes this process's matmul and
    gather precision settings (``config``)."""
    devices = [torch.device(d) for d in (devices or ["cpu"] * world)]
    devices = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d
               for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= visible:
            raise RuntimeError(f"device {d} was asked for but {visible} CUDA "
                               f"devices are visible")
    if backend == "nccl" and any(d.type != "cuda" for d in devices):
        raise RuntimeError("the nccl backend needs a CUDA device per rank")
    with tempfile.TemporaryDirectory() as folder:
        # through a file: arguments pickled into the processes' start-up
        # pipes would make each process wait for the one before it
        torch.save(args, os.path.join(folder, "args.pt"))
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world, backend, devices, folder,
                              (config.matmul_precision(),
                               config.gather_value_parts())),
            nprocs=world, join=True)
        return [torch.load(os.path.join(folder, f"result{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
