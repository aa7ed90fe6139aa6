"""The coalition axis split over devices (counterpart of
``interpret_quality_tpu/parallel/mesh.py``).

The attribution engines batch the masked clouds of many coalitions (orders
x rows) into one forward.  Every cloud's logits depend on that cloud alone
(the kernels work per cloud, eval BatchNorm per row), so the batch splits
along its first axis into one part per device: each device runs its own
replica of the frozen model on its part, and the logits come back in order
on the first device, where the engine takes the rewards and sums the
marginals.  This is the port's form of the JAX package's sharding
constraint on the coalition axis with its ``psum`` of marginals.

A list that names one device twice (``[cpu, cpu]``, ``[cuda:0, cuda:0]``)
gives a virtual split: the same code path on one device, which is how the
tests hold the split against the unsplit run.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of the split: ``devices`` as given, or the first
    ``n_devices`` visible CUDA devices (all of them for None).  Asking for a
    CUDA device that is not visible raises: the split never shrinks and
    never moves to the CPU."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if devices is None:
        n = visible if n_devices is None else n_devices
        if n < 1 or n > visible:
            raise RuntimeError(f"a split over {n} CUDA devices was asked for "
                               f"but {visible} are visible")
        return [torch.device("cuda", i) for i in range(n)]
    out = [torch.device(d) for d in devices]
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= visible:
            raise RuntimeError(f"device {d} was asked for but {visible} CUDA "
                               f"devices are visible")
    if not out:
        raise ValueError("a split needs at least one device")
    return out


def _on(device: torch.device):
    """Make ``device`` current, so a kernel launches in its context."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _split_tree(tree, sections: int):
    """Each tensor of a nested tuple split along dim 0 into ``sections``
    parts: a list of trees, one per part."""
    if tree is None:
        return [None] * sections
    if isinstance(tree, torch.Tensor):
        return list(torch.tensor_split(tree, sections))
    parts = [_split_tree(t, sections) for t in tree]
    return [tuple(p[i] for p in parts) for i in range(sections)]


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tuple(_to(t, device) for t in tree)


class SplitForward:
    """The forward of a frozen model split along the coalition axis: one
    replica per device, built once.  Called like the model's ``ForwardFn``
    (``(B, N, 3) -> (B, num_class)``, with the ``plan_fn`` /
    ``apply_plan_fn`` hooks of the enumeration's plan path); the logits
    come back in order on ``devices[0]``.  Parts are as even as
    ``torch.tensor_split`` makes them, with no padding; an empty part (a
    batch smaller than the split) is not run."""

    def __init__(self, replicas: Sequence[Callable],
                 devices: Sequence[torch.device]):
        self.replicas = list(replicas)
        self.devices = list(devices)
        self.device = self.devices[0]

    def _run(self, fn, x: torch.Tensor, plans=None) -> torch.Tensor:
        xs = torch.tensor_split(x, len(self.devices))
        plans = plans if plans is not None else [None] * len(xs)
        outs = []
        for replica, dev, part, plan in zip(self.replicas, self.devices, xs,
                                            plans):
            if part.shape[0] == 0:
                continue
            with _on(dev):
                outs.append(fn(replica, part.to(dev), plan))
        return torch.cat([o.to(self.device) for o in outs])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(lambda f, part, _: f(part), x)

    def plan_fn(self, x: torch.Tensor):
        """The plan of the whole batch, computed once on the first device,
        split like the batch and copied to each part's device: a list of
        per-part plans (None for a family without a plan)."""
        with _on(self.device):
            plan = self.replicas[0].plan_fn(x.to(self.device))
        if plan is None:
            return None
        return [_to(p, d) for p, d in
                zip(_split_tree(plan, len(self.devices)), self.devices)]

    def apply_plan_fn(self, x: torch.Tensor, plans) -> torch.Tensor:
        """Logits of ``x`` with the per-part plans of ``plan_fn``."""
        return self._run(lambda f, part, plan: f.apply_plan_fn(part, plan),
                         x, plans)


def coalition_split(forward_fn_factory: Callable[[torch.device], Callable],
                    devices: Sequence) -> SplitForward:
    """A ``SplitForward`` over ``devices``: ``forward_fn_factory(device)``
    builds the replica of each device (its parameters copied there once)."""
    devices = make_mesh(devices=devices)
    return SplitForward([forward_fn_factory(d) for d in devices], devices)
