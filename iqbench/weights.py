"""Seeded weights in the reference's state-dict layout (the reference
module's ``leaves``), made from a configuration's widths on the device, in
two large draws.

The names are those of the published code (``conv1.0.weight``,
``sa1.conv_blocks.0.0.weight``, ...), which the port's modules keep, so the
port loads them with ``strict=True``: a port whose widths differ from the
configuration's fails there.  The reference reads the same dictionary.

Every BatchNorm is randomised (scales of both signs, running statistics),
so that the edge convs' max and min both serve.  Products are He-uniform,
biases uniform in +-1/sqrt(fan_in).
"""
from __future__ import annotations

from typing import Dict

import torch

from iqbench.reference import attribution as ref_attr

BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def seeded_state(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of configuration ``cfg`` from ``seed``, on ``device``."""
    leaves = ref_attr.model(cfg).leaves(cfg)
    sizes = []
    for leaf in leaves:
        shape = leaf[1]
        n = shape if leaf[2] == "bn" else int(torch.Size(shape).numel())
        sizes.append(n * (4 if leaf[2] == "bn" else 1))
    total = sum(sizes)
    g = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand(total, generator=g, device=device)
    nrm = torch.randn(total, generator=g, device=device)
    state, off = {}, 0
    for leaf, n in zip(leaves, sizes):
        names, shape, kind = leaf[0], leaf[1], leaf[2]
        u, z = uni[off:off + n], nrm[off:off + n]
        off += n
        if kind == "w":
            fan_in = int(torch.Size(shape[1:]).numel())
            t = {"": ((2 * u - 1) * (6.0 / fan_in) ** 0.5).reshape(shape)}
        elif kind == "b":
            t = {"": ((2 * u - 1) / leaf[3] ** 0.5).reshape(shape)}
        else:
            w = shape
            us, zs = u.reshape(4, w), z.reshape(4, w)
            fields = (torch.where(zs[0] < 0, -1.0, 1.0) * (0.5 + us[0]),
                      0.1 * zs[1], 0.1 * zs[2], 0.5 + us[3])
            t = {"." + f: v.contiguous() for f, v in zip(BN_FIELDS, fields)}
            t[".num_batches_tracked"] = torch.zeros((), dtype=torch.int64,
                                                    device=device)
        for name in names:
            for suffix, v in t.items():
                state[name + suffix] = v
    return state
