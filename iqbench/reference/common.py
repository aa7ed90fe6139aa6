"""What the reference models share: the product precision, neighbour
selection, BatchNorm, blocked evaluation, and counting distinct values."""
from __future__ import annotations

import contextlib

import torch

BN_EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool):
    """The card's float32 products: exact (``tf32=False``, the
    configurations' setting) or one TF32 pass (the control)."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = tf32
    try:
        yield
    finally:
        for f, s in zip(flags, saved):
            f.allow_tf32 = s


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) rows at idx (B, ...) -> (B, ..., C)."""
    B = x.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, N, M) of rows a (B, N, C) and b (B, M, C),
    |a|^2 - 2 a.b + |b|^2."""
    return ((a * a).sum(-1, keepdim=True) - 2.0 * a @ b.transpose(1, 2)
            + (b * b).sum(-1)[:, None, :])


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest rows of each row of x (B, N, C) in its own cloud, self
    included, ascending distance, ties to the lowest index."""
    return torch.sort(sq_dist(x, x), dim=-1, stable=True).indices[..., :k]


def bn_eval(x: torch.Tensor, state, name: str) -> torch.Tensor:
    """Eval BatchNorm over the last axis with the running statistics."""
    return ((x - state[name + ".running_mean"])
            / torch.sqrt(state[name + ".running_var"] + BN_EPS)
            * state[name + ".weight"] + state[name + ".bias"])


def blocked(fn, x: torch.Tensor, block: int):
    """fn over blocks of ``block`` clouds of x, concatenated."""
    return torch.cat([fn(x[s:s + block]) for s in range(0, x.shape[0], block)])


def distinct_per_row(ids: torch.Tensor, absent: int) -> torch.Tensor:
    """Distinct values other than ``absent`` along the last axis."""
    s = torch.sort(ids, dim=-1).values
    new = (s[..., 1:] != s[..., :-1]) & (s[..., 1:] != absent)
    return new.sum(-1) + (s[..., 0] != absent)


def first_mask(ids: torch.Tensor) -> torch.Tensor:
    """True at the first occurrence of each value along the last axis."""
    order = torch.sort(ids, dim=-1, stable=True)
    first = torch.ones_like(order.values, dtype=torch.bool)
    first[..., 1:] = order.values[..., 1:] != order.values[..., :-1]
    return torch.zeros_like(first).scatter_(-1, order.indices, first)
