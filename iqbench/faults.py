"""Faults planted underneath the timed path, for the tests that see the
check fail and for ``calibrate.py --fault``: each bends an answer of the
port where it is produced, before the engine or the caller reads it.

  * ``answer_altered``: every cloud's first logit off by 0.05;
  * ``tail_quarter``: the last quarter of each forward's clouds answer with
    the logits of the row before (a kernel wrong on the tail rows of its
    batch);
  * ``one_nan``: the first cloud of each forward answers NaN;
  * ``regions_swapped``: the Shapley engine books regions 0 and 1's
    marginals each to the other (a wrong index for two regions).

``plant(name)`` is a context manager; plant before the driver is built, as
it binds the forward's methods.
"""
from __future__ import annotations

import contextlib


def _answer_altered(logits):
    logits = logits.clone()
    logits[:, 0] += 0.05
    return logits


def _tail_quarter(logits):
    if logits.shape[0] < 2:
        return logits
    q = max(1, logits.shape[0] // 4)
    bent = logits.clone()
    bent[-q:] = logits[-q - 1:-1]
    return bent


def _one_nan(logits):
    logits = logits.clone()
    logits[0] = float("nan")
    return logits


def _regions_swapped(marginals):
    return marginals[:, [1, 0] + list(range(2, marginals.shape[1]))]


FORWARD = {"answer_altered": _answer_altered, "tail_quarter": _tail_quarter,
           "one_nan": _one_nan}
MARGINALS = {"regions_swapped": _regions_swapped}
FAULTS = sorted(FORWARD) + sorted(MARGINALS)


@contextlib.contextmanager
def _patched(cls, bends):
    saved = {name: getattr(cls, name) for name in bends}
    for name, bend in bends.items():
        setattr(cls, name, bend(saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def plant(name: str):
    if name in FORWARD:
        from interpret_quality_tpu_torch.models import registry
        bend = FORWARD[name]
        return _patched(registry.ForwardFn, {
            "__call__": lambda f: lambda self, x: bend(f(self, x)),
            "apply_plan_fn": lambda f: lambda self, x, p: bend(f(self, x, p))})
    from interpret_quality_tpu_torch.attrib.shapley import ShapleyEngine
    bend = MARGINALS[name]
    return _patched(ShapleyEngine, {
        "_marginals": lambda f: lambda self, *a: bend(f(self, *a))})
