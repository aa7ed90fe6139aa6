"""Stage timing, tracing and work counters.

``StageTimer`` prints one JSON line per stage with the raw item count beside
the seconds, so aggregators sum items directly instead of multiplying back
through a rounded rate.  Stages end by copying their results to the host,
which waits for the device, so the wall clock covers the device work.
``device_trace`` wraps a stage's device work in a ``torch.profiler`` trace.
``device_line`` names the hardware a measurement ran on.

Work counters count what the program really does, beside the profiler's
spans, and only while a ``torch.profiler`` records (``tracing``), so an
untraced run counts nothing and launches nothing for them.  A count made
from shapes is a host int (``count``); one the device knows is added on
the device into an int64 accumulator (``accumulator``), by a kernel or by
the caller, so that nothing waits for it.  ``counters`` reads them all,
with one synchronisation per device, and ``reset_counters`` clears them.
The counters (each documented where it is counted): ``dense_products``
(``ops.precision.matmul``, ``ops.cuda.dense``), ``k3_distances``,
``k3_tie_rows`` (``ops.cuda.neighbors``), ``k5_rows``, ``k5_tiles``,
``k5_front_waits`` (``ops.cuda.groups``).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import time
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import profiler as autograd_profiler

# counts from shapes, on the host
_HOST_COUNTS: Dict[str, int] = {}
# int64 (1,) accumulators on a device, by (counter, device)
_DEVICE_COUNTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


class StageTimer:
    """Wall-clock timer with derived throughput.

    Example:
        with StageTimer("shapley", items=33_000) as t: ...
        # prints {"stage": "shapley", "seconds": ..., "items": 33000,
        #         "items_per_sec": ...}
    """

    def __init__(self, stage: str, items: Optional[int] = None,
                 printer=print):
        self.stage = stage
        self.items = items
        self.printer = printer
        self.seconds = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        rec = {"stage": self.stage, "seconds": self.seconds}
        if exc and exc[0] is not None:
            # a stage that died mid-flight did not do its items
            rec["aborted"] = True
        elif self.items is not None:
            rec["items"] = self.items
            rec["items_per_sec"] = self.items / self.seconds
        if self.printer is not None:
            self.printer(json.dumps(rec))
        return False


def device_line(device: str = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line), or ``cpu`` for ``device`` "cpu".  Raises where
    nvidia-smi cannot be run."""
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], name: str):
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA
    where a card is present) written to ``<trace_dir>/<name>.pt.trace.json``
    as a Chrome trace, one file per call; a no-op without ``trace_dir``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        trace_dir, re.sub(r"[^\w.-]", "_", name) + ".pt.trace.json"))


def tracing() -> bool:
    """True while a ``torch.profiler`` (or ``torch.autograd.profiler``)
    records on this process."""
    return autograd_profiler._is_profiler_enabled


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` while a profiler records
    (else nothing)."""
    if tracing():
        _HOST_COUNTS[name] = _HOST_COUNTS.get(name, 0) + int(n)


def accumulator(name: str, device) -> torch.Tensor:
    """The int64 (1,) accumulator of counter ``name`` on ``device``, made
    zero at first use.  Callers add into it, or hand it to a kernel that
    does, only while ``tracing()``."""
    key = (name, torch.device(device))
    acc = _DEVICE_COUNTS.get(key)
    if acc is None:
        acc = _DEVICE_COUNTS[key] = torch.zeros(1, dtype=torch.int64,
                                                device=key[1])
    return acc


def counters() -> Dict[str, int]:
    """Every counter's total since the last ``reset_counters``, as ints;
    the device accumulators are read once, one synchronisation a device."""
    out = dict(_HOST_COUNTS)
    by_device: Dict[torch.device, list] = {}
    for (name, device), acc in _DEVICE_COUNTS.items():
        by_device.setdefault(device, []).append((name, acc))
    for entries in by_device.values():
        values = torch.cat([acc for _, acc in entries]).tolist()
        for (name, _), v in zip(entries, values):
            out[name] = out.get(name, 0) + int(v)
    return out


def reset_counters() -> None:
    """Drop every counter, on the host and on the devices."""
    _HOST_COUNTS.clear()
    _DEVICE_COUNTS.clear()
