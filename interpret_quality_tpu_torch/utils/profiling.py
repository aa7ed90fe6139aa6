"""Stage timing and tracing.

``StageTimer`` prints one JSON line per stage with the raw item count beside
the seconds, so aggregators sum items directly instead of multiplying back
through a rounded rate.  Stages end by copying their results to the host,
which waits for the device, so the wall clock covers the device work.
``device_trace`` wraps a stage's device work in a ``torch.profiler`` trace.
``device_line`` names the hardware a measurement ran on.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import time
from typing import Optional


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
    import torch
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
