"""The traced run's device timeline, from ``torch.profiler``.

``summarize`` reads the profiler's raw events once: the device's kernels,
copies and sets (each with the host time of the call that launched it),
the benchmark's spans (``iqbench.*``) and the port's (``iq_*``).  From
them: the busy time (the union of device intervals inside the window
span ``iqbench.window``), the device time launched inside a span, the
idle gaps, and the breakdown of the result line.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "iqbench.window"
SPAN_PREFIXES = ("iqbench.", "iq_")
NAME_CHARS = 160


def start(device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    def __init__(self, kernels, spans, host_ops, window):
        self.kernels = kernels          # (name, start, end, launch time or None)
        self.spans = spans              # name -> sorted [(start, end)]
        self.host_ops = host_ops        # [(start, end, name)] of the window's thread
        self.w0, self.w1 = window
        inside = [(max(s, self.w0), min(e, self.w1)) for _, s, e, _ in kernels
                  if e > self.w0 and s < self.w1]
        self.busy = _union(inside)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self.window_s = (self.w1 - self.w0) / 1e9
        launched = [k for k in kernels if k[3] is not None]
        self.attributed = len(launched) / max(1, len(kernels))

    def _inside(self, name: str, t: int) -> bool:
        iv = self.spans.get(name, [])
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    def device_s(self, inside: Sequence[str], outside: Sequence[str] = ()
                 ) -> Optional[float]:
        """Seconds of device work launched inside a span of every name in
        ``inside`` and of none in ``outside``; None where the launches
        cannot be told (fewer than 99% of the kernels carry one)."""
        if self.attributed < 0.99:
            return None
        total = 0
        for _, s, e, t in self.kernels:
            if (t is not None and all(self._inside(n, t) for n in inside)
                    and not any(self._inside(n, t) for n in outside)):
                total += e - s
        return total / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        edges = [self.w0] + [x for iv in self.busy for x in iv] + [self.w1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def breakdown(self) -> Dict[str, list]:
        """The 10 device operations that took most time, and the 10 host
        activities (the innermost span or operator running when the device
        went idle) under which the device was idle longest."""
        ops: Dict[str, int] = defaultdict(int)
        for name, s, e, _ in self.kernels:
            if e > self.w0 and s < self.w1:
                ops[name[:NAME_CHARS]] += min(e, self.w1) - max(s, self.w0)
        idle: Dict[str, int] = defaultdict(int)
        for (s, e), name in zip(self.gaps(), self._host_at([s for s, _ in self.gaps()])):
            idle[name] += e - s

        def top(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}

    def _host_at(self, times: List[int]) -> List[str]:
        """The innermost host operation running at each time (sorted)."""
        out, stack, i = [], [], 0
        ops = self.host_ops
        for t in times:
            while i < len(ops) and ops[i][0] <= t:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2][:NAME_CHARS] if stack else "(no host operation)")
        return out


def summarize(prof) -> Trace:
    """Stop the profiler and read its events."""
    prof.__exit__(None, None, None)
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    cpu_by_corr: Dict[int, int] = {}
    runtime_by_corr: Dict[int, int] = {}
    device, spans = [], defaultdict(list)
    host: Dict[int, list] = defaultdict(list)
    window, window_thread = None, None
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(("cuda", "cu")) and not name.startswith("cuda:"):
                runtime_by_corr[ev.correlation_id()] = s
            else:
                cpu_by_corr[ev.correlation_id()] = s
                host[ev.start_thread_id()].append((s, e, name))
            if name.startswith(SPAN_PREFIXES):
                spans[name].append((s, e))
            if name == WINDOW:
                window, window_thread = (s, e), ev.start_thread_id()
        elif not ev.is_user_annotation() and ev.device_type() == DeviceType.CUDA:
            device.append((name, s, e, ev.correlation_id(),
                           ev.linked_correlation_id()))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    kernels = []
    for name, s, e, corr, linked in device:
        t = runtime_by_corr.get(corr)
        if t is None:
            t = cpu_by_corr.get(linked)
        kernels.append((name, s, e, t))
    host_ops = sorted(host[window_thread])
    return Trace(kernels, {k: sorted(v) for k, v in spans.items()}, host_ops,
                 window)
