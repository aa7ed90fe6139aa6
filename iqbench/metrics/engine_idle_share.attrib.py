"""The idle that the port's engine causes on the host: the share of the
traced window in which no operation runs on the device while the program
is inside one of the engine's spans (``iq_engine.*``: keep masks built and
uploaded, masking, reward and marginals, the copy to the host) and not
inside a forward or a plan (``iq_forward``, ``iq_plan``), apart from the
benchmark's own host work around the calls (moves ``forwards_per_s``).
At most ``idle_share.attrib``; None where the port has no engine spans."""
from typing import List, Tuple

from iqbench.trace import _union as union

ENGINE = "iq_engine."
MODEL = ("iq_forward", "iq_plan")

Intervals = List[Tuple[int, int]]


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """The common part of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """``a`` less ``b``, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def engine_idle_ns(gaps: Intervals, spans) -> int:
    """Nanoseconds of the idle ``gaps`` inside an engine span and outside
    every model span (``spans``: name -> intervals)."""
    engine = union([iv for name, ivs in spans.items()
                    if name.startswith(ENGINE) for iv in ivs])
    model = union([iv for name in MODEL for iv in spans.get(name, [])])
    return sum(e - s for s, e in intersect(union(gaps), subtract(engine, model)))


def read(ctx):
    t = ctx.trace
    if not any(name.startswith(ENGINE) for name in t.spans) or t.w1 <= t.w0:
        return None
    return 100.0 * engine_idle_ns(t.gaps(), t.spans) / (t.w1 - t.w0)
