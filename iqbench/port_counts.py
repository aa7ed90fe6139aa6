"""The port's work counters (``utils.profiling.counters``): what the program
really did in the traced window, for the readers that set it against what
the inputs need.  The port counts only while a profiler records, so only
the traced run has them."""
from __future__ import annotations

from typing import Optional


def port_counter(name: str) -> Optional[int]:
    """The port's counter ``name`` over the traced window; None where the
    port keeps no such counter or counted nothing."""
    from interpret_quality_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    return read().get(name) or None
