"""Readings of the program's own profiler ranges (``rangedet_tpu_torch/
utils/spans.py``) from a reduced trace (``trace.Trace``): how many windows
of a range a step, and the device work launched inside a range's windows,
each kernel, copy or set matched to its launch by CUPTI's correlation id
as ``Trace.range_ms`` matches it. Each returns None where the trace does
not hold what it reads: the program's range (a program without it), or,
for device readings, any device work (a run without a card)."""
from __future__ import annotations

import bisect
from typing import Iterable, Optional

COPIES = ("Memcpy", "Memset")  # device work that is no kernel launch


def count(trace, name: str, program_range: str) -> Optional[float]:
    """Windows of range ``name`` a step; None where the trace has no
    ``program_range`` (the range that opens around ``name``'s, whose
    presence says the program has these ranges: a count may be 0)."""
    if trace is None or not trace.ranges.get(program_range):
        return None
    return len(trace.ranges.get(name, ())) / trace.steps


def _launched_inside(trace, names: Iterable[str]):
    """The device work launched while a window of one of ``names`` was
    open on the host: a list of (name, ns), or None (see the module)."""
    if trace is None or not trace.device:
        return None
    wins = sorted(w for n in names for w in trace.ranges.get(n, ()))
    if not wins:
        return None
    starts = [lo for lo, _ in wins]
    out = []
    for op, s, e, corr in trace.device:
        t = trace.launch.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < wins[i][1]:
            out.append((op, e - s))
    return out


def device_ms(trace, names: Iterable[str]) -> Optional[float]:
    """Device ms a step of the work launched inside the windows of
    ``names``, which must not overlap one another."""
    work = _launched_inside(trace, names)
    if work is None:
        return None
    return sum(ns for _, ns in work) / 1e6 / trace.steps


def launches(trace, names: Iterable[str]) -> Optional[float]:
    """Kernels a step launched inside the windows of ``names`` (copies and
    sets left out)."""
    work = _launched_inside(trace, names)
    if work is None:
        return None
    return sum(not op.startswith(COPIES) for op, _ in work) / trace.steps
