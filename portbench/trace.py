"""The reduction of a ``torch.profiler`` trace of the traced steps to what
the per-layer metrics read: device activity, the host's named ranges, and
the link between them.

Every kernel, copy and set on the card is matched to the host call that
launched it by CUPTI's correlation id (``tools/profile_eval.py:
range_device_ms``'s method): the program launches its own kernels through
ctypes, and torch.profiler credits those to no range of its own. A range's
device time is that of the work launched while one of its windows was open
on the host, on any thread. Device busy time is the union of the device
intervals, so work that overlaps on two streams counts once. NCCL's
kernels (names that start with ``nccl``) are kept out of it and counted
apart (``collective_s``, ``collective_launches``): a collective's kernel
spins on the card while it waits for the slowest rank, so as busy time it
would count the other ranks' lag as this card's work.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "portbench.window"  # the harness's range around the traced steps
TOP = 10  # entries of each breakdown list
COLLECTIVE = "nccl"  # the prefix of NCCL's kernel names


def _user_range(e) -> bool:
    if hasattr(e, "is_user_annotation"):
        return bool(e.is_user_annotation())
    return not e.name().startswith(("aten::", "cu", "autograd::", "torch::",
                                    "Optimizer.", "<", "Memcpy", "Memset"))


class Trace:
    """``prof``: a finished ``torch.profiler.profile`` whose steps ran
    inside ``record_function(WINDOW)``; ``steps``: how many."""

    def __init__(self, prof, steps: int):
        from torch.autograd import DeviceType

        self.steps = steps
        self.ranges: Dict[str, List[Tuple[int, int]]] = {}
        self.launch: Dict[int, int] = {}
        device = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CPU:
                if _user_range(e):
                    self.ranges.setdefault(e.name(), []).append(
                        (e.start_ns(), e.end_ns()))
                elif e.name().startswith("cu"):  # the CUDA API: launches
                    self.launch[e.correlation_id()] = e.start_ns()
            elif e.duration_ns() > 0:
                device.append(e)
        # the device's copies of the host's ranges are no device work
        self.device = [(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
                       for e in device if e.name() not in self.ranges
                       and not _user_range(e)]
        wins = self.ranges.get(WINDOW)
        if not wins:
            raise RuntimeError("the trace holds no traced window")
        self.t0, self.t1 = wins[0][0], wins[-1][1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _busy(self) -> List[Tuple[int, int]]:
        """The union of the device intervals inside the window, sorted,
        collectives left out."""
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for n, s, e, _ in self.device
                       if not n.startswith(COLLECTIVE))
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e9

    def _collectives(self) -> List[int]:
        """The durations (ns) of the collectives' kernels in the window."""
        inside = ((max(s, self.t0), min(e, self.t1))
                  for n, s, e, _ in self.device if n.startswith(COLLECTIVE))
        return [e - s for s, e in inside if e > s]

    @property
    def collective_s(self) -> float:
        """Device seconds of the collectives' kernels in the window, their
        waits for the other ranks included."""
        return sum(self._collectives()) / 1e9

    @property
    def collective_launches(self) -> int:
        return len(self._collectives())

    def range_ms(self, name: str) -> Optional[float]:
        """Device ms a step of the work launched inside range ``name``;
        None where the trace has no such range."""
        wins = self.ranges.get(name)
        if not wins:
            return None
        ns = 0
        for _, s, e, corr in self.device:
            t = self.launch.get(corr)
            if t is not None and any(lo <= t < hi for lo, hi in wins):
                ns += e - s
        return ns / 1e6 / self.steps

    def kernel_s(self, patterns: Iterable[str]) -> Optional[float]:
        """Device seconds a step of the work whose name holds one of
        ``patterns``; None where no such work ran."""
        pats = tuple(patterns)
        ns = [e - s for n, s, e, _ in self.device if any(p in n for p in pats)]
        return sum(ns) / 1e9 / self.steps if ns else None

    def device_ops(self) -> List[list]:
        """The device operations that took most time in the window:
        [name, seconds] summed over their launches."""
        total: Dict[str, int] = {}
        for n, s, e, _ in self.device:
            total[n[:120]] = total.get(n[:120], 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_gaps(self) -> List[list]:
        """The device's idle time in the window, summed by what the host
        was doing: the innermost named range open at each gap's middle
        ("no range" where none was). [label, seconds], longest first."""
        busy = self._busy()
        edges = [self.t0] + [t for span in busy for t in span] + [self.t1]
        named = [(n, w) for n, ws in self.ranges.items() if n != WINDOW
                 for w in ws]
        total: Dict[str, int] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            inner = [(w[0], n) for n, w in named if w[0] <= mid < w[1]]
            label = max(inner)[1] if inner else "no range"
            total[label] = total.get(label, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, ns / 1e9] for n, ns in top]
