"""The traced part of a window: a ``torch.profiler`` run of the card's
activity alone (kernels, copies, sets), reduced to device intervals and
kernel times.

Only CUDA activity is recorded: host-side op recording doubled a 2B
request's host time on the card, the device-side tracing alone added about
a third (H100 80GB HBM3, 700 W).  Kineto stamps device activity in the
host's wall clock (on the card a spin kernel launched just after a
``time.time_ns`` reading started 0.3–0.5 ms after it), so a
``time.perf_counter`` reading is laid over the trace through one pair of
readings taken when tracing starts.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(merged: List[Tuple[int, int]], ends: List[int], a: int, b: int) -> int:
    """Nanoseconds of [a, b) that the merged intervals cover."""
    i, total = bisect.bisect_right(ends, a), 0
    while i < len(merged) and merged[i][0] < b:
        x, y = merged[i]
        total += min(b, y) - max(a, x)
        i += 1
    return total


@dataclass
class Trace:
    """The device side of a traced window, in the trace's nanoseconds;
    ``start`` and ``end`` bound the window the numbers cover."""

    start: int
    end: int
    kernels: List[Tuple[str, int, int]]  # name, start, duration
    busy: List[Tuple[int, int]]  # merged device intervals
    offset_ns: int  # trace ns - perf_counter ns

    def __post_init__(self):
        self._ends = [b for _, b in self.busy]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return _overlap(self.busy, self._ends, self.start, self.end) / 1e9

    def at(self, perf_s: float) -> int:
        """A ``time.perf_counter`` reading in the trace's clock."""
        return int(perf_s * 1e9) + self.offset_ns

    def _matching(self, pattern: str, exclude: str):
        inc = re.compile(pattern, re.I)
        exc = re.compile(exclude, re.I) if exclude else None
        return [k for k in self.kernels
                if self.start <= k[1] < self.end and inc.search(k[0])
                and not (exc and exc.search(k[0]))]

    def kernel_seconds(self, pattern: str, exclude: str = "") -> Tuple[float, int]:
        """(summed device seconds, launches) of the window's kernels whose
        name matches ``pattern`` and not ``exclude`` (regular expressions,
        case ignored)."""
        ks = self._matching(pattern, exclude)
        return sum(k[2] for k in ks) / 1e9, len(ks)

    def kernel_names(self, pattern: str, exclude: str = "", k: int = 6) -> List[list]:
        """The names (cut to 60 letters) and launches of the kernels that
        ``kernel_seconds`` counts, most launched first."""
        by: Dict[str, int] = {}
        for name, _, _ in self._matching(pattern, exclude):
            by[name[:60]] = by.get(name[:60], 0) + 1
        return sorted(by.items(), key=lambda x: -x[1])[:k]

    def idle_inside(self, windows: List[Tuple[int, int]]) -> Tuple[float, float]:
        """(idle seconds, total seconds) of the device inside ``windows``,
        cut to the traced window."""
        idle = total = 0
        for a, b in windows:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            total += b - a
            idle += (b - a) - _overlap(self.busy, self._ends, a, b)
        return idle / 1e9, total / 1e9

    def idle_gaps(self, label) -> List[list]:
        """Idle seconds inside the window summed by ``label(gap start)``,
        what the host was doing, largest first."""
        by: Dict[str, int] = {}
        prev = self.start
        for a, b in self.busy + [(self.end, self.end)]:
            a, b = max(a, self.start), min(b, self.end)
            if a > prev:
                key = label(prev)
                by[key] = by.get(key, 0) + (a - prev)
            prev = max(prev, b)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda x: -x[1])[:10]]

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, s, dur in self.kernels:
            if self.start <= s < self.end:
                by[name] = by.get(name, 0) + dur
        return [[n[:120], d / 1e9] for n, d in sorted(by.items(), key=lambda x: -x[1])[:k]]


class Window:
    """A profiler that ``start()`` turns on and ``stop()`` (or leaving the
    ``with`` block) turns off; ``trace`` then holds the reduced trace.  A
    window made with ``enabled=False`` does nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None
        self.started_at = None
        self._prof = None
        if enabled:
            # the profiler's first start sets up CUPTI for seconds: done here, in
            # set-up, so that starting it mid-window stalls nothing
            self.start()
            self._prof.__exit__(None, None, None)
            self._prof = self.started_at = None

    def __enter__(self):
        return self

    def start(self):
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        # a CPU-only run (the tests) records host ops, which count as no device work
        self._prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                         else ProfilerActivity.CPU])
        self._prof.__enter__()
        self.started_at = time.perf_counter()
        self._offset = time.time_ns() - time.perf_counter_ns()

    def stop(self):
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stopped = time.perf_counter()
        self._prof.__exit__(None, None, None)
        kernels = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation():
                kernels.append((ev.name(), int(ev.start_ns()), int(ev.duration_ns())))
        self._prof = None
        self.trace = Trace(start=int(self.started_at * 1e9) + self._offset,
                           end=int(stopped * 1e9) + self._offset, kernels=kernels,
                           busy=_merge([(s, s + d) for _, s, d in kernels]),
                           offset_ns=self._offset)

    def __exit__(self, *exc):
        self.stop()
        return False
