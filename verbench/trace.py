"""What a ``torch.profiler`` trace of the window says about the device.

* ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets) in the window, so that overlapping streams count once;
* ``kernel_s(substring)``: device seconds and launches of the kernels
  whose name holds a substring;
* ``device_ops``: the ten device operations that took the most time;
* ``idle_gaps``: the ten longest stretches with nothing on the device,
  each named by the innermost host operation that was running at its
  start (``host idle`` where none was).
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Tuple


# a range of record_function drawn on the device's timeline
# ("Optimizer.step#AdamW.step", "ProfilerStep#3"), not device work
_RANGE = re.compile(r"^[\w.]+#[\w.]+$")


def _events(prof):
    """(device [(start_ns, end_ns, name)], host [(start_ns, end_ns, name)])
    from the profiler's raw events."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        activity = str(e.activity_type()) if hasattr(e, "activity_type") \
            else ""
        if "annotation" in activity.lower() or _RANGE.match(e.name()):
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1e3)
        if dur <= 0:
            continue
        row = (int(start), int(start + dur), e.name())
        if kind.endswith("CUDA"):
            dev.append(row)
        elif kind.endswith("CPU"):
            host.append(row)
    return dev, host


class TraceSummary:
    def __init__(self, prof, window_s: float):
        dev, host = _events(prof)
        if not dev:
            raise RuntimeError("the profiler recorded no device activity")
        self.window_s = window_s
        dev.sort()
        self._dev = dev
        merged: List[List[int]] = []
        for s, e, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        totals: Dict[str, float] = collections.defaultdict(float)
        counts: Dict[str, int] = collections.defaultdict(int)
        for s, e, name in dev:
            totals[name] += (e - s) / 1e9
            counts[name] += 1
        self._totals, self._counts = totals, counts
        self.device_ops = sorted(([n, t] for n, t in totals.items()),
                                 key=lambda r: -r[1])[:10]
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        host.sort()
        starts = [h[0] for h in host]
        self.idle_gaps = [[self._host_at(host, starts, at), g / 1e9]
                          for g, at in gaps]

    @staticmethod
    def _host_at(host, starts, t) -> str:
        """The innermost (latest started) host op running at time ``t``."""
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(i - 4000, 0) - 1, -1):
            s, e, name = host[j]
            if e >= t:
                best = name
                break
        return best or "host idle"

    def kernel_s(self, substring: str) -> Tuple[float, int]:
        secs = sum(t for n, t in self._totals.items() if substring in n)
        launches = sum(c for n, c in self._counts.items() if substring in n)
        return secs, launches

    def breakdown(self) -> Dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}
