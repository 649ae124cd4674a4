"""Reading a ``torch.profiler`` trace of the window.

``Trace`` keeps the device's operations (kernels, copies, sets: name, start,
duration) and the host's operations of the thread that drove the window,
from the profiler's raw events (``kineto_results.events()``; building its
``FunctionEvent`` tree for a window of 10^5-10^6 events costs more than
the window).  Times are nanoseconds on the profiler's clock.
"""

from __future__ import annotations

import collections
from bisect import bisect_right
from typing import List, Tuple

NAME_CHARS = 160        # device-op names in the breakdown are cut to this


class Trace:
    def __init__(self, device_ops: List[Tuple[str, int, int]],
                 host_ops: List[Tuple[str, int, int]], window_s: float):
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self.window_s = window_s
        self.busy = _union([(s, s + d) for _, s, d in self.device_ops])

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        device, host = [], collections.defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            row = (e.name(), int(e.start_ns()), int(e.duration_ns()))
            if kind.endswith("CUDA"):
                device.append(row)
            elif kind.endswith("CPU"):
                host[e.start_thread_id()].append(row)
        main = max(host.values(), key=len) if host else []
        return cls(device, main, window_s)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy) / 1e9

    def device_time_s(self, match) -> float:
        """Seconds of the device operations whose name ``match`` accepts."""
        return sum(d for n, _, d in self.device_ops if match(n)) / 1e9

    def top_device_ops(self, k: int = 10) -> list:
        tot = collections.Counter()
        for n, _, d in self.device_ops:
            tot[n[:NAME_CHARS]] += d
        return [[n, d / 1e9] for n, d in tot.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time between device operations, summed by the innermost
        host operation running at each gap's middle."""
        starts = [s for _, s, _ in self.host_ops]
        tot = collections.Counter()
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            mid = (a + b) // 2
            label = "host between operations"
            i = bisect_right(starts, mid) - 1
            # walk back over finished siblings to the deepest op open at mid
            for j in range(i, max(i - 64, -1), -1):
                name, s, d = self.host_ops[j]
                if s + d >= mid:
                    label = name
                    break
            tot[label] += b - a
        return [[n, d / 1e9] for n, d in tot.most_common(k)]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
