"""The traced stretch: ``torch.profiler`` over a fixed number of queries,
reduced to device kernels, the benchmark's query spans, and host activity,
all on the profiler's one clock (nanoseconds).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from bench.yardstick import busy_union

SPAN = "bench.query"


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (start, end, name)
    spans: list = field(default_factory=list)     # (start, end) a query
    host: list = field(default_factory=list)      # (start, end, name)
    rows_scanned: int = 0                         # by the traced queries

    @property
    def window(self) -> tuple:
        return (min(s for s, _ in self.spans), max(e for _, e in self.spans))

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_in(*self.window)

    def time_by_name(self) -> dict:
        """{kernel name: [launches, seconds]} inside the window."""
        lo, hi = self.window
        out: dict = {}
        for s, e, name in self.kernels:
            if e <= lo or s >= hi:
                continue
            acc = out.setdefault(name, [0, 0.0])
            acc[0] += 1
            acc[1] += (min(e, hi) - max(s, lo)) / 1e9
        return out

    def busy_in(self, lo, hi) -> float:
        """Seconds of [lo, hi] in which some device operation ran."""
        return busy_union([(s, e) for s, e, _ in self.kernels], lo, hi) / 1e9

    def idle_gaps(self) -> list:
        """[(start, end)] of the window's stretches with no device
        operation running."""
        lo, hi = self.window
        gaps, end = [], lo
        for s, e, _ in sorted(self.kernels):
            if e <= lo or s >= hi:
                continue
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        return gaps

    def gaps_by_host(self, top: int = 10) -> list:
        """[[what the host ran, seconds]] of the device's idle time,
        longest first: each gap charged to the innermost host operation
        running at its middle, or to Python inside or between queries
        where no operation runs."""
        host = sorted(self.host)
        starts = [h[0] for h in host]
        span_starts = [s for s, _ in self.spans]
        acc: dict = {}
        for s, e in self.idle_gaps():
            mid = (s + e) / 2
            k = bisect.bisect_right(span_starts, mid) - 1
            name = ("python inside a query" if k >= 0
                    and self.spans[k][1] >= mid else "python between queries")
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 256), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            acc[name] = acc.get(name, 0.0) + (e - s) / 1e9
        return [[n, v] for n, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]


def read(prof) -> Trace:
    """The profiler's raw events, without building its tree of
    FunctionEvents."""
    from torch.autograd import DeviceType
    tr = Trace()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = float(e.start_ns()), float(e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if name != SPAN:
                tr.kernels.append((s, t, name))
        elif name == SPAN:
            tr.spans.append((s, t))
        else:
            tr.host.append((s, t, name))
    tr.spans.sort()
    return tr


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span():
    from torch.profiler import record_function
    return record_function(SPAN)
