"""Reading ``torch.profiler``'s Chrome trace of the traced window.

:class:`TraceView` holds what the per-layer readers (``metrics/*.py``) take:
the device operations inside the window (kernels, copies, sets), the
window's length, the rounds run in it, the host time the harness spent
inside the program's frame call, and the cell's configuration and traffic.
Times are in microseconds, as the trace has them.
"""

from __future__ import annotations

import bisect
import functools
import gzip
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
BETWEEN_CALLS = "python (between runtime calls)"


def load(path) -> dict:
    """A Chrome trace written by ``export_chrome_trace`` (``.json`` or ``.json.gz``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceView:
    """The traced window, as the readers see it."""
    window: tuple[float, float]                   # us
    rounds: int
    device_ops: list[tuple[float, float, str, str]]   # (start, end, name, cat)
    host_events: list[tuple[float, float, str]] = field(default_factory=list)
    host_frame_s: float = 0.0                      # harness clock inside the frame calls
    link: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    readers: dict = field(default_factory=dict)   # metric name -> read(view)

    @classmethod
    def from_trace(cls, trace: dict, rounds: int, **kw) -> "TraceView":
        """The view of a trace taken over the window alone: the window runs
        from its first event to its last."""
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        w0 = min(float(e["ts"]) for e in events)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
        dev, host = [], []
        for e in events:
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((s, t, e.get("name", ""), cat))
            elif cat in HOST_CATS:
                host.append((s, t, e.get("name", "")))
        host.sort()
        return cls(window=(w0, w1), rounds=rounds, device_ops=dev, host_events=host, **kw)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def kernels(self) -> list[tuple[float, float, str, str]]:
        return [op for op in self.device_ops if op[3] == "kernel"]

    def busy_us(self) -> float:
        """Time in which some operation ran on the device: the union of the
        operations' intervals, not the sum of their durations."""
        return union_length([(s, e) for s, e, *_ in self.device_ops])

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The window's intervals in which no device operation ran."""
        out, t = [], self.window[0]
        for s, e in merged([(s, e) for s, e, *_ in self.device_ops]):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def read(self, metric: str):
        """Another metric's reading of this view (``None`` when it has none)."""
        return self.readers[metric](self)

    @functools.cached_property
    def _host_starts(self) -> list[float]:
        return [s for s, _, _ in self.host_events]

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host event (the
        latest started) that holds ``t``, else Python between calls."""
        i = bisect.bisect_right(self._host_starts, t)
        for s, e, name in reversed(self.host_events[max(0, i - 64):i]):
            if e >= t:
                return name
        return BETWEEN_CALLS

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each ``[[name, seconds], ...]``."""
        by_op: dict[str, float] = defaultdict(float)
        for s, e, name, _ in self.device_ops:
            by_op[name[:160]] += (e - s) / 1e6
        by_gap: dict[str, float] = defaultdict(float)
        for s, e in self.idle_gaps():
            by_gap[self.host_label((s + e) / 2)] += (e - s) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}
