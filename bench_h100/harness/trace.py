"""The traced run: ``torch.profiler`` over the whole window, read into
device intervals, host spans and kernel times.

The benchmark's own spans (``record_function``) mark the window
(``bench.window``), each request (``bench.request``) and, through a wrapper
on the interface's frontend, each sentence's ``string_to_features``
(``bench.frontend``).  Device operations are the profiler's kernels,
copies and sets; ``busy_s`` is the length of their union inside the
window.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Trace:
    def __init__(self):
        self.prof = None
        self.device_ops = []      # (start_ns, end_ns, name), in the window, by start
        self.host = []            # (start_ns, end_ns, name), host ops and spans, by start
        self.window_ns = None
        self.parts = {}           # seconds of the profiler's stop and of reading its events
        self.memo = {}            # what one reader works out from the trace for the others

    @staticmethod
    def span(name):
        return record_function(name)

    @contextlib.contextmanager
    def record(self):
        """Profile the block; the window is the ``bench.window`` span
        inside it."""
        cuda = torch.cuda.is_available()
        kinds = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=kinds)
        with self.prof:
            yield self
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        t1 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        t2 = time.perf_counter()
        self._read(events)
        self.prof = None
        self.parts = dict(stop_s=t1 - t0, events_s=t2 - t1, read_s=time.perf_counter() - t2,
                          events=len(events))

    def _read(self, events):
        device, host = [], []
        # what the running torch's events offer, asked of the first alone
        first = events[0] if events else None
        has_kind = hasattr(first, "activity_type")
        in_ns = getattr(first, "start_ns", None) is not None
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            kind = e.activity_type() if has_kind else None
            start = e.start_ns() if in_ns else int(e.start_us() * 1000)
            end = start + (e.duration_ns() if in_ns else int(e.duration_us() * 1000))
            name = e.name()
            if e.device_type() == cuda:
                # without an activity type, the device's copies of the host
                # spans are told apart by their names
                if kind in DEVICE_KINDS or (not isinstance(kind, str)
                                            and not name.startswith("bench.")):
                    device.append((start, end, name))
            elif kind in ("cpu_op", "user_annotation") or not isinstance(kind, str):
                if name == WINDOW:
                    self.window_ns = (start, end)
                host.append((start, end, name))
        if self.window_ns is None:
            raise RuntimeError("the trace holds no bench.window span")
        lo, hi = self.window_ns
        self.device_ops = sorted((max(s, lo), min(t, hi), n) for s, t, n in device
                                 if t > lo and s < hi)
        self.host = sorted(host)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def gaps(self) -> list:
        """(start_ns, end_ns) of every stretch of the window with no device
        operation (found once; the readers share them)."""
        if "gaps" not in self.memo:
            self.memo["gaps"] = self._gaps()
        return self.memo["gaps"]

    def _gaps(self) -> list:
        out, cur = [], self.window_ns[0]
        for s, t, _ in self.device_ops:
            if s > cur:
                out.append((cur, s))
            cur = max(cur, t)
        if self.window_ns[1] > cur:
            out.append((cur, self.window_ns[1]))
        return out

    @property
    def busy_s(self) -> float:
        return self.window_s - sum(t - s for s, t in self.gaps()) / 1e9

    def kernel_times(self, pattern: str) -> list:
        """Seconds of each device operation whose name matches ``pattern``,
        in the order they ran."""
        if "names" not in self.memo:
            self.memo["names"] = {n for _, _, n in self.device_ops}
        rx = re.compile(pattern)
        match = {n for n in self.memo["names"] if rx.search(n)}
        return [(t - s) / 1e9 for s, t, n in self.device_ops if n in match]

    def top_ops(self, k: int = 10) -> list:
        totals = defaultdict(float)
        for s, t, n in self.device_ops:
            totals[n] += (t - s) / 1e9
        return sorted(([n[:160], v] for n, v in totals.items()), key=lambda x: -x[1])[:k]

    def top_gaps(self, k: int = 10) -> list:
        """The longest idle gaps, each named by what the host was doing at
        its middle: the innermost host op or span, under the outermost
        ``bench.`` span."""
        starts = [h[0] for h in self.host]
        out = []
        for s, t in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:k]:
            mid = (s + t) // 2
            inner, outer = None, None
            for h in self.host[:bisect.bisect_right(starts, mid)]:
                if h[1] >= mid and h[2] != WINDOW:
                    if inner is None or h[1] - h[0] < inner[1] - inner[0]:
                        inner = h
                    if h[2].startswith("bench.") and (outer is None or h[0] < outer[0]):
                        outer = h
            parts = [x[2] for x in (outer, inner) if x is not None]
            if outer is not None and outer is inner:
                parts = parts[:1]
            name = "/".join(parts) or "host idle"
            out.append([name[:160], (t - s) / 1e9])
        return out
