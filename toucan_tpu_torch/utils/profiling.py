"""Tracing: spans at the serving path's layer boundaries, an in-memory span
log, and the profiler exporter.

``span(name, rid=None)`` marks a layer of the program (the interface names
its spans ``toucan.*``).  While no ``torch.profiler`` records and no
``SpanLog`` is open it returns one shared no-op context, after a check of
two Python flags.  Otherwise it enters a record function of torch's
profiler, so that the span lands in the profiler's trace among the host's
ops, on the clock of the device's kernels and copies, and, with a
``SpanLog`` open, appends a ``SpanRecord`` to the log.  The record is
torch's ``_RecordFunctionFast``, an op-scope record: a user-scope
``torch.profiler.record_function`` also leaves a copy of itself on the
device's timeline over the kernels it launched, which a reader of torch
2.11's events (they carry no activity type) cannot tell from a kernel.  A
span given no ``rid`` takes its parent's.  Spans nest on one thread.

``profile_trace`` wraps a block in ``torch.profiler`` (the JAX package's
wraps ``jax.profiler``) and writes a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_NOOP = contextlib.nullcontext()
_log: Optional["SpanLog"] = None     # the open SpanLog


class SpanRecord(NamedTuple):
    rid: Optional[int]           # the request id, the parent's where none was given
    name: str
    parent: Optional[int]        # the enclosing span's position in the log
    start_ns: int                # time.perf_counter_ns()
    end_ns: Optional[int]        # None while the span is open
    index: Optional[int] = None  # a sentence's index within its request


class SpanLog:
    """Every span entered while the log is open, in the order they were
    entered (``spans``).  ``with SpanLog() as log:``; ``write(path)``
    writes the spans as JSON lines."""

    def __init__(self):
        self.spans: list = []
        self._open: list = []        # positions of the spans open now
        self._outer = None

    def __enter__(self):
        global _log
        self._outer, _log = _log, self
        return self

    def __exit__(self, *exc):
        global _log
        _log = self._outer

    def _enter(self, name, rid, index) -> int:
        parent = self._open[-1] if self._open else None
        if rid is None and parent is not None:
            rid = self.spans[parent].rid
        self.spans.append(SpanRecord(rid, name, parent, time.perf_counter_ns(), None, index))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def _exit(self, pos: int):
        self._open.remove(pos)
        self.spans[pos] = self.spans[pos]._replace(end_ns=time.perf_counter_ns())

    def write(self, path: str):
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s._asdict()) + "\n")


class _Span:
    __slots__ = ("name", "rid", "index", "_rf", "_log", "_pos")

    def __init__(self, name, rid, index):
        self.name, self.rid, self.index = name, rid, index

    def __enter__(self):
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        self._log = _log
        if self._log is not None:
            self._pos = self._log._enter(self.name, self.rid, self.index)
        return self

    def __exit__(self, *exc):
        if self._log is not None:
            self._log._exit(self._pos)
        self._rf.__exit__(*exc)


def span(name: str, rid: Optional[int] = None, index: Optional[int] = None):
    """A context that marks ``name`` in the profiler's trace and the open
    ``SpanLog``, or the shared no-op where neither records."""
    if _log is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, rid, index)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` around a block, with CPU activity and, where a
    card is visible, CUDA activity; the trace is written to
    ``logdir/trace.json`` (open it in Perfetto or ``chrome://tracing``).
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
