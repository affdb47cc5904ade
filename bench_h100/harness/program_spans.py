"""The program's own spans in the traced run, and the device's idle time
put down to them.

``toucan_tpu_torch`` marks each layer of its serving path with a
``toucan.*`` span (``utils/profiling.py::span``, a ``record_function``
while the profiler records), which the trace reads among its host events
(``Trace.host``) on the clock of the device's operations.  Each idle
nanosecond of the window (``Trace.gaps``) goes to the innermost ``toucan.``
span open on the host at that instant, or to ``OUTSIDE`` where none is
open: the client, the harness and the profiler, not the program.  The
parts sum to the window's idle time exactly.  Where the trace holds no
``toucan.`` span (a program without them) there is nothing to read.
"""

from __future__ import annotations

from collections import defaultdict

PREFIX = "toucan."
OUTSIDE = "outside"
DISPATCH = ("toucan.dispatch", "toucan.stage", "toucan.replay", "toucan.capture")


def innermost(spans) -> list:
    """(start_ns, end_ns, name) of each stretch in which one span is the
    innermost open, in order; spans nest (one thread), and of two that
    open together the shorter is inner."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    points = sorted({p for s, t, _ in spans for p in (s, t)})
    out, active, j = [], [], 0
    for a, b in zip(points, points[1:]):
        while j < len(spans) and spans[j][0] <= a:
            active.append(spans[j])
            j += 1
        active = [x for x in active if x[1] > a]
        if active:
            out.append((a, b, max(active, key=lambda x: (x[0], -x[1]))[2]))
    return out


def idle_ns(trace) -> dict | None:
    """{span name or ``OUTSIDE``: idle ns of the window}, or None where the
    trace holds no device operation (no trace, or the CPU) or no span;
    worked out once a trace."""
    if trace is None or not trace.device_ops:
        return None
    if "idle_ns" not in trace.memo:
        trace.memo["idle_ns"] = _idle_ns(trace)
    return trace.memo["idle_ns"]


def _idle_ns(trace) -> dict | None:
    segs = innermost([h for h in trace.host if h[2].startswith(PREFIX)])
    if not segs:
        return None
    out = defaultdict(int)
    i = 0
    for gs, ge in trace.gaps():
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        covered, k = 0, i
        while k < len(segs) and segs[k][0] < ge:
            overlap = min(ge, segs[k][1]) - max(gs, segs[k][0])
            out[segs[k][2]] += overlap
            covered += overlap
            k += 1
        out[OUTSIDE] += (ge - gs) - covered
    return dict(out)


def starts(trace, name: str) -> int:
    """How many ``name`` spans start in the window."""
    lo, hi = trace.window_ns
    return sum(1 for s, _, n in trace.host if n == name and lo <= s < hi)


def idle_ms_per(trace, names, per: str):
    """Idle ms under the spans ``names`` (innermost), per ``per`` span that
    starts in the window; None without device operations or ``per`` spans."""
    idle = idle_ns(trace)
    if idle is None:
        return None
    count = starts(trace, per)
    if not count:
        return None
    return sum(idle.get(n, 0) for n in names) / 1e6 / count
