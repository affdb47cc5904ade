"""The variance adaptor's device ms a ``toucan.call``: from the end of the
call's last encoder K1 launch to the start of its first decoder K1 launch
(``flash_rel_kernel``, the ``enc_layers``-th and next, in device order,
among the device operations that start inside the call's span).  That
stretch holds the duration, pitch and energy predictors (or flows, or
nothing where they are bypassed), the length regulator, the tail of the
encoder's last block and the head of the decoder's first.  A call that
does not show ``enc_layers + dec_layers`` K1 launches is left out; None
where no call qualifies."""

import bisect
import re

from bench_h100.metrics.k1_roofline_pct import PATTERN


def read(run):
    trace = run.trace
    if trace is None or not trace.device_ops:
        return None
    a = run.config["acoustic"]
    enc, launches = a["enc_layers"], a["enc_layers"] + a["dec_layers"]
    rx = re.compile(PATTERN)
    match = {n for n in {n for _, _, n in trace.device_ops} if rx.search(n)}
    k1 = [(s, t) for s, t, n in trace.device_ops if n in match]
    starts = [s for s, _ in k1]
    lo, hi = trace.window_ns
    stretches = []
    for s, t, name in trace.host:
        if name != "toucan.call" or not lo <= s < hi:
            continue
        calls = k1[bisect.bisect_left(starts, s):bisect.bisect_left(starts, t)]
        if len(calls) == launches:
            stretches.append(calls[enc][0] - calls[enc - 1][1])
    return sum(stretches) / len(stretches) / 1e6 if stretches else None
