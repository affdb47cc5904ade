"""The readers of the program's spans (``harness/program_spans.py``) on a
hand-built trace: the innermost span takes each idle nanosecond, the parts
sum to the window's idle time exactly, and nothing is read without device
operations or without the program's spans."""

import pytest

from bench_h100.harness import program_spans, spec
from bench_h100.harness.run import Run
from bench_h100.harness.trace import WINDOW, Trace


def hand_trace(device_ops, spans):
    """A window of 0..1000 ns with these device operations and host spans."""
    trace = Trace()
    trace.window_ns = (0, 1000)
    trace.device_ops = sorted((s, t, "kernel") for s, t in device_ops)
    trace.host = sorted([(0, 1000, WINDOW), (0, 1000, "bench.request"), (5, 7, "aten::empty")]
                        + spans)
    return trace


# device busy at 100..300 and 600..700; idle at 0..100, 300..600, 700..1000
DEVICE = [(100, 300), (600, 700)]
SPANS = [(50, 950, "toucan.call"), (60, 500, "toucan.dispatch"), (60, 150, "toucan.frontend"),
         (150, 350, "toucan.stage"), (350, 500, "toucan.replay"), (500, 900, "toucan.fetch"),
         (960, 990, "toucan.call"), (965, 990, "toucan.dispatch"), (1000, 1100, "toucan.call")]


def test_innermost_span_takes_the_idle_time():
    idle = program_spans.idle_ns(hand_trace(DEVICE, SPANS))
    assert idle == {"outside": 50 + 10 + 10, "toucan.call": 10 + 50 + 5, "toucan.frontend": 40,
                    "toucan.stage": 50, "toucan.replay": 150, "toucan.fetch": 100 + 200,
                    "toucan.dispatch": 25}


def test_the_parts_sum_to_the_idle_time():
    trace = hand_trace(DEVICE, SPANS)
    idle = program_spans.idle_ns(trace)
    assert sum(idle.values()) == sum(t - s for s, t in trace.gaps()) == 700
    assert sum(idle.values()) / 1e9 == pytest.approx(trace.window_s - trace.busy_s, abs=1e-15)


def test_spans_that_open_together_give_the_time_to_the_shorter():
    idle = program_spans.idle_ns(hand_trace([(0, 10)], [(10, 20, "toucan.call"),
                                                        (10, 19, "toucan.fetch"),
                                                        (10, 15, "toucan.write")]))
    assert idle == {"toucan.write": 5, "toucan.fetch": 4, "toucan.call": 1, "outside": 980}


def test_nothing_to_read_without_device_operations_or_spans():
    assert program_spans.idle_ns(None) is None
    assert program_spans.idle_ns(hand_trace([], SPANS)) is None
    assert program_spans.idle_ns(hand_trace(DEVICE, [])) is None


def test_the_readers():
    run = Run(cell={}, config={}, mix={}, records=[], window_s=1e-6, setup_s=0.0,
              trace=hand_trace(DEVICE, SPANS))
    read = {name: spec.reader(name) for name in ("dispatch_idle_ms", "fetch_idle_ms",
                                                 "write_idle_ms", "idle_outside_program_pct")}
    # two toucan.call spans start in the window; the third starts at its end
    assert read["dispatch_idle_ms"](run) == pytest.approx((25 + 50 + 150) / 1e6 / 2)
    assert read["fetch_idle_ms"](run) == pytest.approx(300 / 1e6 / 2)
    assert read["write_idle_ms"](run) is None   # no toucan.read_to_file page
    assert read["idle_outside_program_pct"](run) == pytest.approx(100.0 * 70 / 1000)
    run.trace = None
    assert all(r(run) is None for r in read.values())
