"""A whole run of each cell on the CPU at tiny widths: the result line's
keys, the metrics each cell reports, and ``correct`` on a sound program."""

import json
import subprocess
import sys

import pytest

import tiny
from bench_h100.harness import run, spec

CELLS = ["toucan_hifigan.interactive", "toucan_bigvgan.read_aloud", "toucan_hifigan.override"]


def tiny_run(cell, traced=False, seed=2**31 + 5, seconds=1.0, **kw):
    cfg, mix = cell.split(".")
    return run.execute(cell, seed, seconds, traced, device="cpu", config_override=tiny.config(cfg),
                       mix_override=tiny.mix(mix), **kw)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(cell, traced, capsys):
    out, info = tiny_run(cell, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {n for n, _, _ in spec.metrics(cell, traced)}
    # on the CPU the device's metrics find nothing to read and stay out
    assert set(out["metrics"]) <= names
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    if not traced:
        assert set(out["metrics"]) == names
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    run.report(out, info)
    lines = capsys.readouterr()
    assert list(json.loads(lines.out.splitlines()[-1])) == list(out)
    assert lines.err.splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    res = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300)
    if res.returncode == 0:
        pytest.skip("a CUDA device is visible")
    assert res.stdout.strip() == ""


def test_padding_is_read_from_what_the_program_ran(monkeypatch):
    """A coarser vocoder frame bucket in the program shows in ``pad_ratio``
    and is judged at the shapes it ran: the yardstick keeps no copy of the
    rule."""
    from toucan_tpu_torch.infer import interface

    runs = []

    class Seen(run.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    monkeypatch.setattr(run, "Run", Seen)
    fine, _ = tiny_run(CELLS[0], traced=True, seed=2**31 + 21)
    monkeypatch.setattr(interface, "_frame_bucket", lambda frames: interface._round_up(frames, 512))
    coarse, _ = tiny_run(CELLS[0], traced=True, seed=2**31 + 21)
    assert fine["correct"] is True and coarse["correct"] is True
    # the tiny sentences' mels and the receptive frames fit in 512 frames,
    # so the coarse bucket vocodes 512 frames a step, or every decoded
    # frame where the step decoded fewer
    served = runs[1].served
    want = sum(min(512, r["decoder_frames"]) for r in served) / sum(r["frames"] for r in served)
    assert coarse["metrics"]["pad_ratio"]["value"] == pytest.approx(want, rel=1e-12)
    assert coarse["metrics"]["pad_ratio"]["value"] > 2 * fine["metrics"]["pad_ratio"]["value"]
    # the frames the acoustic model decoded do not follow the vocoder's bucket
    assert (coarse["metrics"]["decode_pad_ratio"]["value"]
            == pytest.approx(fine["metrics"]["decode_pad_ratio"]["value"], rel=0.2))
