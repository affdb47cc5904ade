"""The override client at tiny widths on the CPU: a sound run is correct
with every given duration served exactly, each request decoded
``round_up(sum + 2, 64)`` frames of its given durations, and the warm-up
made every bucket the window used."""

import numpy as np
import pytest

import tiny
from bench_h100.clients import override
from bench_h100.harness import run

CELL = "toucan_hifigan.override"


def override_run(seed, **kw):
    seen = []

    class Seen(run.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(run, "Run", Seen)
    try:
        out, info = run.execute(CELL, seed, 2.0, False, device="cpu",
                                config_override=tiny.config("toucan_hifigan"),
                                mix_override=tiny.mix("override"), **kw)
    finally:
        mp.undo()
    return out, info, seen[0]


def test_given_inputs_are_served_at_their_frames():
    seed = 2**31 + 41
    out, info, r = override_run(seed)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["duration_gap"]["value"] == 0
    assert info["captures_in_window"] == 0
    st = run.prepare(CELL, seed, "cpu", tiny.config("toucan_hifigan"), tiny.mix("override"))
    given = override.draw(st)
    assert r.served
    for rec in r.served:
        d = given[rec["item"]]["durations"]
        assert np.array_equal(rec["durations"], d)
        want = 64 * max(1, -(-(int(d.sum()) + 2) // 64))
        assert rec["decoder_frames"] == want == rec["noise_shape"][1]
        assert rec["frames"] == int(d.sum()) // 2 * 2


def test_the_durations_follow_the_corpus_rate():
    from bench_h100.reference.frontend.inventory import feature_index
    from bench_h100.traffic import generator

    st = run.prepare(CELL, 7, "cpu", tiny.config("toucan_hifigan"), tiny.mix("override"))
    given = override.draw(st)
    words = sum(len(t.split()) for t, _ in st.schedule)
    frames = sum(int(g["durations"].sum()) for g in given)
    assert frames / words == pytest.approx(generator.frames_per_word(st.mix["corpus"]), rel=0.05)
    boundary = feature_index()["word-boundary"]
    for (text, phones), g in zip(st.schedule, given):
        assert len(g["durations"]) == phones and g["pitch"].shape == (phones, 1)
        assert g["durations"].max() <= st.mix["durations"]["longest_phone"]
        on = st.features[text][:, boundary] == 1
        assert on.any() and not g["durations"][on].any()
        assert not g["pitch"][on].any() and not g["energy"][on].any()
        assert (g["pitch"][~on] > 0).all() and (g["energy"][~on] > 0).all()
    # the same seed gives the same inputs
    assert override.draw(st)[0]["durations"].tolist() == given[0]["durations"].tolist()
