"""The timed path broken underneath, on the CPU at tiny widths: a run must
come out not correct.  Each fault alters an answer where the program
produces it: the wave in the vocoder's call, one phone's duration in the
duration predictor, the pitch in the pitch predictor, and, where the
client gives them, one given duration or the given pitch where the
acoustic model takes them."""

import pytest

from test_bench_result import CELLS, tiny_run


def alter_wave(iface):
    call = iface._vocoder_call

    def altered(mel):
        wave = call(mel)
        return wave + 1e-3 * wave.abs().max()
    iface._vocoder_call = altered


def alter_duration(iface):
    dp = iface.model.duration_predictor
    forward = dp.forward

    def altered(*args, **kwargs):
        d = forward(*args, **kwargs).clone()
        d[:, 1] += 1
        return d
    dp.forward = altered


def alter_pitch(iface):
    pp = iface.model.pitch_predictor
    forward = pp.forward

    def altered(*args, **kwargs):
        return forward(*args, **kwargs) * 1.01
    pp.forward = altered


def alter_given(name, change):
    def fault(iface):
        infer = iface.model.infer

        def altered(*args, **kwargs):
            kwargs[name] = change(kwargs[name].clone())
            return infer(*args, **kwargs)
        iface.model.infer = altered
    fault.__name__ = f"alter_{name}"
    return fault


def one_more_frame(d):
    d[:, 1] += 1
    return d


PREDICTED = CELLS[:2]   # the cells whose durations and pitch the model predicts
GIVEN = CELLS[2]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in PREDICTED
                                        for f in (alter_wave, alter_duration)]
                         + [(GIVEN, alter_wave),
                            (GIVEN, alter_given("gold_durations", one_more_frame)),
                            (GIVEN, alter_given("gold_pitch", lambda p: p * 1.01)),
                            (GIVEN, alter_given("gold_energy", lambda e: e * 1.01))])
def test_a_fault_is_not_correct(cell, fault):
    out, _ = tiny_run(cell, on_interface=fault)
    assert out["correct"] is False, out["checks"]


def test_a_pitch_fault_is_not_correct():
    out, _ = tiny_run(CELLS[0], on_interface=alter_pitch)
    assert out["correct"] is False and out["checks"]["pitch_err"]["value"] > 1e-3


def test_a_sound_run_is_correct():
    out, _ = tiny_run(CELLS[0], seed=12345)
    assert out["correct"] is True
