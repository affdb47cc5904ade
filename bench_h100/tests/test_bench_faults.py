"""The timed path broken underneath, on the CPU at tiny widths: a run must
come out not correct.  Each fault alters an answer where the program
produces it: the wave in the vocoder's call, one phone's duration in the
duration predictor, the pitch in the pitch predictor."""

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


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [alter_wave, alter_duration])
def test_a_fault_is_not_correct(cell, fault):
    out, _ = tiny_run(cell, on_interface=fault)
    assert out["correct"] is False, out["checks"]


def test_a_pitch_fault_is_not_correct():
    out, _ = tiny_run(CELLS[0], on_interface=alter_pitch)
    assert out["correct"] is False and out["checks"]["pitch_err"]["value"] > 1e-3


def test_a_sound_run_is_correct():
    out, _ = tiny_run(CELLS[0], seed=12345)
    assert out["correct"] is True
