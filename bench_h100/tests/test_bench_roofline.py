"""The yardstick's arithmetic: the kernels' bounds reproduce the port's
kernel table (PERF.md), and the model FLOP count matches
``FlopCounterMode`` on the reference at exact shapes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from bench_h100.families import toucan_tts
from bench_h100.roofline import kernels, launches, model_flops, peaks

STAGES = ((8, 256), (48, 128), (192, 64), (384, 32))


def test_k1_bound_at_the_table_shape():
    flops, nbytes = kernels.k1(2, 4, 2048, 48, [2048, int(0.7 * 2048)])
    assert peaks.bound_s(flops, nbytes, kernels.K1_PEAK) * 1e3 == pytest.approx(0.0498, abs=5e-5)


def test_k2_bound_at_the_table_shapes():
    total = [sum(x) for x in zip(*(kernels.k2(s * 512, c) for s, c in STAGES))]
    assert peaks.bound_s(*total, kernels.K2_PEAK) * 1e3 == pytest.approx(1.947, abs=5e-4)


def test_k5_bound_at_the_table_shapes():
    total = [sum(x) for x in zip(*(kernels.k5(1, s * 512, c) for s, c in STAGES))]
    assert peaks.bound_s(*total, kernels.K5_PEAK) * 1e3 == pytest.approx(0.0401, abs=5e-5)


def test_launches_per_sentence():
    hifigan = json.load(open(tiny.BENCH / "configs" / "toucan_hifigan.json"))
    bigvgan = json.load(open(tiny.BENCH / "configs" / "toucan_bigvgan.json"))
    rec = dict(phones=101, rows=1, phone_bucket=128, decoder_frames=2048, vocoder_frames=2048,
               frames=504, durations=[5] * 101)
    assert len(launches.k1(hifigan, rec)) == 12
    assert launches.k2(hifigan, rec) == [(2048 * s, c, (3, 7, 11), (1, 3, 5)) for s, c in STAGES]
    assert len(launches.k5(bigvgan, rec)) == 73 and launches.k2(bigvgan, rec) == []
    assert launches.k1(hifigan, rec)[-1] == (1, 4, 2048, 48, [505])
    # a step whose shapes were not recorded has no launches: the rooflines fall silent
    for k in (launches.k1, launches.k2):
        assert k(hifigan, dict(rec, rows=2)) == [] and k(hifigan, {"phones": 101}) == []
    assert launches.k5(bigvgan, {"phones": 101}) == []


@pytest.mark.parametrize("vocoder", ["toucan_hifigan", "toucan_bigvgan"])
@pytest.mark.parametrize("n", [7, 12])
def test_model_flops_match_the_flop_counter(vocoder, n):
    cfg = tiny.config(vocoder)
    torch.manual_seed(0)
    tts, voc = toucan_tts.build(cfg, "cpu")
    a = cfg["acoustic"]
    x = torch.randn(1, n, a["input_features"])
    kw = dict(utterance_embedding=torch.randn(1, 64), lang_ids=torch.tensor([[3]]))
    with torch.no_grad():
        # the durations these weights predict, then a run at exactly that length
        frames = int(tts.infer(x, torch.tensor([n]), 64 * n, **kw)[2].sum())
        z = torch.randn(1, frames, a["mel_channels"])
        with FlopCounterMode(display=False) as counter:
            _, after, *_ = tts.infer(x, torch.tensor([n]), frames, glow_noise=z, **kw)
            voc(after)
    counted = counter.get_total_flops()
    # the plain rel-shift computes q_v . p over 2T - 1 offsets, the model
    # needs T: 2 T (T - 1) d more in each conformer block
    excess = (a["enc_layers"] * 2 * n * (n - 1) * a["adim"]
              + a["dec_layers"] * 2 * frames * (frames - 1) * a["adim"])
    # the glow keeps an even number of frames, which the vocoder runs over
    want = (toucan_tts.acoustic_flops(cfg, n, frames)
            + model_flops.vocoder(cfg["vocoder"], cfg["vocoder_config"], after.shape[1]))
    assert want == counted - excess
