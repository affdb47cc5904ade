"""The StochasticToucanTTS family at tiny widths on the CPU: the program
served through ``ToucanTTSInterface(acoustic="stochastic")`` against the
reference's copy on seeded random weights (durations equal, pitch, energy
and wave within the cell's limits); the noise replay gives the interface's
draws exactly; the ``ceil`` near-tie rule on constructed ties; the weights
calibration reaches its frames a written word; the model FLOPs match the
flop counter; ``variance_ms`` on a hand-built trace; and the family and
the cell found by name, the harness naming neither."""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from bench_h100.families import stochastic_toucan_tts as family
from bench_h100.harness import check, run, spec
from bench_h100.harness.trace import WINDOW, Trace
from bench_h100.reference.frontend.text import TextFrontend
from bench_h100.roofline import model_flops
from bench_h100.traffic import generator
from test_bench_families import code_names

CELL = "toucan_stochastic_hifigan.interactive"
CONFIG = "toucan_stochastic_hifigan"


@pytest.mark.parametrize("seed", [2**31 + 7, 3_000_000_029])
def test_the_program_is_judged_correct(seed):
    torch.set_num_threads(2)
    out, info = run.execute(CELL, seed, 2.0, False, device="cpu",
                            config_override=tiny.config(CONFIG),
                            mix_override=tiny.mix("interactive"))
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and info["judged"] >= 1
    assert list(out["checks"]) == ["features_differ", "duration_gap", "wave_err", "pitch_err",
                                   "energy_err"]
    limits = spec.limits(CELL)
    for k, c in out["checks"].items():
        assert c["value"] <= limits[k], k
    assert out["checks"]["duration_gap"]["value"] == 0
    assert set(out["metrics"]) == {"audio_s_per_s", "latency_p50_ms", "latency_p95_ms", "setup_s"}


def _tiny_setup(seed):
    cfg = tiny.config(CONFIG)
    st = run.prepare(CELL, seed, "cpu", cfg, tiny.mix("interactive"))
    iface = family.build_interface(cfg, st.tts.state_dict(), st.voc.state_dict(), st.embedding,
                                   seed, "cpu")
    return cfg, st, iface


def test_the_noise_replay_is_the_interface_draws():
    torch.set_num_threads(2)
    seed = 2**31 + 11
    cfg, st, iface = _tiny_setup(seed)
    draws, steps, filled = [], [], []
    family.record_shapes(iface, draws, steps)
    flow_draw, glow_draw = iface._draw_flow_noise, iface._draw_noise

    def keep_flow(buf):
        flow_draw(buf)
        filled.append([b.clone() for b in buf])

    def keep_glow(buf):
        glow_draw(buf)
        filled[-1].append(buf.clone())

    iface._draw_flow_noise, iface._draw_noise = keep_flow, keep_glow
    for text, _ in st.schedule[:3]:
        iface(text)
    assert len(draws) == len(steps) == 3
    for entry, step in zip(draws, steps):
        assert entry == family.noise_shape(cfg, step["decoder_frames"])
        assert entry[0] == (1, step["phone_bucket"], 2)
    replay = family.noise(seed, draws, {0, 2}, "cpu")
    assert set(replay) == {0, 2}
    for k in (0, 2):
        flows, glow = replay[k]
        for got, want in zip((*flows, glow), filled[k]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    # (unrounded durations, fixed, reference's ceil, served, gap)
    ([3.2, 4.0, 1.5], [False] * 3, [4, 4, 2], [4, 4, 2], 0.0),          # agree
    ([3.0 + 1e-6], [False], [4], [3], 1e-6),                              # just past 3: ceils to 4
    ([4.0 - 1e-6], [False], [4], [5], 1e-6),                              # (k - 1) - d
    ([2.5], [False], [3], [4], 0.5),                                      # a half-frame fault
    ([2.5, 3.0], [False, True], [3, 0], [3, 1], 1.0),                     # a word boundary served
])
def test_the_ceil_near_tie_rule(case):
    d, fixed, ref, served, want = case
    gap = family.ceil_gap(np.log(np.asarray(d, np.float64)), fixed, ref, served)
    assert gap == pytest.approx(want, abs=1e-9)


def test_the_calibration_reaches_its_frames_a_word():
    torch.set_num_threads(2)
    cfg = tiny.config(CONFIG)
    mix = tiny.mix("interactive")
    fe = TextFrontend(language="en", use_g2p=True)
    sents = generator.sentences(mix, 5, lambda t: len(fe.string_to_features(t)))
    calibration = [(fe.string_to_features(t), len(t.split())) for t, _ in sents]
    rate = generator.frames_per_word(mix["corpus"])
    torch.manual_seed(5)
    tts, _ = family.build(cfg, "cpu")
    emb = torch.randn(1, 64)
    reached = family.calibrate_durations(tts, calibration, emb, check.LANG_EN, rate)
    words = sum(w for _, w in calibration)
    assert reached["target"] == pytest.approx(rate * words)
    assert reached["longest"] <= family.LONGEST_PHONE
    # the same draws again, through the solved affine: the model's own ceil
    torch.manual_seed(5)
    family.build(cfg, "cpu")
    torch.randn(1, 64)
    d = torch.ceil(torch.exp(family.sampled_log_durations(tts, calibration, emb, check.LANG_EN)))
    assert d.sum().item() == pytest.approx(rate * words, rel=0.02)
    assert d.max().item() <= family.LONGEST_PHONE


@pytest.mark.parametrize("n", [7, 12])
def test_model_flops_match_the_flop_counter(n):
    cfg = tiny.config(CONFIG)
    torch.manual_seed(0)
    tts, voc = family.build(cfg, "cpu")
    a = cfg["acoustic"]
    x = torch.randn(1, n, a["input_features"])
    utt, lang = torch.randn(1, 64), torch.tensor([[3]])
    flows = tuple(torch.randn(1, n, 2) for _ in range(3))
    with torch.no_grad():
        frames = int(tts.infer(x, torch.tensor([n]), 64 * n, utt, lang,
                               torch.zeros(1, 64 * n, 80), flows)[2].sum())
        z = torch.randn(1, frames, a["mel_channels"])
        with FlopCounterMode(display=False) as counter:
            _, after, *_ = tts.infer(x, torch.tensor([n]), frames, utt, lang, z, flows)
            voc(after)
    excess = (a["enc_layers"] * 2 * n * (n - 1) * a["adim"]
              + a["dec_layers"] * 2 * frames * (frames - 1) * a["adim"])
    want = (family.acoustic_flops(cfg, n, frames)
            + model_flops.vocoder(cfg["vocoder"], cfg["vocoder_config"], after.shape[1]))
    assert want == counter.get_total_flops() - excess


def _trace(calls, device_ops):
    trace = Trace()
    trace.window_ns = (0, 10_000)
    trace.device_ops = sorted(device_ops)
    trace.host = sorted([(0, 10_000, WINDOW)] + [(s, t, "toucan.call") for s, t in calls])
    return trace


def test_variance_ms_reads_the_stretch_between_encoder_and_decoder():
    read = spec.reader("variance_ms")
    cfg = spec.config(CONFIG)      # 6 + 6 conformer blocks
    k1 = "void flash_rel_kernel<48>(float const*)"

    def call(start, gap):
        ops = [(start + 10 * i, start + 10 * i + 5, k1) for i in range(6)]
        ops += [(start + 55 + gap + 10 * i, start + 60 + gap + 10 * i, k1) for i in range(6)]
        return ops + [(start + 58, start + 58 + gap, "spline_kernel")]

    ops = call(100, 400) + call(2000, 200) + call(5000, 300)[:-2]   # the third lacks a launch
    run_ = run.Run(cell={}, config=cfg, mix={}, records=[], window_s=1e-5, setup_s=0.0,
                   trace=_trace([(50, 1900), (1950, 4000), (4900, 6000)], ops))
    # from the end of the 6th launch (start + 55) to the start of the 7th
    assert read(run_) == pytest.approx((400 + 200) / 2 / 1e6)
    run_.trace = _trace([(4900, 6000)], call(5000, 300)[:-2])
    assert read(run_) is None
    run_.trace = None
    assert read(run_) is None


def test_the_family_and_cell_are_found_by_name():
    cfg = spec.config(CONFIG)
    assert spec.family(cfg) is family
    assert spec.cell(CELL)["config"] == CONFIG and spec.cell(CELL)["chips"] == 1
    assert set(spec.limits(CELL)) == {"features_differ", "duration_gap", "pitch_err",
                                      "energy_err", "wave_err"}
    names = {n for n, _, _ in spec.metrics(CELL, traced=True)}
    assert {"variance_ms", "k1_roofline_pct", "k2_roofline_pct", "mfu_pct"} <= names
    for path in (tiny.BENCH / "harness").glob("*.py"):
        assert not any("stochastic" in n.lower() for n in code_names(path)), path.name
    assert cfg["reduced"] == [] and cfg["flows"] == dataclasses.asdict(family.FlowConfig())
    assert not math.isnan(family.acoustic_flops(cfg, 100, 400))


@pytest.mark.card
def test_tf32_control_is_not_correct():
    from bench_h100.harness import control

    assert control.control(CELL, 3_000_000_031)["correct"] is False


@pytest.mark.card
def test_reference_against_itself_reads_zero():
    from bench_h100.harness import control

    out = control.control(CELL, 3_000_000_032, precision="float32", count=16)
    assert out["correct"] is True and not any(out["numbers"].values())
