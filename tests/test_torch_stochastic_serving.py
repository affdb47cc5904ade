"""``ToucanTTSInterface(acoustic="stochastic")`` against the port's own
``StochasticToucanTTS.infer``, on the CPU at a tiny size (the port's model
is held against the JAX package's by ``tests/test_torch_stochastic.py``).

On injected flow and glow noise the interface's durations equal the model's
and its mel and wave lie within ROADMAP's bars (3e-4, 2e-5), eagerly and
through the buckets; the generator's draws come in one fixed order (the
pitch, energy and duration flows', then the glow's); the knobs and given
prosody that the model cannot take raise; ``acoustic="toucan"`` serves what
the default interface serves and draws nothing more; and a duration flow
that sums past the bucket has its delivered lengths clamped and the frames
lost counted.
"""

import numpy as np
import pytest
import torch

from toucan_tpu_torch.infer.interface import (FRAMES_PER_PHONE, PHONE_BUCKET, SAMPLES_PER_FRAME,
                                              ToucanTTSInterface)
from toucan_tpu_torch.models.stochastic_toucan_tts import StochasticToucanTTS
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.nn.stochastic_flows import ConvFlow

torch.set_num_threads(2)

TINY = ToucanTTSConfig(adim=32, aheads=2, enc_layers=1, enc_units=64, dec_layers=1,
                       dec_units=64, duration_chans=32, pitch_chans=32, pitch_layers=2,
                       energy_chans=32, glow_blocks=2, glow_hidden=32, glow_layers=2,
                       lang_embs=100)
TEXT = "~hɛlˈoʊ wˈɜːld, ðɪs ɪz ə tˈɛst~#"
LANG_EN = 12


def _weights(acoustic=StochasticToucanTTS, seed=0):
    torch.manual_seed(seed)
    tts = acoustic(TINY)
    for m in tts.modules():
        if isinstance(m, ConvFlow):   # zero-initialised: every spline would be the identity
            torch.nn.init.normal_(m.proj.weight, 0.0, 0.3)
            torch.nn.init.normal_(m.proj.bias, 0.0, 0.3)
    voc = HiFiGANGenerator(channels=32)
    emb = np.random.RandomState(seed).randn(64).astype(np.float32)
    return tts.state_dict(), voc.state_dict(), emb


def make(weights, acoustic="stochastic", seed=0, **kw):
    tts_sd, voc_sd, emb = weights
    return ToucanTTSInterface(tts_sd, voc_sd, config=TINY, vocoder=HiFiGANGenerator(channels=32),
                              default_embedding=emb, language="en", use_g2p=False,
                              device="cpu", seed=seed, acoustic=acoustic, **kw)


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def iface(weights):
    return make(weights)


def _shapes(iface, text=TEXT):
    n = len(iface.text2phone.string_to_features(text, input_phonemes=True))
    n_pad = -(-n // PHONE_BUCKET) * PHONE_BUCKET
    return n, n_pad, n_pad * FRAMES_PER_PHONE


def _model_infer(iface, flow_noise, glow_noise, text=TEXT):
    """The port's model alone at the interface's bucket: (durations, mel
    masked past its length, wave, mel length)."""
    feats = iface.text2phone.string_to_features(text, input_phonemes=True)
    n, n_pad, frames = _shapes(iface, text)
    x = torch.zeros(1, n_pad, feats.shape[1])
    x[0, :n] = torch.as_tensor(feats)
    fn = torch.zeros(3, 1, n_pad, 2)
    fn[:, 0, :n] = torch.as_tensor(flow_noise)
    with torch.no_grad():
        _, after, dur, _, _, lens = iface.model.infer(
            x, torch.tensor([n]), frames,
            utterance_embedding=torch.as_tensor(iface.default_utterance_embedding)[None],
            lang_ids=torch.tensor([[LANG_EN]]), glow_noise=torch.as_tensor(glow_noise)[None],
            flow_noise=tuple(fn))
        length = int(lens[0])
        mel = torch.where(torch.arange(frames)[None, :, None] < length, after, 0.0)
        wave = iface.vocoder(mel)[0, :length * SAMPLES_PER_FRAME, 0]
    return dur[0, :n].numpy(), mel[0, :length].numpy(), wave.numpy(), length


@pytest.mark.parametrize("eager", [True, False])
def test_injected_noise_matches_the_model(iface, eager):
    n, n_pad, frames = _shapes(iface)
    rng = np.random.RandomState(3)
    flow_noise = rng.randn(3, n, 2).astype(np.float32)
    glow_noise = (0.8 * rng.randn(frames, 80)).astype(np.float32)
    want_dur, want_mel, want_wave, length = _model_infer(iface, flow_noise, glow_noise)
    iface._eager = eager
    try:
        wave, dur, pitch, energy = iface(TEXT, input_is_phones=True, glow_noise=glow_noise,
                                         flow_noise=flow_noise, return_duration_pitch_energy=True)
        (_, after, *_), _ = iface._dispatch_call(TEXT, input_is_phones=True,
                                                 glow_noise=glow_noise, flow_noise=flow_noise)
    finally:
        iface._eager = False
    np.testing.assert_array_equal(dur, want_dur)
    assert len(wave) == length * SAMPLES_PER_FRAME
    np.testing.assert_allclose(after[0, :length].numpy(), want_mel, atol=3e-4)
    np.testing.assert_allclose(wave, want_wave, atol=2e-5)
    assert pitch.shape == energy.shape == (n,)


def test_the_generator_draws_flows_then_glow(weights):
    iface = make(weights, seed=11)
    n, n_pad, frames = _shapes(iface)
    wave, dur, pitch, energy = iface(TEXT, input_is_phones=True,
                                     return_duration_pitch_energy=True)
    gen = torch.Generator().manual_seed(11)
    flows = [torch.randn((1, n_pad, 2), generator=gen) for _ in range(3)]
    glow = torch.randn((1, frames, 80), generator=gen) * 0.8
    assert torch.equal(iface.generator.get_state(), gen.get_state())
    replay = make(weights, seed=99)
    got = replay(TEXT, input_is_phones=True, return_duration_pitch_energy=True,
                 flow_noise=torch.stack([f[0, :n] for f in flows]).numpy(),
                 glow_noise=glow[0].numpy())
    np.testing.assert_array_equal(got[1], dur)
    for a, b in zip(got[2:], (pitch, energy)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(got[0], wave, atol=1e-6)
    # the eager path draws the same, in the same order
    eager = make(weights, seed=11)
    eager._eager = True
    np.testing.assert_array_equal(eager(TEXT, input_is_phones=True), wave)


def test_batch_and_file_serve_the_same_buckets(weights, tmp_path):
    one = make(weights, seed=4)
    want = one(TEXT, input_is_phones=True)
    batch = make(weights, seed=4)
    got, = batch.synthesize_batch([TEXT], input_is_phones=True)
    np.testing.assert_array_equal(got, want)
    page = make(weights, seed=4)
    samples = page.read_to_file([TEXT], tmp_path / "page.wav", input_is_phones=True)
    np.testing.assert_array_equal(samples[10600:10600 + len(want)], want)
    assert len(samples) == len(want) + 2 * 10600
    for it in (one, batch, page):
        assert set(it._e2e_cache) == {(1, 32, 512, False, False, False)}
        assert it.counters["frames_truncated"] == 0


REFUSED = {
    "duration_scaling_factor": lambda it: it(TEXT, duration_scaling_factor=1.2,
                                              input_is_phones=True),
    "pitch_variance_scale": lambda it: it(TEXT, pitch_variance_scale=0.5, input_is_phones=True),
    "energy_variance_scale": lambda it: it(TEXT, energy_variance_scale=2.0,
                                            input_is_phones=True),
    "pause_duration_scaling_factor": lambda it: it(TEXT, pause_duration_scaling_factor=2.0,
                                                    input_is_phones=True),
    "durations": lambda it: it(TEXT, durations=np.ones(_shapes(it)[0]), input_is_phones=True),
    "pitch": lambda it: it(TEXT, pitch=np.ones((_shapes(it)[0], 1)), input_is_phones=True),
    "energy": lambda it: it(TEXT, energy=np.ones((_shapes(it)[0], 1)), input_is_phones=True),
    "batch_knob": lambda it: it.synthesize_batch([TEXT], input_is_phones=True,
                                                 pitch_variance_scale=0.5),
    "file_durations": lambda it: it.read_to_file([TEXT], "/dev/null", input_is_phones=True,
                                                 dur_list=[np.ones(_shapes(it)[0])]),
    "precompile_overrides": lambda it: it.precompile(phone_buckets=(32,), with_overrides=True),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_the_model_cannot_take_raises(iface, case):
    built = dict(iface.counters)
    with pytest.raises(ValueError):
        REFUSED[case](iface)
    assert iface.counters["sentences"] == built["sentences"]


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(dtype=torch.bfloat16),
                                dict(acoustic="other")])
def test_construction_refuses_what_it_cannot_serve(weights, kw):
    with pytest.raises(ValueError):
        make(weights, **{"acoustic": "stochastic", **kw})


def test_toucan_serves_as_before():
    weights = _weights(ToucanTTS, seed=1)
    tts_sd, voc_sd, emb = weights
    default = ToucanTTSInterface(tts_sd, voc_sd, config=TINY,
                                 vocoder=HiFiGANGenerator(channels=32), default_embedding=emb,
                                 language="en", use_g2p=False, device="cpu", seed=7)
    named = make(weights, acoustic="toucan", seed=7)
    assert type(named.model) is ToucanTTS and not named.stochastic
    got = [it(TEXT, input_is_phones=True, return_duration_pitch_energy=True)
           for it in (default, named)]
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    # one glow draw a call, as before: no flow noise
    _, _, frames = _shapes(named)
    gen = torch.Generator().manual_seed(7)
    torch.randn((1, frames, 80), generator=gen)
    assert torch.equal(named.generator.get_state(), gen.get_state())
    assert set(named._e2e_cache[1, 32, 512, False, False, False].inputs) == {
        "text", "text_lengths", "utt", "lang", "knobs", "durations", "pitch", "energy", "noise"}
    with pytest.raises(ValueError):
        named(TEXT, input_is_phones=True, flow_noise=np.zeros((3, 4, 2), np.float32))


def test_durations_past_the_bucket_are_clamped_and_counted():
    tts_sd, voc_sd, emb = _weights(seed=2)
    # the duration flow's last affine: log-durations shifted up by 6 (~400 frames a phone)
    tts_sd["duration_flow.flows.0.m"][0] = -6.0
    iface = make((tts_sd, voc_sd, emb), seed=5)
    n, n_pad, frames = _shapes(iface)
    rng = np.random.RandomState(8)
    flow_noise = rng.randn(3, n, 2).astype(np.float32)
    glow_noise = (0.8 * rng.randn(frames, 80)).astype(np.float32)
    dur, _, want_wave, length = _model_infer(iface, flow_noise, glow_noise)
    assert length > frames and int(dur.sum()) > frames
    wave = iface(TEXT, input_is_phones=True, flow_noise=flow_noise, glow_noise=glow_noise)
    assert len(wave) == frames * SAMPLES_PER_FRAME
    np.testing.assert_allclose(wave, want_wave[:len(wave)], atol=2e-5)
    assert iface.counters["frames_truncated"] == length - frames
    assert iface.counters["frames_delivered"] == frames
    waves = iface.synthesize_batch([TEXT], input_is_phones=True)
    assert len(waves[0]) == frames * SAMPLES_PER_FRAME
    assert iface.counters["frames_delivered"] == 2 * frames
    assert iface.counters["frames_truncated"] > length - frames
