"""The port's per-bucket path (``infer/capture.py``) against its eager path
and the JAX package, on the CPU.

On the CPU a bucket runs its step eagerly over the same static buffers
(and static outputs) as a CUDA graph replays on the card, so these tests
hold the bucket logic itself: keys, buffers that must not go stale, outputs
that the next call overwrites, the noise drawn into its buffer, and the
knobs as a device tensor.  The bucketed and eager paths run the same
arithmetic on the same inputs, so they must agree bit for bit; against JAX
the tolerances of ``tests/test_torch_interface.py`` hold (durations equal,
wave 2e-4, mel, pitch and energy 3e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.toucan_tts import _scale_variance as jax_scale_variance
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu_torch.infer.capture import Bucket
from toucan_tpu_torch.infer.interface import SENTENCE_JOIN_SILENCE, ToucanTTSInterface
from toucan_tpu_torch.kernels import build, imcol
from toucan_tpu_torch.kernels.imcol import prepare_imcol_stage
from toucan_tpu_torch.kernels.resstack import pack_stage
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig, _scale_variance
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.nn.positional import _cached_table, rel_positional_encoding
from toucan_tpu_torch.weights import hifigan_from_jax, toucan_tts_from_jax

from test_torch_interface import TEXTS, TINY, _batch_inputs, whole_step
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

IPA = TEXTS[0]
KNOBS = [(1.0, 1.0, 1.0, 1.0), (1.5, 0.6, 1.4, 2.0)]


@pytest.fixture(scope="module")
def variables():
    tts_vars = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                                jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                utterance_embedding=jnp.zeros((1, 64)),
                                lang_ids=jnp.zeros((1, 1), jnp.int32),
                                method=JaxToucanTTS.infer)
    voc_vars = seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                jnp.zeros((1, 16, 80)))
    emb = np.random.RandomState(2).randn(64).astype(np.float32)
    return tts_vars, voc_vars, emb


def make_port(variables, seed=0):
    tts_vars, voc_vars, emb = variables
    return ToucanTTSInterface(toucan_tts_from_jax(tts_vars), hifigan_from_jax(voc_vars),
                              config=ToucanTTSConfig(**TINY),
                              vocoder=HiFiGANGenerator(channels=64), default_embedding=emb,
                              language="en", use_g2p=False, device="cpu", seed=seed)


@pytest.fixture(scope="module")
def port(variables):
    return make_port(variables)


def eager(port, fn):
    """fn() with the port's every call run eagerly, outside the buckets."""
    port._eager = True
    try:
        return fn()
    finally:
        port._eager = False


@pytest.mark.parametrize("knobs", KNOBS)
def test_knob_tensor_matches_jax(variables, port, knobs):
    """The knobs as one (4,) tensor: durations, pitch, energy, mel and wave
    of the port's step over every decoded frame equal the JAX interface's
    jitted step (knobs traced)."""
    tts_vars, voc_vars, emb = variables
    jax_iface = JaxInterface(tts_vars, voc_vars, None, default_embedding=emb,
                             config=JaxConfig(**TINY), vocoder=JaxHiFiGAN(channels=64),
                             language="en", use_g2p=False)
    text, lens = _batch_inputs(port)
    rng = np.random.RandomState(7)
    utt = rng.randn(3, 64).astype(np.float32)
    lang = np.asarray([[12], [12], [3]], np.int32)
    noise = (0.8 * rng.randn(3, 512, 80)).astype(np.float32)
    want = jax_iface._e2e_fn(32, 512, False)(
        jax_iface.tts_variables, jax_iface.vocoder_variables, jnp.asarray(text),
        jnp.asarray(lens), jnp.asarray(utt), jnp.asarray(lang), jnp.asarray(noise),
        jnp.asarray(knobs, jnp.float32))
    got = whole_step(port, torch.tensor(text), torch.tensor(lens, dtype=torch.long), 512,
                     torch.tensor(utt), torch.tensor(lang, dtype=torch.long), torch.tensor(noise),
                     torch.tensor(knobs, dtype=torch.float32))
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[2], want[2])      # durations
    np.testing.assert_array_equal(got[5], want[5])      # mel lengths
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)
    for g, w in zip((got[1], got[3], got[4]), (want[1], want[3], want[4])):
        np.testing.assert_allclose(g, w, atol=3e-4)


@pytest.mark.parametrize("scale", [1.0, 1.5, 0.6])
def test_scale_variance_as_tensor_matches_jax(scale):
    """A 0-d tensor scale; at 1 the curve passes through unclamped (its
    negative values stay), elsewhere it is widened or narrowed and clamped."""
    seq = np.random.RandomState(8).randn(2, 7, 1).astype(np.float32)
    seq[0, 2] = 0.0
    got = _scale_variance(torch.tensor(seq), torch.tensor(scale)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_scale_variance(jnp.asarray(seq), scale)),
                               atol=1e-6)
    if scale == 1.0:
        np.testing.assert_array_equal(got, seq)
    else:
        assert (got >= 0).all()


def test_precompile_creates_the_key_a_call_reuses(port):
    port._e2e_cache.clear()
    port.precompile(phone_buckets=(32,), batch_sizes=(1,))
    key = (1, 32, 32 * 16, False, False, False)
    assert list(port._e2e_cache) == [key]
    bucket = port._e2e_cache[key]
    wave = port(IPA, input_is_phones=True)
    assert np.isfinite(wave).all() and len(wave) > 0
    assert list(port._e2e_cache) == [key] and port._e2e_cache[key] is bucket


def test_precompile_with_overrides_keys_every_override(port):
    port._e2e_cache.clear()
    port.precompile(phone_buckets=(32,), batch_sizes=(2,), with_overrides=True)
    assert list(port._e2e_cache) == [(2, 32, 512, True, True, True)]


def test_precompile_makes_the_largest_bucket_first(port):
    """The smaller graphs capture into the memory the largest one's capture
    left free in the shared pool, so precompile goes largest first."""
    port._e2e_cache.clear()
    port.precompile(phone_buckets=(32, 64), batch_sizes=(1, 2))
    assert [k[:2] for k in port._e2e_cache] == [(2, 64), (1, 64), (2, 32), (1, 32)]
    port._e2e_cache.clear()


def test_precompile_makes_every_vocoder_bucket_a_step_reaches(port):
    """The vocoder's frame buckets step by 64 frames to 1024 and by 512
    above, up to the frames decoded; ``precompile`` makes every one that a
    step of its phone buckets can reach, the largest first."""
    port._e2e_cache.clear()
    port._vocoder_cache.clear()
    port.precompile(phone_buckets=(32, 96), batch_sizes=(1,))
    assert list(port._vocoder_cache) == [(1, f) for f in [1536, *range(1024, 0, -64)]]
    assert {(1, port._cut_frames(n, m)) for m in (512, 1536)
            for n in range(m + 1)} == set(port._vocoder_cache)
    port._e2e_cache.clear()
    port._vocoder_cache.clear()


def test_bucket_calls_with_new_knobs_and_noise_match_eager(port):
    """Two calls in one bucket, each with other knobs and other injected
    noise, each equal its own eager call: no static buffer goes stale."""
    port._e2e_cache.clear()
    n = len(port.text2phone.string_to_features(IPA, input_phonemes=True))
    rng = np.random.RandomState(9)
    for knobs in KNOBS:
        z = (0.8 * rng.randn(n * 16, 80)).astype(np.float32)
        kw = dict(zip(("duration_scaling_factor", "pitch_variance_scale",
                       "energy_variance_scale", "pause_duration_scaling_factor"), knobs))
        got = port(IPA, input_is_phones=True, glow_noise=z, return_duration_pitch_energy=True,
                   **kw)
        want = eager(port, lambda: port(IPA, input_is_phones=True, glow_noise=z,
                                        return_duration_pitch_energy=True, **kw))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(port._e2e_cache) == 1


def test_bucket_noise_sequence_equals_eager(port):
    """Noise drawn into the bucket's buffer from the interface's generator
    follows the eager path's sequence: three calls from one seed."""
    port._e2e_cache.clear()
    port.generator.manual_seed(11)
    got = [port(t, input_is_phones=True) for t in TEXTS]
    port.generator.manual_seed(11)
    want = eager(port, lambda: [port(t, input_is_phones=True) for t in TEXTS])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    port.generator.manual_seed(11)
    torch.randn((1, 512, 80), generator=port.generator)
    after_one = port.generator.get_state()
    port.generator.manual_seed(11)
    port(IPA, input_is_phones=True)
    assert torch.equal(port.generator.get_state(), after_one)


def test_read_to_file_equals_single_calls_joined(port, tmp_path):
    """Two sentences of one bucket, both enqueued before either is fetched:
    the first's wave is copied off the bucket's outputs before the second
    overwrites them."""
    port._e2e_cache.clear()
    texts = TEXTS[:2]
    port.generator.manual_seed(12)
    got = port.read_to_file(texts, tmp_path / "out.wav", input_is_phones=True)
    assert len(port._e2e_cache) == 1
    port.generator.manual_seed(12)
    silence = np.zeros(SENTENCE_JOIN_SILENCE, np.float32)
    pieces = [silence]
    for t in texts:
        pieces += [port(t, input_is_phones=True), silence]
    want = np.concatenate(pieces)
    assert len(pieces[1]) != len(pieces[3]) or not np.array_equal(pieces[1], pieces[3])
    np.testing.assert_array_equal(got, want)


def test_synthesize_batch_bucket_equals_eager(port):
    port._e2e_cache.clear()
    port.generator.manual_seed(13)
    got = port.synthesize_batch(TEXTS, input_is_phones=True, languages=["en", "en", "de"])
    port.generator.manual_seed(13)
    want = eager(port, lambda: port.synthesize_batch(TEXTS, input_is_phones=True,
                                                     languages=["en", "en", "de"]))
    assert list(port._e2e_cache) == [(3, 32, 512, False, False, False)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_vocode_bucket_equals_eager(port):
    port._vocoder_cache.clear()
    mel = np.random.RandomState(14).randn(70, 80).astype(np.float32)
    got = port._vocode(mel)
    again = port._vocode(mel[:66])
    assert list(port._vocoder_cache) == [(1, 128)]
    np.testing.assert_array_equal(got, eager(port, lambda: port._vocode(mel)))
    np.testing.assert_array_equal(again, eager(port, lambda: port._vocode(mel[:66])))


def test_quantize_vocoder_clears_caches(variables):
    port = make_port(variables)
    port(IPA, input_is_phones=True)
    port._vocode(np.zeros((10, 80), np.float32))
    assert port._e2e_cache and port._vocoder_cache
    port.quantize_vocoder(act_scales={i: np.ones(18, np.float32) for i in range(4)})
    assert not port._e2e_cache and not port._vocoder_cache


def test_bucket_takes_exactly_its_inputs():
    bucket = Bucket(lambda x, y: (x + 1,), {"x": ((2,), torch.float32), "y": None}, "cpu")
    np.testing.assert_array_equal(bucket(x=torch.ones(2))[0].numpy(), [2.0, 2.0])
    with pytest.raises(ValueError, match="exactly"):
        bucket(x=torch.ones(2), y=torch.ones(2))
    with pytest.raises(ValueError, match="exactly"):
        bucket()


def test_captured_launches_count_at_replay(monkeypatch):
    """A launch made while the stream captures goes to the open tally, and
    each replay adds the tally to the wrapper's count."""
    def wrapper():
        pass
    wrapper.launches = 0
    build.count_launch(wrapper)
    assert wrapper.launches == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with build.CaptureTally() as tally:
        build.count_launch(wrapper)
        build.count_launch(wrapper)
    build.count_launch(wrapper)     # a capture with no tally open counts nowhere
    assert wrapper.launches == 1 and tally.counts == {wrapper: 2}
    with build.CaptureTally(), pytest.raises(RuntimeError, match="already open"):
        with build.CaptureTally():
            pass
    tally.replayed()
    tally.replayed()
    assert wrapper.launches == 5


def test_capture_holds_the_position_tables_it_reads(monkeypatch):
    """A graph reads its position tables by address: the capture's tally
    holds each table it took, so the table stays the same tensor with the
    same values after 40 other lengths have pushed it out of the cache."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    x = torch.zeros(1, 7, 16)
    with build.CaptureTally() as tally:
        _, table = rel_positional_encoding(x, 16)
    monkeypatch.undo()
    want = table.clone()
    for length in range(8, 48):
        rel_positional_encoding(torch.zeros(1, length, 16), 16)
    assert _cached_table(7, 16, x.device, x.dtype) is not table   # evicted, rebuilt
    assert len(tally.held) == 1 and tally.held[0] is table
    assert torch.equal(tally.held[0], want)


def test_widened_imcol_stage_lives_on_its_stage():
    """K4's stage widened for C % 4 != 0 is made once per stage and kept
    on it, as long as the stage whose weights a graph also reads."""
    g = torch.Generator().manual_seed(0)
    c, ks, dil = 6, (3, 7, 11), (1, 3, 5)
    convs = [(torch.randn(c, c, k, generator=g), torch.randn(c, generator=g))
             for k in ks for _ in range(6)]
    st = prepare_imcol_stage(pack_stage(convs, c, ks, dil, 0.1), "int8")
    wide = imcol._widened(st)
    assert imcol._widened(st) is wide and wide.channels == 8
    assert torch.equal(wide.w, imcol.widened(st, 8).w)
