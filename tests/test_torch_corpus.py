"""The port's corpus caches against the JAX package's, on the CPU.

The 4-utterance IPA corpus of ``tests/test_corpus_pipeline.py`` (16 kHz
tones) goes through both packages' ``build_aligner_cache``: the text
features equal, the conditioned wave within 1e-6, the mel in power within
1e-4 of its peak, and the mel equal to ``AudioPreprocessor.
audio_to_mel_spec_tensor``'s.  A cache written by either package loads
equal in the other.  A 10-utterance corpus (22 050 Hz and stereo files, one
too short) takes the worker-process path, whose result equals the serial
one's.  ``build_fastspeech_cache`` on a seeded full-size aligner carried by
``weights.aligner_from_jax``: durations equal, pitch and energy within
1e-4, ``lang_id`` equal.
"""

import os
import wave as wave_mod

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.data import corpus as jax_corpus
from toucan_tpu.models.aligner import Aligner as JaxAligner
from toucan_tpu_torch.data import corpus
from toucan_tpu_torch.frontend.audio import AudioPreprocessor
from toucan_tpu_torch.weights import aligner_from_jax

from test_corpus_pipeline import IPA_SENTENCES, _write_wav
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

TOL_WAVE = 1e-6
TOL_MEL_POWER = 1e-4      # of the utterance's peak mel power
TOL_PROSODY = 1e-4
CACHE_KW = dict(lang="en", loading_processes=1, use_g2p=False, min_len_s=0.5)


def _mel_power_error(got, want):
    p_got, p_want = 10.0 ** np.asarray(got, np.float64), 10.0 ** np.asarray(want, np.float64)
    return np.abs(p_got - p_want).max() / p_want.max()


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    mapping = {}
    for i, ipa in enumerate(IPA_SENTENCES):
        path = root / f"utt_{i}.wav"
        _write_wav(path, seconds=1.2 + 0.3 * i, freq=160 + 40 * i)
        mapping[str(path)] = ipa
    return mapping


@pytest.fixture(scope="module")
def caches(tiny_corpus, tmp_path_factory):
    port_dir, jax_dir = (str(tmp_path_factory.mktemp(n)) for n in ("port", "jax"))
    port = corpus.build_aligner_cache(tiny_corpus, port_dir, device="cpu", **CACHE_KW)
    ref = jax_corpus.build_aligner_cache(tiny_corpus, jax_dir, **CACHE_KW)
    return port, ref, port_dir, jax_dir


def test_aligner_cache_matches_jax(caches):
    port, ref, _, _ = caches
    assert len(port) == len(ref) == 4
    for got, want in zip(port, ref):
        assert got.keys() == want.keys()
        assert got["path"] == want["path"] and got["transcript"] == want["transcript"]
        np.testing.assert_array_equal(got["text"], want["text"])
        np.testing.assert_allclose(got["wave"], want["wave"], atol=TOL_WAVE)
        assert got["mel"].shape == want["mel"].shape and got["mel"].dtype == np.float32
        assert _mel_power_error(got["mel"], want["mel"]) <= TOL_MEL_POWER
        np.testing.assert_array_equal(got["speaker_embedding"], np.zeros(192, np.float32))


def test_mel_is_the_audio_preprocessors(caches):
    for d in caches[0]:
        want = AudioPreprocessor(input_sr=16000).audio_to_mel_spec_tensor(
            d["wave"], normalize=False, device="cpu").T.numpy()
        np.testing.assert_array_equal(d["mel"], want)


def test_caches_load_equal_in_the_other_package(caches):
    port, ref, port_dir, jax_dir = caches
    name = "aligner_train_cache.npz"
    for loaded, written in ((corpus.load_cache(os.path.join(jax_dir, name)), ref),
                            (jax_corpus.load_cache(os.path.join(port_dir, name)), port)):
        assert len(loaded) == len(written)
        for got, want in zip(loaded, written):
            assert got.keys() == want.keys()
            for k, v in want.items():
                if isinstance(v, str):
                    assert got[k] == v
                else:
                    assert got[k].dtype == np.asarray(v).dtype
                    np.testing.assert_array_equal(got[k], np.asarray(v))
    # a second build reads the cache back instead of rebuilding it
    again = corpus.build_aligner_cache({}, port_dir, device="cpu", **CACHE_KW)
    np.testing.assert_array_equal(again[0]["mel"], port[0]["mel"])


def _write_stereo_22k(path, seconds, freq, sr=22050):
    t = np.arange(int(sr * seconds)) / sr
    left = 0.4 * np.sin(2 * np.pi * freq * t)
    right = 0.3 * np.sin(2 * np.pi * 1.5 * freq * t)
    pcm = (np.stack([left, right], 1) * 32767).astype(np.int16)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def test_worker_processes_give_the_serial_cache(tmp_path):
    """Past 8 utterances the host work fans out over forked workers, and
    the parent computes the mels: the same cache as one process builds,
    and the resampled and downmixed waves within 1e-6 of JAX's."""
    mapping = {}
    for i in range(10):
        path = tmp_path / f"u{i}.wav"
        if i % 3 == 0:
            _write_stereo_22k(path, 1.0 + 0.1 * i, 150 + 20 * i)
        else:
            _write_wav(path, seconds=0.3 if i == 4 else 1.0 + 0.1 * i, freq=150 + 20 * i)
        mapping[str(path)] = IPA_SENTENCES[i % 4]
    kw = dict(CACHE_KW, rebuild_cache=True)
    pooled = corpus.build_aligner_cache(mapping, str(tmp_path / "a"), device="cpu",
                                        **dict(kw, loading_processes=2))
    serial = corpus.build_aligner_cache(mapping, str(tmp_path / "b"), device="cpu", **kw)
    ref = jax_corpus.build_aligner_cache(mapping, str(tmp_path / "c"), **kw)
    assert len(pooled) == len(serial) == len(ref) == 9          # the 0.3 s file is dropped
    for got, want, jax_d in zip(pooled, serial, ref):
        for k in ("text", "wave", "mel"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["wave"], jax_d["wave"], atol=TOL_WAVE)
        assert _mel_power_error(got["mel"], jax_d["mel"]) <= TOL_MEL_POWER


def test_fastspeech_cache_matches_jax(caches, tmp_path):
    port, ref, _, _ = caches
    variables = seeded_variables(JaxAligner(), np.random.RandomState(11), jnp.zeros((1, 20, 80)))
    got = corpus.build_fastspeech_cache(port, aligner_from_jax(variables), str(tmp_path / "p"),
                                        "en", device="cpu")
    want = jax_corpus.build_fastspeech_cache(ref, variables, str(tmp_path / "j"), "en")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["lang_id"] == w["lang_id"] == 12
        np.testing.assert_array_equal(g["durations"], w["durations"])
        assert g["durations"].sum() == len(g["mel"])
        np.testing.assert_allclose(g["pitch"], w["pitch"], atol=TOL_PROSODY)
        np.testing.assert_allclose(g["energy"], w["energy"], atol=TOL_PROSODY)
    loaded = jax_corpus.load_cache(str(tmp_path / "p" / "fast_train_cache.npz"))
    np.testing.assert_array_equal(loaded[0]["durations"], got[0]["durations"])


def test_entry_points_ask_for_the_card_unless_told(tiny_corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        corpus.build_aligner_cache(tiny_corpus, str(tmp_path), **CACHE_KW)
