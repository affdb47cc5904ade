"""The port's small utilities against the JAX package's, on the CPU.

``frontend/multilinguality.py`` (its own copy of the JSON assets),
``utils/audio_io.py``, ``frontend/g2p_eval.py`` on two languages of the
fixture, ``data/silence_removal.py``, ``nn/attention.py::
MultiHeadedAttention`` on weights carried by
``weights.multi_headed_attention_from_jax`` (1e-6, with masks of both
shapes) and ``utils/profiling.py``: each equal to JAX's, or within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.data import silence_removal as jax_silence
from toucan_tpu.frontend import g2p_eval as jax_g2p_eval
from toucan_tpu.frontend import multilinguality as jax_multilinguality
from toucan_tpu.nn.attention import MultiHeadedAttention as JaxMHA
from toucan_tpu.utils import audio_io as jax_audio_io
from toucan_tpu_torch.data import silence_removal
from toucan_tpu_torch.frontend import g2p_eval, multilinguality
from toucan_tpu_torch.frontend.inventory import feature_index
from toucan_tpu_torch.nn.attention import MultiHeadedAttention
from toucan_tpu_torch.utils import audio_io
from toucan_tpu_torch.utils.profiling import profile_trace, span
from toucan_tpu_torch.weights import multi_headed_attention_from_jax

from test_torch_modules import seeded_variables

torch.set_num_threads(2)

TOL = 1e-6


def test_multilinguality_data_is_the_port_s_own_copy():
    assert multilinguality._DATA_DIR != jax_multilinguality._DATA_DIR
    for name in ("iso_lookup.json", "iso_to_fullname.json", "iso_to_long_lat.json",
                 "iso_to_memberships.json"):
        with open(os.path.join(multilinguality._DATA_DIR, name), "rb") as f, \
                open(os.path.join(jax_multilinguality._DATA_DIR, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("lang,candidates", [
    ("deu", ["nld", "fra", "cmn", "vie", "eng", "swe"]),
    ("spa", ["por", "ita", "fra", "deu", "eus"]),
])
def test_similarity_solver_matches_jax(lang, candidates):
    port, ref = multilinguality.SimilaritySolver(), jax_multilinguality.SimilaritySolver()
    assert port.find_closest_in_family(lang, candidates, n_closest=3) == \
        ref.find_closest_in_family(lang, candidates, n_closest=3)
    assert port.find_closest_on_map(lang, n_closest=7) == ref.find_closest_on_map(lang, n_closest=7)
    for cand in candidates:
        assert port.tree_dist(lang, cand) == ref.tree_dist(lang, cand)
        assert port.map_dist(lang, cand) == ref.map_dist(lang, cand)
    assert multilinguality.iso_to_fullname() == jax_multilinguality.iso_to_fullname()


@pytest.mark.parametrize("dtype", ["int16", "int8", "uint8"])
def test_float2pcm_and_cumsum_durations_match_jax(dtype):
    rng = np.random.RandomState(3)
    sig = np.clip(rng.randn(1000) * 0.6, -1.2, 1.2).astype(np.float32)
    np.testing.assert_array_equal(audio_io.float2pcm(sig, dtype),
                                  jax_audio_io.float2pcm(sig, dtype))
    durations = rng.randint(0, 9, 17)
    for got, want in zip(audio_io.cumsum_durations(durations),
                         jax_audio_io.cumsum_durations(durations)):
        np.testing.assert_allclose(got, want, atol=TOL)
    with pytest.raises(TypeError):
        audio_io.float2pcm(np.zeros(3, np.int16))


def test_g2p_eval_on_two_languages_matches_jax(tmp_path):
    with open(g2p_eval.default_fixture_path(), encoding="utf-8") as f:
        fixture = json.load(f)
    path = tmp_path / "two.json"
    path.write_text(json.dumps({lang: fixture[lang][:40] for lang in ("en", "de")}),
                    encoding="utf-8")
    got, want = g2p_eval.evaluate(str(path)), jax_g2p_eval.evaluate(str(path))
    assert set(got) == {"en", "de"}
    assert got == {k: {**v, "errors": [tuple(e) for e in v["errors"]]} for k, v in want.items()}


def _speech_and_pause(sr=16000, hop=256):
    """3 phones: tone, tone with an illegal 0.3 s pause inside, silence."""
    f2i = feature_index()
    text = np.zeros((3, 62), np.float32)
    text[0, f2i["phoneme"]] = text[1, f2i["phoneme"]] = 1
    text[2, f2i["silence"]] = 1
    tone = 0.5 * np.sin(2 * np.pi * 200 * np.arange(8000) / sr)
    seg2 = np.concatenate([tone[:1600], np.zeros(4800), tone[:1600]])
    wave = np.concatenate([tone, seg2, np.zeros(4800)]).astype(np.float32)
    durations = np.array([8000 // hop, 8000 // hop, 4800 // hop], np.int64)
    return wave, text, durations


@pytest.mark.parametrize("with_mel", [False, True])
def test_remove_illegal_silences_matches_jax(with_mel):
    wave, text, durations = _speech_and_pause()
    assert silence_removal.find_illegal_silences(wave, text, durations) == \
        jax_silence.find_illegal_silences(wave, text, durations)
    d = dict(wave=wave, text=text, durations=durations)
    if with_mel:
        d["mel"] = np.zeros((int(durations.sum()), 80), np.float32)
    got = silence_removal.remove_illegal_silences(d, device="cpu")
    want = jax_silence.remove_illegal_silences(d)
    assert len(got["wave"]) < len(wave)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["wave"], want["wave"])
    np.testing.assert_array_equal(got["durations"], want["durations"])
    if with_mel:
        assert got["mel"].shape == want["mel"].shape
        p_got, p_want = 10.0 ** got["mel"], 10.0 ** np.asarray(want["mel"])
        assert np.abs(p_got - p_want).max() <= 1e-4 * p_want.max()
    assert silence_removal.make_silence_cleaned_versions([d], device="cpu")[0]["wave"].shape \
        == got["wave"].shape


@pytest.mark.parametrize("mask_kind", ["none", "keys", "full"])
def test_multi_headed_attention_matches_jax(mask_kind):
    rng = np.random.RandomState(5)
    b, t1, t2, f = 2, 7, 9, 32
    q = rng.randn(b, t1, f).astype(np.float32)
    kv = rng.randn(b, t2, f).astype(np.float32)
    mask = None
    if mask_kind == "keys":
        mask = np.arange(t2)[None, None] < np.array([9, 5])[:, None, None]      # (B, 1, T2)
    elif mask_kind == "full":
        mask = rng.rand(b, t1, t2) > 0.3                                       # (B, T1, T2)
        mask[:, :, 0] = True
    jax_mha = JaxMHA(n_head=4, n_feat=f)
    variables = seeded_variables(jax_mha, rng, q, kv, kv, mask)
    want = jax_mha.apply(variables, q, kv, kv, None if mask is None else jnp.asarray(mask))
    port = MultiHeadedAttention(4, f)
    port.load_state_dict(multi_headed_attention_from_jax(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_multi_headed_attention_dropout_only_when_not_deterministic():
    torch.manual_seed(0)
    mha = MultiHeadedAttention(2, 16, dropout_rate=0.5)
    x = torch.randn(1, 5, 16)
    with torch.no_grad():
        a, b = mha(x, x, x), mha(x, x, x)
        c = mha(x, x, x, deterministic=False)
    assert torch.equal(a, b) and not torch.allclose(a, c)


def test_profile_trace_writes_a_trace_with_the_program_s_spans(tmp_path):
    with profile_trace(str(tmp_path / "prof")) as prof:
        with span("toucan.call", 1):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "toucan.call" for e in events)
