"""The port's data scorers against the JAX package's, on the CPU.

``AlignmentScorer`` on a seeded full-size aligner (``weights.
aligner_from_jax``) and ``TTSScorer`` on a seeded tiny ToucanTTS
(``weights.toucan_tts_from_jax``), with given utterance embeddings and with
the GST's (``compat/torch_gst.py``'s layout carried back): every score
within 1e-4 relative of JAX's, the same ``worst_n``, and the same
``nan_indexes`` where a datapoint's pitch is NaN.  ``ctc_outlier_filter``
on 400 seeded scores and ``remove_samples`` are JAX's.  ``TTSScorer``
passes ``deterministic=True, train=False`` whatever the module's mode, so
its attention goes through the K1 wrapper.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.compat.torch_gst import convert_style_embedding
from toucan_tpu.data import scorer as jax_scorer
from toucan_tpu.models.aligner import Aligner as JaxAligner
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu_torch.data import scorer
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.nn import attention
from toucan_tpu_torch.weights import aligner_from_jax, toucan_tts_from_jax

from test_torch_gst import seeded_gst
from test_torch_interface import TINY
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

TOL_SCORE = 1e-4   # relative


def dataset(n=3, seed=0, lang_id=12, t=8, frames=24):
    """Seeded datapoints of one shape (JAX's eager ops then compile once):
    phone features, durations summing to the mel's frames."""
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(n):
        cuts = np.sort(rng.choice(np.arange(1, frames), t - 1, replace=False))
        durations = np.diff(np.concatenate([[0], cuts, [frames]])).astype(np.int32)
        data.append(dict(text=(rng.rand(t, 62) > 0.5).astype(np.float32),
                         mel=(rng.randn(frames, 80) - 3.0).astype(np.float32),
                         durations=durations, pitch=rng.randn(t).astype(np.float32),
                         energy=rng.randn(t).astype(np.float32), lang_id=lang_id))
    return data


def _check_scores(got, want, port, ref):
    assert got.shape == want.shape
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    np.testing.assert_allclose(got[finite], want[finite], rtol=TOL_SCORE)
    assert port.worst_n(2) == ref.worst_n(2)


def test_alignment_scorer_matches_jax():
    data = dataset()
    variables = seeded_variables(JaxAligner(), np.random.RandomState(1), jnp.zeros((1, 20, 80)))
    ref = jax_scorer.AlignmentScorer(variables)
    port = scorer.AlignmentScorer(aligner_from_jax(variables), device="cpu")
    _check_scores(port.score(data), ref.score(data), port, ref)
    assert np.isfinite(port.scores).all()


@pytest.fixture(scope="module")
def tts_pair():
    variables = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(2),
                                 jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                 utterance_embedding=jnp.zeros((1, 64)),
                                 lang_ids=jnp.zeros((1, 1), jnp.int32),
                                 method=JaxToucanTTS.infer)
    return variables, toucan_tts_from_jax(variables)


@pytest.mark.parametrize("conditioning", ["given", "gst"])
def test_tts_scorer_matches_jax(tts_pair, conditioning, monkeypatch):
    variables, sd = tts_pair
    data = dataset(seed=3)
    data[2]["pitch"] = np.full_like(data[2]["pitch"], np.nan)
    kw, port_kw, utt = {}, {}, None
    if conditioning == "gst":
        gst = seeded_gst(4)
        port_kw["gst_state_dict"] = gst.state_dict()
        kw["gst_variables"] = convert_style_embedding(
            {k: v.numpy() for k, v in gst.state_dict().items()})
    else:
        utt = np.random.RandomState(5).randn(len(data), 64).astype(np.float32)
    ref = jax_scorer.TTSScorer(variables, JaxConfig(**TINY), **kw)
    port = scorer.TTSScorer(sd, ToucanTTSConfig(**TINY), device="cpu", **port_kw)
    port.model.train()   # the scorer passes its own modes
    calls = []
    real = attention.flash_rel_attention
    monkeypatch.setattr(attention, "flash_rel_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    got, want = port.score(data, utt_embeddings=utt), ref.score(data, utt_embeddings=utt)
    _check_scores(got, want, port, ref)
    assert port.nan_indexes() == ref.nan_indexes() == [2]
    assert len(calls) == len(data) * (TINY["enc_layers"] + TINY["dec_layers"])


def test_ctc_outlier_filter_and_remove_samples_match_jax():
    rng = np.random.RandomState(7)
    scores = rng.gamma(2.0, 1.5, 400)
    scores[[3, 77, 250]] += 25.0
    data = list(range(400))
    got = scorer.ctc_outlier_filter(data, scores)
    assert got == jax_scorer.ctc_outlier_filter(data, scores)
    assert 3 not in got and 77 not in got and len(got) < 397
    assert scorer.ctc_outlier_filter(data[:300], scores[:300]) == data[:300]   # min_size
    drop = [0, 5, 399]
    assert scorer.remove_samples(data, drop) == jax_scorer.remove_samples(data, drop)
