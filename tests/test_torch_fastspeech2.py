"""Glow-less and unconditional-predictor ToucanTTS models against JAX.

``fastspeech2_config`` (adim 384 with 4 heads, so K1 runs at d = 96, a
5-layer pitch predictor, unconditional predictors, no post-flow) at a tiny
depth, a glow-less model with conditional predictors, and a model whose
predictors are unconditional although its encoder takes an utterance
embedding: each on seeded variables in the JAX layout, carried to the port
by ``weights.toucan_tts_from_jax``.  Durations must be equal and the mel,
pitch and energy within 3e-4, the bar of ``test_torch_modules.py``; without
a glow the odd last frame is kept.  Each variant's reference-format ``.pt``
is sniffed and loaded by the port.  The port decides conditional
predictors from the duration predictor's own keys; the JAX package's
``compat/load.py`` takes any checkpoint with an utterance projection in its
encoder as conditional, which the last test pins.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.compat import load as jax_load
from toucan_tpu.compat.torch_toucan import convert_toucan_tts
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.toucan_tts import fastspeech2_config as jax_fastspeech2_config
from toucan_tpu_torch import load
from toucan_tpu_torch.frontend.inventory import feature_index
from toucan_tpu_torch.kernels.flash_attention import flash_rel_attention
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig, fastspeech2_config
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.weights import toucan_tts_from_jax

from test_torch_load import write_gst, write_tts, write_vocoder
from test_torch_modules import _flatten, _t, seeded_variables

torch.set_num_threads(2)

# the tiny depth: one conformer block each side, narrow feed-forwards and
# predictors; fastspeech2 keeps its adim 384 and 4 heads (d = 96)
SMALL = dict(enc_layers=1, dec_layers=1, enc_units=64, dec_units=64, duration_chans=16,
             pitch_chans=16, energy_chans=16, duration_layers=1, pitch_layers=2,
             energy_layers=1, lang_embs=100)
VARIANTS = {
    "fastspeech2": dict(fastspeech2=True),
    "glowless_conditional": dict(adim=32, aheads=2, use_postflow=False),
    "unconditional_with_glow": dict(adim=32, aheads=2, glow_blocks=2, glow_hidden=16,
                                    conditional_predictors=False),
}


def _configs(variant):
    kw = dict(SMALL, **VARIANTS[variant])
    if kw.pop("fastspeech2", False):
        return jax_fastspeech2_config(**kw), fastspeech2_config(**kw)
    return JaxConfig(**kw), ToucanTTSConfig(**kw)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    jax_cfg, cfg = _configs(request.param)
    model = JaxToucanTTS(jax_cfg)
    variables = seeded_variables(model, np.random.RandomState(0), jnp.zeros((1, 8, 62)),
                                 jnp.array([8]), 32, utterance_embedding=jnp.zeros((1, 64)),
                                 lang_ids=jnp.zeros((1, 1), jnp.int32),
                                 method=JaxToucanTTS.infer)
    port = ToucanTTS(cfg)
    port.load_state_dict(toucan_tts_from_jax(variables))
    return request.param, cfg, model, variables, port.eval()


def test_configs_are_jaxs():
    """The port's config fields and ``fastspeech2_config`` are JAX's."""
    want = jax_fastspeech2_config()
    got = fastspeech2_config()
    for field in dataclasses.fields(got):
        if field.name != "dtype":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert not got.use_postflow and not got.conditional_predictors
    assert got.adim // got.aheads == 96


def test_modules_follow_the_config(variant):
    _, cfg, _, _, port = variant
    assert hasattr(port, "post_flow") == cfg.use_postflow
    assert any(".W_scale." in k for k in port.state_dict()) == cfg.conditional_predictors
    assert hasattr(port.encoder, "hs_emb_projection")   # utt_embed_dim stays set


def test_weights_round_trip_exactly(variant):
    """The port's state dict through the compat converter gives the JAX
    variables back, bit for bit."""
    _, cfg, _, variables, port = variant
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_toucan_tts(sd, enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
                              duration_layers=cfg.duration_layers, pitch_layers=cfg.pitch_layers,
                              energy_layers=cfg.energy_layers,
                              glow_blocks=cfg.glow_blocks if cfg.use_postflow else 0,
                              glow_layers=cfg.glow_layers,
                              conditional=cfg.conditional_predictors)
    want, got = _flatten(variables), _flatten(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("gold_durations", [False, True])
def test_infer_matches_jax(variant, gold_durations):
    name, cfg, model, variables, port = variant
    rng = np.random.RandomState(8)
    b, t, max_frames = 2, 12, 64
    text = (rng.rand(b, t, 62) > 0.5).astype(np.float32)
    text[..., feature_index()["word-boundary"]] = 0    # no phone loses its duration
    lens = np.asarray([12, 9], np.int32)
    utt = rng.randn(b, 64).astype(np.float32)
    lang = np.asarray([[3], [41]], np.int32)
    noise = (0.8 * rng.randn(b, max_frames, 80)).astype(np.float32)
    # odd totals, so a model without a glow keeps its last frame
    durations = np.asarray([[3] * 11 + [2], [1] * 12], np.int32) if gold_durations else None
    want = model.apply(variables, text, lens, max_frames, utterance_embedding=utt,
                       lang_ids=lang, gold_durations=durations, glow_noise=noise,
                       method=JaxToucanTTS.infer)
    got = port.infer(_t(text), _t(lens, torch.long), max_frames, utterance_embedding=_t(utt),
                     lang_ids=_t(lang, torch.long),
                     gold_durations=None if durations is None else _t(durations, torch.int32),
                     glow_noise=_t(noise))
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[2], want[2])           # durations
    np.testing.assert_array_equal(got[5], want[5])           # mel lengths
    if gold_durations:                                       # 35 and 9 frames
        assert list(got[5]) == ([35, 9] if not cfg.use_postflow else [34, 8])
    for i in (0, 1, 3, 4):                                   # before, after, pitch, energy
        np.testing.assert_allclose(got[i], want[i], atol=3e-4)
    assert flash_rel_attention.launches == 0


def test_reference_files_load(variant, tmp_path):
    """A reference-format ``.pt`` of the variant: sniffed to its config, and
    served by ``load.interface_from_torch`` on the CPU."""
    _, cfg, *_ = variant
    paths = [str(tmp_path / n) for n in ("best.pt", "vocoder.pt", "embedding_function.pt")]
    write_tts(paths[0], cfg)
    write_vocoder(paths[1], HiFiGANGenerator(channels=64))
    write_gst(paths[2])
    _, _, sniffed = load.load_toucan_tts(paths[0], return_config=True)
    assert sniffed == cfg
    iface = load.interface_from_torch(*paths, vocoder_kind="hifigan", use_g2p=False,
                                      device="cpu")
    assert iface.vocoder.input_conv.out_channels == 64    # the checkpoint's width
    n = len(iface.text2phone.string_to_features("~tˈɛst~#", input_phonemes=True))
    wave = iface("~tˈɛst~#", input_is_phones=True, durations=np.full(n, 3))
    assert len(wave) % 384 == 0 and len(wave) > 0 and np.isfinite(wave).all()


def test_sniff_differs_from_compat_on_the_fastspeech2_layout(tmp_path):
    """The FastSpeech2 layout (an utterance projection in the encoder,
    plain-LayerNorm predictors, no post-flow): the port reads unconditional
    predictors from the predictor's keys and loads it; the JAX package's
    ``compat/load.py:94-99`` reports conditional predictors for it, and its
    converter would look for conditional-norm keys that are not there."""
    cfg = fastspeech2_config(**SMALL)
    path = str(tmp_path / "best.pt")
    write_tts(path, cfg)
    sd, _, got = load.load_toucan_tts(path, return_config=True)
    assert (got.use_postflow, got.conditional_predictors, got.utt_embed_dim) == (False, False, 64)
    ToucanTTS(got).load_state_dict(sd)
    jax_cfg = jax_load.sniff_toucan_config({k: v.numpy() for k, v in sd.items()})
    assert (jax_cfg.use_postflow, jax_cfg.conditional_predictors) == (False, True)
    with pytest.raises(KeyError):
        jax_load.load_toucan_tts(path)
