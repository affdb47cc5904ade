"""The port's ``.pt`` loader against ``toucan_tpu.compat.load``, on the CPU.

Reference-format files are written from seeded port modules: weight norm
split into ``weight_g``/``weight_v`` where the reference has it (the Glow's
WaveNet convs, every vocoder conv), and the reference's constant buffers that
the port leaves out (InvConvNear's ``l_mask``/``eye``, BigVGAN's resampling
filters) added.  The JAX loader and the port's read each file; the port's
state dict must equal the JAX variables carried back by ``weights.py``,
exactly, and the sniffed configs must be equal in all three fallback cases
(multilingual, multispeaker-only, single-speaker).  The interface built by
``interface_from_torch`` serves a cloned voice with the im2col vocoder.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from toucan_tpu.compat import load as jax_load
from toucan_tpu.compat.torch_toucan import _fold_weight_norm
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.load import (GLOW_WEIGHT_NORM, fold_weight_norm, interface_from_torch,
                                   load_style_embedding, load_toucan_tts, load_vocoder,
                                   split_weight_norm)
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.weights import (bigvgan_from_jax, hifigan_from_jax, style_embedding_from_jax,
                                      toucan_tts_from_jax)

from test_torch_gst import seeded_gst, speech_like
from test_torch_interface import IPA, TEXTS, TINY

torch.set_num_threads(2)

# a single-speaker checkpoint has plain-LayerNorm predictors, which the
# port's sniff reads as ``conditional_predictors=False``, as JAX's does
VARIANTS = {"multilingual": {}, "multispeaker": dict(lang_embs=None),
            "singlespeaker": dict(lang_embs=None, utt_embed_dim=None,
                                  conditional_predictors=False)}


def _randomized(module, seed):
    """The module with every parameter and float buffer seeded at random
    (biases and norms included), so every part of a comparison is live."""
    torch.manual_seed(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if t.is_floating_point() and not name.endswith((".p", ".sign_s")):
                t.copy_(0.1 * torch.randn_like(t) + (1.0 if name.endswith("running_var") else 0.0))
    return module.eval()


def write_tts(path, config, seed=0):
    model = _randomized(ToucanTTS(config), seed)
    sd = split_weight_norm(model.state_dict(), GLOW_WEIGHT_NORM)
    for name, p in model.named_buffers():
        if name.endswith(".p"):       # the reference InvConvNear's LU constants
            base, c = name[:-2], p.shape[0]
            sd[f"{base}.l_mask"] = torch.tril(torch.ones(c, c), -1)
            sd[f"{base}.eye"] = torch.eye(c)
    emb = torch.randn(config.utt_embed_dim) if config.utt_embed_dim else None
    torch.save({"model": sd, "default_emb": emb}, path)
    return emb


def write_vocoder(path, vocoder, seed=1):
    sd = split_weight_norm(_randomized(vocoder, seed).state_dict(), r".")
    if isinstance(vocoder, BigVGAN):  # the reference activations' resampling filters
        for name in [k[:-len(".act.alpha")] for k in sd if k.endswith(".act.alpha")]:
            sd[f"{name}.upsample.filter"] = torch.ones(1, 1, 12)
            sd[f"{name}.downsample.lowpass.filter"] = torch.ones(1, 1, 12)
    torch.save({"generator": sd}, path)


def write_gst(path):
    torch.save({"style_emb_func": seeded_gst(3).state_dict()}, path)


def _assert_equal_dicts(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k].float(), v.float()), k


def test_fold_weight_norm_is_compats():
    rng = np.random.RandomState(0)
    g, v = rng.rand(6, 1, 1).astype(np.float32), rng.randn(6, 4, 5).astype(np.float32)
    got = fold_weight_norm({"c.weight_g": torch.from_numpy(g), "c.weight_v": torch.from_numpy(v),
                            "c.bias": torch.zeros(6)})
    assert set(got) == {"c.weight", "c.bias"}
    np.testing.assert_array_equal(got["c.weight"].numpy(),
                                  _fold_weight_norm({"c.weight_g": g, "c.weight_v": v}, "c"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_toucan_tts_file_reads_as_in_compat(variant, tmp_path):
    config = ToucanTTSConfig(**{**TINY, **VARIANTS[variant]})
    path = str(tmp_path / "best.pt")
    emb = write_tts(path, config)
    jax_vars, jax_emb, jax_config = jax_load.load_toucan_tts(path, return_config=True)
    sd, got_emb, got_config = load_toucan_tts(path, return_config=True)
    assert got_config == config
    for field in dataclasses.fields(got_config):
        got, want = getattr(got_config, field.name), getattr(jax_config, field.name)
        if field.name == "dtype":  # torch.float32 and jnp.float32
            got, want = str(got).removeprefix("torch."), np.dtype(want).name
        assert got == want, field.name
    assert jax_config.conditional_predictors == (config.utt_embed_dim is not None)
    _assert_equal_dicts(sd, toucan_tts_from_jax(jax.tree.map(np.asarray, jax_vars)))
    if emb is None:
        assert got_emb is None and jax_emb is None
    else:
        np.testing.assert_array_equal(got_emb, emb.numpy())
        np.testing.assert_array_equal(got_emb, jax_emb)
    ToucanTTS(got_config).load_state_dict(sd)


@pytest.mark.parametrize("kind", ["hifigan", "bigvgan"])
def test_vocoder_file_reads_as_in_compat(kind, tmp_path):
    path = str(tmp_path / "voc.pt")
    module = HiFiGANGenerator(channels=64) if kind == "hifigan" else BigVGAN(channels=64)
    write_vocoder(path, module)
    sd = load_vocoder(path, kind)
    want = (hifigan_from_jax if kind == "hifigan" else bigvgan_from_jax)(
        jax.tree.map(np.asarray, jax_load.load_vocoder(path, kind)))
    _assert_equal_dicts(sd, want)
    type(module)(channels=64).load_state_dict(sd)


def test_style_embedding_file_reads_as_in_compat(tmp_path):
    path = str(tmp_path / "embedding_function.pt")
    write_gst(path)
    sd = load_style_embedding(path)
    _assert_equal_dicts(sd, style_embedding_from_jax(
        jax.tree.map(np.asarray, jax_load.load_style_embedding(path))))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    paths = [str(tmp / name) for name in ("tts.pt", "voc.pt", "gst.pt")]
    write_tts(paths[0], ToucanTTSConfig(**TINY))
    write_vocoder(paths[1], HiFiGANGenerator(channels=64))
    write_gst(paths[2])
    return paths


def _iface(files, **kw):
    return interface_from_torch(*files, vocoder_kind=HiFiGANGenerator(channels=64, **kw),
                                use_g2p=False, device="cpu", seed=4)


def test_interface_from_torch_serves_a_cloned_voice(files):
    """Reference files -> interface with the int8 im2col vocoder -> speaker
    from a 24 kHz wave -> synthesis; the same as an interface built from the
    loaded dicts by hand."""
    iface = _iface(files, imcol_mode="int8")
    assert iface.vocoder.imcol_mode == "int8" and iface.gst is not None
    wave = speech_like(24000, 1.5, seed=5)
    iface.set_utterance_embedding(wave=wave, sr=24000)
    tts_sd, _, config = load_toucan_tts(files[0], return_config=True)
    by_hand = ToucanTTSInterface(tts_sd, load_vocoder(files[1]), config=config,
                                 vocoder=HiFiGANGenerator(channels=64, imcol_mode="int8"),
                                 use_g2p=False, device="cpu", seed=4,
                                 gst_state_dict=load_style_embedding(files[2]))
    by_hand.set_utterance_embedding(wave=wave, sr=24000)
    np.testing.assert_array_equal(iface.default_utterance_embedding,
                                  by_hand.default_utterance_embedding)
    got = iface(IPA, input_is_phones=True)
    assert len(got) > 0 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, by_hand(IPA, input_is_phones=True))


def test_missing_key_raises(files, tmp_path):
    sd = torch.load(files[1], weights_only=True)["generator"]
    del sd["output_conv.1.bias"]
    path = str(tmp_path / "voc.pt")
    torch.save({"generator": sd}, path)
    with pytest.raises(RuntimeError, match="output_conv.1.bias"):
        interface_from_torch(files[0], path, files[2], vocoder_kind=HiFiGANGenerator(channels=64),
                             use_g2p=False, device="cpu")


def test_interface_options(files, tmp_path):
    """``synthesize_batch(return_pcm16=)``, ``read_to_file(
    increased_compatibility_mode=)`` and ``read_aloud(_player=)``, as the
    JAX interface has them."""
    f32 = _iface(files).synthesize_batch(TEXTS, input_is_phones=True)
    pcm = _iface(files).synthesize_batch(TEXTS, input_is_phones=True, return_pcm16=True)
    for a, b in zip(f32, pcm):
        assert b.dtype == np.int16
        np.testing.assert_array_equal(b, np.round(np.clip(a, -1, 1) * 32767).astype(np.int16))
    import wave as wave_mod
    path = tmp_path / "out.wav"
    wav = _iface(files).read_to_file([IPA], path, input_is_phones=True,
                                     increased_compatibility_mode=True)
    single = _iface(files)(IPA, input_is_phones=True)
    with wave_mod.open(str(path), "rb") as f:
        assert f.getframerate() == 48000 and f.getnframes() == len(wav) == 2 * (len(single)
                                                                                 + 2 * 10600)
    assert wav.dtype == np.int16

    class Player:
        def play(self, data, samplerate):
            self.played = (data, samplerate)

        def wait(self):
            self.waited = True

    player = Player()
    out = _iface(files).read_aloud(IPA, input_is_phones=True, blocking=True, _player=player)
    assert player.played[1] == 24000 and player.waited and len(out) == len(single) + 12000
    np.testing.assert_array_equal(out[:len(single)], single)
    assert _iface(files).read_aloud("  ", _player=player) is None
