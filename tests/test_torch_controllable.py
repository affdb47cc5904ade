"""The port's embedding GAN and slider interface against the JAX package's, on the CPU.

``ResNetG`` (image sides 4 and 8) gets seeded weights in the JAX layout,
carried over by ``weights.resnet_g_from_jax``; its embedding and its
first hidden layer are held to atol 2e-5, rtol 1e-4
(``tests/test_embedding_gan.py``), and ``compat/torch_gan.py`` must give the
JAX variables back exactly from the port's state dict.  JAX's latents come
from ``jax.random``, which a torch generator cannot draw, so the sliders
are compared on JAX's latent bank and basis carried into the port's
``GanWrapper``; the basis itself is the same numpy SVD and least squares,
equal on equal hidden layers and within 1e-4 on the port's own.
``ControllableInterface`` is a copy; its ``read`` runs the port's
interface (tiny, seeded torch weights).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.compat.torch_gan import convert_resnet_g
from toucan_tpu.models.embedding_gan import GanWrapper as JaxGanWrapper
from toucan_tpu.models.embedding_gan import ResNetG as JaxResNetG
from toucan_tpu_torch.infer.controllable import _TOO_LONG, MAX_PHONES, ControllableInterface
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.load import load_embedding_gan
from toucan_tpu_torch.models.embedding_gan import GanWrapper, ResNetG, pca_basis
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.weights import resnet_g_from_jax

from test_torch_interface import IPA, TINY
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

PCA_SAMPLES = 256
SLIDERS = [np.zeros(6), [3.0, 0, 0, 0, 0, 0], [0.5, -1.0, 2.0, 0.0, -0.3, 1.5]]


@pytest.fixture(scope="module", params=[4, 8])
def generators(request):
    """(size, JAX ResNetG, its variables, the port's ResNetG with them)."""
    size = request.param
    jax_g = JaxResNetG(size=size)
    variables = seeded_variables(jax_g, np.random.RandomState(size), jnp.zeros((2, 32)))
    port = ResNetG(size=size)
    port.load_state_dict(resnet_g_from_jax(variables, size=size))
    return size, jax_g, variables, port.eval()


def test_resnet_g_matches_jax(generators):
    _, jax_g, variables, port = generators
    z = np.random.RandomState(1).randn(3, 32).astype(np.float32)
    want, want_inter = jax.jit(jax_g.apply, static_argnames="return_intermediate")(
        variables, jnp.asarray(z), return_intermediate=True)
    with torch.no_grad():
        got, got_inter = port(torch.from_numpy(z), return_intermediate=True)
    assert got.shape == (3, 64) and got_inter.shape == want_inter.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_inter.numpy(), np.asarray(want_inter), atol=2e-5, rtol=1e-4)


def test_resnet_g_round_trip(generators, tmp_path):
    """``convert_resnet_g`` of the port's state dict gives the JAX variables
    exactly; ``load_embedding_gan`` reads a reference-format file."""
    size, _, variables, port = generators
    sd = port.state_dict()
    back = convert_resnet_g({k: v.numpy() for k, v in sd.items()}, size=size)
    leaves = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in leaves(back)] == [p for p, _ in leaves(variables)]
    for (_, a), (_, b) in zip(leaves(back), leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))
    path = tmp_path / "embedding_gan.pt"
    params = dict(data_dim=[64], z_dim=32, size=size, nfilter=64, nfilter_max=512)
    torch.save({"model_parameters": params, "generator_state_dict": sd, "critic_state_dict": {},
                "dataset_mean": torch.full((64,), 0.5), "dataset_std": torch.ones(64)}, path)
    loaded, generator, mean, std = load_embedding_gan(str(path))
    assert generator.size == size and generator.nf0 == port.nf0
    assert all(torch.equal(loaded[k], v) for k, v in sd.items()) and loaded.keys() == sd.keys()
    np.testing.assert_array_equal(mean, np.full(64, 0.5, np.float32))
    np.testing.assert_array_equal(std, np.ones(64, np.float32))


@pytest.fixture(scope="module")
def wrappers():
    """(JAX GanWrapper, the port's GanWrapper carrying its bank and basis,
    the port's generator state dict) on ``ResNetG()``."""
    variables = seeded_variables(JaxResNetG(), np.random.RandomState(0), jnp.zeros((2, 32)))
    jax_w = JaxGanWrapper(variables, JaxResNetG(), num_latents=10, num_pca_samples=PCA_SAMPLES)
    sd = resnet_g_from_jax(variables)
    state = tuple(np.asarray(a) for a in (jax_w.z_list, jax_w.z, jax_w.U))
    return jax_w, GanWrapper(sd, device="cpu", state=state), sd


def test_pca_basis_from_the_same_intermediates(wrappers):
    jax_w, port, _ = wrappers
    z = jax.random.normal(jax.random.split(jax.random.PRNGKey(0))[1], (PCA_SAMPLES, 32))
    _, inter = jax_w.generator.apply(jax_w.g_variables, z, return_intermediate=True)
    np.testing.assert_array_equal(pca_basis(np.asarray(inter), np.asarray(z)), np.asarray(jax_w.U))
    own = pca_basis(port.intermediate(torch.tensor(np.asarray(z))).numpy(), np.asarray(z))
    assert own.shape == (6, 32)
    np.testing.assert_allclose(own, np.asarray(jax_w.U), atol=1e-4)


def test_modify_embed_with_carried_state(wrappers):
    jax_w, port, _ = wrappers
    for seed in (0, 3):
        jax_w.set_latent(seed)
        port.set_latent(seed)
        embeds = []
        for sliders in SLIDERS:
            got = port.modify_embed(np.asarray(sliders, np.float32))
            np.testing.assert_allclose(got, jax_w.modify_embed(np.asarray(sliders, np.float32)),
                                       atol=2e-5, rtol=1e-4)
            embeds.append(got)
        assert not np.allclose(embeds[0], embeds[1])


def test_wrapper_draws_bank_and_basis_from_its_seed(wrappers):
    *_, sd = wrappers
    make = lambda seed: GanWrapper(sd, num_latents=10, num_pca_samples=PCA_SAMPLES, seed=seed,
                                   device="cpu")
    a, b, c = make(0), make(0), make(1)
    for x, y in zip(a.state(), b.state()):
        np.testing.assert_array_equal(x, y)
    assert a.state()[0].shape == (10, 32) and a.state()[2].shape == (6, 32)
    assert not np.array_equal(a.state()[0], c.state()[0])
    a.reset_default_latent(torch.Generator().manual_seed(5))
    assert not np.array_equal(a.modify_embed(np.zeros(6)), b.modify_embed(np.zeros(6)))


@pytest.fixture(scope="module")
def controllable(wrappers):
    torch.manual_seed(0)
    tts = ToucanTTS(ToucanTTSConfig(**TINY))
    vocoder = HiFiGANGenerator(channels=64)
    iface = ToucanTTSInterface(tts.state_dict(), vocoder.state_dict(),
                               config=ToucanTTSConfig(**TINY), vocoder=HiFiGANGenerator(channels=64),
                               use_g2p=False, device="cpu")
    return ControllableInterface(iface, wrappers[1])


def _expected(ci, prompt, seed, sliders, **kw):
    """The interface's own 24 kHz call with the slider embedding and glow
    noise drawn after ``manual_seed(seed)``."""
    ci.wgan.set_latent(seed)
    ci.model.set_utterance_embedding(embedding=ci.wgan.modify_embed(np.asarray(sliders, np.float32)))
    ci.model.generator.manual_seed(seed)
    return ci.model(prompt, **kw)


def test_read_doubles_to_48k(controllable):
    ci = controllable
    ci.model.generator.manual_seed(4)
    sr, wave = ci.read(IPA, voice_seed=4, emb_slider_2=1.5, input_is_phones=True)
    want = _expected(ci, IPA, 4, [0, 1.5, 0, 0, 0, 0], input_is_phones=True)
    assert sr == 48000 and len(want) > 0
    np.testing.assert_array_equal(wave, np.repeat(want, 2))


def test_read_guards_the_phone_count(controllable):
    ci = controllable
    prompt = "This is a test. " * 125
    assert len(ci.model.text2phone.get_phone_string(prompt)) > MAX_PHONES
    ci.model.generator.manual_seed(2)
    _, wave = ci.read(prompt, voice_seed=2)
    np.testing.assert_array_equal(
        wave, np.repeat(_expected(ci, _TOO_LONG["English"], 2, np.zeros(6)), 2))


def test_read_returns_a_plot(controllable):
    sr, wave, path = controllable.read(IPA, language="German", input_is_phones=True,
                                       return_plot=True)
    try:
        assert sr == 48000 and len(wave) > 0 and controllable.current_language == "German"
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    finally:
        os.unlink(path)
