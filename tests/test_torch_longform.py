"""The port's time-sharded long-form vocoding and the interface's ``mesh=``
path, on gloo CPU ranks (``tests/torch_dist_worker.py``; 2 and 4 ranks,
started once each for the module), against JAX and against the port
unsharded.

- the collectives: the all-reduce route of ``all_gather`` and ``ppermute``
  equals gloo's native ``all_gather`` on CPU tensors, and both are right;
- HiFiGAN (32 channels, one stack of kernel 3) and BigVGAN (32 channels,
  one AMP block of kernel 3; seeded, BigVGAN as
  ``tests/test_torch_bigvgan.py::_bigvgan_variables``), with every bias nonzero
  (``tests/test_longform.py::_randomize_biases``), so a wrong edge halo
  shows, against the port unsharded: ragged mels (HiFiGAN 515 frames,
  BigVGAN 258, padded on 2 and 4 ranks, the tail patched), and a short one
  (the whole-input path); and a HiFiGAN mel of 512 frames
  against JAX's ``synthesize_longform`` on the 8-device CPU mesh of
  ``tests/conftest.py``, which shards it (512 >= 2 x 32 x 8; JAX's own
  HiFiGAN tests use 320 frames, which it vocodes whole); all within atol
  2e-5.  The unsharded BigVGAN is held against JAX's by
  ``tests/test_torch_bigvgan.py``;
- ``ToucanTTSInterface(mesh=..., longform_frames=512)`` on a long input
  with durations and glow noise injected, against the port's interface
  without a mesh and the JAX interface without one (which JAX's
  ``tests/test_pipelined_longform.py`` holds to its ``mesh=`` path at
  2e-6), within atol 2e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.dist import make_mesh as jax_make_mesh
from toucan_tpu.dist.longform import synthesize_longform as jax_longform
from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.models.gst import StyleEmbedding
from toucan_tpu.models.toucan_tts import ToucanTTS
from toucan_tpu.models.vocoders import BigVGAN as JaxBigVGAN
from toucan_tpu.models.vocoders import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu_torch.weights import bigvgan_from_jax, hifigan_from_jax, toucan_tts_from_jax

import torch_dist_worker as worker
from test_longform import _randomize_biases
from test_torch_bigvgan import _bigvgan_variables
from test_pipelined_longform import TINY as JAX_TINY
from test_torch_modules import seeded_variables
from test_torch_train import FIELDS

WORLDS = [2, 4]
# one stack of kernel 3 (the JAX side's 8-device compile is 20 s, 38 s with
# the kernel-11 stack of tests/test_longform.py); the halo at the full
# generator's receptive field is held on the card (chip_smoke.py)
JAX_HIFIGAN = dict(channels=32, resblock_kernel_sizes=(3,), resblock_dilations=((1,),))
PHONES = "~" + "ðɪs ɪz ə tˈɛst " * 16 + "~#"


def tiny_models():
    """``tests/test_pipelined_longform.py``'s tiny models with seeded
    variables (no init to compile)."""
    model, voc = ToucanTTS(JAX_TINY), JaxHiFiGAN(**JAX_HIFIGAN)
    tts_vars = seeded_variables(model, np.random.RandomState(7), jnp.zeros((1, 8, 62)),
                                jnp.array([8]), 32, utterance_embedding=jnp.zeros((1, 64)),
                                lang_ids=jnp.zeros((1, 1), jnp.int32), method=ToucanTTS.infer)
    # the vocoder at its init's scale, as JAX's test has it: kernels
    # N(0, 0.01), biases zero.  The plain path vocodes the bucket (zeroed
    # frames past the mel's end, which the transposed convs spill into) and
    # the long path the mel cut at its true end: the last frames part by
    # far less than 2e-6 at this scale, in JAX as in the port, and by more
    # with live weights
    rng = np.random.RandomState(8)
    voc_vars = jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if "bias" in str(path[-1])
        else (0.01 * rng.randn(*a.shape)).astype(np.float32),
        seeded_variables(voc, rng, jnp.zeros((1, 16, 80))))
    gst_vars = seeded_variables(StyleEmbedding(), np.random.RandomState(9),
                                jnp.zeros((1, 20, 80)), jnp.array([20]))
    return model, tts_vars, voc, voc_vars, gst_vars


def _mel(seed, t):
    return np.random.RandomState(seed).randn(t, 80).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("longform")
    jax_hifi = JaxHiFiGAN(**JAX_HIFIGAN)
    jax_big = JaxBigVGAN(channels=32, resblock_kernel_sizes=(3,),
                         resblock_dilations=((1, 3, 5),))
    zeros = jnp.zeros((1, 16, 80))
    hifi_vars = _randomize_biases(seeded_variables(jax_hifi, np.random.RandomState(4), zeros))
    rng = np.random.RandomState(5)  # live activations, kernels at gain 0.8
    big_vars = _randomize_biases(_bigvgan_variables(seeded_variables(jax_big, rng, zeros), rng))
    kw = dict(channels=32, resblock_kernel_sizes=(3,), resblock_dilations=(1,))
    mels = {"hifigan": {"ragged": _mel(1, 515), "even": _mel(6, 512), "short": _mel(3, 100)},
            "bigvgan": {"ragged": _mel(2, 258)}}
    vocoders = {
        "hifigan": dict(kind="hifigan", kwargs=kw, sd=hifigan_from_jax(hifi_vars),
                        mels=mels["hifigan"]),
        "bigvgan": dict(kind="bigvgan", kwargs=dict(kw, resblock_dilations=(1, 3, 5)),
                        sd=bigvgan_from_jax(big_vars), mels=mels["bigvgan"])}
    model, tts_vars, voc, voc_vars, gst_vars = tiny_models()
    jax_plain = JaxInterface(tts_vars, voc_vars, gst_vars, config=JAX_TINY, vocoder=voc,
                             language="en", use_g2p=False)
    n = len(jax_plain.text2phone.string_to_features(PHONES, input_phonemes=True))
    durations = np.full(n, 8)
    noise = np.random.RandomState(0).randn(4096, 80).astype(np.float32) * 0.8
    interface = dict(tts=toucan_tts_from_jax(tts_vars), config={k: getattr(JAX_TINY, k)
                                                                for k in FIELDS},
                     voc=dict(kind="hifigan", kwargs=kw, sd=hifigan_from_jax(voc_vars)),
                     phones=PHONES, durations=durations, noise=noise, longform_frames=512)
    inp = dict(vocoders=vocoders, interface=interface)
    inp_path = str(d / "in.pt")
    torch.save(inp, inp_path)
    outs = {w: str(d / f"out_{w}.pt") for w in WORLDS}
    procs = {w: worker.start("longform", w, 1, inp_path, outs[w]) for w in WORLDS}
    try:
        unsharded = {}
        for name, spec in vocoders.items():
            voc_port = worker._vocoder(spec)
            with torch.no_grad():
                unsharded.update({f"{name}/{k}": voc_port(torch.from_numpy(m)[None])[0, :, 0]
                                  .numpy() for k, m in spec["mels"].items()})
        jax_out = {"hifigan/even": jax_longform(jax_hifi, hifi_vars, mels["hifigan"]["even"],
                                                jax_make_mesh(n_data=8, n_model=1))}
        jax_wave = jax_plain(PHONES, input_is_phones=True, durations=durations,
                             glow_noise=noise)
        plain = worker._interface_wave(interface, None)
    finally:
        for ps in procs.values():
            worker.wait(ps)
    return dict(ranks={w: torch.load(o, weights_only=False) for w, o in outs.items()},
                unsharded=unsharded, jax=jax_out, jax_wave=jax_wave, plain=plain)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_routes_agree(runs, world):
    got = runs["ranks"][world]
    want = torch.stack([torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(world)])
    for g in got["gather"]:
        assert torch.equal(g, want)
    # rank 0 receives from rank world-1 (shift 1) and from rank 1 (shift -1)
    a, b, c, e = got["ppermute"]
    assert torch.equal(a, want[world - 1]) and torch.equal(b, a)
    assert torch.equal(c, want[1]) and torch.equal(e, c)


@pytest.mark.parametrize("key", ["hifigan/ragged", "hifigan/even", "hifigan/short",
                                 "bigvgan/ragged"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_synthesis_matches_unsharded_and_jax(runs, world, key):
    got = runs["ranks"][world][key]
    want = runs["unsharded"][key]
    assert got.shape == want.shape == (want.size,)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if key in runs["jax"]:
        np.testing.assert_allclose(got, runs["jax"][key], atol=2e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_interface_mesh_path_matches_the_plain_interfaces(runs, world):
    got, plain = runs["ranks"][world]["interface"], runs["plain"]
    assert len(got) == len(plain) == len(runs["jax_wave"])
    assert len(got) / 24000.0 > 12.0  # past longform_frames
    np.testing.assert_allclose(got, plain, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, runs["jax_wave"], atol=2e-6, rtol=0)
