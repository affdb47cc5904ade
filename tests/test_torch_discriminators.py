"""The vocoder critics, their norms, losses and optimizer, against the JAX package.

On the CPU, the same seeded variables (in the JAX layout, carried over by
``weights.avocodo_discriminator_from_jax``) and the same numpy inputs go
through both packages:

- ``NormedConv`` in each norm, 1-D "SAME" with stride and groups and 2-D
  with explicit padding: outputs within 1e-6; the spectral sigma, with
  JAX's start vector injected, within 1e-6 relative;
- the PQMF bands and every feature map and score of the 17 critics of
  ``AvocodoJointDiscriminator(channel_scale=0.05)`` at 8 frames (3072
  samples), in JAX's order, within 1e-5 of each tensor's peak;
- the mel, adversarial and feature-matching losses within rtol 1e-5;
- the optimizer: 8 steps of optax's ``chain(clip_by_global_norm, radam)``
  (both branches of the rectification) on fixed gradients, parameters
  within 1e-6 relative; the vocoder schedule at its milestones;
- ``VocoderDataset`` on WAV files written here: equal segments and noise
  draws for a seed, mels in power within 1e-4 of each mel's peak;
- the critic's converter round-trips exactly.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.data.vocoder_data import VocoderDataset as JaxVocoderDataset
from toucan_tpu.models.vocoders.discriminators import \
    AvocodoJointDiscriminator as JaxJointDiscriminator
from toucan_tpu.models.vocoders.discriminators import pqmf_analysis as jax_pqmf
from toucan_tpu.nn.param_norm import NormedConv as JaxNormedConv
from toucan_tpu.train import vocoder_train as jax_vt
from toucan_tpu_torch.data.vocoder_data import VocoderDataset
from toucan_tpu_torch.infer.interface import write_wav
from toucan_tpu_torch.models.vocoders.discriminators import (AvocodoJointDiscriminator,
                                                             pqmf_analysis)
from toucan_tpu_torch.nn.param_norm import NormedConv
from toucan_tpu_torch.train import vocoder_train as vt
from toucan_tpu_torch.train.radam import RAdam
from toucan_tpu_torch.train.schedules import VocoderScheduler
from toucan_tpu_torch.train.toucan_train import clip_by_global_norm
from toucan_tpu_torch.weights import (avocodo_discriminator_from_jax,
                                      avocodo_discriminator_to_jax)

from test_torch_modules import seeded_variables

torch.set_num_threads(2)

SCALE = 0.05
FRAMES = 8
SEGMENT = FRAMES * 384


def jax_start_vector(out):
    """JAX's spectral-norm start (``toucan_tpu/nn/param_norm.py:68``)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(7), (out,), jnp.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def to_jax_layout(x):
    """(B, C, ...) -> (B, ..., C), the JAX module's layout."""
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _peak_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------- NormedConv

CONVS = {
    "1d_same_strided_grouped": dict(cin=8, t=(50,), kw=dict(features=12, kernel_size=(41,),
                                                             strides=(4,),
                                                             feature_group_count=4)),
    "1d_dilated": dict(cin=4, t=(37,), kw=dict(features=6, kernel_size=(5,),
                                                kernel_dilation=(3,))),
    "2d_explicit": dict(cin=3, t=(17, 3), kw=dict(features=5, kernel_size=(5, 1),
                                                   strides=(3, 1),
                                                   padding=((2, 2), (0, 0)))),
}


def _port_conv(cin, kw, norm):
    return NormedConv(cin, kw["features"], kw["kernel_size"], kw.get("strides"),
                      kw.get("padding", "SAME"), kw.get("feature_group_count", 1),
                      kw.get("kernel_dilation"), norm=norm)


@pytest.mark.parametrize("norm", ["weight", "spectral", "none"])
@pytest.mark.parametrize("case", sorted(CONVS))
def test_normed_conv_matches_jax(case, norm):
    spec = CONVS[case]
    rng = np.random.RandomState(0)
    x = rng.randn(2, *spec["t"], spec["cin"]).astype(np.float32)
    jax_conv = JaxNormedConv(norm=norm, **spec["kw"])
    variables = seeded_variables(jax_conv, rng, jnp.asarray(x))
    if norm == "weight":
        variables["params"]["g"] = (0.5 + rng.rand(spec["kw"]["features"])).astype(np.float32)
    want = np.asarray(jax.jit(jax_conv.apply)(variables, jnp.asarray(x)))
    port = _port_conv(spec["cin"], spec["kw"], norm)
    sd = avocodo_discriminator_from_jax({"params": {"c": variables["params"]}},
                                        torch.nn.ModuleDict({"c": port}), jax_start_vector)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = to_jax_layout(port(torch.from_numpy(np.moveaxis(x, -1, 1).copy())))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if norm == "spectral":
        # JAX's sigma: the same conv without norm and bias, over the normed one
        plain = JaxNormedConv(norm="none", **spec["kw"])
        nobias = dict(variables["params"], bias=np.zeros_like(variables["params"]["bias"]))
        y0 = np.asarray(plain.apply({"params": nobias}, jnp.asarray(x)), np.float64)
        y1 = np.asarray(jax_conv.apply({"params": nobias}, jnp.asarray(x)), np.float64)
        sigma_jax = (y0 * y1).sum() / (y1 * y1).sum()
        assert abs(port.sigma().item() / sigma_jax - 1) < 1e-6


def test_same_padding_is_asymmetric_with_stride():
    """At T = 12288, k = 41, s = 4 XLA pads 18 before and 19 after; a
    symmetric padding of 20 gives the same length and shifted samples."""
    from toucan_tpu_torch.nn.param_norm import same_padding
    assert same_padding(12288, 41, 4) == (18, 19)
    assert same_padding(12288, 41, 1) == (20, 20)


def test_weight_norm_starts_at_unit_gain():
    conv = NormedConv(4, 6, (5,), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(conv.kernel(), conv.weight_v, atol=1e-7, rtol=1e-6)


# ----------------------------------------------------------------- critics

@pytest.fixture(scope="module")
def critics():
    """JAX's and the port's tiny joint critics on the same seeded variables,
    and both packages' outputs on a fake (with taps) and a real wave."""
    rng = np.random.RandomState(0)
    jax_disc = JaxJointDiscriminator(channel_scale=SCALE)
    wave = jnp.zeros((1, SEGMENT, 1))
    variables = seeded_variables(jax_disc, rng, wave, wave[:, ::2], wave[:, ::8])
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if path[-1].key == "g" else a, variables)
    fake = [(0.1 * rng.randn(1, n, 1)).astype(np.float32)
            for n in (SEGMENT, SEGMENT // 2, SEGMENT // 8)]
    real = (0.1 * rng.randn(1, SEGMENT, 1)).astype(np.float32)
    apply = jax.jit(jax_disc.apply)
    want_fake = jax.tree.map(np.asarray, apply(variables, *map(jnp.asarray, fake)))
    want_real = jax.tree.map(np.asarray, apply(variables, jnp.asarray(real)))
    port = AvocodoJointDiscriminator(channel_scale=SCALE, segment=SEGMENT)
    port.load_state_dict(avocodo_discriminator_from_jax(variables, port, jax_start_vector))
    got_fake = port(*map(_t, fake))
    got_real = port(_t(real))
    return dict(variables=variables, port=port, fake=fake, real=real, want_fake=want_fake,
                want_real=want_real, got_fake=got_fake, got_real=got_real)


def test_critics_feature_maps_and_scores_match_jax(critics):
    for which in ("fake", "real"):
        got, want = critics[f"got_{which}"], critics[f"want_{which}"]
        assert len(got) == len(want) == 17
        for i, (g_outs, w_outs) in enumerate(zip(got, want)):
            assert len(g_outs) == len(w_outs)
            for j, (g, w) in enumerate(zip(g_outs, w_outs)):
                g = to_jax_layout(g) if g.dim() > 2 else g.detach().numpy()
                assert g.shape == w.shape, (which, i, j)
                assert _peak_err(g, w) < 1e-5, (which, i, j, _peak_err(g, w))


def test_combd_shares_its_band_critics(critics):
    """combd_1 and combd_2 each run twice (the generator's tap, then the
    PQMF band) with one set of weights; without taps both runs see the
    band."""
    port = critics["port"]
    n_convs = len(list(port.mcmbd.combd_1.parameters()))
    assert len(list(port.mcmbd.parameters())) == 3 * n_convs
    wave = _t(critics["fake"][0]).transpose(1, 2)
    with torch.no_grad():
        outs = port.mcmbd(wave)
    for a, b in ((outs[1], outs[3]), (outs[2], outs[4])):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("n,taps,cutoff,beta", [(2, 256, 0.25, 10.0), (8, 192, 0.13, 10.0),
                                                 (16, 256, 0.03, 10.0), (64, 256, 0.1, 9.0)])
def test_pqmf_bands_match_jax(n, taps, cutoff, beta):
    x = np.random.RandomState(n).randn(2, SEGMENT, 1).astype(np.float32)
    want = np.asarray(jax_pqmf(jnp.asarray(x), n, taps, cutoff, beta))
    got = to_jax_layout(pqmf_analysis(_t(x).transpose(1, 2), n, taps, cutoff, beta))
    assert got.shape == want.shape == (2, SEGMENT // n, n)
    assert _peak_err(got, want) < 1e-5


def test_losses_match_jax(critics):
    got_f, got_r = critics["got_fake"], critics["got_real"]
    want_f, want_r = critics["want_fake"], critics["want_real"]
    j = jax.tree.map(jnp.asarray, (want_f, want_r))
    pairs = [(vt.generator_adversarial_loss(got_f), jax_vt.generator_adversarial_loss(j[0])),
             (vt.discriminator_adversarial_loss(got_f, got_r),
              jax_vt.discriminator_adversarial_loss(*j)),
             (vt.feature_matching_loss(got_f, got_r), jax_vt.feature_matching_loss(*j))]
    rng = np.random.RandomState(3)
    a, b = (0.1 * rng.randn(2, SEGMENT)).astype(np.float32), \
        (0.1 * rng.randn(2, SEGMENT)).astype(np.float32)
    pairs.append((vt.mel_loss(_t(a), _t(b)), jax_vt.mel_loss(jnp.asarray(a), jnp.asarray(b))))
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_feature_matching_takes_no_gradient_from_real_features(critics):
    fake = [_t(w).requires_grad_() for w in critics["fake"]]
    real = _t(critics["real"]).requires_grad_()
    port = critics["port"]
    loss = vt.feature_matching_loss(port(*fake), port(real))
    grads = torch.autograd.grad(loss, [fake[0], real], allow_unused=True)
    assert grads[0] is not None and grads[0].abs().max() > 0
    assert grads[1] is None


def test_critic_converter_round_trips(critics):
    back = avocodo_discriminator_to_jax(critics["port"])
    want = critics["variables"]["params"]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_back.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[k], np.asarray(v))


# --------------------------------------------------------------- optimizer

OPTIMIZERS = {
    # the vocoders': clip 10, betas (0.5, 0.9), rectified from update 6
    "vocoder": dict(clip=10.0, lr=1e-3, betas=(0.5, 0.9)),
    # the aligner's: clip 1, optax's default betas
    "aligner": dict(clip=1.0, lr=1e-4, betas=(0.9, 0.999)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_radam_matches_optax_over_both_branches(name):
    cfg = OPTIMIZERS[name]
    rng = np.random.RandomState(1)
    shapes = [(7, 5), (11,), (3, 2, 4)]
    params0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * (0.3 if k % 2 else 8.0)).astype(np.float32) for s in shapes]
             for k in range(8)]
    sched = jax_vt.vocoder_schedule(cfg["lr"]) if name == "vocoder" else cfg["lr"]
    opt = optax.chain(optax.clip_by_global_norm(cfg["clip"]),
                      optax.radam(sched, b1=cfg["betas"][0], b2=cfg["betas"][1]))
    jp = [jnp.asarray(p) for p in params0]
    state = opt.init(jp)
    update = jax.jit(opt.update)
    for g in grads:
        u, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, u)
    tp = [torch.nn.Parameter(_t(p)) for p in params0]
    radam = RAdam(tp, lr=cfg["lr"], betas=cfg["betas"])
    sched_t = VocoderScheduler(radam, cfg["lr"]) if name == "vocoder" else None
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = _t(x)
        clip_by_global_norm([p.grad for p in tp], cfg["clip"])
        radam.step()
        if sched_t:
            sched_t.step()
    for got, want in zip(tp, jp):
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("step", [0, 1, 499_999, 500_000, 1_000_000, 1_200_000, 1_399_999,
                                  1_400_000])
def test_vocoder_schedule_matches_jax(step):
    opt = RAdam([torch.nn.Parameter(torch.zeros(1))], lr=1e-3)
    sched = VocoderScheduler(opt, 1e-3)
    sched.last_epoch = step
    np.testing.assert_allclose(sched.get_lr()[0],
                               float(jax_vt.vocoder_schedule(1e-3)(jnp.asarray(step))), rtol=1e-6)


# ----------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def wav_paths(tmp_path_factory):
    """Six seeded harmonic tones with noise, 1.2-2.4 s at 22050 Hz, PCM16."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.RandomState(4)
    paths = []
    for i in range(6):
        n = int(22050 * rng.uniform(1.2, 2.4))
        t = np.arange(n) / 22050
        f0 = rng.uniform(90, 250)
        wave = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
        wave = 0.3 * wave / np.abs(wave).max() + 0.01 * rng.randn(n)
        path = root / f"utt_{i}.wav"
        write_wav(path, wave.astype(np.float32), 22050)
        paths.append(str(path))
    return paths


def test_vocoder_dataset_matches_jax(wav_paths):
    jax_ds = JaxVocoderDataset(wav_paths, seed=5, noise_prob=0.5)
    port_ds = VocoderDataset(wav_paths, seed=5, noise_prob=0.5)
    want = jax_ds.sample_batch(6)
    got = port_ds.sample_batch(6)
    assert got["gold_wave"].shape == (6, 12288, 1) and got["mel"].shape == (6, 32, 80)
    np.testing.assert_array_equal(got["gold_wave"], want["gold_wave"])
    # the log10 mel magnifies the f32 FFT's rounding (relative to the
    # spectrum's peak) in the quietest bins of these tones: held in power,
    # within 1e-4 of each mel's peak, as chip_smoke.py holds the cloner's
    # mel (TOL_MEL_POWER)
    got_p, want_p = 10.0 ** got["mel"].astype(np.float64), 10.0 ** want["mel"].astype(np.float64)
    err = np.abs(got_p - want_p).max((1, 2)) / want_p.max((1, 2))
    assert err.max() < 1e-4, err
    # the generators are in the same state: the same draws follow
    assert port_ds.rng.randint(1 << 30) == jax_ds.rng.randint(1 << 30)
