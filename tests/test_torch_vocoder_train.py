"""The port's vocoder training against the JAX package's, on the CPU.

The tiny generator of ``tests/test_vocoder_train.py`` (HiFiGAN of 32
channels with one residual stack of dilations 1 and 3; BigVGAN likewise) and the critic at
``channel_scale=0.05`` on 8 frames (3072 samples) get seeded variables in
the JAX layout, carried over by ``weights.py``.  Held against JAX:

- the generators' differentiable path with the Avocodo taps: wave and taps
  within 2e-5; against the port's no-grad path (the kernels' plain versions
  here) within 1e-6; the default path still goes through the kernel
  wrappers and the differentiable one through none;
- one adversarial step with the critic update from a JAX state built with
  ``g_lr = d_lr = LR``: RAdam's first update is ``lr * clip(g)``, so each
  net's ``p0 - p1`` is ``LR`` times its clipped gradient, read off JAX's
  step (no second ``jax.grad`` compile): metrics within rtol 1e-5, ``p0 -
  p1`` within 1e-4 of each tensor's peak beyond one f32 ulp of the
  parameter (each side's reading of ``p0 - p1`` rounds ``p1``; ``LR = 10``
  keeps that floor small beside most updates); then a second step from
  JAX's optimizer states after the first (live moments, count 1) on the
  seeded parameters, carried over by ``weights.vocoder_train_state_from_jax``,
  its update likewise;
- the warm-up step: its mel loss against JAX's ``mel_loss`` and its
  generator update against the clipped ``jax.grad`` of 45 x the mel loss;
- ``avocodo_pipeline``'s loop on a synthetic LJSpeech corpus: steps,
  checkpoint layout and keep-5, ``load.py::load_vocoder`` and resume.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.models.vocoders.bigvgan import BigVGAN as JaxBigVGAN
from toucan_tpu.models.vocoders.discriminators import \
    AvocodoJointDiscriminator as JaxJointDiscriminator
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu.train import vocoder_train as jax_vt
from toucan_tpu_torch import load
from toucan_tpu_torch.infer.interface import write_wav
from toucan_tpu_torch.models.vocoders import bigvgan as bigvgan_module
from toucan_tpu_torch.models.vocoders import hifigan as hifigan_module
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.discriminators import AvocodoJointDiscriminator
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.recipes import pipelines
from toucan_tpu_torch.train import vocoder_train as vt
from toucan_tpu_torch.weights import (avocodo_discriminator_from_jax, bigvgan_from_jax,
                                      hifigan_from_jax, vocoder_train_state_from_jax)

from test_torch_bigvgan import _bigvgan_variables
from test_torch_discriminators import jax_start_vector
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

FRAMES = 8
SEGMENT = FRAMES * 384
SCALE = 0.05
LR = 10.0
TINY_HIFIGAN = dict(channels=32, resblock_kernel_sizes=(3,))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def tiny_generators(kind):
    """(JAX generator, its seeded variables, the port's generator with them)."""
    rng = np.random.RandomState(0 if kind == "hifigan" else 1)
    mel = jnp.zeros((1, FRAMES, 80))
    if kind == "hifigan":
        jax_gen = JaxHiFiGAN(resblock_dilations=((1, 3),), **TINY_HIFIGAN)
        port = HiFiGANGenerator(resblock_dilations=(1, 3), **TINY_HIFIGAN)
        convert = hifigan_from_jax
    else:
        jax_gen = JaxBigVGAN(resblock_dilations=((1, 3),), **TINY_HIFIGAN)
        port = BigVGAN(resblock_dilations=(1, 3), **TINY_HIFIGAN)
        convert = bigvgan_from_jax
    variables = seeded_variables(jax_gen, rng, mel, return_intermediates=True)
    if kind == "bigvgan":  # live activations, kernels at gain 0.8 (test_torch_bigvgan.py)
        variables = _bigvgan_variables(variables, rng)
    port.load_state_dict(convert(variables))
    return jax_gen, variables, port


@pytest.fixture(scope="module")
def hifigan():
    return tiny_generators("hifigan")


def tiny_critic(rng):
    """The JAX critic's seeded variables (weight-norm gains in [0.5, 1.5])."""
    jax_disc = JaxJointDiscriminator(channel_scale=SCALE)
    wave = jnp.zeros((1, SEGMENT, 1))
    variables = seeded_variables(jax_disc, rng, wave, wave[:, ::2], wave[:, ::8])
    return jax_disc, jax.tree_util.tree_map_with_path(
        lambda path, a: (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if path[-1].key == "g" else a, variables)


def batch(seed):
    rng = np.random.RandomState(seed)
    return dict(gold_wave=(0.1 * rng.randn(1, SEGMENT, 1)).astype(np.float32),
                mel=rng.randn(1, FRAMES, 80).astype(np.float32))


# --------------------------------------------------------------- generators

@pytest.mark.parametrize("kind", ["hifigan", "bigvgan"])
def test_differentiable_path_with_taps_matches_jax_and_the_no_grad_path(kind, hifigan):
    jax_gen, variables, port = hifigan if kind == "hifigan" else tiny_generators(kind)
    mel = np.random.RandomState(2).randn(1, FRAMES, 80).astype(np.float32)
    want = _np(jax.jit(jax_gen.apply, static_argnames="return_intermediates")(
        variables, jnp.asarray(mel), return_intermediates=True))
    got = port(_t(mel), return_intermediates=True, differentiable=True)
    assert got[0].requires_grad
    shapes = [(1, SEGMENT, 1), (1, SEGMENT // 2, 1), (1, SEGMENT // 8, 1)]
    for g, w, shape in zip(got, want, shapes):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g.detach().numpy(), w, atol=2e-5, rtol=0)
    plain = port(_t(mel), return_intermediates=True)
    assert not plain[0].requires_grad
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.detach().numpy(), p.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["hifigan", "bigvgan"])
def test_only_the_default_path_reaches_the_kernel_wrappers(kind, hifigan, monkeypatch):
    """The default path calls K2 (K5), the differentiable one calls none;
    the choice is the argument, not the grad mode."""
    module, name = ((hifigan_module, "hifigan_stage") if kind == "hifigan"
                    else (bigvgan_module, "alias_free_snake"))
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or real(*a))
    port = hifigan[2] if kind == "hifigan" else BigVGAN(resblock_dilations=(1, 3),
                                                        **TINY_HIFIGAN)
    mel = torch.randn(1, 2, 80)
    with torch.enable_grad():
        port(mel)
    n_default = len(calls)
    with torch.no_grad():
        port(mel, differentiable=True)
    assert n_default == (4 if kind == "hifigan" else 4 * 4 + 1)
    assert len(calls) == n_default


# -------------------------------------------------------------------- steps

@pytest.fixture(scope="module")
def jax_run(hifigan):
    """Two adversarial JAX steps with the critic update (one compile) from a
    state built with g_lr = d_lr = LR, on two batches; the second from the
    first's optimizer states and the seeded parameters."""
    jax_gen, g_vars, _ = hifigan
    jax_disc, d_vars = tiny_critic(np.random.RandomState(3))
    opts = jax_vt.make_vocoder_optimizers(LR, LR)
    state0 = jax_vt.VocoderTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
        g_opt_state=opts[0].init(g_vars["params"]), d_params=d_vars["params"],
        d_opt_state=opts[1].init(d_vars["params"]))
    step = jax.jit(jax_vt.make_vocoder_train_step(opts, jax_gen, jax_disc, use_adversarial=True),
                   static_argnums=2)
    batches = [batch(5), batch(6)]
    state1, m1 = step(state0, jax.tree.map(jnp.asarray, batches[0]), True)
    # the second step starts from the moments and count of the first and the
    # parameters of before it: a step of rate LR moves this tiny generator
    # far from the seeded weights, to a near-silent wave whose log-mel no
    # longer compares in f32
    restart = state1.replace(g_params=state0.g_params, d_params=state0.d_params)
    state2, m2 = step(restart, jax.tree.map(jnp.asarray, batches[1]), True)
    return dict(g_vars=g_vars, d_vars=d_vars, states=[state0, state1, restart, state2],
                metrics=[_np(m1), _np(m2)], batches=batches)


def port_state(g_params, d_params):
    gen = HiFiGANGenerator(resblock_dilations=(1, 3), **TINY_HIFIGAN)
    gen.load_state_dict(hifigan_from_jax({"params": g_params}))
    disc = AvocodoJointDiscriminator(channel_scale=SCALE, segment=SEGMENT)
    disc.load_state_dict(avocodo_discriminator_from_jax({"params": d_params}, disc,
                                                        jax_start_vector))
    return vt.create_vocoder_train_state(gen, disc, g_lr=LR, d_lr=LR, device="cpu")


def _sd(state):
    return ({k: v.detach().clone().double() for k, v in state.generator.state_dict().items()},
            {k: v.detach().clone().double() for k, v in state.discriminator.state_dict().items()})


def _jax_sd(state):
    g = hifigan_from_jax({"params": _np(state.g_params)})
    d = avocodo_discriminator_from_jax({"params": _np(state.d_params)},
                                       AvocodoJointDiscriminator(channel_scale=SCALE,
                                                                 segment=SEGMENT),
                                       jax_start_vector)
    return ({k: v.double() for k, v in g.items()}, {k: v.double() for k, v in d.items()})


def _check_updates(before, after, want_before, want_after):
    """Each tensor's update within 1e-4 of the JAX update's peak, beyond one
    f32 ulp of the parameter: each side reads its update as ``p0 - p1``, and
    rounding p1 to f32 costs each up to half an ulp."""
    for got0, got1, w0, w1 in zip(before, after, want_before, want_after):
        for k in w0:
            if k.endswith("u0"):
                continue
            want = w0[k] - w1[k]
            ulp = torch.from_numpy(np.spacing(np.maximum(w0[k].abs(), w1[k].abs()).float()
                                              .numpy())).double()
            err = ((got0[k] - got1[k] - want).abs() - ulp).max().item()
            assert err <= 1e-4 * max(want.abs().max().item(), 1e-12), (k, err)


def _check_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)


def test_adversarial_step_matches_jax(jax_run):
    s0, s1, _, _ = jax_run["states"]
    state = port_state(_np(s0.g_params), _np(s0.d_params))
    step = vt.make_vocoder_train_step(use_adversarial=True)
    before = _sd(state)
    metrics = step(state, {k: _t(v) for k, v in jax_run["batches"][0].items()}, True)
    _check_metrics(metrics, jax_run["metrics"][0])
    _check_updates(before, _sd(state), _jax_sd(s0), _jax_sd(s1))
    assert state.step == 1


def test_second_step_from_a_jax_state_matches_jax(jax_run):
    """JAX's optimizer states after one step (moments and count live) on the
    seeded parameters, carried over by ``vocoder_train_state_from_jax``,
    then one more step on both sides."""
    s0, _, s1, s2 = jax_run["states"]
    state = port_state(_np(s0.g_params), _np(s0.d_params))
    g_adam, d_adam = s1.g_opt_state[1][0], s1.d_opt_state[1][0]
    vocoder_train_state_from_jax(
        state, _np(s1.g_params), _np(s1.d_params), _np(g_adam.mu), _np(g_adam.nu),
        _np(d_adam.mu), _np(d_adam.nu), int(g_adam.count), int(d_adam.count), int(s1.step),
        start_vector=jax_start_vector)
    assert state.step == 1 and state.g_scheduler.last_epoch == 1
    before = _sd(state)
    metrics = vt.make_vocoder_train_step(use_adversarial=True)(
        state, {k: _t(v) for k, v in jax_run["batches"][1].items()}, True)
    _check_metrics(metrics, jax_run["metrics"][1])
    _check_updates(before, _sd(state), _jax_sd(s1), _jax_sd(s2))


def test_warmup_step_matches_the_mel_loss_and_its_gradient(jax_run, hifigan):
    jax_gen, g_vars, _ = hifigan
    b = jax_run["batches"][0]
    mel, gold = jnp.asarray(b["mel"]), jnp.asarray(b["gold_wave"])

    def loss(params):
        wave = jax_gen.apply({"params": params}, mel, return_intermediates=True)[0]
        return 45.0 * jax_vt.mel_loss(wave[..., 0], gold[..., 0])

    value, grads = jax.jit(jax.value_and_grad(loss))(g_vars["params"])
    grads = _np(optax.clip_by_global_norm(10.0).update(grads, None)[0])
    s0 = jax_run["states"][0]
    state = port_state(_np(s0.g_params), _np(s0.d_params))
    before = _sd(state)
    metrics = vt.make_vocoder_train_step(use_adversarial=False)(
        state, {k: _t(v) for k, v in b.items()}, True)
    assert set(metrics) == {"mel_loss", "generator_total"}
    np.testing.assert_allclose(metrics["generator_total"].item(), float(value), rtol=1e-5)
    want = hifigan_from_jax({"params": grads})
    for k, g in want.items():
        got = (before[0][k] - state.generator.state_dict()[k].double()) / LR
        assert (got - g.double()).abs().max() <= 1e-4 * max(g.abs().max().item(), 1e-12), k
    # the critic does not move in the warm-up
    for k, v in state.discriminator.state_dict().items():
        torch.testing.assert_close(v.double(), before[1][k], rtol=0, atol=0)


# ------------------------------------------------------------------ pipeline

def write_ljspeech(root, n=4, seed=0, sr=22050):
    """A seeded LJSpeech layout (metadata.csv and wavs/) of harmonic tones
    with noise, 0.8-1.2 s each."""
    base = os.path.join(root, "LJSpeech", "LJSpeech-1.1")
    os.makedirs(os.path.join(base, "wavs"))
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        t = np.arange(int(sr * rng.uniform(0.8, 1.2))) / sr
        f0 = rng.uniform(90, 250)
        wave = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
        wave = 0.3 * wave / np.abs(wave).max() + 0.01 * rng.randn(len(t))
        write_wav(os.path.join(base, "wavs", f"LJ{i:03d}.wav"), wave.astype(np.float32), sr)
        lines.append(f"LJ{i:03d}|text {i}|text {i}")
    with open(os.path.join(base, "metadata.csv"), "w") as f:
        f.write("\n".join(lines))


def test_pipeline_runs_checkpoints_keeps_five_and_resumes(tmp_path, monkeypatch):
    write_ljspeech(tmp_path / "corpora")
    monkeypatch.setenv("TOUCAN_CORPORA_ROOT", str(tmp_path / "corpora"))
    monkeypatch.setattr(pipelines, "CHECKPOINT_EVERY", 1)
    seen = []
    gen = HiFiGANGenerator(resblock_dilations=(1, 3), **TINY_HIFIGAN)
    disc = AvocodoJointDiscriminator(channel_scale=SCALE,
                                     generator=torch.Generator().manual_seed(0))
    save = tmp_path / "Avocodo"
    state = pipelines._vocoder_pipeline(
        "Avocodo", gen, steps=6, batch_size=2, generator_warmup=-99, model_dir=str(save),
        device="cpu", discriminator=disc, callbacks=[lambda s, m: seen.append((s, set(m)))])
    assert state.step == 6
    warm, adv = {"mel_loss", "generator_total"}, {"mel_loss", "generator_total",
                                                  "adversarial_loss", "feature_matching_loss"}
    assert seen == [(0, warm), (1, warm), (2, adv), (3, adv | {"discriminator_loss"}),
                    (4, adv), (5, adv)]
    assert sorted(os.listdir(save)) == [f"checkpoint_{s}.pt" for s in range(1, 6)]
    sd = load.load_vocoder(str(save / "checkpoint_5.pt"))
    for k, v in state.generator.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    fresh = vt.create_vocoder_train_state(
        HiFiGANGenerator(resblock_dilations=(1, 3), **TINY_HIFIGAN),
        AvocodoJointDiscriminator(channel_scale=SCALE), device="cpu")
    vt.load_vocoder_checkpoint(str(save / "checkpoint_5.pt"), fresh)
    assert fresh.step == 6 and fresh.d_scheduler.last_epoch == 1
    for a, b in ((fresh.discriminator, state.discriminator), (fresh.generator, state.generator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(v, w, rtol=0, atol=0)
    p = next(fresh.d_optimizer.state.values().__iter__())
    assert int(p["step"]) == 1
