"""The port's sharded vocoder GAN step and data-parallel aligner step
against its single-process steps on the global batch and against JAX's
steps, on the CPU.

gloo ranks (``tests/torch_dist_worker.py``) on meshes (2, 1) and (1, 2),
started once per mesh for the module.  The tiny HiFiGAN and critic of
``tests/test_torch_vocoder_train.py`` take one adversarial step with the
critic update on a global batch of two segments; the aligner and its
``TinyTTS`` of ``tests/test_torch_aligner_train.py`` one step on two
utterances of unequal lengths.  On (1, 2) the generator's stage 0 and 1
residual convs are split on their output channels.

- against the single-process step, both in float64: every parameter,
  statistic and metric within 1e-6 of its tensor's peak (the vocoder's
  adversarial step with the critic update: the mel L1, the adversarial and
  feature-matching means and the critic's loss each weighted by the rank's
  share);
- in float32 against JAX's step on the global batch: the metrics within
  rtol 1e-5 and each parameter's update within 1e-4 of the JAX update's
  peak beyond one f32 ulp (the single-process vocoder test's bar: RAdam's
  first update is ``LR * clip(g)``); for the vocoder its warm-up step (the mel loss, the
  generator split on (1, 2)), since JAX's adversarial step takes about a
  minute to compile on the CPU; ``tests/test_torch_vocoder_train.py`` holds
  the single-process adversarial step against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import toucan_tpu.models.aligner as jax_aligner_module
from toucan_tpu.frontend.inventory import NUM_CTC_SYMBOLS
from toucan_tpu.models.aligner import Aligner as JaxAligner
from toucan_tpu.train import vocoder_train as jax_vt
from toucan_tpu.train.aligner_train import AlignerTrainState as JaxAlignerState
from toucan_tpu.train.aligner_train import TinyTTS as JaxTinyTTS
from toucan_tpu.train.aligner_train import make_aligner_train_step as jax_aligner_step
from toucan_tpu_torch.models.vocoders.discriminators import AvocodoJointDiscriminator
from toucan_tpu_torch.weights import (aligner_from_jax, avocodo_discriminator_from_jax,
                                      hifigan_from_jax, tiny_tts_from_jax)

import torch_dist_worker as worker
from test_torch_aligner_train import _NoDropout, _updates_match
from test_torch_discriminators import jax_start_vector
from test_torch_modules import seeded_variables
from test_torch_vocoder_train import (LR, SCALE, SEGMENT, TINY_HIFIGAN, _check_updates,
                                      _jax_sd, batch as voc_batch, tiny_critic,
                                      tiny_generators)

MESHES = [(2, 1), (1, 2)]
STEP = 1000   # the aligner's reconstruction weighs min(5, 1000 / 2000) = 0.5


def aligner_global_batch():
    rnd = np.random.RandomState(4)
    return dict(mel=rnd.randn(2, 24, 80).astype(np.float32),
                mel_lengths=np.array([24, 13], np.int32),
                tokens=rnd.randint(0, 100, size=(2, 6)).astype(np.int32),
                token_lengths=np.array([6, 3], np.int32),
                speaker_embeddings=rnd.randn(2, 192).astype(np.float32))


def _tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_gan")
    jax_gen, g_vars, _ = tiny_generators("hifigan")
    jax_disc, d_vars = tiny_critic(np.random.RandomState(3))
    vb = {k: np.concatenate([voc_batch(5)[k], voc_batch(6)[k]]) for k in ("gold_wave", "mel")}
    critic = dict(channel_scale=SCALE, segment=SEGMENT)
    ab = aligner_global_batch()
    rng = np.random.RandomState(1)
    mel, lens = jnp.asarray(ab["mel"]), jnp.asarray(ab["mel_lengths"])
    asr_vars = seeded_variables(JaxAligner(), rng, mel, lens)
    tts_vars = seeded_variables(JaxTinyTTS(), rng, jnp.zeros((2, 24, NUM_CTC_SYMBOLS + 192)),
                                lens, mel)
    inp = dict(
        vocoder=dict(generator=dict(resblock_dilations=(1, 3), **TINY_HIFIGAN), critic=critic,
                     g=hifigan_from_jax(g_vars),
                     d=avocodo_discriminator_from_jax(d_vars, AvocodoJointDiscriminator(
                         **critic), jax_start_vector),
                     lr=LR, batch=vb),
        aligner=dict(asr=aligner_from_jax(asr_vars), tts=tiny_tts_from_jax(tts_vars), lr=LR,
                     step=STEP, batch=ab))
    inp_path = str(d / "in.pt")
    torch.save(inp, inp_path)
    outs = {shape: str(d / f"out_{shape[0]}x{shape[1]}.pt") for shape in MESHES}
    procs = {shape: worker.start("gan_and_aligner", *shape, inp_path, outs[shape])
             for shape in MESHES}
    try:
        single = {"vocoder": worker.vocoder_step(inp["vocoder"], None),
                  "aligner": worker.aligner_step(inp["aligner"], None)}
        opts = jax_vt.make_vocoder_optimizers(LR, LR)
        v0 = jax_vt.VocoderTrainState(
            step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
            g_opt_state=opts[0].init(g_vars["params"]), d_params=d_vars["params"],
            d_opt_state=opts[1].init(d_vars["params"]))
        vstep = jax.jit(jax_vt.make_vocoder_train_step(opts, jax_gen, jax_disc,
                                                       use_adversarial=False), static_argnums=2)
        v1, vm = vstep(v0, jax.tree.map(jnp.asarray, vb), False)
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.radam(LR))
        a0 = JaxAlignerState(step=jnp.asarray(STEP, jnp.int32), asr_params=asr_vars["params"],
                             asr_batch_stats=asr_vars["batch_stats"],
                             asr_opt_state=opt.init(asr_vars["params"]),
                             tts_params=tts_vars["params"],
                             tts_opt_state=opt.init(tts_vars["params"]))
        mp = pytest.MonkeyPatch()
        mp.setattr(jax_aligner_module, "nn", _NoDropout())
        try:
            a1, am = jax.jit(jax_aligner_step(opt))(a0, jax.tree.map(jnp.asarray, ab),
                                                    jax.random.PRNGKey(0))
            jax.block_until_ready(am)
        finally:
            mp.undo()
    finally:
        for ps in procs.values():
            worker.wait(ps)
    jax_out = dict(vocoder=dict(before=_jax_sd(v0), after=_jax_sd(v1), metrics=_tree(vm)),
                   aligner=dict(before=[aligner_from_jax(asr_vars), tiny_tts_from_jax(tts_vars)],
                                after=[aligner_from_jax({"params": _tree(a1.asr_params),
                                                         "batch_stats": _tree(
                                                             a1.asr_batch_stats)}),
                                       tiny_tts_from_jax({"params": _tree(a1.tts_params)})],
                                metrics=_tree(am)))
    return inp, single, {s: torch.load(o, weights_only=False) for s, o in outs.items()}, jax_out


def _close(got, want, what):
    got, want = got.double(), want.double()
    peak = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * peak, (what, peak)


@pytest.mark.parametrize("net", ["vocoder", "aligner"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_equals_the_single_process_step(runs, shape, net):
    _, single, meshes, _ = runs
    got, want = meshes[shape][net]["64"], single[net]
    for part in want:
        assert got[part].keys() == want[part].keys(), part
        for k, v in want[part].items():
            if v.is_floating_point():
                _close(got[part][k], v, f"{part}.{k}")
            else:
                assert torch.equal(got[part][k], v), k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_vocoder_step_matches_jax(runs, shape):
    inp, _, meshes, jax_out = runs
    got, want = meshes[shape]["vocoder"]["32"], jax_out["vocoder"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].item(), float(v), rtol=1e-5, err_msg=k)
    before = ({k: v.double() for k, v in inp["vocoder"]["g"].items()},
              {k: v.double() for k, v in inp["vocoder"]["d"].items()})
    after = tuple({k: v.double() for k, v in got[n].items()} for n in ("g", "d"))
    _check_updates(before, after, want["before"], want["after"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_aligner_step_matches_jax(runs, shape):
    inp, _, meshes, jax_out = runs
    got, want = meshes[shape]["aligner"]["32"], jax_out["aligner"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].item(), float(v), rtol=1e-5, err_msg=k)
    for before, after, wb, wa in zip((inp["aligner"]["asr"], inp["aligner"]["tts"]),
                                     (got["asr"], got["tts"]), want["before"], want["after"]):
        _updates_match(before, after, wb, wa)
    for k, v in got["asr"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want["after"][0][k].numpy(), atol=1e-6,
                                       err_msg=k)
