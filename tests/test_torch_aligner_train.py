"""The port's aligner training, device MAS and embedding WGAN-QC against JAX, on the CPU.

- One aligner step (full-size ``Aligner()`` and ``TinyTTS()``, as JAX's step
  always builds them, on 2 utterances of at most 24 frames with feasible
  token counts) from a JAX state of seeded variables at step 1000 (so the
  reconstruction weighs 0.5) with RAdam at rate ``LR``: the losses within
  rtol 1e-5; RAdam's first update is ``LR * clip(g)``, so each net's
  ``p0 - p1`` is read off JAX's step and held within 1e-4 of each tensor's
  peak beyond one f32 ulp of the parameter; the BatchNorm statistics within
  1e-6.  JAX's step always drops at the aligner's fixed 0.5
  (``toucan_tpu/models/aligner.py:103``): here a test-time patch sets that
  rate to 0, and the port runs ``deterministic``.
- ``mas_torch`` gives the path of ``mas_numpy`` and ``mas_jax``, exactly.
- ``_aligner_train_fn`` runs its loop.
- WGAN-QC: ``solve_ot_lp`` is JAX's (the same scipy); one step with JAX's
  ``z``, potentials and plan injected: ``D``, ``WD`` and ``G`` within rtol
  1e-5, the critic's and the generator's Adam updates by the rule of
  ``tests/test_torch_train.py`` (within 2 lr everywhere, within 1e-3 lr
  where |g| > 1e-6), the generator's BatchNorm statistics after their two
  updates within 1e-6;
  ``resnet_d_from_jax`` round-trips exactly.
"""


import numpy as np
import optax
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

import toucan_tpu.models.aligner as jax_aligner_module
import toucan_tpu.models.embedding_gan as jax_gan_module
from toucan_tpu.models.aligner import Aligner as JaxAligner
from toucan_tpu.models.aligner import mas_jax, mas_numpy as jax_mas_numpy
from toucan_tpu.models.embedding_gan import ResNetD as JaxResNetD
from toucan_tpu.models.embedding_gan import ResNetG as JaxResNetG
from toucan_tpu.train.aligner_train import AlignerTrainState as JaxAlignerState
from toucan_tpu.train.aligner_train import TinyTTS as JaxTinyTTS
from toucan_tpu.train.aligner_train import make_aligner_train_step as jax_aligner_step
from toucan_tpu_torch.frontend.inventory import NUM_CTC_SYMBOLS
from toucan_tpu_torch.models.aligner import Aligner, mas_numpy, mas_torch
from toucan_tpu_torch.models.embedding_gan import (ResNetD, ResNetG, create_wgan_qc_state,
                                                   make_wgan_qc_train_step, solve_ot_lp)
from toucan_tpu_torch.recipes.pipelines import _aligner_train_fn
from toucan_tpu_torch.train.aligner_train import (TinyTTS, create_aligner_train_state,
                                                  make_aligner_train_step)
from toucan_tpu_torch.weights import (aligner_from_jax, resnet_d_from_jax, resnet_g_from_jax,
                                      tiny_tts_from_jax)

from test_torch_modules import seeded_variables

torch.set_num_threads(2)

LR = 10.0
STEP = 1000   # min(5, 1000 / 2000) = 0.5: the reconstruction is live


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def aligner_batch():
    rnd = np.random.RandomState(0)
    return dict(mel=rnd.randn(2, 24, 80).astype(np.float32),
                mel_lengths=np.array([24, 18], np.int32),
                tokens=rnd.randint(0, 100, size=(2, 6)).astype(np.int32),
                token_lengths=np.array([6, 4], np.int32),
                speaker_embeddings=rnd.randn(2, 192).astype(np.float32))


class _NoDropout:
    """``flax.linen`` with ``Dropout`` at rate 0, for the JAX aligner's
    fixed 0.5."""

    def __getattr__(self, name):
        return getattr(flax_nn, name)

    @staticmethod
    def Dropout(rate, deterministic=None):
        return flax_nn.Dropout(0.0, deterministic=deterministic)


@pytest.fixture(scope="module")
def aligner_run():
    rng = np.random.RandomState(1)
    b = aligner_batch()
    mel, lens = jnp.asarray(b["mel"]), jnp.asarray(b["mel_lengths"])
    asr_vars = seeded_variables(JaxAligner(), rng, mel, lens)
    tts_vars = seeded_variables(JaxTinyTTS(), rng, jnp.zeros((2, 24, NUM_CTC_SYMBOLS + 192)),
                                lens, mel)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.radam(LR))
    state0 = JaxAlignerState(step=jnp.asarray(STEP, jnp.int32), asr_params=asr_vars["params"],
                             asr_batch_stats=asr_vars["batch_stats"],
                             asr_opt_state=opt.init(asr_vars["params"]),
                             tts_params=tts_vars["params"],
                             tts_opt_state=opt.init(tts_vars["params"]))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_aligner_module, "nn", _NoDropout())
    try:
        step = jax.jit(jax_aligner_step(opt))
        state1, metrics = step(state0, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(0))
        jax.block_until_ready(metrics)
    finally:
        mp.undo()
    return dict(asr_vars=asr_vars, tts_vars=tts_vars, state1=state1, metrics=_np(metrics),
                batch=b)


def _updates_match(before, after, want_before, want_after):
    for k in want_before:
        if not k.endswith(("weight", "bias")) or k.endswith(("running_mean", "running_var")):
            continue
        want = want_before[k].double() - want_after[k].double()
        ulp = torch.from_numpy(np.spacing(np.maximum(np.abs(want_before[k].numpy()),
                                                     np.abs(want_after[k].numpy()))))
        err = ((before[k].double() - after[k].double() - want).abs() - ulp.double()).max()
        assert err <= 1e-4 * max(want.abs().max().item(), 1e-12), (k, err.item())


def test_aligner_step_matches_jax(aligner_run):
    r = aligner_run
    asr, tts = Aligner(), TinyTTS()
    asr.load_state_dict(aligner_from_jax(r["asr_vars"]))
    tts.load_state_dict(tiny_tts_from_jax(r["tts_vars"]))
    state = create_aligner_train_state(lr=LR, device="cpu", asr=asr, tts=tts)
    state.step = STEP
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in (asr, tts)]
    got = make_aligner_train_step()(state, {k: torch.from_numpy(v) for k, v in
                                            r["batch"].items()}, deterministic=True)
    assert state.step == STEP + 1
    assert set(got) == set(r["metrics"]) == {"ctc_loss", "reconstruction_loss", "total_loss"}
    for k, want in r["metrics"].items():
        np.testing.assert_allclose(got[k].item(), float(want), rtol=1e-5, err_msg=k)
    s1 = r["state1"]
    want_asr = aligner_from_jax({"params": _np(s1.asr_params),
                                 "batch_stats": _np(s1.asr_batch_stats)})
    want_tts = tiny_tts_from_jax({"params": _np(s1.tts_params)})
    want_before = [aligner_from_jax(r["asr_vars"]), tiny_tts_from_jax(r["tts_vars"])]
    for b, m, wb, wa in zip(before, (asr, tts), want_before, (want_asr, want_tts)):
        _updates_match(b, m.state_dict(), wb, wa)
    for k, v in asr.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_asr[k].numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("frames,tokens,seed", [(24, 6, 0), (57, 13, 1), (200, 40, 2),
                                                (9, 9, 3)])
def test_mas_torch_equals_mas_numpy_and_mas_jax(frames, tokens, seed):
    scores = np.random.RandomState(seed).rand(frames, tokens).astype(np.float32)
    want = mas_numpy(scores)
    np.testing.assert_array_equal(want, jax_mas_numpy(scores))
    np.testing.assert_array_equal(np.asarray(mas_jax(jnp.asarray(scores))), want)
    np.testing.assert_array_equal(mas_torch(torch.from_numpy(scores)).numpy(), want)


def test_aligner_train_fn_runs():
    from toucan_tpu_torch.frontend.text import TextFrontend
    text = TextFrontend(language="en").string_to_features("~hɛlˈoʊ wˈɜːld~#",
                                                          input_phonemes=True)
    rng = np.random.RandomState(2)
    data = [dict(text=text, mel=rng.randn(frames, 80).astype(np.float32))
            for frames in (30, 40, 22)]
    seen = []
    state = _aligner_train_fn(data, 2, device="cpu", callbacks=[lambda s, m: seen.append(s)])
    assert state.step == 2 and seen == [0, 1]


# ------------------------------------------------------------------ WGAN-QC

BATCH = 8


def test_solve_ot_lp_is_jax_s():
    d = np.random.RandomState(3).rand(6, 6).astype(np.float32)
    for got, want in zip(solve_ot_lp(d), jax_gan_module.solve_ot_lp(d)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def wgan_run():
    rng = np.random.RandomState(4)
    g_vars = seeded_variables(JaxResNetG(), rng, jnp.zeros((2, 32)), train=True)
    d_vars = seeded_variables(JaxResNetD(), rng, jnp.zeros((2, 64)))
    lr = 1e-4
    g_opt, d_opt = optax.adam(lr, b1=0.5, b2=0.999), optax.adam(lr, b1=0.5, b2=0.999)
    state0 = jax_gan_module.WganQCState(
        step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
        g_batch_stats=g_vars["batch_stats"], g_opt_state=g_opt.init(g_vars["params"]),
        d_params=d_vars["params"], d_opt_state=d_opt.init(d_vars["params"]))
    step = jax_gan_module.make_wgan_qc_train_step(JaxResNetG(), JaxResNetD(), g_opt, d_opt)
    real = rng.randn(BATCH, 64).astype(np.float32)
    solved = []
    jax_solve = jax_gan_module.solve_ot_lp

    def recording(dist):  # JAX's LP solution, to inject into the port's step
        solved.append(jax_solve(dist))
        return solved[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_gan_module, "solve_ot_lp", recording)
    try:
        key = jax.random.PRNGKey(5)
        state1, metrics = step(state0, real, key)
    finally:
        mp.undo()
    z = np.asarray(jax.random.normal(key, (BATCH, 32)))
    return dict(g_vars=g_vars, d_vars=d_vars, state1=state1, metrics=metrics, real=real, z=z,
                ot=solved[0], lr=lr)


def test_wgan_qc_step_matches_jax(wgan_run):
    r = wgan_run
    gen, critic = ResNetG(), ResNetD()
    gen.load_state_dict(resnet_g_from_jax(r["g_vars"]))
    critic.load_state_dict(resnet_d_from_jax(r["d_vars"]))
    state = create_wgan_qc_state(gen, critic, lr=r["lr"], device="cpu")
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in (gen, critic)]
    potentials, plan = r["ot"]
    got = make_wgan_qc_train_step()(state, r["real"], z=_t(r["z"]),
                                    ot=(potentials, r["real"][np.argmax(plan, axis=0)]))
    for k, want in r["metrics"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-5, err_msg=k)
    s1, lr = r["state1"], r["lr"]
    want_g = resnet_g_from_jax({"params": _np(s1.g_params),
                                "batch_stats": _np(s1.g_batch_stats)})
    want_d = resnet_d_from_jax({"params": _np(s1.d_params)})
    for module, b, want in ((gen, before[0], want_g), (critic, before[1], want_d)):
        for name, p in module.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            assert diff.max() <= 2 * lr, name
            live = np.abs(p.grad.numpy()) > 1e-6
            assert not live.any() or diff[live].max() <= 1e-3 * lr, (name, diff[live].max())
    for name, buf in gen.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_g[name].numpy(), atol=1e-6, err_msg=name)
            assert not torch.equal(buf, before[0][name])


def test_resnet_d_round_trips(wgan_run):
    d_vars = wgan_run["d_vars"]
    sd = resnet_d_from_jax(d_vars)
    critic = ResNetD()
    critic.load_state_dict(sd)
    p = d_vars["params"]
    back = {"fc_input": {"kernel": sd["fc_input.weight"].numpy().T,
                         "bias": sd["fc_input.bias"].numpy()},
            "fc": {"kernel": sd["fc.weight"].numpy().T, "bias": sd["fc.bias"].numpy()}}
    for k in back:
        for leaf in back[k]:
            np.testing.assert_array_equal(back[k][leaf], np.asarray(p[k][leaf]))
    for k, idx in (("block_0", 0), ("block_1", 1)):
        for conv in p[k]:
            w = sd[f"resnet.{idx}.{conv}.weight"].numpy()
            np.testing.assert_array_equal(np.transpose(w, (2, 3, 1, 0)),
                                          np.asarray(p[k][conv]["kernel"]))
    x = np.random.RandomState(6).randn(3, 64).astype(np.float32)
    want = np.asarray(JaxResNetD().apply(d_vars, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(critic(_t(x)).numpy(), want, atol=1e-5, rtol=1e-5)
