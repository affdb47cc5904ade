"""The port's acoustic training against the JAX package's, on the CPU.

A tiny ToucanTTS (``TINY`` of ``tests/test_train_dist.py``) gets seeded
variables in the JAX layout (``seeded_variables``); the port gets them
through ``weights.toucan_tts_from_jax``.  Held against JAX:

- the glow's forward flow: forward then reverse is the identity (1e-5); its
  log-determinant and ``Glow.loss`` within rtol 1e-5;
- ``ToucanTTS.forward`` in training mode without dropout (JAX's
  ``deterministic=True, train=True``): the mels within 3e-4 (the bar of
  ``tests/test_toucan_parity.py``), predictions within 1e-5, every loss
  within rtol 1e-5, every gradient of the total within 1e-4 of its tensor's
  peak against ``jax.grad`` (the gradients that are 0 in exact arithmetic,
  ``ZERO_GRADIENTS``, below 1e-6 of the largest gradient on both sides), the
  new BatchNorm statistics within 1e-6;
- one train step with the critic from a JAX ``TrainState`` carried over by
  ``weights.train_state_from_jax`` (after one JAX step, so Adam's moments
  and count are live), dropout 0, the critic's windows at JAX's starts: the
  losses (rtol 1e-5), the moments (1e-4 of their peak), the statistics, and
  the update, which Adam makes about +-lr wherever a gradient is nonzero:
  within 2 lr everywhere and within 1e-3 lr where |g| > 1e-6;
- the schedules and the global-norm clip against optax, the losses and the
  critic against JAX; ``random_windows`` by its statistics;
- dropout: each layer's rate, and none when ``deterministic``;
- checkpoints (keep-5, resume, SWA into a ``best.pt`` that ``load.py``
  reads into an interface) and ``train_loop``, mono and meta.
"""

import functools
import os

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import toucan_tpu.models.toucan_tts as jax_toucan_tts_module
from toucan_tpu.data.batching import pad_batch as jax_pad_batch
from toucan_tpu.models.discriminator import SpectrogramDiscriminator as JaxDisc
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.nn.postnet import PostNet as JaxPostNet
from toucan_tpu.train.losses import toucan_tts_loss as jax_loss
from toucan_tpu.train.schedules import noam_warmup_schedule as jax_noam
from toucan_tpu.train.schedules import toucan_warmup_schedule as jax_warmup
from toucan_tpu.train.toucan_train import TrainState as JaxTrainState
from toucan_tpu.train.toucan_train import make_optimizer, make_train_step as jax_make_step
from toucan_tpu.compat.torch_gst import convert_style_embedding
from toucan_tpu_torch import load
from toucan_tpu_torch.data import batching
from toucan_tpu_torch.data.prefetch import DevicePrefetcher
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.models.discriminator import SpectrogramDiscriminator, random_windows
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.train import checkpointing
from toucan_tpu_torch.train.loop import train_loop
from toucan_tpu_torch.train.losses import toucan_tts_loss
from toucan_tpu_torch.train.schedules import (WarmupScheduler, noam_warmup_schedule,
                                              toucan_warmup_schedule)
from toucan_tpu_torch.train.toucan_train import (ZERO_GRADIENTS, clip_by_global_norm,
                                                 create_train_state, make_train_step)
from toucan_tpu_torch.weights import (spectrogram_discriminator_from_jax, toucan_tts_from_jax,
                                      train_state_from_jax)

from test_torch_gst import seeded_gst
from test_torch_modules import _flatten, seeded_variables
from test_train_dist import TINY as JAX_TINY, tiny_batch

torch.set_num_threads(2)

NO_DROPOUT = dict(dropout=0.0, duration_dropout=0.0, pitch_dropout=0.0, energy_dropout=0.0)
FIELDS = ("adim", "aheads", "enc_layers", "enc_units", "dec_layers", "dec_units",
          "duration_layers", "pitch_layers", "energy_layers", "duration_chans", "pitch_chans",
          "energy_chans", "glow_blocks", "glow_hidden", "utt_embed_dim", "lang_embs")
TINY = {k: getattr(JAX_TINY, k) for k in FIELDS}
PORT_CFG = ToucanTTSConfig(**TINY, **NO_DROPOUT)
LR, WARMUP, MAX_STEPS = 1e-3, 4, 100


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def port_batch(batch):
    return {k: _t(v, torch.long if k == "lang_ids" else
                  torch.int32 if v.dtype == np.int32 else torch.float32)
            for k, v in batch.items()}


def batch_args(batch):
    return (batch["text"], batch["text_lengths"], batch["gold_speech"], batch["speech_lengths"],
            batch["gold_durations"], batch["gold_pitch"], batch["gold_energy"])


@pytest.fixture(scope="module")
def tts():
    model = JaxToucanTTS(JAX_TINY)
    b = tiny_batch(b=2)
    variables = seeded_variables(model, np.random.RandomState(0),
                                 *[jnp.asarray(a) for a in batch_args(b)],
                                 utterance_embedding=jnp.zeros((2, 64)),
                                 lang_ids=jnp.zeros((2, 1), jnp.int32))
    port = ToucanTTS(PORT_CFG)
    port.load_state_dict(toucan_tts_from_jax(variables))
    return model, variables, port


def test_glow_forward_then_reverse_is_identity(tts):
    _, _, port = tts
    rng = np.random.RandomState(1)
    x, g = _t(rng.randn(2, 24, 80)), _t(rng.randn(2, 24, 32))
    mask = _t((np.arange(24)[None, :] < np.array([[24], [18]]))[..., None])
    glow = port.post_flow
    cond = F.conv1d(torch.cat([x, g], -1).transpose(1, 2), glow.g_proj.weight,
                    glow.g_proj.bias, padding=2).transpose(1, 2)
    with torch.no_grad():
        z, _ = glow.flow(x, mask, cond)
        from toucan_tpu_torch.nn.glow import squeeze, unsqueeze
        y, mask_sq = squeeze(z, mask)
        g_sq, _ = squeeze(cond, mask)
        for i in range(len(glow.flows) - 1, -1, -3):
            y = glow.flows[i].reverse(y, mask_sq, g_sq)
            y = glow.flows[i - 1].reverse(y, mask_sq)
            y = glow.flows[i - 2].reverse(y, mask_sq)
        y, _ = unsqueeze(y, mask_sq)
    np.testing.assert_allclose(y.numpy(), (x * mask).numpy(), atol=1e-5)


def test_glow_logdet_and_loss_match_jax(tts):
    model, variables, port = tts
    rng = np.random.RandomState(2)
    tgt, mel, enc = rng.randn(2, 26, 80), rng.randn(2, 26, 80), rng.randn(2, 26, 32)
    mask = (np.arange(26)[None, :] < np.array([[26], [19]]))[..., None].astype(np.float32)
    tgt, mel, enc = (a.astype(np.float32) for a in (tgt, mel, enc))

    def run(m, tgt, mel, enc, mask):
        g = m.post_flow._condition(mel, enc)
        return m.post_flow._flow(tgt, mask, g)[1], m.post_flow.loss(tgt, mel, enc, mask)

    want_ld, want_loss = model.apply(variables, tgt, mel, enc, mask, method=run)
    glow = port.post_flow
    with torch.no_grad():
        cond = F.conv1d(torch.cat([_t(mel), _t(enc)], -1).transpose(1, 2), glow.g_proj.weight,
                        glow.g_proj.bias, padding=2).transpose(1, 2)
        _, ld = glow.flow(_t(tgt), _t(mask), cond)
        loss = glow.loss(_t(tgt), _t(mel), _t(enc), _t(mask))
    np.testing.assert_allclose(ld.numpy(), np.asarray(want_ld), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)


def _jax_forward_loss(model, params, stats, buffers, batch, utt, run_glow):
    (before, after, d, p, e, glow), upd = model.apply(
        {"params": params, "batch_stats": stats, "buffers": buffers}, *batch_args(batch),
        utterance_embedding=utt, lang_ids=batch["lang_ids"], run_glow=run_glow,
        deterministic=True, train=True, mutable=["batch_stats"])
    losses = jax_loss(before, after, batch["gold_speech"], batch["speech_lengths"],
                      batch["text_lengths"], batch["gold_durations"], d, p, e,
                      batch["gold_pitch"], batch["gold_energy"])
    total = sum(losses) + (glow if run_glow else 0.0)
    return total, ((before, after, d, p, e, glow), losses, upd["batch_stats"])


@functools.lru_cache(maxsize=None)
def _jax_grad(run_glow):
    model = JaxToucanTTS(JAX_TINY)
    return jax.jit(jax.grad(
        lambda params, stats, buffers, batch, utt: _jax_forward_loss(
            model, params, stats, buffers, batch, utt, run_glow), has_aux=True))


def _max_rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("run_glow", [True, False])
def test_forward_losses_gradients_and_statistics_match_jax(tts, run_glow):
    _, variables, _ = tts
    port = ToucanTTS(PORT_CFG)
    port.load_state_dict(toucan_tts_from_jax(variables))
    batch = tiny_batch(b=3, seed=3)
    utt = np.random.RandomState(4).randn(3, 64).astype(np.float32)
    grads, (outs, losses, stats) = _jax_grad(run_glow)(
        variables["params"], variables["batch_stats"], variables["buffers"],
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(utt))

    pb = port_batch(batch)
    got = port(*batch_args(pb), utterance_embedding=_t(utt), lang_ids=pb["lang_ids"],
               run_glow=run_glow, deterministic=True, train=True)
    got_losses = toucan_tts_loss(got[0], got[1], pb["gold_speech"], pb["speech_lengths"],
                                 pb["text_lengths"], pb["gold_durations"], *got[2:5],
                                 pb["gold_pitch"], pb["gold_energy"])
    total = sum(got_losses) + (got[5] if run_glow else 0.0)
    total.backward()

    for i, tol in ((0, 3e-4), (1, 3e-4), (2, 1e-5), (3, 1e-5), (4, 1e-5)):
        np.testing.assert_allclose(got[i].detach().numpy(), np.asarray(outs[i]), atol=tol)
    for g, w in zip(got_losses, losses):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    if run_glow:
        np.testing.assert_allclose(got[5].item(), float(outs[5]), rtol=1e-5)
    else:
        assert got[5] is None
    want_grads = toucan_tts_from_jax({"params": grads, "batch_stats": variables["batch_stats"],
                                      "buffers": variables["buffers"]})
    peak = max(np.abs(g.numpy()).max() for g in want_grads.values())
    for name, p in port.named_parameters():
        want = want_grads[name].numpy()
        if not run_glow and name.startswith("post_flow"):
            assert p.grad is None and not np.any(want), name
            continue
        g = p.grad.numpy()
        if name.endswith(ZERO_GRADIENTS):
            # float noise on both sides: held far below every live gradient
            assert max(np.abs(g).max(), np.abs(want).max()) <= 1e-6 * peak, name
            continue
        assert np.abs(g - want).max() <= 1e-4 * np.abs(want).max(), (name, _max_rel(g, want))
    want_sd = toucan_tts_from_jax({"params": variables["params"], "batch_stats": stats,
                                   "buffers": variables["buffers"]})
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(), atol=1e-6)


def test_inference_still_runs_the_kernel_wrapper(tts, monkeypatch):
    """Training mode is the module's; ``infer`` runs deterministically and
    through the K1 wrapper whatever the mode, as JAX's ``infer`` does."""
    _, _, port = tts
    import toucan_tpu_torch.nn.attention as attention
    calls = []
    real = attention.flash_rel_attention
    monkeypatch.setattr(attention, "flash_rel_attention",
                        lambda *a: calls.append(1) or real(*a))
    port.train()
    text = _t((np.random.RandomState(5).rand(1, 8, 62) > 0.5))
    port.infer(text, torch.tensor([8]), 32, utterance_embedding=torch.ones(1, 64),
               lang_ids=torch.tensor([[1]]))
    assert len(calls) == TINY["enc_layers"] + TINY["dec_layers"]
    calls.clear()
    b = port_batch(tiny_batch(b=2))
    port(*batch_args(b), utterance_embedding=torch.ones(2, 64), lang_ids=b["lang_ids"])
    assert not calls


def test_infer_ignores_the_module_mode(tts):
    """A module in training mode (PyTorch's mode after construction) infers
    as JAX's ``infer`` does, on running statistics, and leaves them as they
    were (a BatchNorm that follows the module's mode would normalize by the
    batch's statistics: the mel 3.7 off)."""
    model, variables, _ = tts
    port = ToucanTTS(PORT_CFG)   # in training mode, as built
    port.load_state_dict(toucan_tts_from_jax(variables))
    rng = np.random.RandomState(14)
    text = (rng.rand(2, 12, 62) > 0.5).astype(np.float32)
    lens, durs = np.array([12, 9], np.int32), rng.randint(1, 5, size=(2, 12)).astype(np.int32)
    utt, lang = rng.randn(2, 64).astype(np.float32), np.array([[3], [41]], np.int32)
    noise = (0.8 * rng.randn(2, 64, 80)).astype(np.float32)
    want = model.apply(variables, text, lens, 64, utterance_embedding=utt, lang_ids=lang,
                       gold_durations=durs, glow_noise=noise, method=JaxToucanTTS.infer)
    stats = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}
    got = port.infer(_t(text), _t(lens, torch.long), 64, utterance_embedding=_t(utt),
                     lang_ids=_t(lang, torch.long), gold_durations=_t(durs, torch.int32),
                     glow_noise=_t(noise))
    for i in (0, 1):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=3e-4)
    assert all(torch.equal(port.state_dict()[k], v) for k, v in stats.items())


def _dropout_rates(monkeypatch):
    calls = []
    real = F.dropout

    def recording(x, p=0.5, training=True, inplace=False):
        calls.append(p)
        return real(x, p, training, inplace)
    monkeypatch.setattr(F, "dropout", recording)
    return calls


def test_dropout_rates_and_deterministic(monkeypatch):
    """Each layer drops at its rate (a distinct rate per field), and nothing
    drops where ``deterministic``: the JAX model's dropout sites."""
    rates = dict(dropout=0.1, duration_dropout=0.2, pitch_dropout=0.3, energy_dropout=0.4)
    port = ToucanTTS(ToucanTTSConfig(**TINY, **rates))   # the PostNet at its own 0.5
    b = port_batch(tiny_batch(b=2))
    calls = _dropout_rates(monkeypatch)
    port(*batch_args(b), utterance_embedding=torch.ones(2, 64), lang_ids=b["lang_ids"],
         deterministic=True, train=True)
    assert calls == []
    port(*batch_args(b), utterance_embedding=torch.ones(2, 64), lang_ids=b["lang_ids"],
         deterministic=False, train=True)
    blocks = TINY["enc_layers"] + TINY["dec_layers"]
    # positional (input and table) per conformer; per block: two FF inner
    # dropouts, attention probabilities, four residual branches
    want = {0.1: 2 * 2 + 7 * blocks, 0.2: TINY["duration_layers"],
            0.3: TINY["pitch_layers"], 0.4: TINY["energy_layers"], 0.5: 5}
    assert {r: calls.count(r) for r in want} == want and len(calls) == sum(want.values())
    x = torch.ones(20000)
    dropped = (F.dropout(x, 0.3) == 0).float().mean().item()
    assert abs(dropped - 0.3) < 0.02


def test_attention_training_path_matches_the_kernel_path_without_dropout(tts):
    _, _, port = tts
    attn = port.encoder.encoders[0].self_attn
    rng = np.random.RandomState(6)
    x = _t(rng.randn(2, 9, 32))
    pos = torch.from_numpy(np.asarray(
        __import__("toucan_tpu_torch.nn.positional", fromlist=["x"])
        .relative_position_encoding(9, 32)).copy())
    mask = _t((np.arange(9)[None] < np.array([[9], [5]]))[:, None], torch.bool)
    with torch.no_grad():
        a = attn(x, x, x, pos, mask, deterministic=True)
        attn.dropout_rate = 0.0
        b = attn(x, x, x, pos, mask, deterministic=False)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


def test_losses_match_jax():
    rng = np.random.RandomState(7)
    b, t, l = 3, 7, 15
    arrs = dict(before=rng.randn(b, l, 80), after=rng.randn(b, l, 80), gold=rng.randn(b, l, 80),
                d=rng.randn(b, t), p=rng.randn(b, t, 1), e=rng.randn(b, t, 1),
                gp=rng.randn(b, t, 1), ge=rng.randn(b, t, 1))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    slen, tlen = np.array([15, 9, 12], np.int32), np.array([7, 4, 6], np.int32)
    dur = rng.randint(0, 5, size=(b, t)).astype(np.int32)
    args = lambda conv, i: (conv(arrs["before"]), conv(arrs["after"]), conv(arrs["gold"]),
                            i(slen), i(tlen), i(dur), conv(arrs["d"]), conv(arrs["p"]),
                            conv(arrs["e"]), conv(arrs["gp"]), conv(arrs["ge"]))
    want = jax_loss(*args(jnp.asarray, jnp.asarray))
    got = toucan_tts_loss(*args(_t, lambda a: _t(a, torch.int32)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 3, 4, 5, 57])
def test_schedules_match_jax(step):
    np.testing.assert_allclose(toucan_warmup_schedule(LR, WARMUP, MAX_STEPS)(step),
                               float(jax_warmup(LR, WARMUP, MAX_STEPS)(step)), rtol=1e-6)
    np.testing.assert_allclose(noam_warmup_schedule(LR, WARMUP)(step),
                               float(jax_noam(LR, WARMUP)(step)), rtol=1e-6)


def test_scheduler_runs_the_schedule_from_step_one():
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=LR)
    sched = WarmupScheduler(opt, LR, WARMUP, MAX_STEPS)
    seen = []
    for _ in range(6):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, [float(jax_warmup(LR, WARMUP, MAX_STEPS)(s))
                                      for s in range(6)], rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_global_norm_clip_matches_optax(scale):
    rng = np.random.RandomState(8)
    trees = [(scale * rng.randn(*s)).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(a) for a in trees], None)
    got = [_t(a) for a in trees]
    clip_by_global_norm(got, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.fixture(scope="module")
def disc_pair():
    model = JaxDisc()
    variables = seeded_variables(model, np.random.RandomState(9), jnp.zeros((2, 100, 80, 1)))
    port = SpectrogramDiscriminator()
    port.load_state_dict(spectrogram_discriminator_from_jax(variables))
    return model, variables, port


def test_discriminator_matches_jax(disc_pair):
    model, variables, port = disc_pair
    rng = np.random.RandomState(10)
    fake, real = rng.randn(2, 2, 100, 80, 1).astype(np.float32)
    score, fmaps = model.apply(variables, fake)
    got_score, got_fmaps = port(_t(fake).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_score.detach().numpy(), np.asarray(score), atol=1e-5)
    for g, w in zip(got_fmaps, fmaps):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-5)
    for method in ("generator_feedback", "discriminator_loss"):
        want = model.apply(variables, fake, real, method=getattr(JaxDisc, method))
        got = getattr(port, method)(_t(fake).permute(0, 3, 1, 2), _t(real).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_discriminator_weights_round_trip(disc_pair):
    """The JAX package has no converter for the critic: the port's state
    dict, run back through the inverse layout change, gives the variables."""
    _, variables, port = disc_pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    conv = lambda k: {"kernel": np.transpose(sd[f"{k}.weight"], (2, 3, 1, 0)),
                      "bias": sd[f"{k}.bias"]}
    back = {f"conv_{i}": conv(f"D.filters.{i}") for i in range(5)}
    back["out"] = conv("D.out")
    back["fc"] = {"kernel": sd["D.fc.weight"].T, "bias": sd["D.fc.bias"]}
    want, got = _flatten(variables["params"]["D"]), _flatten(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_critic_is_frozen_in_the_generator_feedback(disc_pair):
    _, _, port = disc_pair
    fake = torch.randn(2, 1, 100, 80, requires_grad=True)
    port.generator_feedback(fake, torch.randn(2, 1, 100, 80)).backward()
    assert fake.grad is not None and fake.grad.abs().sum() > 0
    assert all(p.grad is None and p.requires_grad for p in port.parameters())
    port.discriminator_loss(fake, torch.randn(2, 1, 100, 80)).backward()
    assert all(p.grad is not None for p in port.parameters())


def test_random_windows_are_cyclic_with_uniform_starts():
    lengths = torch.tensor([7, 150, 1])
    x = torch.arange(3 * 160, dtype=torch.float32).reshape(3, 160, 1).expand(3, 160, 80)
    gen = torch.Generator().manual_seed(0)
    starts = []
    for _ in range(3000):
        fake, real = random_windows(x, x + 1, lengths, generator=gen)
        rows = fake[:, 0, :, 0] - torch.arange(3)[:, None] * 160
        assert torch.equal(real, fake + 1)
        s = rows[:, 0].long()
        want = (s[:, None] + torch.arange(100)) % lengths[:, None]
        assert torch.equal(rows.long(), want)
        starts.append(s)
    s = torch.stack(starts)
    assert (s[:, 0] < 7).all() and (s[:, 2] == 0).all()
    counts = torch.bincount(s[:, 0], minlength=7).float()
    assert counts.min() > 3000 / 7 * 0.8 and counts.max() < 3000 / 7 * 1.2
    np.testing.assert_allclose(s[:, 1].float().mean().item(), 74.5, atol=3.0)


def test_batching_is_the_jax_copy():
    rng = np.random.RandomState(11)
    points = [dict(text=rng.rand(t, 62).astype(np.float32), mel=rng.randn(l, 80),
                   durations=rng.randint(1, 3, size=t), pitch=rng.rand(t), energy=rng.rand(t),
                   lang_id=i) for i, (t, l) in enumerate(((5, 40), (9, 70)))]
    want, got = jax_pad_batch(points), batching.pad_batch(points)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_keeps_order_and_raises_at_the_consumer():
    batches = [{"x": np.full((2,), i, np.float32), "lang_ids": np.zeros((2, 1), np.int32)}
               for i in range(5)]
    got = [int(b["x"][0]) for b in DevicePrefetcher(iter(batches), "cpu", depth=2)]
    assert got == list(range(5))

    def failing():
        yield batches[0]
        raise RuntimeError("source failed")
    it = DevicePrefetcher(failing(), "cpu")
    assert next(it)["lang_ids"].dtype == torch.int64
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def _jax_state(variables, disc_vars, gst_vars):
    params = {"tts": variables["params"], "disc": disc_vars["params"]}
    optimizer = make_optimizer(LR, WARMUP, MAX_STEPS)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=variables["batch_stats"], buffers=variables["buffers"],
                         opt_state=optimizer.init(params), gst_variables=gst_vars), optimizer


@pytest.fixture(scope="module")
def jax_steps(tts, disc_pair, monkeypatch_module):
    """Two JAX train steps from the seeded variables, dropout 0 (the JAX
    model builds its PostNet at PostNet's default rate, which no config
    field reaches: it is set to 0 for this comparison)."""
    _, variables, _ = tts
    _, disc_vars, _ = disc_pair
    monkeypatch_module.setattr(jax_toucan_tts_module, "PostNet",
                               functools.partial(JaxPostNet, dropout_rate=0.0))
    cfg = JAX_TINY.__class__(**{**JAX_TINY.__dict__, **NO_DROPOUT})
    gst = seeded_gst()
    gst_vars = convert_style_embedding({k: v.numpy() for k, v in gst.state_dict().items()})
    state0, optimizer = _jax_state(variables, disc_vars, gst_vars)
    step = jax.jit(jax_make_step(cfg, optimizer, run_glow=True, use_discriminator=True))
    batches = [tiny_batch(b=3, seed=s) for s in (12, 13)]
    rng = jax.random.PRNGKey(1)
    state1, _ = step(state0, {k: jnp.asarray(v) for k, v in batches[0].items()}, rng)
    state2, metrics = step(state1, {k: jnp.asarray(v) for k, v in batches[1].items()}, rng)
    # the critic's window starts the JAX step drew for the second batch
    _, win_rng = jax.random.split(jax.random.fold_in(rng, state1.step))
    lengths = jnp.asarray(batches[1]["speech_lengths"])
    starts = jax.random.randint(win_rng, (3,), 0, jnp.maximum(lengths, 1))
    return gst, state1, state2, metrics, batches[1], np.asarray(starts)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_train_step_from_a_jax_state_matches_jax(jax_steps):
    gst, state1, state2, metrics, batch, starts = jax_steps
    port = create_train_state(PORT_CFG, gst.state_dict(), lr=LR, warmup_steps=WARMUP,
                              max_steps=MAX_STEPS, use_discriminator=True, device="cpu")
    port.model.conv_postnet.dropout_rate = 0.0   # as the JAX side's (see ``jax_steps``)
    adam1 = state1.opt_state[1][0]
    train_state_from_jax(port, _np_tree(state1.params), _np_tree(state1.batch_stats),
                         _np_tree(state1.buffers), _np_tree(adam1.mu), _np_tree(adam1.nu),
                         int(adam1.count), int(state1.step))
    assert port.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jax_warmup(LR, WARMUP, MAX_STEPS)(1)), rel=1e-6)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    got = make_train_step(run_glow=True, use_discriminator=True)(
        port, port_batch(batch), window_starts=torch.tensor(starts))
    assert port.step == int(state2.step) == 2
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-5, err_msg=k)

    adam2 = state2.opt_state[1][0]
    conv = lambda tree, stats=state2.batch_stats: toucan_tts_from_jax(
        {"params": _np_tree(tree["tts"]), "batch_stats": _np_tree(stats),
         "buffers": _np_tree(state2.buffers)})
    want_params, want_mu, want_nu = conv(state2.params), conv(adam2.mu), conv(adam2.nu)
    sd = port.model.state_dict()
    lr = float(jax_warmup(LR, WARMUP, MAX_STEPS)(1))
    for name, p in port.model.named_parameters():
        st = port.optimizer.state[p]
        for got_m, want_m in ((st["exp_avg"], want_mu[name]), (st["exp_avg_sq"], want_nu[name])):
            got_m, want_m = got_m.numpy(), want_m.numpy()
            if not name.endswith(ZERO_GRADIENTS):  # moments of float noise (see above)
                assert np.abs(got_m - want_m).max() <= 1e-4 * np.abs(want_m).max(), name
        upd = (sd[name] - before[name]).numpy()
        want_upd = (want_params[name] - before[name]).numpy()
        diff = np.abs(upd - want_upd)
        assert diff.max() <= 2 * lr, name
        live = np.abs(p.grad.numpy()) > 1e-6
        assert not live.any() or diff[live].max() <= 1e-3 * lr, (name, diff[live].max() / lr)
    for name, buf in port.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_params[name].numpy(), atol=1e-6)
    want_disc = spectrogram_discriminator_from_jax({"params": _np_tree(state2.params["disc"])})
    for name, p in port.disc.named_parameters():
        assert np.abs(p.detach().numpy() - want_disc[name].numpy()).max() <= 2 * lr, name


def tiny_dataset(n=12, seed=0, lang_id=12):
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(n):
        t = rng.randint(4, 8)
        durations = rng.randint(1, 4, size=t)
        data.append(dict(text=(rng.rand(t, 62) > 0.5).astype(np.float32),
                         mel=rng.randn(int(durations.sum()), 80).astype(np.float32),
                         durations=durations, pitch=rng.rand(t, 1).astype(np.float32),
                         energy=rng.rand(t, 1).astype(np.float32), lang_id=lang_id))
    return data


def test_checkpoints_keep_five_resume_and_swa(tmp_path):
    state = create_train_state(PORT_CFG, seeded_gst().state_dict(), use_discriminator=True,
                               device="cpu", seed=1)
    step = make_train_step(run_glow=True, use_discriminator=True)
    batch = port_batch(batching.pad_batch(tiny_dataset(4)))
    saved = []
    for i in range(7):
        step(state, batch, generator=torch.Generator().manual_seed(i))
        checkpointing.save_checkpoint(str(tmp_path), state, state.step)
        saved.append({k: v.clone() for k, v in state.model.state_dict().items()})
    paths = checkpointing.list_checkpoints(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [f"checkpoint_{s}.pt" for s in range(3, 8)]

    other = create_train_state(PORT_CFG, seeded_gst().state_dict(), use_discriminator=True,
                               device="cpu", seed=2)
    checkpointing.load_checkpoint(checkpointing.get_most_recent_checkpoint(str(tmp_path)), other)
    assert other.step == 7
    assert other.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k

    checkpointing.swa_update(str(tmp_path), state, n=2)
    best = torch.load(tmp_path / "best.pt", weights_only=True)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ((saved[-1][name] + saved[-2][name]) / 2).numpy(), rtol=1e-6)
        assert torch.equal(best["model"][name], p.detach())
    assert torch.equal(best["model"]["encoder.encoders.0.conv_module.norm.running_mean"],
                       saved[-1]["encoder.encoders.0.conv_module.norm.running_mean"])


@pytest.mark.parametrize("meta", [False, True])
def test_train_loop_and_best_checkpoint_serve(tmp_path, meta):
    data = [tiny_dataset(6, seed=i, lang_id=i + 1) for i in range(3)] if meta else tiny_dataset()
    gst_sd = seeded_gst().state_dict()
    seen = []
    state, history = train_loop(data, gst_sd, str(tmp_path), config=PORT_CFG, batch_size=4,
                                steps=4, postnet_start_steps=1, warmup_steps=2, log_every=1,
                                steps_per_checkpoint=3, use_discriminator=not meta,
                                device="cpu", callbacks=[lambda s, m: seen.append(s)])
    assert state.step == 6 and seen == list(range(6))
    assert all(np.isfinite(h["total_loss"]) for h in history)
    assert "glow_loss" not in history[1] and "glow_loss" in history[2]
    assert (tmp_path / "best.pt").exists()
    if meta:
        state2, _ = train_loop(data, gst_sd, str(tmp_path), config=PORT_CFG, batch_size=4,
                               steps=7, postnet_start_steps=1, warmup_steps=2,
                               steps_per_checkpoint=3, resume=True, device="cpu")
        assert state2.step == 9
        return
    sd, emb, cfg = load.load_toucan_tts(str(tmp_path / "best.pt"), return_config=True)
    assert emb.shape == (64,)
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    iface = ToucanTTSInterface(sd, HiFiGANGenerator(channels=64).state_dict(), config=cfg,
                               vocoder=HiFiGANGenerator(channels=64), default_embedding=emb,
                               device="cpu")
    wave = iface("~hɛlˈoʊ wˈɜːld~#", input_is_phones=True)
    assert wave.ndim == 1 and len(wave) > 0 and np.isfinite(wave).all()


def test_train_loop_asks_for_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(tiny_dataset(4), seeded_gst().state_dict(), "unused", config=PORT_CFG)
