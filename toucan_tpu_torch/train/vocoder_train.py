"""Vocoder (GAN) training: losses, optimizers and the train step.

Counterpart of ``toucan_tpu/train/vocoder_train.py`` on one device (its
``make_sharded_vocoder_steps`` is not ported); the reference's
``hifigan_train_loop.py:19-182``: the generator's loss is 45 x the L1 of
24 kHz 100-mel log spectrograms (fft 1536, hop 384, fmin 80), and after
the warm-up 2 x the adversarial and 2 x the feature-matching losses of the
Avocodo joint critic; each net has optax's RAdam (``train/radam.py``; betas
(0.5, 0.9), generator 1e-3, critic 5e-4) after a global-norm clip at 10,
and a MultiStepLR halving at 500k/1M/1.2M/1.4M updates.

The step keeps JAX's order: the generator's loss with the critic frozen
(gradients are taken for the generator's parameters only, the real
features are computed without a graph), the generator's update, then,
when ``update_discriminator``, the critic's loss on the detached fake of
the same forward, with the critic's parameters of before the step, and its
update.  The generator runs its differentiable path
(``forward(..., differentiable=True)``): no kernel is launched in a step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from toucan_tpu_torch.frontend.audio import amplitude_spectrogram, mel_filterbank
from toucan_tpu_torch.models.vocoders.discriminators import SEGMENT, AvocodoJointDiscriminator
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.train.radam import RAdam
from toucan_tpu_torch.train.schedules import VocoderScheduler
from toucan_tpu_torch.train.toucan_train import clip_by_global_norm
from toucan_tpu_torch.utils.device import resolve_device

BETAS = (0.5, 0.9)
CLIP = 10.0


# ------------------------------------------------------------------ losses

def mel_spectrogram_24k(wave, fs: int = 24000, fft_size: int = 1536, hop: int = 384,
                        num_mels: int = 100, fmin: float = 80.0, fmax=None, eps: float = 1e-10):
    """(B, T) wave -> (B, frames, num_mels) log10-mel with the reference
    MelSpectrogramLoss's parameters (``MelSpectrogramLoss.py:104-117``)."""
    amp = amplitude_spectrogram(wave, fft_size, hop)
    basis = torch.from_numpy(mel_filterbank(fs, fft_size, num_mels, fmin, fmax or fs / 2))
    # the reference takes sqrt(clamp(power, eps)), the filterbank, clamp and log10
    amp = torch.sqrt(torch.clamp(amp ** 2, min=eps))
    return torch.log10(torch.clamp(amp @ basis.to(amp).T, min=eps))


def mel_loss(pred_wave, gold_wave):
    """L1 between the log-mel spectrograms of predicted and gold 24 kHz waves (B, T)."""
    return (mel_spectrogram_24k(pred_wave) - mel_spectrogram_24k(gold_wave)).abs().mean()


def generator_adversarial_loss(d_outs):
    """The mean over critics of each final score's MSE to one."""
    return sum(((outs[-1] - 1.0) ** 2).mean() for outs in d_outs) / len(d_outs)


def discriminator_adversarial_loss(d_outs_fake, d_outs_real):
    n = len(d_outs_fake)
    fake = sum((f[-1] ** 2).mean() for f in d_outs_fake)
    real = sum(((r[-1] - 1.0) ** 2).mean() for r in d_outs_real)
    return real / n + fake / n


def feature_matching_loss(d_outs_fake, d_outs_real):
    """L1 over the feature maps (the score excluded), averaged per critic;
    the real features carry no gradient."""
    total = 0.0
    for outs_f, outs_r in zip(d_outs_fake, d_outs_real):
        feats_f, feats_r = outs_f[:-1], outs_r[:-1]
        per = sum((f - r.detach()).abs().mean() for f, r in zip(feats_f, feats_r))
        total = total + per / max(len(feats_f), 1)
    return total


# --------------------------------------------------------------- optimizer

def make_vocoder_optimizer(module, lr: float):
    """(RAdam, its schedule) of one net; the clip is the step's."""
    opt = RAdam(module.parameters(), lr=lr, betas=BETAS)
    return opt, VocoderScheduler(opt, lr)


@dataclass
class VocoderTrainState:
    generator: torch.nn.Module
    discriminator: AvocodoJointDiscriminator
    g_optimizer: RAdam
    g_scheduler: VocoderScheduler
    d_optimizer: RAdam
    d_scheduler: VocoderScheduler
    step: int = 0


def create_vocoder_train_state(generator=None, discriminator=None, g_lr: float = 1e-3,
                               d_lr: float = 5e-4, segment: int = SEGMENT, device=None,
                               seed: int = 0) -> VocoderTrainState:
    """A generator (default ``HiFiGANGenerator()``, its weights as given) and
    a critic (default ``AvocodoJointDiscriminator(segment=segment)`` drawn
    from ``seed``) on ``device`` (None: the card), in training mode, with
    their optimizers and schedules."""
    device = resolve_device(device)
    generator = generator if generator is not None else HiFiGANGenerator()
    if discriminator is None:
        discriminator = AvocodoJointDiscriminator(
            segment=segment, generator=torch.Generator().manual_seed(seed))
    generator.to(device).train()
    discriminator.to(device).train()
    g_opt, g_sched = make_vocoder_optimizer(generator, g_lr)
    d_opt, d_sched = make_vocoder_optimizer(discriminator, d_lr)
    return VocoderTrainState(generator, discriminator, g_opt, g_sched, d_opt, d_sched)


def _apply(params, grads, optimizer, scheduler):
    """Set each parameter's gradient (zeros where the loss does not reach
    it, as optax moves every moment), clip, update, advance the schedule;
    ``.grad`` keeps the clipped gradient after the step."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    clip_by_global_norm([p.grad for p in params], CLIP)
    optimizer.step()
    scheduler.step()


def make_vocoder_train_step(use_adversarial: bool = True, mel_weight: float = 45.0,
                            adv_weight: float = 2.0, fm_weight: float = 2.0):
    """-> step(state, batch, update_discriminator) -> metrics (0-d tensors).

    ``batch``: {"gold_wave": (B, T, 1), "mel": (B, T / 384, 80)}.  The
    metric names are JAX's: ``mel_loss``, ``adversarial_loss``,
    ``feature_matching_loss``, ``generator_total`` and, when the critic
    updates, ``discriminator_loss``."""

    def train_step(state: VocoderTrainState, batch, update_discriminator: bool = False):
        gen, disc = state.generator, state.discriminator
        gold = batch["gold_wave"]
        g_params = list(gen.parameters())
        wave, up2, up1 = gen(batch["mel"], return_intermediates=True, differentiable=True)
        m_loss = mel_loss(wave[..., 0], gold[..., 0])
        total = mel_weight * m_loss
        metrics = {"mel_loss": m_loss}
        if use_adversarial:
            d_fake = disc(wave, up2, up1)
            with torch.no_grad():
                d_real = disc(gold)
            adv = generator_adversarial_loss(d_fake)
            fm = feature_matching_loss(d_fake, d_real)
            total = total + adv_weight * adv + fm_weight * fm
            metrics.update(adversarial_loss=adv, feature_matching_loss=fm)
        metrics["generator_total"] = total
        grads = torch.autograd.grad(total, g_params, allow_unused=True)
        _apply(g_params, grads, state.g_optimizer, state.g_scheduler)
        if use_adversarial and update_discriminator:
            d_params = list(disc.parameters())
            fake = [t.detach() for t in (wave, up2, up1)]
            d_loss = discriminator_adversarial_loss(disc(*fake), disc(gold))
            grads = torch.autograd.grad(d_loss, d_params, allow_unused=True)
            _apply(d_params, grads, state.d_optimizer, state.d_scheduler)
            metrics["discriminator_loss"] = d_loss
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def spectral_sigmas(discriminator) -> dict:
    """{conv path: sigma} of every spectral-norm conv of a critic."""
    return {name: m.sigma().detach() for name, m in discriminator.named_modules()
            if getattr(m, "norm", None) == "spectral"}


def checkpoint_payload(state: VocoderTrainState) -> dict:
    """What a vocoder checkpoint holds: the generator's state dict under
    ``generator`` (the reference vocoder ``best.pt`` layout that
    ``load.py::load_vocoder`` reads), the critic, both optimizers and
    schedules, and ``step_counter``."""
    return {"generator": state.generator.state_dict(),
            "discriminator": state.discriminator.state_dict(),
            "generator_optimizer": state.g_optimizer.state_dict(),
            "discriminator_optimizer": state.d_optimizer.state_dict(),
            "generator_scheduler": state.g_scheduler.state_dict(),
            "discriminator_scheduler": state.d_scheduler.state_dict(),
            "step_counter": state.step}


def load_vocoder_checkpoint(path: str, state: VocoderTrainState) -> VocoderTrainState:
    """Resume ``state`` in place from a checkpoint of ``checkpoint_payload``."""
    device = next(state.generator.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.generator.load_state_dict(ckpt["generator"])
    state.discriminator.load_state_dict(ckpt["discriminator"])
    state.g_optimizer.load_state_dict(ckpt["generator_optimizer"])
    state.d_optimizer.load_state_dict(ckpt["discriminator_optimizer"])
    state.g_scheduler.load_state_dict(ckpt["generator_scheduler"])
    state.d_scheduler.load_state_dict(ckpt["discriminator_scheduler"])
    state.step = int(ckpt["step_counter"])
    return state
