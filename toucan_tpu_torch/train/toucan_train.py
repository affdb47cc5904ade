"""ToucanTTS training step.

Counterpart of ``toucan_tpu/train/toucan_train.py`` on one device; the
reference mono loop's semantics (``toucantts_train_loop.py:37-264``): a
frozen GST (eval mode, no gradient) gives each utterance's style
embedding, the losses are summed with a NaN guard each, the glow joins
after a warm-up (``run_glow``), an optional spectrogram discriminator adds
its LSGAN and feature-matching losses, and one Adam over the TTS's and the
critic's parameters steps after the gradients are clipped to global norm
1.0, at the rate of ``toucan_warmup_schedule``.

As optax does: the clip scales by max / ||g|| only where ||g|| exceeds max
(no 1e-6 added, unlike ``torch.nn.utils.clip_grad_norm_``); Adam's eps is
outside the square root (PyTorch's Adam and optax's agree there); the
first update runs at the schedule's value of step 1.  The model runs in
training mode: dropout on, BatchNorm on batch statistics, attention on its
plain path (no kernel is reached: the kernels have no backward).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from toucan_tpu_torch.models.discriminator import SpectrogramDiscriminator, random_windows
from toucan_tpu_torch.models.gst import StyleEmbedding
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.train.losses import toucan_tts_loss
from toucan_tpu_torch.train.schedules import WarmupScheduler
from toucan_tpu_torch.utils.device import resolve_device

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)  # optax.adam's defaults
CLIP = 1.0                                   # the global-norm clip
# parameters whose gradient is 0 in exact arithmetic, so float noise on any
# two devices: a key bias shifts every score of a query alike, which the
# softmax ignores, and a bias in front of a train-mode BatchNorm goes out
# with the batch mean
ZERO_GRADIENTS = ("self_attn.linear_k.bias", "conv_module.depthwise_conv.bias")


@dataclass
class TrainState:
    model: ToucanTTS
    disc: Optional[SpectrogramDiscriminator]
    gst: StyleEmbedding                     # frozen
    optimizer: torch.optim.Adam
    scheduler: WarmupScheduler
    step: int = 0

    def parameters(self):
        """The optimized parameters: the TTS's, then the critic's."""
        return [*self.model.parameters(), *(self.disc.parameters() if self.disc else ())]


def _nan_guard(x):
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def create_train_state(config: ToucanTTSConfig, gst_state_dict, lr: float = 1e-3,
                       warmup_steps: int = 8000, max_steps: int = 80000,
                       use_discriminator: bool = False, device=None, seed: int = 0) -> TrainState:
    """A fresh model (and critic) initialised from ``seed``, the GST from
    ``gst_state_dict``, Adam and the warm-up schedule.  ``device=None`` is
    the card (``utils.device.resolve_device``)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ToucanTTS(config)
        disc = SpectrogramDiscriminator() if use_discriminator else None
    gst = StyleEmbedding()
    gst.load_state_dict(gst_state_dict)
    gst.to(device).eval().requires_grad_(False)
    model.to(device).train()
    if disc is not None:
        disc.to(device).train()
    state = TrainState(model, disc, gst, optimizer=None, scheduler=None)
    state.optimizer = torch.optim.Adam(state.parameters(), lr=lr, **ADAM)
    state.scheduler = WarmupScheduler(state.optimizer, lr, warmup_steps, max_steps)
    return state


def clip_by_global_norm(grads, max_norm: float):
    """optax's ``clip_by_global_norm`` in place: g * (max / ||g||) where the
    global norm ||g|| is above ``max_norm``; no host read."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def compute_gradients(state: TrainState, batch, run_glow: bool = True,
                      use_discriminator: bool = False, generator=None, window_starts=None):
    """The forward and backward of one step (JAX ``loss_fn`` and its
    ``jax.grad``): each parameter's ``.grad`` holds the gradient of the
    guarded total; the BatchNorm running statistics are updated.  Returns
    the metrics as 0-d tensors (read on the host only when logged).

    ``batch`` holds the tensors of ``data/batching.py::pad_batch``;
    ``generator`` draws the critic's window starts, or ``window_starts``
    (B,) gives them."""
    model = state.model
    for p in state.parameters():
        p.grad = None
    style = state.gst(batch["gold_speech"], batch["speech_lengths"])
    before, after, d_pred, p_pred, e_pred, glow_loss = model(
        batch["text"], batch["text_lengths"], batch["gold_speech"], batch["speech_lengths"],
        batch["gold_durations"], batch["gold_pitch"], batch["gold_energy"],
        utterance_embedding=style, lang_ids=batch["lang_ids"], run_glow=run_glow,
        deterministic=False, train=True)
    l1, dl, pl, el = toucan_tts_loss(
        before, after, batch["gold_speech"], batch["speech_lengths"], batch["text_lengths"],
        batch["gold_durations"], d_pred, p_pred, e_pred, batch["gold_pitch"],
        batch["gold_energy"])
    metrics = {"l1_loss": l1, "duration_loss": dl, "pitch_loss": pl, "energy_loss": el}
    total = _nan_guard(l1) + _nan_guard(dl) + _nan_guard(pl) + _nan_guard(el)
    if run_glow and glow_loss is not None:
        total = total + _nan_guard(glow_loss)
        metrics["glow_loss"] = glow_loss
    if use_discriminator:
        fake, real = random_windows(after, batch["gold_speech"], batch["speech_lengths"],
                                    generator=generator, starts=window_starts)
        gen_loss = state.disc.generator_feedback(fake, real)      # critic frozen
        crit_loss = state.disc.discriminator_loss(fake, real)     # fake detached
        total = total + _nan_guard(gen_loss) + _nan_guard(crit_loss)
        metrics["generator_loss"] = gen_loss
        metrics["discriminator_loss"] = crit_loss
    metrics["total_loss"] = total
    total.backward()
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(run_glow: bool = True, use_discriminator: bool = False):
    """-> step(state, batch, generator=None, window_starts=None) -> metrics:
    gradients, the global-norm clip, Adam, the schedule; ``state.step``
    advances by one."""
    def train_step(state: TrainState, batch, generator=None, window_starts=None):
        if use_discriminator and state.disc is None:
            raise ValueError("use_discriminator needs a state made with a discriminator")
        metrics = compute_gradients(state, batch, run_glow, use_discriminator, generator,
                                    window_starts)
        params = state.parameters()
        for p in params:  # optax moves every moment each step, a zero gradient's too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm([p.grad for p in params], CLIP)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return metrics

    return train_step
