"""GST embedding training: co-training with FastSpeech2, and fine-tuning to tasks.

Counterpart of ``toucan_tpu/train/embedding_train.py`` (the reference's
``Spectrogram_to_Embedding/embedding_function_train_loop.py`` and
``finetune_embeddings_to_tasks.py``):

* the co-training step: the GST in training mode embeds the gold speech,
  the ``fastspeech2_config()`` ToucanTTS runs its training forward on that
  embedding (no glow), and one Adam over both nets' parameters (the noam
  warm-up, after a global-norm clip at 1.0) updates them;
* the token-spread step: the same optimizer on the GST's token-bank
  regulariser.  As optax does, it updates *every* parameter: the others
  get zero gradients, which still move the moments of those that carry
  momentum, and Adam's count (so the schedule) advances;
* the fine-tune step: triplet + 0.1 x Barlow Twins of the GST's embeddings
  of (anchor, positive, negative) spectrograms.  The GST runs in training
  mode (batch statistics) but leaves its running statistics as they were,
  as JAX's step returns only parameters and optimizer state.

Parity with JAX needs the dropout off (``deterministic=True``): a
``torch.Generator`` cannot reproduce JAX's draws.  No kernel is launched:
the model's training path takes the plain attention.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from toucan_tpu_torch.models.gst import StyleEmbedding
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, fastspeech2_config
from toucan_tpu_torch.train.diverse_losses import barlow_twins_loss, triplet_loss
from toucan_tpu_torch.train.losses import toucan_tts_loss
from toucan_tpu_torch.train.schedules import NoamScheduler
from toucan_tpu_torch.train.toucan_train import ADAM, CLIP, clip_by_global_norm
from toucan_tpu_torch.utils.device import resolve_device


@dataclass
class EmbeddingTrainState:
    model: ToucanTTS
    gst: StyleEmbedding
    optimizer: torch.optim.Adam
    scheduler: NoamScheduler
    step: int = 0

    def parameters(self):
        """The optimized parameters: the TTS's, then the GST's."""
        return [*self.model.parameters(), *self.gst.parameters()]


def create_embedding_train_state(config=None, lr: float = 1e-3, warmup_steps: int = 8000,
                                 device=None, seed: int = 0) -> EmbeddingTrainState:
    """A ``fastspeech2_config()`` ToucanTTS (or ``config``) and a GST drawn
    from ``seed`` on ``device`` (None: the card), one Adam with the noam
    schedule."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ToucanTTS(config or fastspeech2_config())
        gst = StyleEmbedding()
    model.to(device).train()
    gst.to(device).train()
    state = EmbeddingTrainState(model, gst, None, None)
    state.optimizer = torch.optim.Adam(state.parameters(), lr=lr, **ADAM)
    state.scheduler = NoamScheduler(state.optimizer, lr, warmup_steps)
    return state


def _update(state: EmbeddingTrainState, loss):
    """Gradients of ``loss`` for every parameter (zeros where it does not
    reach), the clip, Adam and the schedule; ``.grad`` keeps the clipped
    gradient."""
    params = state.parameters()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    clip_by_global_norm([p.grad for p in params], CLIP)
    state.optimizer.step()
    state.scheduler.step()


def make_embedding_train_step():
    """-> step(state, batch, deterministic=False) -> {total_loss, l1_loss}.

    ``batch`` holds the tensors of ``data/batching.py::pad_batch``."""

    def train_step(state: EmbeddingTrainState, batch, deterministic: bool = False):
        style = state.gst(batch["gold_speech"], batch["speech_lengths"], train=True)
        before, after, d_pred, p_pred, e_pred, _ = state.model(
            batch["text"], batch["text_lengths"], batch["gold_speech"], batch["speech_lengths"],
            batch["gold_durations"], batch["gold_pitch"], batch["gold_energy"],
            utterance_embedding=style, lang_ids=batch.get("lang_ids"), run_glow=False,
            deterministic=deterministic, train=True)
        l1, dl, pl, el = toucan_tts_loss(
            before, after, batch["gold_speech"], batch["speech_lengths"], batch["text_lengths"],
            batch["gold_durations"], d_pred, p_pred, e_pred, batch["gold_pitch"],
            batch["gold_energy"])
        total = l1 + dl + pl + el
        _update(state, total)
        state.step += 1
        return {"total_loss": total.detach(), "l1_loss": l1.detach()}

    return train_step


def make_spread_regularization_step():
    """-> reg_step(state) -> loss: the token-spread step (``state.step``
    stays, as in JAX; Adam's count and the schedule advance)."""

    def reg_step(state: EmbeddingTrainState):
        loss = state.gst.token_spread_regularizer()
        _update(state, loss)
        return loss.detach()

    return reg_step


def make_finetune_step(barlow_weight: float = 0.1):
    """-> step(gst, optimizer, batch) -> {triplet, barlow}: one update of
    the GST's parameters by ``optimizer`` (over them) on triplet +
    ``barlow_weight`` x Barlow Twins.  ``batch``: ``anchor``,
    ``positive``, ``negative`` (B, L, 80) and their ``*_lengths``."""

    def step(gst: StyleEmbedding, optimizer, batch):
        def embed(name):
            return gst(batch[name], batch[f"{name}_lengths"], train=True, update_stats=False)

        anchor, positive, negative = embed("anchor"), embed("positive"), embed("negative")
        tl = triplet_loss(anchor, positive, negative)
        bt = barlow_twins_loss(anchor, positive)
        params = list(gst.parameters())
        grads = torch.autograd.grad(tl + barlow_weight * bt, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        optimizer.step()
        return {"triplet": tl.detach(), "barlow": bt.detach()}

    return step
