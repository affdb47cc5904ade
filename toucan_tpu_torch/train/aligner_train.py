"""Aligner training: CTC plus the TinyTTS reconstruction.

Counterpart of ``toucan_tpu/train/aligner_train.py`` on one device (its
``make_sharded_aligner_step`` is not ported); the reference's
``autoaligner_train_loop.py:24-148``: the loss is the aligner's CTC plus
``min(5, step / 2000)`` x the reconstruction loss of a small decoder
(``TinyTTS``) that reads the aligner's logits and the L2-normalised speaker
embedding; each net has optax's RAdam at 1e-4 (``train/radam.py``) after a
global-norm clip at 1.0.  The aligner runs in training mode (BatchNorm on
batch statistics, its running statistics updated as flax's); its dropout
is on unless ``deterministic``.  The LSTMs are cuDNN's on packed
sequences, which is what JAX's length masks compute.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from toucan_tpu_torch.frontend.inventory import NUM_CTC_SYMBOLS
from toucan_tpu_torch.models.aligner import Aligner, ctc_loss
from toucan_tpu_torch.nn.masks import make_non_pad_mask
from toucan_tpu_torch.train.radam import RAdam
from toucan_tpu_torch.train.toucan_train import clip_by_global_norm
from toucan_tpu_torch.utils.device import resolve_device

CLIP = 1.0


class TinyTTS(nn.Module):
    """The spectrogram-reconstruction decoder that sharpens the CTC states
    (reference ``AutoAligner/TinyTTS.py:9-36``): ``in_proj``, two
    bidirectional LSTM layers ``rnn1`` and ``rnn2`` over the true lengths,
    ``out_proj``."""

    def __init__(self, n_mels: int = 80, num_symbols: int = NUM_CTC_SYMBOLS,
                 speaker_embedding_dim: int = 192, lstm_dim: int = 512):
        super().__init__()
        self.in_proj = nn.Linear(num_symbols + speaker_embedding_dim, lstm_dim)
        self.rnn1 = nn.LSTM(lstm_dim, lstm_dim, batch_first=True, bidirectional=True)
        self.rnn2 = nn.LSTM(2 * lstm_dim, lstm_dim, batch_first=True, bidirectional=True)
        self.out_proj = nn.Linear(2 * lstm_dim, n_mels)

    def forward(self, x, lens, ys):
        """x (B, T, num_symbols + spk_dim), true lengths (B,), gold mels
        (B, T, n_mels) -> the masked, weighted L1 + L2 loss."""
        x = self.in_proj(x)
        cpu_lens = torch.as_tensor(lens).cpu()
        for rnn in (self.rnn1, self.rnn2):
            packed = pack_padded_sequence(x, cpu_lens, batch_first=True, enforce_sorted=False)
            x, _ = pad_packed_sequence(rnn(packed)[0], batch_first=True,
                                       total_length=ys.shape[1])
        x = self.out_proj(x)
        mask = make_non_pad_mask(torch.as_tensor(lens, device=ys.device), ys.shape[1])[..., None]
        weights = mask / mask.sum(1, keepdim=True)
        weights = weights / (ys.shape[0] * ys.shape[2])
        err = (x - ys).abs() + (x - ys) ** 2
        return torch.where(mask, err * weights, torch.zeros_like(err)).sum()


@dataclass
class AlignerTrainState:
    asr: Aligner
    tts: TinyTTS
    asr_optimizer: RAdam
    tts_optimizer: RAdam
    step: int = 0


def create_aligner_train_state(lr: float = 1e-4, spk_dim: int = 192, device=None,
                               seed: int = 0, asr=None, tts=None) -> AlignerTrainState:
    """``Aligner()`` and ``TinyTTS()`` (drawn from ``seed`` where not given)
    on ``device`` (None: the card), each with its RAdam."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        asr = asr if asr is not None else Aligner()
        tts = tts if tts is not None else TinyTTS(speaker_embedding_dim=spk_dim)
    asr.to(device).train()
    tts.to(device).train()
    return AlignerTrainState(asr, tts, RAdam(asr.parameters(), lr=lr),
                             RAdam(tts.parameters(), lr=lr))


def _l2_normalize(x, eps: float = 1e-12):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True)).clamp(min=eps)


def make_aligner_train_step(use_reconstruction: bool = True):
    """-> step(state, batch, deterministic=False) -> metrics (0-d tensors).

    ``batch``: ``mel`` (B, L, 80), ``mel_lengths`` (B,), ``tokens`` (B, S),
    ``token_lengths`` (B,), ``speaker_embeddings`` (B, 192).  Metrics:
    ``ctc_loss``, ``reconstruction_loss``, ``total_loss``."""

    def train_step(state: AlignerTrainState, batch, deterministic: bool = False):
        logits = state.asr(batch["mel"], batch["mel_lengths"], train=True,
                           deterministic=deterministic)
        loss = ctc_loss(logits, batch["mel_lengths"], batch["tokens"], batch["token_lengths"])
        metrics = {"ctc_loss": loss}
        if use_reconstruction:
            spk = _l2_normalize(batch["speaker_embeddings"])
            spk = spk[:, None, :].expand(logits.shape[0], logits.shape[1], spk.shape[-1])
            recon = state.tts(torch.cat([logits, spk], -1), batch["mel_lengths"], batch["mel"])
            metrics["reconstruction_loss"] = recon
            loss = loss + min(5.0, state.step / 2000.0) * recon
        metrics["total_loss"] = loss
        nets = ((state.asr, state.asr_optimizer), (state.tts, state.tts_optimizer))
        params = [list(net.parameters()) for net, _ in nets]
        grads = torch.autograd.grad(loss, params[0] + params[1], allow_unused=True)
        grads = (grads[:len(params[0])], grads[len(params[0]):])
        for (_, opt), ps, gs in zip(nets, params, grads):
            for p, g in zip(ps, gs):
                p.grad = torch.zeros_like(p) if g is None else g
            clip_by_global_norm([p.grad for p in ps], CLIP)
            opt.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
