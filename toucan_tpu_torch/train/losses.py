"""ToucanTTS training losses.

Counterpart of ``toucan_tpu/train/losses.py``; reference ``ToucanTTSLoss``
(``TrainingInterfaces/Text_to_Spectrogram/ToucanTTS/ToucanTTSLoss.py:20-66``),
with its idiosyncrasies: the spectrogram L1 weights normalize per sample,
per mel channel and per batch; the duration, pitch and energy weights per
sample only (so those losses scale with the batch size); and the variance
weights are applied twice, which multiplies the pitch and energy losses by
the sum of the weights, the batch size (PARITY.md §2.3).
"""

import torch

from toucan_tpu_torch.nn.masks import make_non_pad_mask


def variance_weight_total(text_lengths, tmax: int):
    """The sum of the variance weights, which multiplies the pitch and
    energy losses: the batch size, as float arithmetic gives it."""
    dur_mask = make_non_pad_mask(text_lengths, tmax)
    return (dur_mask / dur_mask.sum(dim=1, keepdim=True)).sum()


def toucan_tts_loss(before_outs, after_outs, gold_spectrograms, spectrogram_lengths,
                    text_lengths, gold_durations, predicted_durations, predicted_pitch,
                    predicted_energy, gold_pitch, gold_energy, duration_log_offset: float = 1.0,
                    w_total=None):
    """Returns (l1_loss, duration_loss, pitch_loss, energy_loss) scalars.

    ``w_total``: the variance weights' sum over the global batch when this
    batch is a rank's share of it (``variance_weight_total`` summed over the
    ranks); None takes this batch's."""
    b, lmax, odim = gold_spectrograms.shape
    tmax = gold_durations.shape[1]
    zero = torch.zeros((), dtype=before_outs.dtype, device=before_outs.device)

    l1 = (before_outs - gold_spectrograms).abs()
    if after_outs is not None:
        l1 = l1 + (after_outs - gold_spectrograms).abs()
    dur_sq = (predicted_durations
              - torch.log(gold_durations.to(torch.float32) + duration_log_offset)) ** 2
    pitch_sq = (predicted_pitch - gold_pitch) ** 2
    energy_sq = (predicted_energy - gold_energy) ** 2

    out_mask = make_non_pad_mask(spectrogram_lengths, lmax)[..., None]        # (B, L, 1)
    out_w = out_mask / out_mask.sum(dim=1, keepdim=True)
    out_w = out_w / (b * odim)
    l1_loss = torch.where(out_mask, l1 * out_w, zero).sum()

    dur_mask = make_non_pad_mask(text_lengths, tmax)                          # (B, T)
    dur_w = dur_mask / dur_mask.sum(dim=1, keepdim=True)
    duration_loss = torch.where(dur_mask, dur_sq * dur_w, zero).sum()

    var_mask, var_w = dur_mask[..., None], dur_w[..., None]
    # the second application of the variance weights turns the scalar into
    # scalar * sum(weights), the batch size
    if w_total is None:
        w_total = torch.where(var_mask, var_w, zero).sum()
    pitch_loss = torch.where(var_mask, pitch_sq * var_w, zero).sum() * w_total
    energy_loss = torch.where(var_mask, energy_sq * var_w, zero).sum() * w_total
    return l1_loss, duration_loss, pitch_loss, energy_loss
