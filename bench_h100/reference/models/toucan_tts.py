"""ToucanTTS acoustic model (FastSpeech-2 family, conformer-based).

Counterpart of ``toucan_tpu/models/toucan_tts.py``: ``forward`` is the
teacher-forced training pass (JAX ``ToucanTTS.__call__``), ``infer`` the
synthesis (reference
``InferenceInterfaces/InferenceArchitectures/InferenceToucanTTS.py:183-250``).
Callers pass padded inputs, lengths and, to ``infer``, the padded output
length ``max_frames``; masks keep each row equal to its exact-length run.
Parameter names are the reference's state-dict keys.

``ToucanTTSConfig.dtype`` is the compute dtype, as the JAX config's: with
``torch.bfloat16`` the parameters are held in bf16 (a state dict's f32
values are rounded as they load, as JAX's bf16 serving rounds them) and
every layer computes in bf16.  What JAX keeps in f32 under bf16 stays f32:
LayerNorm and GroupNorm statistics (PyTorch computes them in f32 for bf16
inputs), the utterance embedding's normalization, the glow's InvConv
inverse (``nn/glow.py``), K1's softmax, the duration rounding and the
variance scaling.  ``fastspeech2_config`` and the ``use_postflow`` and
``conditional_predictors`` fields give the JAX package's glow-less,
unconditional-predictor variants.
"""

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.frontend.inventory import feature_index
from bench_h100.reference.nn.conformer import Conformer
from bench_h100.reference.nn.convolution import conv_btc
from bench_h100.reference.nn.glow import Glow
from bench_h100.reference.nn.length_regulator import length_regulate, regulate_durations
from bench_h100.reference.nn.masks import make_non_pad_mask
from bench_h100.reference.nn.postnet import PostNet
from bench_h100.reference.nn.predictors import DurationPredictor, VariancePredictor


@dataclass(frozen=True)
class ToucanTTSConfig:
    input_features: int = 62
    mel_channels: int = 80
    adim: int = 192
    aheads: int = 4
    enc_layers: int = 6
    enc_units: int = 1536
    enc_kernel: int = 7
    dec_layers: int = 6
    dec_units: int = 1536
    dec_kernel: int = 31
    dropout: float = 0.2
    duration_layers: int = 3
    duration_chans: int = 256
    duration_kernel: int = 3
    duration_dropout: float = 0.2
    pitch_layers: int = 7
    pitch_chans: int = 256
    pitch_kernel: int = 5
    pitch_dropout: float = 0.5
    energy_layers: int = 2
    energy_chans: int = 256
    energy_kernel: int = 3
    energy_dropout: float = 0.5
    utt_embed_dim: Optional[int] = 64
    lang_embs: Optional[int] = 8000
    glow_blocks: int = 18
    glow_hidden: int = 192
    glow_kernel: int = 5
    glow_layers: int = 4
    glow_sqz: int = 2
    use_postflow: bool = True            # False: FastSpeech2-style, no glow
    conditional_predictors: bool = True  # False: plain-LayerNorm predictors
    dtype: torch.dtype = torch.float32


class ToucanTTS(nn.Module):
    def __init__(self, config: ToucanTTSConfig = ToucanTTSConfig()):
        super().__init__()
        c = self.config = config
        self.encoder = Conformer(c.adim, c.aheads, c.enc_units, c.enc_layers, c.enc_kernel,
                                 use_input_embedding=True, input_features=c.input_features,
                                 use_output_norm=True, utt_embed_dim=c.utt_embed_dim,
                                 lang_embs=c.lang_embs, dropout_rate=c.dropout)
        # unconditional predictors even where the encoder takes an utterance
        # embedding (toucan_tpu/models/toucan_tts.py:93)
        pred_utt_dim = c.utt_embed_dim if c.conditional_predictors else None
        self.duration_predictor = DurationPredictor(c.adim, c.duration_layers, c.duration_chans,
                                                    c.duration_kernel, pred_utt_dim,
                                                    c.duration_dropout)
        self.pitch_predictor = VariancePredictor(c.adim, c.pitch_layers, c.pitch_chans,
                                                 c.pitch_kernel, pred_utt_dim, c.pitch_dropout)
        self.energy_predictor = VariancePredictor(c.adim, c.energy_layers, c.energy_chans,
                                                  c.energy_kernel, pred_utt_dim, c.energy_dropout)
        self.pitch_embed = nn.Sequential(nn.Conv1d(1, c.adim, 1))
        self.energy_embed = nn.Sequential(nn.Conv1d(1, c.adim, 1))
        self.decoder = Conformer(c.adim, c.aheads, c.dec_units, c.dec_layers, c.dec_kernel,
                                 use_input_embedding=False, use_output_norm=False,
                                 dropout_rate=c.dropout)
        self.feat_out = nn.Linear(c.adim, c.mel_channels)
        # at PostNet's own rate, 0.5, which no config field reaches, as the JAX
        # model builds it (toucan_tpu/models/toucan_tts.py:111)
        self.conv_postnet = PostNet(c.mel_channels)
        if c.use_postflow:
            self.post_flow = Glow(c.mel_channels, c.glow_hidden, c.glow_kernel,
                                  n_blocks=c.glow_blocks, n_layers=c.glow_layers,
                                  n_sqz=c.glow_sqz, text_condition_channels=c.adim)
        self.to(c.dtype)

    @torch.no_grad()
    def infer(self, text, text_lengths, max_frames: int, utterance_embedding=None,
              lang_ids=None, gold_durations=None, gold_pitch=None, gold_energy=None,
              duration_scaling_factor=1.0, pitch_variance_scale=1.0,
              energy_variance_scale=1.0, pause_duration_scaling_factor=1.0,
              glow_noise=None):
        """text (B, T, 62); text_lengths (B,); lang_ids (B, 1); utterance
        embedding (B, E); gold_* override the predictions ((B, T) durations,
        (B, T, 1) pitch and energy).  ``glow_noise`` is (B, max_frames, 80).
        The four scales are floats or 0-d f32 tensors on the model's device:
        only the device reads a tensor, so a captured graph takes any value.

        Returns (before_outs, after_outs, durations, pitch, energy,
        mel_lengths), after_outs (B, max_frames, 80); frames past mel_lengths
        are padding that the caller drops.  Inputs are f32; the mels come out
        in the config's dtype, pitch and energy in f32 (JAX's variance
        scaling promotes them to its f32 knobs).  Without a post-flow the
        mel is the PostNet's, and an odd last frame is kept.
        """
        cfg = self.config
        dt = cfg.dtype
        f2i = feature_index()
        tmax = text.shape[1]
        if utterance_embedding is not None:
            utterance_embedding = F.normalize(utterance_embedding.float(), dim=-1)
        text_mask = make_non_pad_mask(text_lengths, tmax)
        text_cmask = text_mask[..., None].to(dt)
        encoded = self.encoder(text.to(dt), text_mask[:, None, :],
                               utterance_embedding=utterance_embedding, lang_ids=lang_ids,
                               conv_mask=text_cmask)

        pitch = (self.pitch_predictor(encoded, utterance_embedding, text_cmask)
                 if gold_pitch is None else gold_pitch)
        energy = (self.energy_predictor(encoded, utterance_embedding, text_cmask)
                  if gold_energy is None else gold_energy)
        durations = (self.duration_predictor(encoded, utterance_embedding, text_cmask)
                     if gold_durations is None else gold_durations.to(torch.int32))

        # linguistic fixes and control knobs
        voiced = text[..., f2i["voiced"]] == 1
        is_phoneme = text[..., f2i["phoneme"]] == 1
        word_boundary = text[..., f2i["word-boundary"]] == 1
        silence = text[..., f2i["silence"]] == 1
        zero = torch.zeros((), dtype=pitch.dtype, device=pitch.device)
        pitch = torch.where(voiced[..., None], pitch, zero)
        energy = torch.where(is_phoneme[..., None], energy, zero)
        durations = torch.where(word_boundary, torch.zeros_like(durations), durations)
        durations = torch.where(
            silence,
            torch.round(durations.float() * pause_duration_scaling_factor).to(torch.int32),
            durations)
        durations = torch.round(durations.float() * duration_scaling_factor).to(torch.int32)
        durations = torch.where(text_mask, durations, torch.zeros_like(durations))
        pitch = _scale_variance(pitch.float(), pitch_variance_scale)
        energy = _scale_variance(energy.float(), energy_variance_scale)

        # the all-zero fallback changes the returned durations, like the
        # reference's in-place LengthRegulator fix (LengthRegulator.py:52-53)
        durations = regulate_durations(durations)
        durations = torch.where(text_mask, durations, torch.zeros_like(durations))

        enriched = encoded + conv_btc(self.pitch_embed[0], pitch.to(dt)) \
            + conv_btc(self.energy_embed[0], energy.to(dt))
        upsampled = length_regulate(enriched, durations, max_frames)
        mel_lengths = durations.sum(1)
        frame_mask = make_non_pad_mask(mel_lengths, max_frames)
        frame_cmask = frame_mask[..., None].to(enriched.dtype)

        decoded = self.decoder(upsampled, frame_mask[:, None, :], conv_mask=frame_cmask)
        before_outs = self.feat_out(decoded)
        after_outs = before_outs + self.conv_postnet(before_outs, mask=frame_cmask)

        if cfg.use_postflow:
            glow_noise = (torch.zeros_like(after_outs) if glow_noise is None
                          else glow_noise.to(dt))
            after_outs = self.post_flow.sample(glow_noise, after_outs, upsampled,
                                               nonpadding=frame_cmask)
            # the flow's time squeeze drops a trailing odd frame (JAX
            # truncates only in its glow branch, toucan_tts.py:249-255)
            mel_lengths = (mel_lengths // cfg.glow_sqz) * cfg.glow_sqz
        return before_outs, after_outs, durations, pitch, energy, mel_lengths


def _scale_variance(seq, scale):
    """Widen/narrow a prosody curve around its nonzero mean (reference
    ``_scale_variance``, InferenceToucanTTS.py:333-343); ``scale`` a float
    or a 0-d tensor.  Scale 1 passes the curve through untouched (no clamp),
    chosen on the device as the JAX package's ``where`` does."""
    scale = torch.as_tensor(scale, dtype=seq.dtype, device=seq.device)
    nonzero = seq != 0.0
    denom = nonzero.sum(dim=(1, 2), keepdim=True).clamp(min=1)
    avg = torch.where(nonzero, seq, torch.zeros_like(seq)).sum(dim=(1, 2), keepdim=True) / denom
    scaled = torch.clamp((seq - avg) * scale + avg, min=0.0)
    return torch.where(scale == 1.0, seq, scaled)
