"""StochasticToucanTTS: ToucanTTS with VITS-style stochastic prosody flows.

Counterpart of ``toucan_tpu/models/stochastic_toucan_tts.py``; reference
``StochasticToucanTTS/StochasticToucanTTS.py``.  The conformer, PostNet and
glow are ``ToucanTTS``'s; duration, pitch and energy come from conditional
spline flows (6/6/3 flows).  ``forward`` returns the flow NLLs (each
normalized by its mask's count) and the glow loss; ``infer`` samples pitch,
then energy (on encodings that hold the pitch), then durations, at
``noise_scale`` 0.3.  On the card ``infer`` runs K1 in every encoder and
decoder block, as ``ToucanTTS.infer`` does; ``forward`` never reaches a
kernel.  The flows' noise is a ``torch.Generator``'s, or given as tensors
(``flow_noise``: the pitch, energy and duration flows' N(0, 1) draws,
(B, T, 2) each), so a test can inject the JAX package's.
"""

import torch
from torch import nn

from toucan_tpu_torch.frontend.inventory import feature_index
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.nn.conformer import Conformer
from toucan_tpu_torch.nn.convolution import conv_btc
from toucan_tpu_torch.nn.glow import Glow
from toucan_tpu_torch.nn.length_regulator import length_regulate, regulate_durations
from toucan_tpu_torch.nn.masks import make_non_pad_mask
from toucan_tpu_torch.nn.postnet import PostNet
from toucan_tpu_torch.nn.stochastic_flows import StochasticVariancePredictor

FLOWS = ("pitch_flow", "energy_flow", "duration_flow")  # the order infer samples them in


class StochasticToucanTTS(nn.Module):
    def __init__(self, config: ToucanTTSConfig = ToucanTTSConfig()):
        super().__init__()
        c = self.config = config
        self.encoder = Conformer(c.adim, c.aheads, c.enc_units, c.enc_layers, c.enc_kernel,
                                 use_input_embedding=True, input_features=c.input_features,
                                 use_output_norm=True, utt_embed_dim=c.utt_embed_dim,
                                 lang_embs=c.lang_embs, dropout_rate=c.dropout)
        self.duration_flow = StochasticVariancePredictor(c.adim, 5, 6, c.utt_embed_dim)
        self.pitch_flow = StochasticVariancePredictor(c.adim, 5, 6, c.utt_embed_dim)
        self.energy_flow = StochasticVariancePredictor(c.adim, 3, 3, c.utt_embed_dim)
        self.pitch_embed = nn.Sequential(nn.Conv1d(1, c.adim, 1))
        self.energy_embed = nn.Sequential(nn.Conv1d(1, c.adim, 1))
        self.decoder = Conformer(c.adim, c.aheads, c.dec_units, c.dec_layers, c.dec_kernel,
                                 use_input_embedding=False, use_output_norm=False,
                                 dropout_rate=c.dropout)
        self.feat_out = nn.Linear(c.adim, c.mel_channels)
        self.conv_postnet = PostNet(c.mel_channels)  # at its own rate, as ToucanTTS's
        self.post_flow = Glow(c.mel_channels, c.glow_hidden, c.glow_kernel,
                              n_blocks=c.glow_blocks, n_layers=c.glow_layers, n_sqz=c.glow_sqz,
                              text_condition_channels=c.adim)

    def forward(self, text, text_lengths, gold_speech, speech_lengths, gold_durations,
                gold_pitch, gold_energy, utterance_embedding=None, lang_ids=None,
                run_glow: bool = True, deterministic=None, train=None, flow_noise=None,
                generator=None):
        """The training pass.  Shapes as ``ToucanTTS.forward``'s;
        ``deterministic``/``train`` default to the module's mode.  Returns
        (before_outs, after_outs, duration, pitch and energy flow losses,
        glow loss or None)."""
        if deterministic is None:
            deterministic = not self.training
        if train is None:
            train = self.training
        noise = dict(zip(FLOWS, flow_noise or (None,) * 3))
        tmax, lmax = text.shape[1], gold_speech.shape[1]
        text_mask = make_non_pad_mask(text_lengths, tmax)
        cmask = text_mask[..., None].to(text.dtype)
        g = utterance_embedding[:, None, :] if utterance_embedding is not None else None
        encoded = self.encoder(text, text_mask[:, None, :], utterance_embedding=utterance_embedding,
                               lang_ids=lang_ids, deterministic=deterministic, train=train)

        def flow_loss(name, encoded, target, nonzero):
            mask = cmask * nonzero.to(cmask.dtype)
            nll = getattr(self, name).nll(encoded.detach(), mask, target, g=g,
                                          noise=noise[name], generator=generator)
            return nll.sum() / mask.sum().clamp(min=1.0)

        # pitch and energy targets are exp-scaled where nonzero; zeros are masked out
        pitch_loss = flow_loss("pitch_flow", encoded,
                               torch.where(gold_pitch != 0, torch.exp(gold_pitch), gold_pitch),
                               gold_pitch != 0)
        encoded = encoded + conv_btc(self.pitch_embed[0], gold_pitch)
        energy_loss = flow_loss("energy_flow", encoded,
                                torch.where(gold_energy != 0, torch.exp(gold_energy), gold_energy),
                                gold_energy != 0)
        encoded = encoded + conv_btc(self.energy_embed[0], gold_energy)
        duration_loss = flow_loss("duration_flow", encoded,
                                  gold_durations[..., None].to(encoded.dtype),
                                  (gold_durations != 0)[..., None])

        upsampled = length_regulate(encoded, gold_durations, lmax)
        speech_mask = make_non_pad_mask(speech_lengths, lmax)
        decoded = self.decoder(upsampled, speech_mask[:, None, :], deterministic=deterministic,
                               train=train)
        before_outs = self.feat_out(decoded)
        after_outs = before_outs + self.conv_postnet(before_outs, deterministic=deterministic)
        glow_loss = None
        if run_glow:
            glow_loss = self.post_flow.loss(gold_speech, after_outs.detach(), upsampled.detach(),
                                            speech_mask[..., None].to(before_outs.dtype))
        return before_outs, after_outs, duration_loss, pitch_loss, energy_loss, glow_loss

    @torch.no_grad()
    def infer(self, text, text_lengths, max_frames: int, utterance_embedding=None,
              lang_ids=None, glow_noise=None, flow_noise=None, generator=None,
              noise_scale: float = 0.3):
        """text (B, T, 62); text_lengths (B,); ``glow_noise`` (B, max_frames,
        80) (zeros where None).  Durations are ceil(exp(log-duration)),
        zeroed on word boundaries and padding, with the all-zero fallback.
        Returns (before_outs, after_outs, durations, pitch, energy,
        mel_lengths) as ``ToucanTTS.infer`` does."""
        cfg = self.config
        f2i = feature_index()
        noise = dict(zip(FLOWS, flow_noise or (None,) * 3))
        text_mask = make_non_pad_mask(text_lengths, text.shape[1])
        cmask = text_mask[..., None].to(text.dtype)
        g = utterance_embedding[:, None, :] if utterance_embedding is not None else None
        encoded = self.encoder(text, text_mask[:, None, :], utterance_embedding=utterance_embedding,
                               lang_ids=lang_ids, conv_mask=cmask)

        def draw(name, encoded):
            return getattr(self, name).sample(encoded, cmask, g=g, noise=noise[name],
                                              generator=generator, noise_scale=noise_scale)

        voiced = text[..., f2i["voiced"]] == 1
        pitch = torch.where(voiced[..., None], draw("pitch_flow", encoded), 0.0)
        encoded = encoded + conv_btc(self.pitch_embed[0], pitch)
        energy = draw("energy_flow", encoded)
        encoded = encoded + conv_btc(self.energy_embed[0], energy)
        durations = torch.ceil(torch.exp(draw("duration_flow", encoded)[..., 0])).to(torch.int32)
        zero = torch.zeros_like(durations)
        durations = torch.where(text[..., f2i["word-boundary"]] == 1, zero, durations)
        durations = regulate_durations(torch.where(text_mask, durations, zero))
        durations = torch.where(text_mask, durations, zero)

        upsampled = length_regulate(encoded, durations, max_frames)
        mel_lengths = durations.sum(1)
        frame_mask = make_non_pad_mask(mel_lengths, max_frames)
        frame_cmask = frame_mask[..., None].to(encoded.dtype)
        decoded = self.decoder(upsampled, frame_mask[:, None, :], conv_mask=frame_cmask)
        before_outs = self.feat_out(decoded)
        after_outs = before_outs + self.conv_postnet(before_outs, mask=frame_cmask)
        glow_noise = torch.zeros_like(after_outs) if glow_noise is None else glow_noise
        after_outs = self.post_flow.sample(glow_noise, after_outs, upsampled,
                                           nonpadding=frame_cmask)
        mel_lengths = (mel_lengths // cfg.glow_sqz) * cfg.glow_sqz
        return before_outs, after_outs, durations, pitch, energy, mel_lengths
