"""StochasticToucanTTS: ToucanTTS with VITS-style stochastic prosody flows,
synthesis only.

Reference: IMS-Toucan
``TrainingInterfaces/Text_to_Spectrogram/StochasticToucanTTS/StochasticToucanTTS.py:120-136``
(the flows) and ``StochasticVariancePredictor.py:39-116`` (the predictor).
(Frozen copy of ``toucan_tpu_torch/models/stochastic_toucan_tts.py``'s
``infer``, on the reference's conformer, PostNet and glow, whose attention
is K1's plain version, ``reference/kernels_plain.py``.)  The conformer
encoder and decoder, PostNet and glow are ToucanTTS's; pitch, then energy
(on encodings that hold the pitch), then durations are sampled by
conditional spline flows, 6, 3 and 6 of them, at ``noise_scale`` 0.3;
durations are ceil(exp(.)), zeroed on word boundaries.

Departures from IMS-Toucan:

- the decoder runs at a static ``max_frames`` (the program's bucket): the
  durations are not bounded, and where they sum past it the frames beyond
  are not decoded while ``mel_lengths`` still report the whole sum;
- the noise is given (the three flows' N(0, 1) draws and the glow's), so
  that the program's draws can be replayed; none is drawn here;
- the first-trained ConvFlow of each predictor is dropped in sampling, as
  IMS-Toucan drops it ("remove a useless vflow"), the flip kept in front
  of the affine;
- ``durations`` (optional) replaces the sampled durations after the flows
  have run, so that the wave can be judged at the durations a program
  served; the flows' draws are unchanged by it;
- ``infer`` also returns the log-durations the duration flow sampled,
  before ceil, which the check's near-tie rule reads.
"""

from dataclasses import dataclass

import torch
from torch import nn

from bench_h100.reference.frontend.inventory import feature_index
from bench_h100.reference.models.toucan_tts import ToucanTTSConfig
from bench_h100.reference.nn.conformer import Conformer
from bench_h100.reference.nn.convolution import conv_btc
from bench_h100.reference.nn.glow import Glow
from bench_h100.reference.nn.length_regulator import length_regulate, regulate_durations
from bench_h100.reference.nn.masks import make_non_pad_mask
from bench_h100.reference.nn.postnet import PostNet
from bench_h100.reference.nn.stochastic_flows import StochasticVariancePredictor

FLOWS = ("pitch_flow", "energy_flow", "duration_flow")  # the order infer samples them in


@dataclass(frozen=True)
class FlowConfig:
    """The published flows (IMS-Toucan ``StochasticToucanTTS.py:120-136``)."""
    duration_flows: int = 6
    duration_kernel: int = 5
    pitch_flows: int = 6
    pitch_kernel: int = 5
    energy_flows: int = 3
    energy_kernel: int = 3
    num_bins: int = 10
    tail_bound: float = 5.0
    noise_scale: float = 0.3


class StochasticToucanTTS(nn.Module):
    def __init__(self, config: ToucanTTSConfig = ToucanTTSConfig(),
                 flows: FlowConfig = FlowConfig()):
        super().__init__()
        c = self.config = config
        f = self.flow_config = flows
        self.encoder = Conformer(c.adim, c.aheads, c.enc_units, c.enc_layers, c.enc_kernel,
                                 use_input_embedding=True, input_features=c.input_features,
                                 use_output_norm=True, utt_embed_dim=c.utt_embed_dim,
                                 lang_embs=c.lang_embs, dropout_rate=c.dropout)

        def predictor(kind):
            return StochasticVariancePredictor(
                c.adim, getattr(f, f"{kind}_kernel"), getattr(f, f"{kind}_flows"),
                c.utt_embed_dim, num_bins=f.num_bins, tail_bound=f.tail_bound)

        self.duration_flow = predictor("duration")
        self.pitch_flow = predictor("pitch")
        self.energy_flow = predictor("energy")
        self.pitch_embed = nn.Sequential(nn.Conv1d(1, c.adim, 1))
        self.energy_embed = nn.Sequential(nn.Conv1d(1, c.adim, 1))
        self.decoder = Conformer(c.adim, c.aheads, c.dec_units, c.dec_layers, c.dec_kernel,
                                 use_input_embedding=False, use_output_norm=False,
                                 dropout_rate=c.dropout)
        self.feat_out = nn.Linear(c.adim, c.mel_channels)
        self.conv_postnet = PostNet(c.mel_channels)
        self.post_flow = Glow(c.mel_channels, c.glow_hidden, c.glow_kernel,
                              n_blocks=c.glow_blocks, n_layers=c.glow_layers, n_sqz=c.glow_sqz,
                              text_condition_channels=c.adim)

    @torch.no_grad()
    def prosody(self, text, text_lengths, utterance_embedding, lang_ids, flow_noise):
        """The encoder and the three flows: (encodings with the pitch and
        energy added, pitch (B, T, 1), energy (B, T, 1), log-durations (B,
        T)); ``flow_noise`` the pitch, energy and duration flows' N(0, 1)
        draws, (B, T, 2) each."""
        f2i = feature_index()
        noise = dict(zip(FLOWS, flow_noise))
        text_mask = make_non_pad_mask(text_lengths, text.shape[1])
        cmask = text_mask[..., None].to(text.dtype)
        g = utterance_embedding[:, None, :]
        encoded = self.encoder(text, text_mask[:, None, :], utterance_embedding=utterance_embedding,
                               lang_ids=lang_ids, conv_mask=cmask)

        def draw(name, encoded):
            return getattr(self, name).sample(encoded, cmask, g, noise[name],
                                              self.flow_config.noise_scale)

        voiced = text[..., f2i["voiced"]] == 1
        pitch = torch.where(voiced[..., None], draw("pitch_flow", encoded), 0.0)
        encoded = encoded + conv_btc(self.pitch_embed[0], pitch)
        energy = draw("energy_flow", encoded)
        encoded = encoded + conv_btc(self.energy_embed[0], energy)
        return encoded, pitch, energy, draw("duration_flow", encoded)[..., 0]

    @torch.no_grad()
    def infer(self, text, text_lengths, max_frames: int, utterance_embedding, lang_ids,
              glow_noise, flow_noise, durations=None):
        """text (B, T, 62); text_lengths (B,); ``glow_noise`` (B, max_frames,
        80); ``flow_noise`` as ``prosody``'s; ``durations`` (B, T) or None.
        Returns (before_outs, after_outs, durations, pitch, energy,
        mel_lengths, log_durations)."""
        cfg = self.config
        encoded, pitch, energy, log_durations = self.prosody(
            text, text_lengths, utterance_embedding, lang_ids, flow_noise)
        if durations is None:
            durations = torch.ceil(torch.exp(log_durations)).to(torch.int32)
        text_mask = make_non_pad_mask(text_lengths, text.shape[1])
        zero = torch.zeros_like(durations)
        durations = torch.where(text[..., feature_index()["word-boundary"]] == 1, zero, durations)
        durations = regulate_durations(torch.where(text_mask, durations, zero))
        durations = torch.where(text_mask, durations, zero)

        upsampled = length_regulate(encoded, durations, max_frames)
        mel_lengths = durations.sum(1)
        frame_mask = make_non_pad_mask(mel_lengths, max_frames)
        frame_cmask = frame_mask[..., None].to(encoded.dtype)
        decoded = self.decoder(upsampled, frame_mask[:, None, :], conv_mask=frame_cmask)
        before_outs = self.feat_out(decoded)
        after_outs = before_outs + self.conv_postnet(before_outs, mask=frame_cmask)
        after_outs = self.post_flow.sample(glow_noise, after_outs, upsampled,
                                           nonpadding=frame_cmask)
        mel_lengths = (mel_lengths // cfg.glow_sqz) * cfg.glow_sqz
        return before_outs, after_outs, durations, pitch, energy, mel_lengths, log_durations
