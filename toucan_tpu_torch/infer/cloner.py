"""Exact prosody cloning (UtteranceCloner).

Counterpart of ``toucan_tpu/infer/cloner.py`` (reference
``InferenceInterfaces/UtteranceCloner.py``): from a reference recording and
its transcript, extract per-phone durations (through the aligner, after a
5-step fine-tune on that one utterance), token-averaged pitch and energy,
and resynthesize them in any voice; the leading and trailing silence that
the trim removed is put back around the generated audio.

The aligner, its fine-tune and the mel run on the interface's device; the
fine-tune trains a copy of the loaded aligner, so calls never pile up, and
runs with grad enabled whatever the caller's mode.  The aligner's layers
are library kernels (cuDNN convs, LSTM and CTC); the synthesis is the
interface's, through K1 and K2.  Every entry point runs in f32
(``utils.device.f32_precision``).
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from toucan_tpu_torch.data.extraction import extract_prosody
from toucan_tpu_torch.frontend.audio import AudioPreprocessor, trim_silence
from toucan_tpu_torch.frontend.inventory import feature_index, vectors_to_ctc_ids
from toucan_tpu_torch.frontend.text import TextFrontend
from toucan_tpu_torch.infer.interface import write_wav
from toucan_tpu_torch.models.aligner import Aligner, alignment_from_logits, ctc_loss
from toucan_tpu_torch.utils.device import f32_precision


class Reference(NamedTuple):
    """A reference recording prepared for the aligner."""
    wave: np.ndarray          # loudness-normalized and trimmed, 16 kHz
    mel: torch.Tensor         # (T, 80) log-mel of ``wave`` on the device
    text: np.ndarray          # (N, 62) phone features with word boundaries
    token_ids: list           # CTC ids of the phones (no boundaries)
    start_silence: int        # 16 kHz samples trimmed in front
    end_silence: int          # and at the back


class UtteranceCloner:
    def __init__(self, tts_interface, aligner_state_dict, language: str = "en"):
        """``aligner_state_dict``: an aligner's (reference keys,
        ``load.load_aligner``); the aligner takes its widths."""
        self.tts = tts_interface
        self.device = tts_interface.device
        self.aligner = Aligner.for_state_dict(aligner_state_dict)
        self.aligner.load_state_dict(aligner_state_dict)
        self.aligner.to(self.device).eval()
        self.ap = AudioPreprocessor(input_sr=16000, output_sr=16000, cut_silence=False)
        self.tf = TextFrontend(language=language, use_g2p=tts_interface.use_g2p)

    def _fine_tune_aligner(self, mel: torch.Tensor, token_ids, steps: int = 5,
                           lr: float = 0.1) -> Aligner:
        """A copy of the aligner after a few SGD steps on this one utterance,
        each gradient clipped to a global norm of 1, like the reference's
        on_line_fine_tune (UtteranceCloner.py:75-94); BatchNorm normalizes
        with the utterance's statistics and updates its running ones, dropout
        stays off."""
        aligner = copy.deepcopy(self.aligner)
        aligner.train()  # cuDNN's LSTM backward needs the module in training mode
        opt = torch.optim.SGD(aligner.parameters(), lr=lr)
        with torch.inference_mode(False), torch.enable_grad():
            mel_b = mel[None].clone()
            tokens = torch.as_tensor(np.asarray(token_ids)[None], device=self.device)
            mel_len, tok_len = [mel.shape[0]], [len(token_ids)]
            for _ in range(steps):
                logits = aligner(mel_b, mel_len, train=True, deterministic=True)
                loss = ctc_loss(logits, mel_len, tokens, tok_len)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                torch.nn.utils.clip_grad_norm_(aligner.parameters(), 1.0)
                opt.step()
        return aligner.eval()

    @f32_precision()
    @torch.no_grad()
    def logits(self, aligner: Aligner, mel: torch.Tensor) -> np.ndarray:
        """(T, num_symbols) logits of ``mel`` (T, 80), on the host."""
        return aligner(mel[None])[0].cpu().numpy()

    @f32_precision()
    def prepare(self, transcript: str, ref_wave, sr: int = 16000, lang: str = "en",
                input_is_phones: bool = False) -> Reference:
        """The host's audio front end and the mel on the device."""
        if self.tf.language != lang:
            self.tf = TextFrontend(language=lang, use_g2p=self.tts.use_g2p)
        if self.ap.input_sr != sr:
            self.ap = AudioPreprocessor(input_sr=sr, output_sr=16000, cut_silence=False)
        full_wave = self.ap.audio_to_wave_tensor(ref_wave, normalize=True)
        norm_wave, start, end = trim_silence(full_wave, 16000)
        text = self.tf.string_to_features(transcript, input_phonemes=input_is_phones)
        with torch.no_grad():
            mel = self.ap.audio_to_mel_spec_tensor(norm_wave, normalize=False,
                                                   explicit_sampling_rate=16000,
                                                   device=self.device).T
        return Reference(norm_wave, mel, text, vectors_to_ctc_ids(text), start,
                         len(full_wave) - end)

    @f32_precision()
    def extract_prosody(self, transcript: str, ref_wave, sr: int = 16000,
                        lang: str = "en", on_line_fine_tune: bool = True,
                        input_is_phones: bool = False, pathfinding: str = "MAS"):
        """-> (durations, pitch (N, 1), energy (N, 1), start silence, end
        silence in 16 kHz samples)."""
        ref = self.prepare(transcript, ref_wave, sr, lang, input_is_phones)
        aligner = self.aligner
        if on_line_fine_tune:
            aligner = self._fine_tune_aligner(ref.mel, ref.token_ids)
        logits = self.logits(aligner, ref.mel)
        return self.prosody(ref, alignment_from_logits(logits, ref.token_ids,
                                                       method=pathfinding))

    @f32_precision()
    def prosody(self, ref: Reference, alignment: np.ndarray):
        """``extract_prosody``'s result from the (frames, phones) alignment
        of ``ref``: durations, then pitch and energy averaged over them."""
        f2i = feature_index()
        boundary_indices = [i for i, v in enumerate(ref.text) if v[f2i["word-boundary"]] == 1]
        durations, energy, pitch = extract_prosody(
            ref.wave, alignment, ref.text, boundary_indices, n_frames=ref.mel.shape[0],
            device=self.device)
        return durations, pitch, energy, ref.start_silence, ref.end_silence

    def clone_utterance(self, reference_wave_for_intonation, transcription,
                        reference_wave_for_voice=None, sr: int = 16000,
                        lang: str = "en", filename_of_result=None,
                        input_is_phones: bool = False):
        """Returns a 24 kHz wave with the reference's exact prosody."""
        if reference_wave_for_voice is not None:
            self.tts.set_utterance_embedding(wave=reference_wave_for_voice, sr=sr)
        durations, pitch, energy, sil_start, sil_end = self.extract_prosody(
            transcription, reference_wave_for_intonation, sr=sr, lang=lang,
            input_is_phones=input_is_phones)
        self.tts.set_language(lang)
        # silence timestamps are 16 kHz samples; output runs at 24 kHz
        start_sil = np.zeros(int(sil_start * 1.5), np.float32)
        end_sil = np.zeros(int(sil_end * 1.5), np.float32)
        wave = self.tts(transcription, durations=durations,
                        pitch=pitch, energy=energy, input_is_phones=input_is_phones)
        out = np.concatenate([start_sil, wave, end_sil])
        if filename_of_result is not None:
            write_wav(filename_of_result, out, 24000)
        return out

    def biblical_accurate_angel_mode(self, reference_wave_for_intonation,
                                     transcription, list_of_voice_waves,
                                     sr: int = 16000, lang: str = "en",
                                     filename_of_result=None):
        """Average several voices over identical prosody (reference
        UtteranceCloner.py:169-194)."""
        prev_embedding = self.tts.default_utterance_embedding.copy()
        durations, pitch, energy, sil_start, sil_end = self.extract_prosody(
            transcription, reference_wave_for_intonation, sr=sr, lang=lang)
        self.tts.set_language(lang)
        waves = []
        for voice_wave in list_of_voice_waves:
            self.tts.set_utterance_embedding(wave=voice_wave, sr=sr)
            waves.append(self.tts(transcription, durations=durations,
                                  pitch=pitch, energy=energy))
        n = min(len(w) for w in waves)
        mean_wave = np.stack([w[:n] for w in waves]).mean(0)
        out = np.concatenate([np.zeros(int(sil_start * 1.5), np.float32),
                              mean_wave,
                              np.zeros(int(sil_end * 1.5), np.float32)])
        self.tts.default_utterance_embedding = prev_embedding
        if filename_of_result is not None:
            write_wav(filename_of_result, out, 24000)
        return out
