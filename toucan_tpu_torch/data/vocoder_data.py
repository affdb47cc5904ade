"""Vocoder training data (the reference's ``HiFiGAN/HiFiGANDataset.py``).

Counterpart of ``toucan_tpu/data/vocoder_data.py``.  Each sample pairs a
random 12288-sample segment of 24 kHz audio with the 32-frame log-mel of
the same segment taken at 16 kHz (the generator learns 16k-mel ->
24k-wave); 10 % of the samples get noise at 5 dB SNR on the mel side
(reference :87-95).  All draws come from one seeded
``np.random.RandomState`` in JAX's order, so a seed gives the JAX
package's segments and noise.  This is host code, as the reference's
DataLoader workers are: it reads files with ``frontend/audio.py::read_wave``
and takes the mel on CPU tensors (explicitly, not as a fallback); batches
reach the card through ``data/prefetch.py::DevicePrefetcher``.
"""

from __future__ import annotations

import numpy as np
import torch

from toucan_tpu_torch.frontend.audio import (log_mel_spectrogram, normalize_loudness, read_wave,
                                             resample)

SEGMENT_24K = 12288
SEGMENT_16K = 8192  # the same duration at 16 kHz
FRAMES = SEGMENT_16K // 256  # 32 mel frames


class VocoderDataset:
    def __init__(self, paths, seed: int = 0, noise_prob: float = 0.1,
                 noise_snr_db: float = 5.0, preload: bool = False):
        self.paths = list(paths)
        self.rng = np.random.RandomState(seed)
        self.noise_prob = noise_prob
        self.noise_snr_db = noise_snr_db
        self._cache = {}
        if preload:
            for p in self.paths:
                self._load(p)

    def _load(self, path):
        if path not in self._cache:
            wave, sr = read_wave(path)
            if wave.ndim == 2:
                wave = wave.mean(1)
            wave = normalize_loudness(wave, sr)
            wave_24 = resample(wave, sr, 24000) if sr != 24000 else wave
            wave_16 = resample(wave, sr, 16000) if sr != 16000 else wave
            self._cache[path] = (wave_24.astype(np.float32), wave_16.astype(np.float32))
        return self._cache[path]

    def sample_item(self):
        """(segment (12288, 1), log-mel (32, 80)), numpy float32."""
        for _ in range(20):
            path = self.paths[self.rng.randint(len(self.paths))]
            try:
                wave_24, wave_16 = self._load(path)
            except Exception:
                continue
            if len(wave_24) <= SEGMENT_24K + 1:
                continue
            max_frame_start = (len(wave_16) - SEGMENT_16K) // 256
            if max_frame_start <= 0:
                continue
            frame_start = self.rng.randint(max_frame_start)
            seg_16 = wave_16[frame_start * 256: frame_start * 256 + SEGMENT_16K]
            start_24 = frame_start * 384
            seg_24 = wave_24[start_24: start_24 + SEGMENT_24K]
            if len(seg_24) < SEGMENT_24K or len(seg_16) < SEGMENT_16K:
                continue
            mel_input = seg_16
            if self.rng.rand() < self.noise_prob:
                noise = self.rng.randn(len(seg_16)).astype(np.float32)
                speech_power = np.mean(seg_16 ** 2) + 1e-12
                noise_power = np.mean(noise ** 2)
                scale = np.sqrt(speech_power / (10 ** (self.noise_snr_db / 10) * noise_power))
                mel_input = seg_16 + scale * noise
            mel = log_mel_spectrogram(torch.from_numpy(np.asarray(mel_input, np.float32)))
            return seg_24[:, None], mel[:FRAMES].numpy()
        raise RuntimeError("could not sample a long-enough utterance")

    def sample_batch(self, batch_size: int):
        waves, mels = zip(*(self.sample_item() for _ in range(batch_size)))
        return {"gold_wave": np.stack(waves), "mel": np.stack(mels)}
