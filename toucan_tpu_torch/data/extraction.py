"""Prosody feature extraction from an alignment.

Counterpart of ``toucan_tpu/data/extraction.py``, which numerically mirrors
the reference calculators:

* durations from a binary alignment matrix by argmax voting
  (``FastSpeech2/DurationCalculator.py:30-31``), plus the word-boundary
  zero-duration insertion and repeated-phoneme 3/5-2/5 split of
  ``FastSpeech2/FastSpeechDataset.py:82-118``;
* token-averaged energy = sqrt(frame power) averaged per phone, non-phoneme
  symbols zeroed, normalized by the nonzero mean
  (``FastSpeech2/EnergyCalculator.py:38-93``);
* token-averaged pitch = F0 averaged over voiced frames per phone, unvoiced
  phones zeroed, normalized by the nonzero mean
  (``FastSpeech2/PitchCalculator.py:45-118``), with the native (C++) F0
  tracker of ``toucan_tpu_torch.native`` (numpy without a compiler).

Everything is host numpy copied from the JAX module but the frame energy,
whose STFT is the port's ``amplitude_spectrogram`` on ``device`` (the card
unless the caller passes "cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from toucan_tpu_torch.frontend.audio import amplitude_spectrogram
from toucan_tpu_torch.frontend.inventory import feature_index
from toucan_tpu_torch.native import estimate_f0
from toucan_tpu_torch.utils.device import resolve_device


def durations_from_alignment(alignment: np.ndarray) -> np.ndarray:
    """(frames, tokens) binary path -> per-token frame counts."""
    votes = alignment.argmax(-1)
    return np.bincount(votes, minlength=alignment.shape[1]).astype(np.int64)


def insert_word_boundary_durations(durations: np.ndarray,
                                   boundary_indices) -> np.ndarray:
    """Insert zero durations at word-boundary token positions (in the
    with-boundaries indexing, applied in ascending order like the
    reference's sequential cat loop)."""
    out = list(np.asarray(durations))
    for idx in boundary_indices:
        out.insert(idx, 0)
    return np.asarray(out, dtype=np.int64)


def split_repeated_phoneme_durations(durations: np.ndarray,
                                     text_vectors: np.ndarray) -> np.ndarray:
    """Consecutive identical phone vectors share their total 3/5 - 2/5."""
    durations = np.asarray(durations).copy()
    for i in range(1, len(text_vectors)):
        if np.array_equal(text_vectors[i - 1], text_vectors[i]):
            total = int(durations[i - 1] + durations[i])
            first = int((total / 5) * 3)
            durations[i - 1] = first
            durations[i] = total - first
    return durations


def compute_frame_energy(wave: np.ndarray, n_fft=1024, hop=256, device=None) -> np.ndarray:
    """sqrt of per-frame STFT power (clamped), reference EnergyCalculator;
    the STFT runs on ``device``."""
    audio = torch.as_tensor(np.asarray(wave, np.float32), device=resolve_device(device))
    power = (amplitude_spectrogram(audio, n_fft, hop) ** 2).sum(-1)
    return np.sqrt(np.maximum(power.cpu().numpy(), 1e-10))


def _adjust_num_frames(x: np.ndarray, n: int, center_pad: bool) -> np.ndarray:
    if n > len(x):
        missing = n - len(x)
        if center_pad:  # pitch pads symmetrically (PitchCalculator.py:79)
            x = np.pad(x, (int(np.ceil(missing / 2)), missing // 2))
        else:           # energy pads at the end (EnergyCalculator.py:90)
            x = np.pad(x, (0, missing))
    elif n < len(x):
        x = x[:n]
    return x


def token_average_energy(frame_energy: np.ndarray, durations: np.ndarray,
                         text_vectors: np.ndarray, n_frames: int | None = None,
                         normalize: bool = True) -> np.ndarray:
    f2i = feature_index()
    if n_frames is not None:
        frame_energy = _adjust_num_frames(frame_energy, n_frames, center_pad=False)
    ends = np.cumsum(durations)
    starts = ends - durations
    avg = np.zeros(len(durations), np.float32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        seg = frame_energy[s:e]
        avg[i] = seg.mean() if len(seg) else 0.0
    avg[np.asarray(text_vectors)[:, f2i["phoneme"]] == 0] = 0.0
    if normalize:
        nz = avg[avg != 0]
        if len(nz):
            avg = avg / nz.mean()
    return avg[:, None]


def token_average_pitch(f0: np.ndarray, durations: np.ndarray,
                        text_vectors: np.ndarray, n_frames: int | None = None,
                        normalize: bool = True) -> np.ndarray:
    f2i = feature_index()
    if n_frames is not None:
        f0 = _adjust_num_frames(f0, n_frames, center_pad=True)
    ends = np.cumsum(durations)
    starts = ends - durations
    avg = np.zeros(len(durations), np.float32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        seg = f0[s:e]
        voiced = seg[seg > 0]
        avg[i] = voiced.mean() if len(voiced) else 0.0
    avg[np.asarray(text_vectors)[:, f2i["voiced"]] == 0] = 0.0
    if normalize:
        nz = avg[avg != 0]
        if len(nz):
            avg = avg / nz.mean()
    return avg[:, None]


def extract_prosody(wave: np.ndarray, alignment: np.ndarray,
                    text_vectors: np.ndarray, boundary_indices,
                    n_frames: int, sr: int = 16000, hop: int = 256, device=None):
    """Full per-utterance pipeline: alignment -> durations (with boundary
    insertion + repeat split) -> token-averaged energy and pitch."""
    durations = durations_from_alignment(alignment)
    durations = insert_word_boundary_durations(durations, boundary_indices)
    durations = split_repeated_phoneme_durations(durations, text_vectors)
    energy = token_average_energy(compute_frame_energy(wave, hop=hop, device=device),
                                  durations, text_vectors, n_frames)
    pitch = token_average_pitch(estimate_f0(wave, sr=sr, hop=hop),
                                durations, text_vectors, n_frames)
    return durations, energy, pitch
