"""Audio -> log-mel spectrogram and signal conditioning.

Counterpart of ``toucan_tpu/frontend/audio.py`` (reference
``Preprocessing/AudioPreprocessor.py``).  The mel front end is PyTorch and
runs on the tensor's device: reflect-padded frames, a periodic Hann window,
``torch.fft.rfft`` magnitudes and one product with the slaney mel filters.
Loudness normalization (ITU-R BS.1770, pyloudnorm's K-weighting), the
polyphase sinc resampler and the energy-based silence trim are host numpy,
copied from the JAX package's module; the resampler prefers the native C++
one (``native.resample``) as the JAX package's does.  ``read_wav`` reads
PCM and IEEE-float WAV files, ``read_wave`` any file as JAX's
``data/corpus.py::read_wave`` does.

Parity-critical constants: 16 kHz, n_fft 1024, hop 256, 80 mels, fmin 40,
fmax 8000, log10, slaney mel filters, reflect padding, periodic Hann window.
"""

from __future__ import annotations

import math
import os
import wave as wave_mod
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from toucan_tpu_torch.utils.device import resolve_device


# ------------------------------------------------------------- mel filters

def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    lin = f / (200.0 / 3)
    log_step = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz, 15.0 + np.log(np.maximum(f, 1e-10) / min_log_hz) / log_step, lin)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    log_step = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), (200.0 / 3) * m)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int = 16000, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 40.0, fmax: float = 8000.0) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular filters, librosa-compatible (slaney
    scale, slaney area normalization)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


# -------------------------------------------------------------------- STFT

@lru_cache(maxsize=None)
def _hann_periodic(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)


def stft_frames(audio: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Centered (reflect-padded) frames (..., n_frames, n_fft)."""
    pad = n_fft // 2
    lead = audio.shape[:-1]
    padded = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")
    return padded.reshape(*lead, -1).unfold(-1, n_fft, hop)


def amplitude_spectrogram(audio: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """|STFT| (..., n_frames, n_fft//2+1) of audio, on its device: in f32,
    or in float64 for float64 audio (a float64 check of the vocoder loss)."""
    frames = stft_frames(audio.to(torch.promote_types(audio.dtype, torch.float32)), n_fft, hop)
    window = torch.from_numpy(_hann_periodic(n_fft)).to(frames.device)
    return torch.fft.rfft(frames * window, dim=-1).abs()


def log_mel_spectrogram(audio: torch.Tensor, sr: int = 16000, n_fft: int = 1024, hop: int = 256,
                        n_mels: int = 80, fmin: float = 40.0, fmax: float = 8000.0,
                        eps: float = 1e-10) -> torch.Tensor:
    """log10 mel spectrogram (..., n_frames, n_mels), the model's input
    orientation (the reference returns the (n_mels, T) transpose)."""
    spc = amplitude_spectrogram(audio, n_fft, hop)
    basis = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(spc.device)
    return torch.log10(torch.clamp(spc @ basis.T, min=eps))


# --------------------------------------------------- loudness (ITU BS.1770)

def _k_weighting_coeffs(sr: float):
    """High-shelf + high-pass biquads of BS.1770-4 (pyloudnorm's defaults)."""
    # stage 1: spherical-head high shelf
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = math.tan(math.pi * f0 / sr)
    Vh = 10 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = [(Vh + Vb * K / Q + K * K) / a0,
               2.0 * (K * K - Vh) / a0,
               (Vh - Vb * K / Q + K * K) / a0]
    a_shelf = [1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0]
    # stage 2: high pass
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / sr)
    a_hp = [1.0, 2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
            (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K)]
    b_hp = [1.0, -2.0, 1.0]
    return (b_shelf, a_shelf), (b_hp, a_hp)


def integrated_loudness(audio: np.ndarray, sr: int) -> float:
    """Gated integrated loudness (LUFS) of a mono signal, BS.1770-4."""
    from scipy.signal import lfilter

    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    y = lfilter(b1, a1, audio.astype(np.float64))
    y = lfilter(b2, a2, y)

    block = int(0.4 * sr)
    step = int(0.1 * sr)  # 75% overlap
    if len(y) < block:
        raise ValueError("audio too short for loudness measurement")
    n_blocks = 1 + (len(y) - block) // step
    starts = np.arange(n_blocks) * step
    power = np.array([np.mean(y[s:s + block] ** 2) for s in starts])
    loud = -0.691 + 10 * np.log10(np.maximum(power, 1e-30))
    above_abs = loud > -70.0
    if not above_abs.any():
        return -70.0
    rel_gate = -0.691 + 10 * np.log10(power[above_abs].mean()) - 10.0
    keep = above_abs & (loud > rel_gate)
    if not keep.any():
        return -70.0
    return float(-0.691 + 10 * np.log10(power[keep].mean()))


def normalize_loudness(audio: np.ndarray, sr: int, target_lufs: float = -30.0) -> np.ndarray:
    """-30 LUFS loudness normalization followed by peak normalization
    (reference: AudioPreprocessor.py:79-94)."""
    try:
        loudness = integrated_loudness(audio, sr)
    except ValueError:
        return audio
    gain = 10.0 ** ((target_lufs - loudness) / 20.0)
    out = audio * gain
    peak = np.max(np.abs(out))
    return out / peak if peak > 0 else out


# ---------------------------------------------------------------- resample

@lru_cache(maxsize=None)
def _sinc_resample_kernel(orig_sr: int, new_sr: int, lowpass_width: int = 6,
                          rolloff: float = 0.99):
    """Polyphase hann-windowed sinc kernel (torchaudio-compatible math)."""
    gcd = math.gcd(orig_sr, new_sr)
    orig, new = orig_sr // gcd, new_sr // gcd
    base_freq = min(orig, new) / 2.0 * rolloff
    width = math.ceil(lowpass_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig  # (1, K)
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx  # (new, K)
    t = t * base_freq
    t = np.clip(t, -lowpass_width, lowpass_width)
    window = np.cos(t * np.pi / lowpass_width / 2) ** 2
    scale = base_freq / orig
    kernel = np.sinc(t) * window * scale
    return kernel.astype(np.float32), orig, new, width


def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase sinc resampling of a mono signal.

    Prefers the native C++ path (``toucan_tpu_torch.native.resample``,
    threaded, equal to the numpy path to float32 rounding) where the host
    has g++, as ``toucan_tpu/frontend/audio.py::resample`` does; set
    ``TOUCAN_NATIVE_RESAMPLE=0`` for the numpy path (``resample_numpy``)."""
    if orig_sr == new_sr:
        return audio
    if os.environ.get("TOUCAN_NATIVE_RESAMPLE", "1") != "0":
        from toucan_tpu_torch import native
        if native.native_resample_available():
            return native.resample(audio, orig_sr, new_sr)
    return resample_numpy(audio, orig_sr, new_sr)


def resample_numpy(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase sinc resampling of a mono signal (numpy)."""
    if orig_sr == new_sr:
        return audio
    kernel, orig, new, width = _sinc_resample_kernel(orig_sr, new_sr)
    length = len(audio)
    audio_p = np.pad(audio.astype(np.float32), (width, width + orig))
    n_out_blocks = int(math.ceil(length / orig))
    # strided view: block b covers audio_p[b*orig : b*orig + K]
    K = kernel.shape[1]
    strides = audio_p.strides[0]
    blocks = np.lib.stride_tricks.as_strided(
        audio_p, shape=(n_out_blocks, K), strides=(orig * strides, strides))
    out = blocks @ kernel.T  # (blocks, new)
    out = out.reshape(-1)
    target_len = int(math.ceil(new_sr * length / orig_sr))
    return out[:target_len]


# --------------------------------------------------------------------- VAD

def trim_silence(audio: np.ndarray, sr: int, frame_ms: float = 30.0,
                 threshold_db: float = -40.0, hangover: int = 4):
    """Energy-based speech span detection; trims leading/trailing silence.

    Stands in for the reference's silero-VAD trim
    (``AudioPreprocessor.py:66-77``); returns (trimmed, start_sample,
    end_sample) so callers (e.g. the prosody cloner) can reconstruct the
    removed spans.
    """
    frame = max(1, int(sr * frame_ms / 1000))
    n = len(audio) // frame
    if n == 0:
        return audio, 0, len(audio)
    frames = audio[:n * frame].reshape(n, frame)
    rms_db = 10 * np.log10(np.maximum(np.mean(frames ** 2, axis=1), 1e-12))
    ref_db = np.max(rms_db)
    speech = rms_db > max(ref_db + threshold_db, -60.0)
    if not speech.any():
        return audio, 0, len(audio)
    first = max(0, int(np.argmax(speech)) - hangover)
    last = min(n, n - int(np.argmax(speech[::-1])) + hangover)
    start, end = first * frame, min(len(audio), last * frame)
    return audio[start:end], start, end


# ------------------------------------------------------------------ files

def read_wav(path) -> tuple:
    """(samples, sr) of a WAV file: float32, (n,) for mono and (n, channels)
    otherwise.  8- to 32-bit PCM is read with the standard library and
    scaled to [-1, 1); IEEE float (32 or 64 bit, plain or
    WAVE_FORMAT_EXTENSIBLE), which the standard library refuses, through
    ``scipy.io.wavfile``, its values as they are (64-bit rounded to f32)."""
    try:
        with wave_mod.open(str(path), "rb") as f:
            channels, width, sr = f.getnchannels(), f.getsampwidth(), f.getframerate()
            raw = f.readframes(f.getnframes())
    except wave_mod.Error:
        from scipy.io import wavfile

        sr, data = wavfile.read(str(path))
        if data.dtype.kind != "f":
            raise
        return data.astype(np.float32), sr
    if width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width in (2, 4):
        data = np.frombuffer(raw, f"<i{width}").astype(np.float32) / float(2 ** (8 * width - 1))
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        data = (np.where(v >= 2 ** 23, v - 2 ** 24, v) / float(2 ** 23)).astype(np.float32)
    else:
        raise ValueError(f"{path}: {8 * width}-bit PCM is not supported")
    return (data if channels == 1 else data.reshape(-1, channels)), sr


def read_wave(path) -> tuple:
    """(float32 samples, sr) of an audio file, as
    ``toucan_tpu/data/corpus.py::read_wave`` loads a reference: soundfile
    where it is installed (any format it reads), else ``read_wav``."""
    from toucan_tpu_torch.utils.optional import optional_import

    try:
        soundfile = optional_import("soundfile")
    except ImportError:
        return read_wav(path)
    wave, sr = soundfile.read(str(path))
    return np.asarray(wave, np.float32), sr


# ------------------------------------------------------------ orchestrator

@dataclass
class AudioPreprocessor:
    """Mirror of the reference preprocessing pipeline (mono -> loudness ->
    resample -> optional VAD trim -> log-mel); the mel runs on the card
    unless the caller passes ``device="cpu"``."""

    input_sr: int
    output_sr: int | None = None
    n_mels: int = 80
    hop_length: int = 256
    n_fft: int = 1024
    fmin: float = 40.0
    fmax: float = 8000.0
    cut_silence: bool = False

    def __post_init__(self):
        self.final_sr = self.output_sr or self.input_sr

    def to_mono(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, dtype=np.float32)
        return audio.mean(axis=1) if audio.ndim == 2 else audio

    def normalize_audio(self, audio: np.ndarray) -> np.ndarray:
        audio = self.to_mono(audio)
        audio = normalize_loudness(audio, self.input_sr)
        if self.output_sr is not None and self.output_sr != self.input_sr:
            audio = resample(audio, self.input_sr, self.output_sr)
        if self.cut_silence:
            audio, _, _ = trim_silence(audio, self.final_sr)
        return audio

    def audio_to_wave_tensor(self, audio, normalize: bool = True) -> np.ndarray:
        """The conditioned wave on the host (loudness, resampling, trim), or
        the input as float32 with ``normalize=False``."""
        return self.normalize_audio(audio) if normalize else np.asarray(audio, np.float32)

    def audio_to_mel_spec_tensor(self, audio, normalize: bool = True,
                                 explicit_sampling_rate: int | None = None,
                                 device=None) -> torch.Tensor:
        """(n_mels, T) log-mel, the reference's orientation, on ``device``:
        the card by default; pass "cpu" for the CPU."""
        sr = explicit_sampling_rate or (self.final_sr if normalize else self.input_sr)
        if normalize and explicit_sampling_rate is None:
            audio = self.normalize_audio(audio)
        audio = torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))
        mel = log_mel_spectrogram(audio, sr=sr, n_fft=self.n_fft, hop=self.hop_length,
                                  n_mels=self.n_mels, fmin=self.fmin, fmax=self.fmax)
        return mel.T
