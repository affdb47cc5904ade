"""F0 estimation (Praat-style autocorrelation with Viterbi path).

Replaces the reference's praat-parselmouth dependency
(``FastSpeech2/PitchCalculator.py:64-73``: ``snd.to_pitch(time_step=
hop/fs, pitch_floor=40, pitch_ceiling=600)``).  Implements Boersma's
AC method: per-frame normalized autocorrelation (corrected by the window's
own autocorrelation), candidate peaks with octave-cost weighting, and a
Viterbi pass with octave-jump and voicing-transition costs.  Host-side
numpy — this runs at dataset-build time.

Matches Praat within tolerance on voiced frames of clean speech; exact
frame-level equality with Praat is not required by the pipeline (pitch is
token-averaged and mean-normalized downstream).
"""

from __future__ import annotations

import numpy as np

_OCTAVE_COST = 0.01
_VOICING_THRESHOLD = 0.45
_SILENCE_THRESHOLD = 0.03
_OCTAVE_JUMP_COST = 0.35
_VOICED_UNVOICED_COST = 0.14
_MAX_CANDIDATES = 15


def estimate_f0(audio: np.ndarray, sr: int = 16000, hop: int = 256,
                fmin: float = 40.0, fmax: float = 600.0) -> np.ndarray:
    """Mono float audio -> per-frame F0 in Hz (0 for unvoiced frames).

    Frame times follow Praat's centered analysis: frames are centered on
    t0 + i*hop/sr with a symmetric margin so the count roughly matches
    ``len(audio)//hop`` (the caller pads/crops to the mel frame count).
    """
    audio = np.asarray(audio, dtype=np.float64)
    window_len = int(3.0 / fmin * sr)  # 3 periods of the lowest pitch
    window_len += window_len % 2
    half = window_len // 2

    global_peak = np.max(np.abs(audio)) + 1e-12

    n_frames = max(1, int(np.floor((len(audio) - window_len) / hop)) + 1)
    t_start = (len(audio) - ((n_frames - 1) * hop + window_len)) // 2

    window = np.hanning(window_len)
    win_ac = _autocorr(window)
    win_ac /= win_ac[0]

    lag_min = int(sr / fmax)
    lag_max = min(int(sr / fmin) + 1, window_len - 1)

    cand_freqs = []   # per frame: array of candidate freqs (0 = unvoiced)
    cand_str = []     # per frame: candidate strengths
    for i in range(n_frames):
        s = t_start + i * hop
        frame = audio[s:s + window_len]
        local_peak = np.max(np.abs(frame)) + 1e-12
        frame = (frame - frame.mean()) * window
        ac = _autocorr(frame)
        if ac[0] <= 0:
            cand_freqs.append(np.array([0.0]))
            cand_str.append(np.array([_VOICING_THRESHOLD + 2.0]))
            continue
        r = ac / ac[0]
        r = r / np.maximum(win_ac, 1e-6)  # Boersma's window correction
        r = r[: lag_max + 1]

        peaks = _local_maxima(r, lag_min, lag_max)
        freqs, strengths = [0.0], [
            _VOICING_THRESHOLD + max(0.0, 2.0 - (local_peak / global_peak)
                                     / (_SILENCE_THRESHOLD / (1.0 + _VOICING_THRESHOLD)))]
        order = np.argsort(r[peaks])[::-1][:_MAX_CANDIDATES] if len(peaks) else []
        for idx in order:
            lag = peaks[idx]
            lag_ref, r_ref = _parabolic_interp(r, lag)
            f = sr / lag_ref
            if f < fmin or f > fmax:
                continue
            strength = r_ref - _OCTAVE_COST * np.log2(fmin * lag_ref / sr)
            freqs.append(f)
            strengths.append(strength)
        cand_freqs.append(np.asarray(freqs))
        cand_str.append(np.asarray(strengths))

    return _viterbi(cand_freqs, cand_str, sr, hop)


def _autocorr(x: np.ndarray) -> np.ndarray:
    n = len(x)
    fft_n = 1 << (2 * n - 1).bit_length()
    spec = np.fft.rfft(x, fft_n)
    ac = np.fft.irfft(spec * np.conj(spec), fft_n)[:n]
    return ac


def _local_maxima(r, lag_min, lag_max):
    seg = r[lag_min:lag_max]
    if len(seg) < 3:
        return np.array([], dtype=int)
    mask = (seg[1:-1] > seg[:-2]) & (seg[1:-1] >= seg[2:]) & (seg[1:-1] > 0)
    return np.flatnonzero(mask) + lag_min + 1


def _parabolic_interp(r, lag):
    if 1 <= lag < len(r) - 1:
        a, b, c = r[lag - 1], r[lag], r[lag + 1]
        denom = a - 2 * b + c
        if abs(denom) > 1e-12:
            delta = 0.5 * (a - c) / denom
            delta = np.clip(delta, -0.5, 0.5)
            return lag + delta, b - 0.25 * (a - c) * delta
    return float(lag), r[lag]


def _viterbi(cand_freqs, cand_str, sr, hop):
    n = len(cand_freqs)
    costs = [s.copy() for s in cand_str]  # higher = better
    back = []
    for i in range(1, n):
        prev_f, cur_f = cand_freqs[i - 1], cand_freqs[i]
        trans = np.zeros((len(prev_f), len(cur_f)))
        for a, fa in enumerate(prev_f):
            for b, fb in enumerate(cur_f):
                if fa == 0 and fb == 0:
                    cost = 0.0
                elif fa == 0 or fb == 0:
                    cost = _VOICED_UNVOICED_COST
                else:
                    cost = _OCTAVE_JUMP_COST * abs(np.log2(fa / fb))
                trans[a, b] = cost
        total = costs[i - 1][:, None] - trans + cand_str[i][None, :]
        back.append(np.argmax(total, axis=0))
        costs[i] = np.max(total, axis=0)

    f0 = np.zeros(n)
    j = int(np.argmax(costs[-1]))
    for i in range(n - 1, -1, -1):
        f0[i] = cand_freqs[i][j]
        if i > 0:
            j = int(back[i - 1][j])
    return f0
