"""Illegal-silence removal (``Utility/silence_removal.py`` equivalent).

The reference excises pauses that have no textual cue (silence detected by
the VAD inside a phone whose text gives no reason to pause) and writes
cleaned corpora.  Here the same logic runs on datapoints: gold durations
mark where pauses are legal (silence symbols / word boundaries); VAD spans
elsewhere get cut from wave + mel, and durations are shortened to match.

Counterpart of ``toucan_tpu/data/silence_removal.py``: host numpy over the
port's ``frontend/audio.py``; the re-computed mel runs on ``device`` (the
card unless ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np

from toucan_tpu_torch.frontend.inventory import feature_index


def find_illegal_silences(wave: np.ndarray, text: np.ndarray,
                          durations: np.ndarray, sr: int = 16000,
                          hop: int = 256, min_pause_s: float = 0.2,
                          threshold_db: float = -40.0):
    """Return [(start_sample, end_sample)] of silent spans inside phones
    that should carry speech."""
    f2i = feature_index()
    frame = int(sr * 0.03)
    n = len(wave) // frame
    if n == 0:
        return []
    frames = wave[:n * frame].reshape(n, frame)
    rms_db = 10 * np.log10(np.maximum(np.mean(frames ** 2, axis=1), 1e-12))
    silent = rms_db < max(rms_db.max() + threshold_db, -60.0)

    # which audio samples belong to pause-legal phones
    legal = (text[:, f2i["silence"]] == 1) | (text[:, f2i["word-boundary"]] == 1)
    ends = np.cumsum(durations) * hop
    starts = ends - durations * hop

    spans, span_start = [], None
    for i, s in enumerate(silent):
        if s and span_start is None:
            span_start = i * frame
        elif not s and span_start is not None:
            spans.append((span_start, i * frame))
            span_start = None
    if span_start is not None:
        spans.append((span_start, n * frame))

    illegal = []
    for s0, s1 in spans:
        if (s1 - s0) / sr < min_pause_s:
            continue
        overlaps_legal = any(starts[i] < s1 and ends[i] > s0
                             for i in range(len(durations)) if legal[i])
        if not overlaps_legal:
            illegal.append((s0, s1))
    return illegal


def remove_illegal_silences(datapoint: dict, sr: int = 16000, hop: int = 256, device=None):
    """Cut illegal silent spans out of wave/mel and shrink the durations of
    the phones they fell into.  Returns a cleaned copy."""
    wave = np.asarray(datapoint["wave"])
    text = np.asarray(datapoint["text"])
    durations = np.asarray(datapoint["durations"]).copy()
    spans = find_illegal_silences(wave, text, durations, sr=sr, hop=hop)
    if not spans:
        return datapoint

    keep = np.ones(len(wave), bool)
    frames_cut_per_phone = np.zeros(len(durations), np.int64)
    ends = np.cumsum(durations)
    starts = ends - durations
    for s0, s1 in spans:
        keep[s0:s1] = False
        f0, f1 = s0 // hop, s1 // hop
        for i in range(len(durations)):
            lo, hi = max(starts[i], f0), min(ends[i], f1)
            if hi > lo:
                frames_cut_per_phone[i] += hi - lo
    new_durations = np.maximum(durations - frames_cut_per_phone, 0)

    new_wave = wave[keep]
    out = dict(datapoint)
    out["wave"] = new_wave.astype(np.float32)
    out["durations"] = new_durations.astype(np.int32)
    if "mel" in datapoint:
        from toucan_tpu_torch.data.corpus import utterance_mel
        mel = utterance_mel(new_wave, device)
        out["mel"] = mel[: int(new_durations.sum())].astype(np.float32)
        total = out["mel"].shape[0]
        # reconcile rounding: pad/truncate the last nonzero duration
        diff = total - int(new_durations.sum())
        if diff != 0:
            idx = np.flatnonzero(new_durations)[-1]
            out["durations"][idx] = max(0, out["durations"][idx] + diff)
    return out


def make_silence_cleaned_versions(datapoints: list, **kwargs) -> list:
    return [remove_illegal_silences(d, **kwargs) for d in datapoints]
