"""Corpus preparation: cache building and pipeline orchestration.

Counterpart of ``toucan_tpu/data/corpus.py`` (the reference's
``AlignerDataset``, ``FastSpeechDataset`` and
``Utility/corpus_preparation.py``):

* ``build_aligner_cache``: per utterance mono, the length window, loudness,
  resampling to 16 kHz, the optional trim and the text features, fanned
  out over worker processes past 8 utterances; then the log-mel on
  ``device``, as ``AudioPreprocessor.audio_to_mel_spec_tensor`` computes it;
* ``build_fastspeech_cache``: the aligner's logits and CTC loss on
  ``device``, MAS on the host, durations, token-averaged pitch and energy
  (``data/extraction.py::extract_prosody``), then the CTC outlier filter;
* ``prepare_fastspeech_corpus``: aligner cache -> optional aligner
  fine-tune on this corpus -> TTS cache, skipping finished stages via their
  cache files.

The workers are forked (as JAX's are on Linux; pinned, whatever the
platform's default) and do host work only: a process forked from one that
has initialised CUDA cannot use it, so the parent computes every mel.  Caches are ``.npz`` files in
the JAX package's layout (flat keys ``"{i}/{k}"`` plus ``__len__``,
strings as numpy unicode arrays), so a cache written by either package
loads in the other.  The aligner comes as its reference state dict
(``asr_model``, as ``load.py::load_aligner`` returns it).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from functools import partial

import numpy as np
import torch

from toucan_tpu_torch.frontend.audio import AudioPreprocessor, log_mel_spectrogram, read_wave
from toucan_tpu_torch.frontend.inventory import feature_index, vectors_to_ctc_ids
from toucan_tpu_torch.frontend.text import TextFrontend, language_id
from toucan_tpu_torch.utils.device import f32_precision, resolve_device

SR = 16000
POOL_AFTER = 8  # utterances beyond which the host work fans out over processes


def _condition_utterance(item, lang: str, min_len_s: float, max_len_s: float,
                         cut_silence: bool, use_g2p: bool):
    """The host part of an utterance: (path, transcript) -> dict(path,
    transcript, text, wave) with the 16 kHz conditioned wave, or None where
    the file does not read, is outside the length window or gives no text."""
    path, transcript = item
    try:
        wave, sr = read_wave(path)
    except Exception:
        return None
    if len(np.shape(wave)) == 2:
        wave = np.mean(wave, axis=1)
    duration_s = len(wave) / sr
    if not (min_len_s <= duration_s <= max_len_s):
        return None
    ap = AudioPreprocessor(input_sr=sr, output_sr=SR, cut_silence=cut_silence)
    try:
        norm_wave = ap.normalize_audio(wave)
    except Exception:
        return None
    fe = TextFrontend(language=lang, use_g2p=use_g2p)
    try:
        text = fe.string_to_features(transcript, input_phonemes=not use_g2p)
    except Exception:
        return None
    if len(text) == 0:
        return None
    return dict(path=path, transcript=transcript, text=text.astype(np.float32),
                wave=np.asarray(norm_wave, np.float32))


def utterance_mel(wave: np.ndarray, device=None) -> np.ndarray:
    """(frames, 80) log-mel of a 16 kHz wave, computed on ``device``."""
    audio = torch.as_tensor(np.asarray(wave, np.float32), device=resolve_device(device))
    return log_mel_spectrogram(audio, sr=SR).cpu().numpy().astype(np.float32)


def build_aligner_cache(path_to_transcript: dict, cache_dir: str, lang: str,
                        loading_processes: int = 8, min_len_s: float = 1.0,
                        max_len_s: float = 20.0, cut_silence: bool = False,
                        use_g2p: bool = True, rebuild_cache: bool = False,
                        speaker_embedding_fn=None, device=None):
    """Builds (or loads) the aligner cache; returns a list of datapoints
    (path, transcript, text (T, 62), wave, mel (L, 80), speaker_embedding
    (192,)).  ``speaker_embedding_fn(mel)`` conditions the aligner's
    reconstruction decoder; zeros without it."""
    device = resolve_device(device)
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(cache_dir, "aligner_train_cache.npz")
    if os.path.exists(cache_path) and not rebuild_cache:
        return load_cache(cache_path)

    items = list(path_to_transcript.items())
    worker = partial(_condition_utterance, lang=lang, min_len_s=min_len_s,
                     max_len_s=max_len_s, cut_silence=cut_silence, use_g2p=use_g2p)
    if loading_processes > 1 and len(items) > POOL_AFTER:
        from toucan_tpu_torch import native

        native.native_resample_available()  # build the resampler once, before the workers
        with ProcessPoolExecutor(max_workers=loading_processes,
                                 mp_context=multiprocessing.get_context("fork")) as pool:
            results = list(pool.map(worker, items, chunksize=8))
    else:
        results = [worker(it) for it in items]
    datapoints = [r for r in results if r is not None]
    for d in datapoints:
        d["mel"] = utterance_mel(d["wave"], device)

    # speaker conditioning for the aligner's reconstruction decoder
    for d in datapoints:
        if speaker_embedding_fn is not None:
            d["speaker_embedding"] = np.asarray(speaker_embedding_fn(d["mel"]), np.float32)
        else:
            d["speaker_embedding"] = np.zeros(192, np.float32)

    save_cache(cache_path, datapoints)
    return datapoints


def save_cache(path: str, datapoints: list):
    flat = {}
    for i, d in enumerate(datapoints):
        for k, v in d.items():
            if isinstance(v, str):
                flat[f"{i}/{k}"] = np.asarray(v)
            else:
                flat[f"{i}/{k}"] = v
    flat["__len__"] = np.asarray(len(datapoints))
    np.savez_compressed(path, **flat)


def load_cache(path: str):
    loaded = np.load(path, allow_pickle=False)
    n = int(loaded["__len__"])
    datapoints = []
    for i in range(n):
        d = {}
        for key in loaded.files:
            if key.startswith(f"{i}/"):
                k = key.split("/", 1)[1]
                v = loaded[key]
                d[k] = str(v) if v.dtype.kind in "US" else v
        datapoints.append(d)
    return datapoints


def build_fastspeech_cache(aligner_datapoints: list, aligner_state_dict, cache_dir: str,
                           lang: str, ctc_selection: bool = True, rebuild_cache: bool = False,
                           device=None):
    """Augment the aligner cache with durations/energy/pitch + CTC filter.

    ``aligner_state_dict``: the aligner's reference state dict.  Its logits
    and CTC loss run on ``device`` in f32 (no TF32); MAS, the durations and
    the pitch are host code, the energy's STFT runs on ``device``."""
    from toucan_tpu_torch.data.extraction import extract_prosody
    from toucan_tpu_torch.data.scorer import ctc_outlier_filter
    from toucan_tpu_torch.models.aligner import Aligner, alignment_from_logits, ctc_loss

    device = resolve_device(device)
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(cache_dir, "fast_train_cache.npz")
    if os.path.exists(cache_path) and not rebuild_cache:
        return load_cache(cache_path)

    aligner = Aligner.for_state_dict(aligner_state_dict)
    aligner.load_state_dict(aligner_state_dict)
    aligner.to(device).eval()
    f2i = feature_index()
    lang_id = language_id(lang)
    out, ctc_scores = [], []
    for d in aligner_datapoints:
        text = np.asarray(d["text"])
        keep = text[:, f2i["word-boundary"]] == 0
        boundary_indices = list(np.flatnonzero(~keep))
        token_ids = vectors_to_ctc_ids(text)
        mel = np.asarray(d["mel"], np.float32)
        with torch.inference_mode(), f32_precision():
            logits = aligner(torch.from_numpy(mel[None]).to(device))
            loss = float(ctc_loss(logits, [len(mel)], np.asarray(token_ids)[None],
                                      [len(token_ids)]))
        logits = logits[0].cpu().numpy()
        alignment = alignment_from_logits(logits, token_ids)
        durations, energy, pitch = extract_prosody(
            np.asarray(d["wave"]), alignment, text, boundary_indices,
            n_frames=mel.shape[0], device=device)
        out.append(dict(text=text, mel=mel, durations=durations.astype(np.int32),
                        energy=energy.astype(np.float32),
                        pitch=pitch.astype(np.float32), lang_id=lang_id,
                        path=d.get("path", "")))
        ctc_scores.append(loss)

    if ctc_selection:
        out = ctc_outlier_filter(out, ctc_scores)
    save_cache(cache_path, out)
    return out


def prepare_fastspeech_corpus(path_to_transcript: dict, corpus_dir: str, lang: str,
                              aligner_state_dict=None, fine_tune_aligner=True,
                              aligner_train_fn=None, use_g2p: bool = True,
                              ctc_selection: bool = True, device=None, **cache_kwargs):
    """Full orchestration (``corpus_preparation.py:17-73``): aligner cache ->
    optional aligner fine-tune on this corpus -> TTS cache.  Where the TTS
    cache exists (and ``rebuild_cache`` is not given) it is loaded and no
    aligner is trained: JAX's trains one and discards it.
    ``aligner_train_fn(datapoints, steps=...)`` returns an aligner train
    state (``recipes/pipelines.py::_aligner_train_fn``), whose ``asr``
    then aligns the corpus."""
    aligner_data = build_aligner_cache(path_to_transcript, corpus_dir, lang,
                                       use_g2p=use_g2p, device=device, **cache_kwargs)
    finished = os.path.exists(os.path.join(corpus_dir, "fast_train_cache.npz")) \
        and not cache_kwargs.get("rebuild_cache", False)
    if finished:
        return load_cache(os.path.join(corpus_dir, "fast_train_cache.npz"))
    if fine_tune_aligner and aligner_train_fn is not None:
        # steps heuristic: len(dataset) steps, like corpus_preparation.py:45-47
        state = aligner_train_fn(aligner_data, steps=max(len(aligner_data), 1))
        aligner_state_dict = state.asr.state_dict()
    assert aligner_state_dict is not None, "need aligner weights or a train fn"
    return build_fastspeech_cache(aligner_data, aligner_state_dict, corpus_dir,
                                  lang, ctc_selection=ctc_selection, device=device)
