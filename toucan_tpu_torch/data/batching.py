"""Host-side batching: padding, bucketing, and the meta-loop sampler.

The reference pads each batch to its longest element
(``toucantts_train_loop.py:24-34`` collate_and_pad).  Under jit that would
recompile per batch shape, so batches pad to fixed buckets (multiples of
``text_bucket``/``frame_bucket``); masks make the extra padding inert.

The multilingual sampler reproduces the LAML batch assembly of
``toucantts_meta_train_loop.py:110-123``: cycle languages in random order,
drawing one utterance per language until the batch is full.
"""

from __future__ import annotations

import math

import numpy as np


def _ceil_to(n, m):
    return max(m, int(math.ceil(n / m)) * m)


def pad_batch(datapoints, text_bucket: int = 32, frame_bucket: int = 64,
              pad_to=None):
    """List of datapoint dicts -> one padded batch dict of numpy arrays.

    Datapoints carry: text (T, 62), mel (L, 80), durations (T,), energy
    (T, 1), pitch (T, 1), lang_id (int).  ``pad_to=(tmax, lmax)`` forces
    fixed padded shapes — required in multi-process training, where every
    host's local batch must share the global array shape.
    """
    b = len(datapoints)
    if pad_to is not None:
        tmax, lmax = pad_to
    else:
        tmax = _ceil_to(max(len(d["text"]) for d in datapoints), text_bucket)
        lmax = _ceil_to(max(len(d["mel"]) for d in datapoints), frame_bucket)
    batch = dict(
        text=np.zeros((b, tmax, 62), np.float32),
        text_lengths=np.zeros((b,), np.int32),
        gold_speech=np.zeros((b, lmax, 80), np.float32),
        speech_lengths=np.zeros((b,), np.int32),
        gold_durations=np.zeros((b, tmax), np.int32),
        gold_pitch=np.zeros((b, tmax, 1), np.float32),
        gold_energy=np.zeros((b, tmax, 1), np.float32),
        lang_ids=np.zeros((b, 1), np.int32),
    )
    for i, d in enumerate(datapoints):
        t, l = len(d["text"]), len(d["mel"])
        batch["text"][i, :t] = d["text"]
        batch["text_lengths"][i] = t
        batch["gold_speech"][i, :l] = d["mel"]
        batch["speech_lengths"][i] = l
        batch["gold_durations"][i, :t] = d["durations"]
        batch["gold_pitch"][i, :t] = np.reshape(d["pitch"], (t, 1))
        batch["gold_energy"][i, :t] = np.reshape(d["energy"], (t, 1))
        batch["lang_ids"][i, 0] = d.get("lang_id", 0)
    return batch


class BatchSampler:
    """Shuffled drop-last batch iterator over one dataset."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 text_bucket: int = 32, frame_bucket: int = 64, pad_to=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.text_bucket = text_bucket
        self.frame_bucket = frame_bucket
        self.pad_to = pad_to

    def __iter__(self):
        order = self.rng.permutation(len(self.dataset))
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            chosen = [self.dataset[j] for j in order[i:i + self.batch_size]]
            yield pad_batch(chosen, self.text_bucket, self.frame_bucket,
                            pad_to=self.pad_to)

    def __len__(self):
        return len(self.dataset) // self.batch_size


class MetaBatchSampler:
    """LAML batch assembly: languages cycled in random order, one sample per
    language, until ``batch_size`` is reached."""

    def __init__(self, datasets_per_language, batch_size: int, seed: int = 0,
                 text_bucket: int = 32, frame_bucket: int = 64, pad_to=None):
        self.datasets = list(datasets_per_language)
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.text_bucket = text_bucket
        self.frame_bucket = frame_bucket
        self.pad_to = pad_to

    def sample_batch(self):
        chosen = []
        while len(chosen) < self.batch_size:
            order = self.rng.permutation(len(self.datasets))
            for lang_idx in order:
                ds = self.datasets[lang_idx]
                chosen.append(ds[self.rng.randint(len(ds))])
                if len(chosen) == self.batch_size:
                    break
        return pad_batch(chosen, self.text_bucket, self.frame_bucket,
                         pad_to=self.pad_to)
