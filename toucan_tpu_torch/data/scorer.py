"""Data-quality scoring (``Utility/Scorer.py`` equivalent).

Counterpart of ``toucan_tpu/data/scorer.py``.  ``AlignmentScorer`` ranks
utterances by the aligner's CTC loss; ``TTSScorer`` by the ToucanTTS
training loss of a trained model.  Both can surface the worst samples and
produce filtered dataset copies (the reference pops them from the cache in
place).

Both run on the card unless ``device="cpu"`` is passed, under
``torch.inference_mode()`` and the "float32" precision policy.
``TTSScorer`` runs the model's teacher-forced pass in eval
(``deterministic=True, train=False``, passed explicitly), so each of its
12 conformer blocks at the default config attends through
``kernels/flash_attention.py::flash_rel_attention`` (K1): 12 launches an
utterance on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from toucan_tpu_torch.frontend.inventory import vectors_to_ctc_ids
from toucan_tpu_torch.models.aligner import Aligner, ctc_loss
from toucan_tpu_torch.models.gst import StyleEmbedding
from toucan_tpu_torch.models.toucan_tts import ToucanTTS
from toucan_tpu_torch.train.losses import toucan_tts_loss
from toucan_tpu_torch.utils.device import f32_precision, resolve_device


def _worst_n(scores, n: int):
    assert scores is not None, "call score() first"
    return list(np.argsort(scores)[::-1][:n])


class AlignmentScorer:
    def __init__(self, aligner_state_dict, device=None):
        self.device = resolve_device(device)
        self.aligner = Aligner.for_state_dict(aligner_state_dict)
        self.aligner.load_state_dict(aligner_state_dict)
        self.aligner.to(self.device).eval()
        self.scores = None

    @torch.inference_mode()
    def score(self, dataset):
        """dataset: list of datapoint dicts with 'mel' and 'text'."""
        scores = []
        with f32_precision():
            for d in dataset:
                mel = torch.from_numpy(np.asarray(d["mel"], np.float32)[None]).to(self.device)
                tokens = vectors_to_ctc_ids(np.asarray(d["text"]))
                logits = self.aligner(mel)
                loss = ctc_loss(logits, [mel.shape[1]], np.asarray(tokens)[None], [len(tokens)])
                scores.append(float(loss))
        self.scores = np.asarray(scores)
        return self.scores

    def worst_n(self, n: int):
        return _worst_n(self.scores, n)


class TTSScorer:
    def __init__(self, tts_state_dict, config, gst_state_dict=None, device=None):
        self.device = resolve_device(device)
        self.model = ToucanTTS(config)
        self.model.load_state_dict(tts_state_dict)
        self.model.to(self.device).eval()
        self.gst = None
        if gst_state_dict is not None:
            self.gst = StyleEmbedding()
            self.gst.load_state_dict(gst_state_dict)
            self.gst.to(self.device).eval()
        self.scores = None

    def _tensor(self, a, shape=None, dtype=np.float32):
        a = np.asarray(a, dtype)
        return torch.from_numpy(a.reshape(shape) if shape else a[None]).to(self.device)

    @torch.inference_mode()
    def score(self, dataset, utt_embeddings=None):
        """dataset: datapoints with text, mel, durations, pitch, energy and
        lang_id; ``utt_embeddings`` (N, 64) or None (then the GST's
        embedding of each mel where a GST was given, else none)."""
        scores = []
        with f32_precision():
            for i, d in enumerate(dataset):
                t, l = len(d["text"]), len(d["mel"])
                text, mel = self._tensor(d["text"]), self._tensor(d["mel"])
                text_lengths, speech_lengths = (torch.tensor([n], device=self.device)
                                                for n in (t, l))
                durations = self._tensor(d["durations"], dtype=np.int32)
                pitch = self._tensor(d["pitch"], (1, t, 1))
                energy = self._tensor(d["energy"], (1, t, 1))
                if utt_embeddings is not None:
                    utt = self._tensor(utt_embeddings[i])
                elif self.gst is not None:
                    utt = self.gst(mel, speech_lengths)
                else:
                    utt = None
                lang_ids = torch.tensor([[int(d.get("lang_id", 0))]], device=self.device)
                before, after, d_pred, p_pred, e_pred, _ = self.model(
                    text, text_lengths, mel, speech_lengths, durations, pitch, energy,
                    utterance_embedding=utt, lang_ids=lang_ids, run_glow=False,
                    deterministic=True, train=False)
                l1, dl, pl, el = toucan_tts_loss(
                    before, after, mel, speech_lengths, text_lengths, durations, d_pred,
                    p_pred, e_pred, pitch, energy)
                total = float(l1 + dl + pl + el)
                scores.append(total if np.isfinite(total) else float("inf"))
        self.scores = np.asarray(scores)
        return self.scores

    def worst_n(self, n: int):
        return _worst_n(self.scores, n)

    def nan_indexes(self):
        assert self.scores is not None, "call score() first"
        return list(np.flatnonzero(~np.isfinite(self.scores)))


def remove_samples(dataset, indices):
    """Filtered copy with the given indices removed (reference pops them
    from the cache; we return a new list)."""
    drop = set(indices)
    return [d for i, d in enumerate(dataset) if i not in drop]


def ctc_outlier_filter(dataset, scores, sigma: float = 1.5, min_size: int = 300):
    """Drop samples whose CTC loss exceeds mean + sigma*std when the corpus
    is large enough (``FastSpeechDataset.py:151-160``)."""
    if len(dataset) <= min_size:
        return dataset
    scores = np.asarray(scores)
    threshold = scores.mean() + sigma * scores.std(ddof=1)
    return [d for d, s in zip(dataset, scores) if s <= threshold]
