"""The weights recipe: the reference's modules, made on the device from the
seed, then the changes that make random weights do realistic work.

1. Every module's own initialisation, on the device, under
   ``torch.manual_seed(seed)`` (the family's ``build``).
2. The family's model steps (``shape_weights``): for ToucanTTS the glow's
   coupling ends drawn and the durations calibrated on ``calibration``
   sentences to the speaking rate of the corpus the traffic follows,
   ``frames_per_word`` mel frames a written word, whatever the seed's raw
   weights predict.
The speaker is one vector from the seed.  The program and the reference
are handed the same state dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.harness import spec


def utterance_embedding(dim: int, seed: int):
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


@torch.no_grad()
def make(config: dict, seed: int, device, calibration: list, lang_id: int,
         frames_per_word: float):
    """(acoustic model, vocoder, embedding) of the reference, on ``device``.
    ``calibration``: [((T, 62) features, written words)] of a few
    sentences."""
    family = spec.family(config)
    torch.manual_seed(seed)
    tts, voc = family.build(config, device)
    emb = utterance_embedding(family.embedding_dim(config), seed)
    family.shape_weights(tts, config, torch.as_tensor(emb, device=device)[None], calibration,
                         lang_id, frames_per_word)
    return tts, voc, emb
