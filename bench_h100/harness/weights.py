"""The weights recipe: the reference's modules, made on the device from the
seed, then three changes that make random weights do realistic work.

1. Every module's own initialisation, on the device, under
   ``torch.manual_seed(seed)``.
2. The glow's coupling ``end`` layers, which initialise at zero (the flow
   is then the identity on its noise and never reads the acoustic model's
   mel), drawn from N(0, ``GLOW_END_STD``) in flow order.
3. The duration predictor's output layer rescaled so that log(d + 1) has
   spread ``DURATION_SPREAD`` over the phones of ``calibration`` sentences
   (word boundaries aside, which the model zeroes), narrowed so that none
   of them passes ``LONGEST_PHONE`` frames, and shifted so that the
   sentences take ``frames_per_word`` frames a written word, the speaking
   rate of the corpus the traffic follows, whatever the seed's raw weights
   predict.
The speaker is one 64-dim vector from the seed.  The program and the
reference are handed the same state dicts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100.reference import models as ref_models
from bench_h100.reference.frontend.inventory import feature_index
from bench_h100.reference.nn.masks import make_non_pad_mask

GLOW_END_STD = 0.02
DURATION_SPREAD = 0.25
LONGEST_PHONE = 15


def utterance_embedding(config: dict, seed: int):
    dim = config["acoustic"]["utt_embed_dim"]
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


@torch.no_grad()
def make(config: dict, seed: int, device, calibration: list, lang_id: int,
         frames_per_word: float):
    """(acoustic model, vocoder, embedding) of the reference, on ``device``.
    ``calibration``: [((T, 62) features, written words)] of a few
    sentences."""
    torch.manual_seed(seed)
    tts, voc = ref_models.build(config, device)
    for flow in getattr(tts, "post_flow", torch.nn.Module()).modules():
        if hasattr(flow, "end"):
            torch.nn.init.normal_(flow.end.weight, 0.0, GLOW_END_STD)
    emb = utterance_embedding(config, seed)
    _calibrate_durations(tts, calibration, torch.as_tensor(emb, device=device)[None], lang_id,
                         frames_per_word)
    return tts, voc, emb


def _calibrate_durations(tts, calibration, emb, lang_id, frames_per_word):
    dp = tts.duration_predictor
    boundary = feature_index()["word-boundary"]
    raw = []
    hook = dp.linear.register_forward_hook(lambda m, i, o: raw.append(o[0, :, 0] - m.bias))
    utt = torch.nn.functional.normalize(emb, dim=-1)
    for feats, _ in calibration:
        x = torch.as_tensor(feats, device=emb.device)[None]
        n = x.shape[1]
        mask = make_non_pad_mask(torch.tensor([n], device=emb.device), n)
        enc = tts.encoder(x, mask[:, None, :], utterance_embedding=utt,
                          lang_ids=torch.tensor([[lang_id]], device=emb.device),
                          conv_mask=mask[..., None].float())
        dp(enc, utt, mask[..., None].float())
        raw[-1] = raw[-1][x[0, :, boundary] != 1]   # the model zeroes word boundaries
    hook.remove()
    r = torch.cat(raw)
    words = sum(w for _, w in calibration)
    # mean(d + 1) over the phones that take frames
    center = 1.0 + frames_per_word * words / len(r)
    # the spread, narrowed where the calibration's longest phone would pass
    # LONGEST_PHONE frames
    top = (r.max() - r.mean()).item()
    scale = min(DURATION_SPREAD / r.std().item(),
                math.log((LONGEST_PHONE + 1) / center) / max(top, 1e-12))
    dp.linear.weight.mul_(scale)
    # the bias at which the calibration's rounded durations sum to
    # frames_per_word frames a word (they grow with it)
    x, lo, hi = scale * r.double(), -20.0, 20.0
    for _ in range(60):
        mid = (lo + hi) / 2
        frames = torch.clamp(torch.round(torch.exp(x + mid) - 1.0), min=0.0).sum().item()
        lo, hi = (mid, hi) if frames < frames_per_word * words else (lo, mid)
    dp.linear.bias.fill_((lo + hi) / 2)
