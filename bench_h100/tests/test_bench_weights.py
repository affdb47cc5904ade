"""The weights recipe at full width on the CPU: the schedule's sentences
take about the corpus's frames a written word (LJSpeech's seconds a clip),
no phone over 16 frames, and the glow reads the acoustic model's mel."""

import json

import numpy as np
import torch

import tiny
from bench_h100.harness import check, weights
from bench_h100.reference.frontend.text import TextFrontend
from bench_h100.traffic import generator
from toucan_tpu_torch.infer.interface import FRAMES_PER_PHONE, PHONE_BUCKET, _round_up


def test_frames_a_word_at_full_width():
    torch.set_num_threads(8)
    cfg = json.loads((tiny.BENCH / "configs" / "toucan_hifigan.json").read_text())
    mix = dict(generator.load_mix("interactive"), blocks=2)
    fe = TextFrontend(language="en", use_g2p=True)
    sents = generator.sentences(mix, 2**31 + 3, lambda t: len(fe.string_to_features(t)))
    calibration = [(fe.string_to_features(t), len(t.split())) for t, _ in sents]
    rate = generator.frames_per_word(mix["corpus"])
    tts, _, emb = weights.make({**cfg, "vocoder_config": dict(cfg["vocoder_config"], channels=8)},
                               2**31 + 3, "cpu", calibration, check.LANG_EN, rate)
    utt = torch.as_tensor(emb)[None]
    words = frames = 0
    longest = 0
    for (x, w), (text, _) in list(zip(calibration, sents))[:4] + list(zip(calibration, sents))[-4:]:
        n = len(x)
        pad = _round_up(n, PHONE_BUCKET)
        xp = np.zeros((1, pad, x.shape[1]), np.float32)
        xp[0, :n] = x
        with torch.no_grad():
            out = tts.infer(torch.as_tensor(xp), torch.tensor([n]), pad * FRAMES_PER_PHONE,
                            utterance_embedding=utt, lang_ids=torch.tensor([[check.LANG_EN]]),
                            glow_noise=torch.zeros(1, pad * FRAMES_PER_PHONE, 80))
        d = out[2][0, :n]
        words, frames, longest = words + w, frames + int(d.sum()), max(longest, int(d.max()))
        # the couplings are not zero: the mel depends on the acoustic model
        assert out[1][0, :int(out[5][0])].abs().max() > 0.05
    assert 0.8 * rate <= frames / words <= 1.25 * rate
    assert longest <= 16
