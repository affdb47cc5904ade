#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s cloning and slider phases on the CPU.

Runs ``phase_clone`` and ``phase_controllable`` on tiny models (the tiny
ToucanTTS of the port's tests, a 64-channel HiFiGAN, an aligner of conv 64
and BiLSTM 32, 2000 PCA samples) with the kernels' plain versions, so that
a wrong path, argument or shape shows before the card is asked.  Launch
counts are not checked (on the CPU every count stays 0), and every time it
prints is the CPU's, not the card's.

    python3 scripts/rehearse_chip_phases.py
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from toucan_tpu_torch.infer.interface import ToucanTTSInterface  # noqa: E402
from toucan_tpu_torch.models.aligner import Aligner  # noqa: E402
from toucan_tpu_torch.models.embedding_gan import GanWrapper  # noqa: E402
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig  # noqa: E402
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator  # noqa: E402

TINY = ToucanTTSConfig(adim=32, aheads=2, enc_layers=1, enc_units=64, dec_layers=1, dec_units=64,
                       duration_layers=1, pitch_layers=1, energy_layers=1, duration_chans=16,
                       pitch_chans=16, energy_chans=16, glow_blocks=2, glow_hidden=16,
                       utt_embed_dim=64, lang_embs=100)


def main():
    torch.cuda.synchronize = lambda *args, **kwargs: None
    chip_smoke.per_synthesis = lambda n, **kernels: {}
    chip_smoke.Aligner = lambda: Aligner(conv_dim=64, lstm_dim=32)
    chip_smoke.GanWrapper = lambda sd, seed=0, device="cpu", state=None: GanWrapper(
        sd, num_pca_samples=2000, seed=seed, device="cpu", state=state)
    torch.manual_seed(chip_smoke.SEED)
    tts_sd = ToucanTTS(TINY).state_dict()
    voc_sd = HiFiGANGenerator(channels=64).state_dict()
    make = lambda: ToucanTTSInterface(tts_sd, voc_sd, config=TINY,
                                      vocoder=HiFiGANGenerator(channels=64), device="cpu",
                                      seed=chip_smoke.SEED)
    iface, cpu = make(), make()
    launches = dict.fromkeys(chip_smoke.WRAPPERS, 0)
    for name, phase in (("clone", lambda: chip_smoke.phase_clone(iface, cpu, launches, "CPU")),
                        ("controllable",
                         lambda: chip_smoke.phase_controllable(iface, launches, "CPU"))):
        t0 = time.perf_counter()
        phase()
        print(f"rehearsal: phase_{name} passed in {time.perf_counter() - t0:.1f} s (CPU)")


if __name__ == "__main__":
    main()
