"""The reference's modules of a benchmark configuration."""

import torch

from bench_h100.reference.models.bigvgan import BigVGAN
from bench_h100.reference.models.hifigan import HiFiGANGenerator
from bench_h100.reference.models.toucan_tts import ToucanTTS, ToucanTTSConfig

VOCODERS = {"hifigan": HiFiGANGenerator, "bigvgan": BigVGAN}


def build(config: dict, device) -> tuple:
    """(acoustic model, vocoder) of ``config`` on ``device``, each module
    initialised there by its own rule from the current seed of torch's
    generator on that device."""
    with torch.device(device):
        tts = ToucanTTS(ToucanTTSConfig(**config["acoustic"])).eval()
        voc = VOCODERS[config["vocoder"]](**config["vocoder_config"]).eval()
    return tts, voc
