"""The reference's models; a family (``families/<family>.py``) builds a
configuration's modules from them."""

from bench_h100.reference.models.bigvgan import BigVGAN
from bench_h100.reference.models.hifigan import HiFiGANGenerator

VOCODERS = {"hifigan": HiFiGANGenerator, "bigvgan": BigVGAN}
