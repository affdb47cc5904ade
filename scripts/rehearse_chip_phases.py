#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s later phases on the CPU.

Runs ``phase_clone``, ``phase_controllable``, ``phase_main_bf16`` (HiFiGAN
and BigVGAN), ``phase_precision``, ``phase_fastspeech2``,
``phase_stochastic``, ``phase_train``, the phases of the rest of
training (``phase_vocoder_train``, ``phase_bigvgan_train``,
``phase_aligner_train``, ``phase_embedding_train``, ``phase_wgan_qc``),
``phase_corpus`` (the corpus caches, scorers, recipes and CLI; the recipes'
models tiny, the corpus at its size) and of distribution (``dist``:
``phase_dist_train``, ``phase_sharded_ckpt``,
``phase_longform``, ``phase_pipelined``, ``phase_scaling``, their ranks
gloo CPU processes, the NCCL one too) on
tiny models (the tiny ToucanTTS of the port's tests, also as the
stochastic model and the trainer's, 64-channel vocoders, the joint critic
at ``channel_scale=0.05``, an aligner of conv 64 and BiLSTM 32 with a
``TinyTTS`` of 32, 2000 PCA samples, ``fastspeech2_config`` at one block a
side) with the kernels' plain versions, on the CPU (the acoustic training
data and batch keep their sizes; the vocoder, aligner and embedding
batches and lengths are cut), so that a wrong path,
argument or shape shows before the card is asked.  Launch counts are not
checked (on the CPU every count stays 0), no graph is replayed, and every
time it prints is the CPU's, not the card's.

    python3 scripts/rehearse_chip_phases.py [PHASE ...]

With names (``vocoder_train``, ``wgan_qc``, ...) only those phases run.
"""

import dataclasses
import functools
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from toucan_tpu_torch import load  # noqa: E402
from toucan_tpu_torch.infer.interface import VOCODERS, ToucanTTSInterface  # noqa: E402
from toucan_tpu_torch.models.aligner import Aligner  # noqa: E402
from toucan_tpu_torch.models.embedding_gan import GanWrapper  # noqa: E402
from toucan_tpu_torch.models.gst import StyleEmbedding  # noqa: E402
from toucan_tpu_torch.models.toucan_tts import (ToucanTTS, ToucanTTSConfig,  # noqa: E402
                                                fastspeech2_config)
from toucan_tpu_torch.models.vocoders import hifigan as hifigan_module  # noqa: E402
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN  # noqa: E402
from toucan_tpu_torch.models.vocoders.discriminators import \
    AvocodoJointDiscriminator  # noqa: E402
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator  # noqa: E402
from toucan_tpu_torch.train import aligner_train, embedding_train  # noqa: E402
from toucan_tpu_torch.train.aligner_train import TinyTTS  # noqa: E402

TINY = ToucanTTSConfig(adim=32, aheads=2, enc_layers=1, enc_units=64, dec_layers=1, dec_units=64,
                       duration_layers=1, pitch_layers=1, energy_layers=1, duration_chans=16,
                       pitch_chans=16, energy_chans=16, glow_blocks=2, glow_hidden=16,
                       utt_embed_dim=64, lang_embs=100)


def dist_phases(cpu_dev, launches):
    """The distribution phases on tiny nets and short inputs, the ranks as
    gloo CPU processes (the NCCL rank too), launches not counted."""
    chip_smoke.HiFiGANGenerator = HiFiGANGenerator   # the phases pass their widths
    chip_smoke.DIST = dict(
        chip_smoke.DIST, device="cpu", nccl=False, count=False, timeout_s=600,
        config=dataclasses.asdict(TINY), critic_scale=0.05,
        vocoder=dict(channels=32, resblock_kernel_sizes=(3,), resblock_dilations=(1, 3)),
        aligner=dict(conv_dim=64, lstm_dim=32), tinytts=dict(lstm_dim=32), train_batch=4,
        voc_frames=8, aligner_frames=(40, 60), aligner_tokens=(8, 12), longform_frames=259,
        iface_longform=256, iface_frames_per_phone=3, pipe_phones=16, pipe_frames=64,
        scaling=dict(batch_per_device=2, tmax=16, lmax=64, steps=2))
    for name, phase in (("dist_train", lambda: chip_smoke.phase_dist_train("CPU")),
                        ("sharded_ckpt", lambda: chip_smoke.phase_sharded_ckpt(ranks, "CPU")),
                        ("longform", lambda: chip_smoke.phase_longform(ranks, launches, "CPU")),
                        ("pipelined", lambda: chip_smoke.phase_pipelined(cpu_dev, launches,
                                                                         "CPU")),
                        ("scaling", lambda: chip_smoke.phase_scaling(cpu_dev, "CPU"))):
        t0 = time.perf_counter()
        out = phase()
        if name == "dist_train":
            ranks = out
        print(f"rehearsal: phase_{name} passed in {time.perf_counter() - t0:.1f} s (CPU)")


def corpus_phase(cpu_dev, launches):
    """``phase_corpus`` with the tiny ToucanTTS as the scorer's and the TTS
    and co-training recipes' model, and the tiny aligner and ``TinyTTS``
    in the aligner's training."""
    chip_smoke.ToucanTTSConfig = lambda: TINY
    chip_smoke.integration_test_pipeline = functools.partial(
        chip_smoke.integration_test_pipeline, config=TINY)
    chip_smoke.fs_embedding_integration_test_pipeline = functools.partial(
        chip_smoke.fs_embedding_integration_test_pipeline, config=TINY)
    embedding_train.fastspeech2_config = lambda: TINY
    aligner_train.Aligner = lambda: Aligner(conv_dim=64, lstm_dim=32)
    aligner_train.TinyTTS = lambda speaker_embedding_dim: TinyTTS(
        speaker_embedding_dim=speaker_embedding_dim, lstm_dim=32)
    chip_smoke.phase_corpus(cpu_dev, launches, "CPU")


def main():
    torch.cuda.synchronize = lambda *args, **kwargs: None
    chip_smoke.per_synthesis = lambda n, **kernels: {}
    chip_smoke.Aligner = lambda: Aligner(conv_dim=64, lstm_dim=32)
    chip_smoke.GanWrapper = lambda sd, seed=0, device="cpu", state=None: GanWrapper(
        sd, num_pca_samples=2000, seed=seed, device="cpu", state=state)
    torch.manual_seed(chip_smoke.SEED)
    tts_sd = ToucanTTS(TINY).state_dict()
    voc_sd = HiFiGANGenerator(channels=64).state_dict()
    launches = dict.fromkeys(chip_smoke.WRAPPERS, 0)

    # the serving phases build full-width interfaces: here tiny ones on the CPU
    def tiny_interface(tts_sd, voc_sd, vocoder="hifigan", config=None, device=None, dtype=None,
                       **kw):
        if isinstance(vocoder, str):
            vocoder = VOCODERS[vocoder](channels=64, dtype=dtype or torch.float32)
        return ToucanTTSInterface(tts_sd, voc_sd, config=config or TINY, vocoder=vocoder,
                                  device="cpu", dtype=dtype, **kw)
    chip_smoke.ToucanTTSInterface = tiny_interface
    chip_smoke.replay_ms_of = lambda graphs: 0.0
    chip_smoke.fastspeech2_config = lambda: fastspeech2_config(enc_layers=1, dec_layers=1)
    chip_smoke.HiFiGANGenerator = lambda: HiFiGANGenerator(channels=64)
    chip_smoke.interface_from_torch = lambda *a, **k: load.interface_from_torch(
        *a, **{**k, "device": "cpu"})
    big_sd = BigVGAN(channels=64).state_dict()
    # the phases synthesize from predicted durations, which the tiny model's
    # init puts at about 0 frames a phone: here about 3
    tts_sd = dict(tts_sd, **{"duration_predictor.linear.bias": torch.tensor([1.5])})
    # the rest of training: tiny nets, short batches
    cpu_dev = torch.device("cpu")
    hifigan_module.HiFiGANGenerator = lambda: HiFiGANGenerator(channels=64)  # the pipeline's
    chip_smoke.joint_discriminator = lambda segment, seed: AvocodoJointDiscriminator(
        channel_scale=0.05, segment=segment, generator=torch.Generator().manual_seed(seed))
    chip_smoke.BigVGAN = lambda: BigVGAN(channels=64)
    chip_smoke.TinyTTS = lambda: TinyTTS(lstm_dim=32)
    for name, value in (("VOC_BATCH", 3), ("BIGVGAN_BATCH", 2), ("BIGVGAN_STEPS", 2),
                        ("ALIGNER_FRAMES", (40, 120)), ("ALIGNER_TOKENS", (8, 30)),
                        ("EMB_BATCH", 4), ("EMB_STEPS", 2), ("TRIPLETS", 3)):
        setattr(chip_smoke, name, value)
    iface, cpu = (tiny_interface(tts_sd, voc_sd, HiFiGANGenerator(channels=64),
                                 seed=chip_smoke.SEED) for _ in range(2))
    for name, phase in (("clone", lambda: chip_smoke.phase_clone(iface, cpu, launches, "CPU")),
                        ("controllable",
                         lambda: chip_smoke.phase_controllable(iface, launches, "CPU")),
                        ("main_bf16 (hifigan)", lambda: chip_smoke.phase_main_bf16(
                            "bf16 hifigan", iface, cpu, "hifigan", tts_sd, voc_sd,
                            chip_smoke.BF16_HIFIGAN, launches, "CPU")),
                        ("main_bf16 (bigvgan)", lambda: chip_smoke.phase_main_bf16(
                            "bf16 bigvgan", tiny_interface(tts_sd, big_sd, "bigvgan"),
                            tiny_interface(tts_sd, big_sd, "bigvgan"), "bigvgan", tts_sd, big_sd,
                            chip_smoke.BF16_BIGVGAN, launches, "CPU")),
                        ("precision", lambda: chip_smoke.phase_precision(
                            tts_sd, voc_sd, iface, launches, "CPU")),
                        ("fastspeech2", lambda: chip_smoke.phase_fastspeech2(launches, "CPU")),
                        ("stochastic", lambda: chip_smoke.phase_stochastic(
                            torch.device("cpu"), launches, "CPU", config=TINY)),
                        ("train", lambda: chip_smoke.phase_train(
                            torch.device("cpu"), voc_sd, StyleEmbedding().state_dict(), launches,
                            "CPU", config=TINY)),
                        ("vocoder_train", lambda: chip_smoke.phase_vocoder_train(
                            cpu_dev, launches, "CPU")),
                        ("bigvgan_train", lambda: chip_smoke.phase_bigvgan_train(
                            cpu_dev, launches, "CPU")),
                        ("aligner_train", lambda: chip_smoke.phase_aligner_train(cpu_dev, "CPU")),
                        ("embedding_train", lambda: chip_smoke.phase_embedding_train(
                            cpu_dev, "CPU")),
                        ("wgan_qc", lambda: chip_smoke.phase_wgan_qc(cpu_dev, "CPU")),
                        ("corpus", lambda: corpus_phase(cpu_dev, launches)),
                        ("dist", lambda: dist_phases(cpu_dev, launches))):
        if sys.argv[1:] and name.split()[0] not in sys.argv[1:]:
            continue
        t0 = time.perf_counter()
        phase()
        print(f"rehearsal: phase_{name} passed in {time.perf_counter() - t0:.1f} s (CPU)")


if __name__ == "__main__":
    main()
