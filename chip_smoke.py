#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``toucan_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. build: nvcc compiles every kernel of the port for sm_90a, one process
   per source, all at once, and prints ptxas's registers / shared memory /
   spills, and the count of tensor-core instructions (HMMA, HGMMA, IMMA)
   and of ``__dp4a`` (IDP) in the SASS of K1-K4: K1 and K2 must hold
   HMMA, K3 and K4 IMMA (int8) and HMMA (bf16), and K4 no IDP;
2. k1: the rel-pos flash attention kernel against its plain PyTorch version
   at B=2, H=4, d=48, T in (128, 2048), and at the main path's encoder
   (B=1, T=128) and decoder (B=1, T=2048, 110 and 2048 valid keys), with
   its time, the plain version's, that of ``scaled_dot_product_attention``
   on a materialised bias, and its bounds (split TF32 and f32); then its
   bf16 instantiation (``k1_bf16``) at the same shapes and at d = 96,
   against its plain version (f32 arithmetic on the same bf16 values),
   beside the f32 kernel, SDPA on bf16 and its bf16 bound;
3. k2: the fused HiFiGAN stage kernel against its plain version at the four
   stage shapes of 512 and of 2048 mel frames, with the tile and cluster
   each launch took, on HiFiGAN's weights and on weights at unit gain
   (where only an f32-accurate product meets K2's tolerance);
4. k5: the alias-free SnakeBeta kernel against its plain version at
   BigVGAN's four stage shapes of 512 and 2048 mel frames (B = 1) and of
   1024 frames at B = 4, each with its share of the bytes bound, GB/s and
   launch geometry, and at 2048 frames timed in turns against one chunk a
   warp; then at T = 8, at T = 4099 (rows not 16-byte aligned) with C = 20
   and 32, and at 100 times the amplitude, where the plain version and the
   kernel are also held against the same formula in float64; then its bf16
   instantiation (``k5_bf16``) at the four stage shapes of 512 and 2048
   frames and at T = 8, 4099 and 4100, every sample within one bf16 ulp of
   its plain version, beside the f32 kernel and the halved bytes bound;
5. k3: the quantized HiFiGAN stage kernel, int8 and bf16, against its plain
   versions at the four stage shapes of 512 mel frames, with scales
   calibrated on the same input, K2's time beside it, and the tiling each
   launch took; where a tile is split over a cluster of blocks, the same
   launch with one block per tile must give the same output, and the two
   are timed in turns;
6. k4: the im2col HiFiGAN stage kernel, int8 and bf16, against its plain
   versions at the shapes of stages 1-3 at 512 mel frames, with K2's and
   K3 int8's times on the same stage beside it, the tiling each launch took
   (cluster, blocks, walk over K, scratch bytes) and the count of elements
   that differ from the plain version (int8: none); the launch on clusters
   and the one with one block per window must give the same output, and
   the two are timed in turns;
7. shapes: K1, K2 (also at unit gain), K3 (int8), K4 (int8, stages 1-3)
   and K5 against their plain versions at the shapes the main path gives
   them: batch size,
   sequence lengths and stage lengths of the ``__call__`` on 110 phones
   (2048 vocoder frames), of the call with 8 frames per phone (896) and of
   ``synthesize_batch`` (B = 4); and K4 (int8, bf16) at the widths of other
   generators, C = 96 (fold 1) and 48 (fold 2, K walked flat in int8);
   widths: K1 at d = 96 and 128 (built) and 40 (zero-padded to 48) at
   T = 2048, K2 at C = 512 (clusters of 8 blocks) and at 48, 16 and 4
   (widened with zero channels), on generators' init weights and at unit
   gain, timed;
   grad: each of K1-K5's wrappers on CUDA inputs that require grad, with
   grad enabled, must raise ValueError without launching (the kernels have
   no backward);
   other models: ``HiFiGANGenerator(channels=1024)`` and ``(channels=64)``
   on 64 mel frames, card against CPU within 2e-5, and a ToucanTTS at adim
   384 with 4 heads (d = 96) with the 64-channel generator, card against
   CPU as in the ref phase;
8. main: the full-width model (default ToucanTTSConfig, seeded random
   weights) through ``ToucanTTSInterface``, on four paths, each call with
   its launches counted from 0.  The interface runs each bucket from a
   CUDA graph: a launch inside a graph is counted at each replay, and a
   bucket's first use adds its eager warm-up (one synthesis) unless
   ``precompile`` made it; each call's log line says which:
   - HiFiGAN 512 channels: ``__call__`` on ~110 phones, ``__call__`` with
     explicit durations, ``synthesize_batch`` of four sentences and
     ``read_to_file``; K1 12 and K2 4 launches per synthesis;
   - BigVGAN 512 channels (``vocoder="bigvgan"``): ``__call__`` (first,
     steady, profiled), explicit durations, ``synthesize_batch``; K1 12 and
     K5 73 launches per synthesis, K2 none;
   - int8 HiFiGAN: ``quantize_vocoder()`` (its calibration pass: K1 12,
     K2 4), then ``__call__`` and ``synthesize_batch``; K1 12 and K3 4 per
     synthesis, K2 none; the int8 wave against the exact one of the same
     call and noise (SNR above 25 dB, max error within 6 % of the peak);
   - imcol: the same weights written as reference-format ``.pt`` files
     (weight norm split), loaded by ``load.interface_from_torch`` with
     ``HiFiGANGenerator(imcol_mode="int8")`` and the GST; the speaker set
     from the HiFiGAN path's wave at 24 kHz (loudness, resampling, trim,
     mel and GST); then ``__call__`` (first, steady, profiled), 8 frames per
     phone and ``synthesize_batch``; K1 12, K2 1 (stage 0) and K4 3 per
     synthesis; the int8 wave against the exact one of the same call;
   after each path, graphs: ``precompile`` (each bucket's warm-up and
   capture time and the memory its graph holds), the graph call's
   durations, pitch, energy and wave against the eager call's
   (``_eager``) on the same noise (wave within 1e-6), launches through
   replays equal to one synthesis's, ``_vocode`` of that call's mel
   through its 64-frame bucket against eager (within 1e-6), the steady ``__call__`` eager against
   graph in turns (eager, graph, graph, eager, three times), the graph's
   replay alone timed by CUDA events and the call's profiled idle share,
   and ``read_to_file`` of two sentences, dispatch-ahead against one
   sentence at a time, in turns;
9. ref: the same weights on the CPU (plain versions) against the card, on a
   short input, for the four paths (imcol: the embedding from the same
   wave within 1e-4, and the wave within 1 % of its peak); and the HiFiGAN
   call, the BigVGAN call and ``set_utterance_embedding`` once more with
   PyTorch's default ``cudnn.allow_tf32 = True`` set by the caller, which
   must give the durations and, within 1e-5, the mel (the wave, the
   embedding) of the same call with TF32 off, and leave the flags as they
   were (each of the two calls captures its own graph);
10. clone (after the HiFiGAN path's ref phase, on its interface): a
   full-size ``Aligner()`` with seeded weights clones a 7.2 s reference at
   24 kHz (the model's own wave of ``LONG_TEXT`` at 5 frames a phone):
   ``clone_utterance`` (5-step fine-tune on the card, MAS; K1 12 and K2 4
   a synthesis; once more under the profiler), ``extract_prosody`` with
   MAS and with dijkstra (no kernel launch), the native F0 path asserted,
   each part on the host clock (audio front end, aligner forward, 5
   fine-tune steps, MAS, F0, energy, synthesis), and the card against the
   CPU: the fine-tune in float64 (within 1e-5), the reference's mel (in
   power, 1e-4 of its peak), and on the card's fine-tuned aligner the
   logits on one mel (1e-4); for MAS and dijkstra the
   alignments (durations) equal on float64 logits of one mel, and in
   float32, each side on its own mel, equal or a near-tie whose margin the
   logits' difference explains (each path optimal under its own logits;
   the margin printed), pitch and energy on the card's path (1e-4); and
   the cloned synthesis on the same noise (``TOL_REF``);
11. controllable: ``GanWrapper`` at JAX's defaults (``ResNetG()``, 1100
   latents, 50 000 PCA samples; seeded weights) with its set-up time split
   into the generator on the card, the copy to the host and the host's SVD
   and least squares, ``modify_embed`` card against CPU on the same bank
   and basis (1e-5), and ``ControllableInterface.read`` without a plot
   (the card's machine has no matplotlib): 48 kHz, each sample twice, K1
   12 and K2 4;
12. bf16 (after the HiFiGAN and after the BigVGAN path): the full-width
   interface with ``dtype=torch.bfloat16`` on the main path with its
   launches counted (HiFiGAN: K1 12, all on bf16, and K3 4 bf16 stages;
   BigVGAN: K1 12 and K5 73, all on bf16), the bf16 card against the f32
   card and against the bf16 CPU on one input with durations given (each
   within twice the CPU's own bf16-against-f32 distance), and the steady
   graph calls in turns with the f32 interface; precision: an interface
   with ``matmul_precision="default"`` (K1 12 and K2 4 as before), its mel
   against "float32", its graph call in turns, the caller's flags kept;
   fastspeech2 (last): a full-width ``fastspeech2_config()`` written as
   reference ``.pt`` files and loaded by ``interface_from_torch`` (K1 12 at
   d = 96, K2 4), card against CPU; and, in the clone phase, the native
   resampler against numpy on the reference.  Each added phase prints its
   wall time;
13. stochastic (after fastspeech2): a full-width ``StochasticToucanTTS``
   (seeded; the flows' projections and affines live) on LONG_TEXT's ~110
   phones with injected flow and glow noise, ``infer`` on the card twice
   (first and steady, host clock; K1 12 a synthesis, nothing else) against
   the CPU: durations equal, the mels within TOL_REF; an ``EmbeddingVAE``
   loss and sample against the CPU;
14. train (last): ``train_loop`` at full width on 48 seeded utterances
   (40-120 phones, 1-12 frames a phone, two languages), batch 24 with the
   spectrogram critic, the glow from step 4, 8 steps, then ``resume=True``
   for 2 more, whose checkpoint starts SWA into ``best.pt``; no train step
   may launch a kernel; the loop's step times, then steps timed alone on
   one batch without and with the glow (utterances/s, mel frames/s), the
   peak device memory, the profiler's top device items of one glow step;
   ``best.pt`` served through ``load.interface_from_torch`` (K1 12 + K2 4
   a synthesis); and the first step at full width with dropout 0 on two
   utterances, card against CPU: the f32 losses and BatchNorm statistics,
   and the gradients in float64;
15. the rest of training (after train), each phase at full width under
   the "float32" policy, none of whose train steps may launch a kernel,
   each with its step times, peak memory and a card-against-CPU check
   (f32 losses within TOL_TRAIN_LOSS, gradients in float64 within
   TOL_TRAIN_GRAD64 of each tensor's peak, the f32 ones printed):
   - vocoder_train: ``avocodo_pipeline`` (``HiFiGANGenerator()``, the
     joint critic at full width) on a seeded synthetic LJSpeech corpus
     written to a temporary ``TOUCAN_CORPORA_ROOT``, batch 18, 12 steps
     (0-2 warm-up, the critic updating at 3, 6, 9), the profiler's top
     items of one adversarial step with the critic update; its
     ``checkpoint_0.pt`` (``load.load_vocoder``) and the returned
     generator served through K2 (4 launches each) against their
     differentiable path (TOL_WAVE); one adversarial step of batch 1 on 16
     frames card against CPU, with the spectral sigmas (TOL_SIGMA);
   - bigvgan_train: full-width ``BigVGAN()`` with the same critic, 3
     adversarial steps of batch 8, then served through K5 (73 launches)
     against its differentiable path (TOL_REF);
   - aligner_train: ``_aligner_train_fn`` with ``Aligner()`` and
     ``TinyTTS()`` on seeded datapoints (200-800 frames, 20-80 tokens),
     batch 8, 8 steps; ``mas_torch`` on the card equal to ``mas_numpy``;
     the first step (BatchNorm statistics within TOL_TRAIN_STATS);
   - embedding_train: ``fastspeech2_config()`` ToucanTTS and the GST, 4
     co-training steps at batch 16, the token-spread step, a fine-tune
     step on 8 triplets that must leave the GST's statistics as they were;
     the first co-training step;
   - wgan_qc: ``ResNetG()`` and ``ResNetD()``, batch 32, 5 steps with the
     host LP timed apart; one step with ``z``, the potentials and the
     ordered reals given to both sides.
16. distribution (last), its ranks started with ``spawn`` after the build
   (``dist/launch.py::run_ranks``: a clock each, the group torn down on a
   failure), sizes in DIST:
   - dist_train: one NCCL rank at world size 1 (mesh 1x1), then two gloo
     ranks sharing the card (NCCL refuses two ranks on one device) on
     meshes 2x1 and 1x2: the full-width ToucanTTS step with the critic
     (each rank batch 12 on 2x1, against one process at batch 24), the
     full-width HiFiGAN GAN step with the critic update (batch 2) and the
     aligner step (batch 2 of unequal lengths), each in float64 within
     TOL_DIST64 of each tensor's peak of one process on the global batch
     (the acoustic one also in float32, printed);
   - sharded_ckpt: on the two ranks, a full-width state (depth cut) saved
     on the 1x2 layout at two steps, restored onto 1x2 and 2x1, and the SWA
     of both: every tensor equal to the saved state, gathered whole;
   - longform: full-width HiFiGAN (K2) and BigVGAN (K5), biases live, on
     4099 frames time-sharded over the two ranks against the unsharded
     synthesis (TOL_LONGFORM), each rank's launches (its chunk and the
     tail's window); then ``ToucanTTSInterface(mesh=...,
     longform_frames=1024)`` on LONG_TEXT with durations and glow noise
     given (K1 12 and K2 a rank) against the same interface without a
     mesh, its mel vocoded whole;
   - pipelined: ``PipelinedSynthesizer`` on the card, six batches, each wave
     against its standalone dispatch (TOL_PIPE), K1 12 and K2 4 a batch;
     ``bench_pipelined_vs_sequential`` (one card: ``two_stage`` False);
   - scaling: ``dist/scaling_bench.py::measure(1, 1)`` at full width.

It then prints one JSON line of per-kernel numbers, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failure exits
nonzero.  TF32 is off for matmuls and cuDNN, for the plain versions; the
port's entry points pin f32 themselves.
"""

import copy
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

from toucan_tpu_torch import native
from toucan_tpu_torch.frontend import audio
from toucan_tpu_torch.data import batching
from toucan_tpu_torch.data.extraction import compute_frame_energy
from toucan_tpu_torch.data.prefetch import to_tensors
from toucan_tpu_torch.data.vocoder_data import SEGMENT_24K, VocoderDataset
from toucan_tpu_torch.dist.longform import synthesize_longform
from toucan_tpu_torch.dist.mesh import (all_gather, make_global_batch, make_mesh,
                                        shard_train_state)
from toucan_tpu_torch.dist.scaling_bench import measure
from toucan_tpu_torch.dist.tensor_parallel import unshard
from toucan_tpu_torch.frontend.inventory import phone_feature_matrix, vectors_to_ctc_ids
from toucan_tpu_torch.frontend.text import TextFrontend
from toucan_tpu_torch.infer.cloner import UtteranceCloner
from toucan_tpu_torch.infer.controllable import ControllableInterface
from toucan_tpu_torch.infer.pipelined import PipelinedSynthesizer, bench_pipelined_vs_sequential
from toucan_tpu_torch.infer.interface import (FRAMES_PER_PHONE, PHONE_BUCKET,
                                              SENTENCE_JOIN_SILENCE, ToucanTTSInterface,
                                              _round_up, write_wav)
from toucan_tpu_torch.kernels import aliasfree as aliasfree_module
from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.kernels import imcol as imcol_module
from toucan_tpu_torch.kernels import stage as stage_module
from toucan_tpu_torch.kernels.aliasfree import (alias_free_snake, alias_free_snake_plain,
                                                alias_free_snake_polyphase)
from toucan_tpu_torch.kernels.flash_attention import (BUILT_HEAD_DIMS, flash_rel_attention,
                                                      flash_rel_attention_plain)
from toucan_tpu_torch.kernels.imcol import (imcol_fold, imcol_stage, imcol_stage_plain,
                                            prepare_imcol_stage)
from toucan_tpu_torch.kernels.resstack import (hifigan_stage, hifigan_stage_plain,
                                               kernel_channels, pack_stage, tiling_for)
from toucan_tpu_torch.kernels.stage import (calibrate_stage_scales, quantize_stage,
                                            quantized_stage, quantized_stage_plain)
from toucan_tpu_torch.load import (GLOW_WEIGHT_NORM, interface_from_torch, load_vocoder,
                                   split_weight_norm)
from toucan_tpu_torch.models import embedding_gan as embedding_gan_module
from toucan_tpu_torch.models.aligner import (Aligner, alignment_from_logits, mas_numpy, mas_torch,
                                             path_score)
from toucan_tpu_torch.models.embedding_gan import (GanWrapper, ResNetG, create_wgan_qc_state,
                                                   make_wgan_qc_train_step, solve_ot_lp)
from toucan_tpu_torch.models.embedding_vae import EmbeddingVAE
from toucan_tpu_torch.models.gst import StyleEmbedding
from toucan_tpu_torch.models.stochastic_toucan_tts import StochasticToucanTTS
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig, fastspeech2_config
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.discriminators import AvocodoJointDiscriminator
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.nn import positional
from toucan_tpu_torch.recipes.pipelines import _aligner_train_fn, aligner_batch, avocodo_pipeline
from toucan_tpu_torch.train import sharded_checkpointing as sharded_ckpt
from toucan_tpu_torch.train.aligner_train import (TinyTTS, create_aligner_train_state,
                                                  make_aligner_train_step,
                                                  make_sharded_aligner_step)
from toucan_tpu_torch.train.embedding_train import (create_embedding_train_state,
                                                    make_embedding_train_step,
                                                    make_finetune_step,
                                                    make_spread_regularization_step)
from toucan_tpu_torch.train.loop import train_loop
from toucan_tpu_torch.train.toucan_train import (ZERO_GRADIENTS, compute_gradients,
                                                 create_train_state, make_train_step)
from toucan_tpu_torch.train.vocoder_train import (create_vocoder_train_state,
                                                  make_sharded_vocoder_steps,
                                                  make_vocoder_train_step, spectral_sigmas)
from toucan_tpu_torch.utils.device import matmul_precision

SEED = 0
F32_PEAK = 67e12      # H100 SXM f32 CUDA-core FLOP/s (NVIDIA data sheet)
# K1 and K2 run their f32 products in split TF32: three TF32 tensor-core
# products (495 TFLOP/s dense) per f32 product
SPLIT_TF32_PEAK = 495e12 / 3
PEAK = {"int8": 1979e12, "bf16": 989e12}  # H100 SXM dense tensor-core rates
HBM_RATE = 3.35e12    # H100 SXM bytes/s
TOL_K1 = 2e-5
TOL_K2 = (2e-4, 2e-3)  # atol, rtol
TOL_K5 = 2e-5
# K3 against its plain version, as a share of max|out|: the integer sums are
# exact on both sides, but the f32 dequant chains and the bf16 stream can
# round a value across a requantization boundary in one and not the other
TOL_K3 = {"int8": 1e-2, "bf16": 2e-2}
# K4 against its plain version, as a share of max|out|: int8 takes the same
# integer sums and the same f32 dequant chain in the same order on both
# sides, so only an order difference could flip a requantization; bf16 sums
# its f32 products in another order through 18 convs
TOL_K4 = {"int8": 1e-5, "bf16": 1e-3}
K4_STAGES = (1, 2, 3)  # the stages of at most 128 channels, which imcol_mode takes
# the GST embedding from the same wave, card against CPU: f32 convs, GRU
# and attention in other orders
TOL_EMB = 1e-4
# int8 wave against the exact one of the same call and noise, the bounds of
# tests/test_pallas_stage.py: SNR above 25 dB, max error within 6 % of the peak
INT8_SNR_DB = 25
TOL_INT8_WAVE = 0.06
# int8 wave, card against CPU on the same scales, as a share of its peak:
# only upstream f32 order differs, which can flip a requantization here and
# there, so the two differ by a small part of the int8 noise, and by far
# more if K3 is wrong
TOL_REF_INT8 = 1e-2
K5_LAUNCHES = 73       # 4 stages x 3 AMP blocks x 6 activations + activation_post
# the full-width path on the card against the CPU: f32 throughout, but the
# sums run in other orders (cuDNN, the kernels' tiles) through 12 conformer
# blocks and 18 glow blocks
TOL_REF = 1e-3
# a generator alone, card against CPU on the same mel: the HiFiGAN wave bar
# of the JAX package against the torch reference (tests/test_vocoder_parity.py)
TOL_WAVE = 2e-5
# the same f32 call with the caller's cudnn.allow_tf32 on and off: only
# cuDNN's choice of algorithm may differ
TOL_TF32_DEFAULT = 1e-5
# a call through its bucket's CUDA graph against the same call run eagerly,
# on the same noise: the same kernels on the same inputs, 0 expected
TOL_GRAPH = 1e-6
GRAPH_ROUNDS = 3   # rounds of (eager, graph, graph, eager) in phase_graphs
K2_FRAMES = 512
STAGE_SCALES = (8, 48, 192, 384)  # vocoder samples per mel frame after each stage
# BigVGAN's stages at 512 channels: (samples per mel frame, channels)
BIGVGAN_STAGES = tuple(zip(STAGE_SCALES, (256, 128, 64, 32)))
# K5's large-amplitude case: x times K5_LARGE, so e^alpha |y| reaches ~1e3.
# There f32 itself moves z by more than TOL_K5 (one ulp of |z| ~ 400 is
# 3e-5, and an ulp of y moves sin^2(e^alpha y) by e^alpha |y| 2^-23 ~ 1e-4),
# so the kernel is held to TOL_K5 x K5_LARGE against the plain version, and
# against a float64 evaluation of the same formula to no more than
# K5_REF_FACTOR x the plain version's own distance from it
K5_LARGE = 100.0
K5_REF_FACTOR = 2.0
# head dims K1 is checked and timed at besides the default's 48: built
# (96, 128) and padded (40), at T = 2048
K1_WIDTHS = (96, 128, 40)
# K2 at other generators' widths, on their init weights and at unit gain:
# (C, generator channels, stage); C = 512 runs on clusters of 8 blocks, the
# others widened with zero channels
K2_WIDTHS = ((512, 1024, 0), (48, 96, 0), (16, 64, 1), (4, 64, 3))
LONG_TEXT = ("The quick brown fox jumps over the lazy dog near the river bank, "
             "while seven children watch from the old bridge.")
BATCH_TEXTS = ["Speech synthesis turns written text into spoken audio.",
               "This sentence is a little longer than the first one.",
               "Numbers like 42 are read out as words.",
               "The last line ends the batch."]


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters):
    """Mean device time of fn over iters runs, after two warm-up runs."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device ms of one fn(): iters calls captured in one CUDA graph and
    replayed between two events (after a warm-up on a side stream), so the
    host's enqueue rate, which bounds a loop of short launches, does not
    enter it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak=F32_PEAK):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the kernels that run on the tensor cores, and the SASS instructions each
# must hold: K1 and K2 split TF32 (HMMA), K3 and K4 int8 (IMMA) and bf16
# (HMMA)
TENSOR_CORE_KERNELS = {"flash_rel_attention": ("HMMA",), "hifigan_stage": ("HMMA",),
                       "hifigan_stage_q": ("IMMA", "HMMA"), "hifigan_imcol": ("IMMA", "HMMA")}
# the kernels whose int8 products must all be on the tensor cores: no IDP
NO_DP4A = ("hifigan_imcol",)
# K4 at the widths of other generators (192 and 384 channels), C: fold
K4_WIDTHS = {96: 1, 48: 2}


def phase_build():
    t0 = time.perf_counter()
    logs = build.build(["flash_rel_attention", "hifigan_stage", "alias_free_snake",
                        "hifigan_stage_q", "hifigan_imcol"])
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line or "spill" in line or "error" in line.lower():
                log("build", f"{name}: {line.strip()}")
    log("build", f"nvcc built {sorted(logs)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    for name, needed in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([cuobjdump, "--dump-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        # IDP: __dp4a on the CUDA cores, which the tensor-core kernels replace
        counts = {op: sum(1 for line in sass.splitlines() if f" {op}" in line)
                  for op in ("HMMA", "HGMMA", "IMMA", "IDP")}
        log("build", f"{name}: instructions in SASS: "
                     + ", ".join(f"{op} {n}" for op, n in counts.items()))
        missing = [op for op in needed if not counts[op]]
        if missing:
            raise AssertionError(f"{name} has no {', '.join(missing)} instruction in its SASS")
        if name in NO_DP4A and counts["IDP"]:
            raise AssertionError(f"{name} still runs __dp4a (IDP) on the CUDA cores")
    # K5: its taps are parameter-bank operands, its halos shuffles; local
    # memory (LDL/STL) only in sinf's slow path for |arg| > 8192
    sass = subprocess.run([cuobjdump, "--dump-sass", str(build.library_path("alias_free_snake"))],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sum(1 for line in sass.splitlines() if f" {op}" in line)
              for op in ("LDL", "STL", "MUFU.SIN", "SHFL", "LDG.E.128", "STG.E.128")}
    log("build", "alias_free_snake: instructions in SASS: "
                 + ", ".join(f"{op} {n}" for op, n in counts.items()))
    if not (counts["MUFU.SIN"] and counts["SHFL"] and counts["LDG.E.128"]):
        raise AssertionError("alias_free_snake lacks its reduced sine, shuffles or float4 loads")


def k1_inputs(gen, dev, b, h, d, t, lengths):
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q_u, q_v, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev) for _ in range(4))
    p = torch.randn(h, 2 * t - 1, d, generator=gen, device=dev)
    return q_u, q_v, k, v, p, lens


def k1_error(args):
    got = flash_rel_attention(*args)
    torch.cuda.synchronize()
    want = flash_rel_attention_plain(*args)
    return (got - want).abs().max().item(), want


def k1_shapes():
    """(label, B, T, lengths) of phase_k1: the two shapes this phase has always timed,
    then the main path's own (default config, 110 phones): the encoder at
    the 128-phone bucket, the decoder at the 2048-frame bucket with the 110
    valid frames random weights give and with every frame valid (trained
    weights predict several frames per phone)."""
    _, (n,), bucket, frames, _ = main_path_cases()[0]
    return [("B=2 T=128", 2, 128, [128, int(0.7 * 128)]),
            ("B=2 T=2048", 2, 2048, [2048, int(0.7 * 2048)]),
            ("encoder", 1, bucket, [n]),
            ("decoder, random weights", 1, frames, [n]),
            ("decoder, all frames valid", 1, frames, [frames])]


def phase_k1(dev, gen):
    """K1 against its plain version, timed beside SDPA and both bounds; the
    row is the B=2 T=2048 shape's, with the worst error of all."""
    h, d = 4, 48
    worst, row = 0.0, None
    for label, b, t, lengths in k1_shapes():
        args = k1_inputs(gen, dev, b, h, d, t, lengths)
        q_u, q_v, k, v, p, lens = args
        err, want = k1_error(args)
        worst = max(worst, err)
        ms = time_ms(lambda: flash_rel_attention(*args), 20)
        plain_ms = time_ms(lambda: flash_rel_attention_plain(*args), 5)
        # yardstick only: SDPA on the same scores with the rel-pos bias and
        # the key mask materialised as a float mask (built outside the timing)
        ar = torch.arange(t, device=dev)
        rel = (t - 1 - ar[:, None] + ar[None, :]).expand(b, h, t, t)
        bias = torch.gather(q_v @ p.transpose(-1, -2)[None], -1, rel) / math.sqrt(d)
        bias = bias.masked_fill(~(ar[None, :] < lens[:, None])[:, None, None, :], float("-inf"))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_err = (sdpa(q_u, k, v, attn_mask=bias) - want).abs().max().item()
        library_ms = time_ms(lambda: sdpa(q_u, k, v, attn_mask=bias), 20)
        del bias, rel
        flops = sum(6 * h * d * t * int(n) for n in lens.tolist())
        nbytes = 4 * (5 * b * h * t * d + h * (2 * t - 1) * d + b)
        bound_ms, bound_by = bound(flops, nbytes, SPLIT_TF32_PEAK)
        f32_ms, _ = bound(flops, nbytes)
        log("k1", f"{label}: B={b} H={h} T={t} d={d} lengths={lens.tolist()} "
                  f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} (sdpa err {lib_err:.2e}) "
                  f"bound_ms={bound_ms:.4f} ({bound_by}, split TF32) f32_bound_ms={f32_ms:.4f} "
                  f"gflop={flops / 1e9:.2f} achieved_tflops={flops / ms / 1e9:.2f}")
        if not err <= TOL_K1:
            raise AssertionError(f"K1 disagrees with its plain version: {label}: {err:.3e}")
        if label == "B=2 T=2048":
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)
    return dict(row, max_abs_err=worst)


def unit_gain_stages(vocoder, gen):
    """Per stage, weights of the stage's shape drawn at unit gain (std
    1/sqrt(k C), biases 0.1): at HiFiGAN's init std of 0.01 the convs hardly
    move the stream, and a kernel that formed one TF32 product per multiply
    would pass too (tests/test_torch_kernels.py::
    test_split_tf32_keeps_f32_accuracy reads single TF32 8.8e-4 over the
    rtol share at unit gain, tolerance 2e-4)."""
    stages = []
    for i in range(len(STAGE_SCALES)):
        sw = vocoder.stage_weights(i)
        c, dev = sw.channels, sw.w.device
        convs = [(torch.randn(c, c, k, generator=gen, device=dev) / math.sqrt(k * c),
                  0.1 * torch.randn(c, generator=gen, device=dev))
                 for k in sw.kernel_sizes for _ in range(2 * len(sw.dilations))]
        stages.append(pack_stage(convs, c, sw.kernel_sizes, sw.dilations, sw.slope))
    return stages


def k2_error(x, sw):
    """(max abs err, max excess over the rtol share of |plain|)."""
    got = hifigan_stage(x, sw)
    torch.cuda.synchronize()
    want = hifigan_stage_plain(x, sw)
    diff = (got - want).abs()
    return diff.max().item(), (diff - TOL_K2[1] * want.abs()).max().item()


def phase_k2(dev, gen, vocoder, unit):
    """K2 against its plain version (18 f32 cuDNN convs) at the four stage
    shapes of K2_FRAMES and of 2048 frames (the main path's), with the
    tiling each launch took, on HiFiGAN's weights (timed) and on ``unit``,
    the stages at unit gain.  The row is K2_FRAMES's totals; its error the
    worst of both weights."""
    rows = {}
    for frames in (K2_FRAMES, 2048):
        totals = dict(ms=0.0, plain_ms=0.0, flops=0, nbytes=0)
        worst, stage_ms = 0.0, []
        for i, scale in enumerate(STAGE_SCALES):
            sw = vocoder.stage_weights(i)
            c, t = sw.channels, scale * frames
            x = torch.randn(1, t, c, generator=gen, device=dev)
            err, excess = k2_error(x, sw)
            err_u, excess_u = k2_error(x, unit[i])
            worst = max(worst, err, err_u)
            ms = time_ms(lambda: hifigan_stage(x, sw), 3)
            plain_ms = time_ms(lambda: hifigan_stage_plain(x, sw), 3)
            flops = 252 * t * c * c
            nbytes = 4 * (2 * t * c + sw.w.numel() + sw.b.numel())
            bound_ms, bound_by = bound(flops, nbytes, SPLIT_TF32_PEAK)
            f32_ms, _ = bound(flops, nbytes)
            tl = tiling_for(x, sw)
            log("k2", f"{frames} frames, stage {i}: B=1 T={t} C={c} max_abs_err={err:.3e} "
                      f"(excess {excess:.2e}; unit gain {err_u:.3e}, excess {excess_u:.2e}; "
                      f"tolerance {TOL_K2[0]} over the rtol share) "
                      f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                      f"bound_ms={bound_ms:.3f} ({bound_by}, split TF32) f32_bound_ms={f32_ms:.3f} "
                      f"gflop={flops / 1e9:.1f} achieved_tflops={flops / ms / 1e9:.2f} "
                      f"tile={tl.tile} cluster={tl.cluster} channels_per_block={tl.block_channels} "
                      f"clusters={tl.clusters} tiles={tl.jobs} "
                      f"scratch_mb={tl.scratch_bytes(c) / 2**20:.1f}")
            if not (excess <= TOL_K2[0] and excess_u <= TOL_K2[0]):
                raise AssertionError(f"K2 disagrees with its plain version at {frames} frames, "
                                     f"stage {i}: excess {excess:.3e}, unit gain {excess_u:.3e}")
            del x
            totals["ms"] += ms
            totals["plain_ms"] += plain_ms
            totals["flops"] += flops
            totals["nbytes"] += nbytes
            stage_ms.append(ms)
        bound_ms, bound_by = bound(totals["flops"], totals["nbytes"], SPLIT_TF32_PEAK)
        f32_ms, _ = bound(totals["flops"], totals["nbytes"])
        log("k2", f"four stages of {frames} frames: kernel_ms={totals['ms']:.3f} "
                  f"plain_ms={totals['plain_ms']:.3f} bound_ms={bound_ms:.3f} (split TF32) "
                  f"f32_bound_ms={f32_ms:.3f}")
        rows[frames] = (dict(ms=totals["ms"], plain_ms=totals["plain_ms"], bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None, max_abs_err=worst), stage_ms)
    row, stage_ms = rows[K2_FRAMES]
    row["max_abs_err"] = max(r["max_abs_err"] for r, _ in rows.values())
    return row, stage_ms


def k5_inputs(gen, dev, b, t, c, scale=1.0):
    """x (B, T, C) as BigVGAN passes it (the view of a (B, C, T) conv
    output), times ``scale``, random alpha and beta (x0.3)."""
    alpha = 0.3 * torch.randn(c, generator=gen, device=dev)
    beta = 0.3 * torch.randn(c, generator=gen, device=dev)
    return scale * torch.randn(b, c, t, generator=gen, device=dev).transpose(1, 2), alpha, beta


def k5_error(x, alpha, beta):
    got = alias_free_snake(x, alpha, beta)
    torch.cuda.synchronize()
    return (got - alias_free_snake_plain(x, alpha, beta)).abs().max().item()


def k5_one_tile(fn):
    """fn() with K5's launches taking one chunk a warp (no persistent runs)."""
    chosen = aliasfree_module.geometry_for
    aliasfree_module.geometry_for = functools.partial(chosen, persistent=False)
    try:
        return fn()
    finally:
        aliasfree_module.geometry_for = chosen


def k5_geometry(x):
    geo = aliasfree_module.geometry_for(x.transpose(1, 2).contiguous())
    return (f"runs of {geo.seg_chunks} chunks, {geo.items} runs, {geo.blocks} blocks "
            f"({geo.warps} warps), {'16-byte' if geo.vector else 'scalar'} access")


def phase_k5(dev, gen):
    """K5 at BigVGAN's four stage shapes of 512 and of 2048 mel frames
    (B = 1) and of 1024 frames at B = 4, each with its share of the bytes
    bound and its launch geometry; at 2048 frames also against one chunk a
    warp (``k5_one_tile``), output equal, timed in turns.  Then the shapes
    no stage gives: T = 8, T = 4099 (odd: rows not 16-byte aligned, scalar
    access) at C = 20 (a multiple of no channel group), and x times 100,
    where e^alpha y reaches ~1e3 (the sine's reduction far from 0).  The
    row: one activation at each 512-frame stage shape, summed; its error
    the worst of all."""
    rows, worst = {}, 0.0
    for frames, b in ((512, 1), (2048, 1), (1024, 4)):
        totals = dict(ms=0.0, plain_ms=0.0, flops=0, nbytes=0)
        for scale, c in BIGVGAN_STAGES:
            t = scale * frames
            x, alpha, beta = k5_inputs(gen, dev, b, t, c)
            err = k5_error(x, alpha, beta)
            worst = max(worst, err)
            ab = ""
            if frames == 2048:
                one = k5_one_tile(lambda: alias_free_snake(x, alpha, beta))
                if not torch.equal(one, alias_free_snake(x, alpha, beta)):
                    raise AssertionError(f"K5 with one chunk a warp differs at T={t} C={c}")
                del one
                a = graph_ms(lambda: alias_free_snake(x, alpha, beta))
                o = k5_one_tile(lambda: graph_ms(lambda: alias_free_snake(x, alpha, beta)))
                o2 = k5_one_tile(lambda: graph_ms(lambda: alias_free_snake(x, alpha, beta)))
                a2 = graph_ms(lambda: alias_free_snake(x, alpha, beta))
                ms = (a + a2) / 2
                ab = (f"; one chunk a warp ({k5_one_tile(lambda: k5_geometry(x))}): "
                      f"{(o + o2) / 2:.4f} ms, output equal, timed in turns")
            else:
                ms = graph_ms(lambda: alias_free_snake(x, alpha, beta))
            # the event loop, host enqueue included, as phase_k5 timed K5 before
            loop_ms = time_ms(lambda: alias_free_snake(x, alpha, beta), 20)
            plain_ms = time_ms(lambda: alias_free_snake_plain(x, alpha, beta), 5)
            flops, nbytes = 56 * b * t * c, 4 * (2 * b * t * c + 2 * c)
            bound_ms, _ = bound(flops, nbytes)
            log("k5", f"{frames} frames: B={b} T={t} C={c} max_abs_err={err:.3e} "
                      f"kernel_ms={ms:.4f} (loop of launches {loop_ms:.4f}) "
                      f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                      f"share_of_bound={bound_ms / ms:.4f} GB/s={nbytes / ms / 1e6:.1f} "
                      f"{k5_geometry(x)}{ab}")
            if not err <= TOL_K5:
                raise AssertionError(f"K5 disagrees with its plain version at B={b} T={t} C={c}")
            del x
            totals["ms"] += ms
            totals["plain_ms"] += plain_ms
            totals["flops"] += flops
            totals["nbytes"] += nbytes
        bound_ms, bound_by = bound(totals["flops"], totals["nbytes"])
        log("k5", f"one activation at each of the four stage shapes of {frames} frames, B={b}: "
                  f"kernel_ms={totals['ms']:.4f} plain_ms={totals['plain_ms']:.4f} "
                  f"bound_ms={bound_ms:.4f} share_of_bound={bound_ms / totals['ms']:.4f} "
                  f"GB/s={totals['nbytes'] / totals['ms'] / 1e6:.1f}")
        rows[frames] = dict(ms=totals["ms"], plain_ms=totals["plain_ms"], bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
    for b, t, c, scale in ((1, 8, 256, 1.0), (2, 4099, 20, 1.0), (1, 4099, 32, 1.0),
                           (1, 192 * 512, 64, K5_LARGE)):
        x, alpha, beta = k5_inputs(gen, dev, b, t, c, scale)
        got = alias_free_snake(x, alpha, beta)
        torch.cuda.synchronize()
        plain = alias_free_snake_plain(x, alpha, beta)
        err = (got - plain).abs().max().item()
        # float64: what f32 rounding costs either side at this amplitude
        ref = alias_free_snake_polyphase(x.double(), alpha.double(), beta.double())
        err_ref, plain_ref = ((v.double() - ref).abs().max().item() for v in (got, plain))
        arg = (torch.exp(alpha).abs().max() * x.abs().max()).item()
        log("k5", f"B={b} T={t} C={c} x{scale:g}: max_abs_err={err:.3e} (kernel against "
                  f"float64 {err_ref:.3e}, plain against float64 {plain_ref:.3e}; "
                  f"max|z| {plain.abs().max().item():.1f}, max e^alpha|x| {arg:.1f}) "
                  f"{k5_geometry(x)}")
        if not (err <= TOL_K5 * scale and err_ref <= max(TOL_K5, K5_REF_FACTOR * plain_ref)):
            raise AssertionError(f"K5 disagrees with its plain version at B={b} T={t} C={c} "
                                 f"x{scale:g}")
        if scale == 1.0:
            worst = max(worst, err)
        del x, got, plain, ref
    return dict(rows[512], max_abs_err=worst)


def k1_bf16_inputs(gen, dev, b, h, d, t, lengths):
    """``k1_inputs`` rounded to bf16, as a bf16 model hands them to K1."""
    *xs, lens = k1_inputs(gen, dev, b, h, d, t, lengths)
    return (*(x.to(torch.bfloat16) for x in xs), lens)


def phase_k1_bf16(dev, gen):
    """K1's bf16 instantiation against its plain version (f32 arithmetic on
    the same bf16 values) at the shapes of ``k1_shapes`` (d = 48, the
    default model's) and at B=2 T=2048 with d = 96 (``fastspeech2_config``),
    timed beside SDPA on the same bf16 inputs with the rel-pos bias and the
    key mask as a bf16 float mask, and beside the f32 kernel on the same
    values; bound by bf16 products.  The row is the B=2 T=2048 d=48 shape's,
    with the worst error of all."""
    h = 4
    worst, row = 0.0, None
    cases = [(label, b, t, lengths, 48) for label, b, t, lengths in k1_shapes()]
    cases.append(("B=2 T=2048, d=96", 2, 2048, [2048, int(0.7 * 2048)], 96))
    for label, b, t, lengths, d in cases:
        args = k1_bf16_inputs(gen, dev, b, h, d, t, lengths)
        q_u, q_v, k, v, p, lens = args
        err, want = k1_error(args)
        worst = max(worst, err)
        ms = time_ms(lambda: flash_rel_attention(*args), 20)
        plain_ms = time_ms(lambda: flash_rel_attention_plain(*args), 5)
        f32_args = (*(x.float() for x in args[:5]), lens)
        f32_ms = time_ms(lambda: flash_rel_attention(*f32_args), 20)
        ar = torch.arange(t, device=dev)
        rel = (t - 1 - ar[:, None] + ar[None, :]).expand(b, h, t, t)
        bias = torch.gather(q_v.float() @ p.float().transpose(-1, -2)[None], -1, rel) / math.sqrt(d)
        bias = bias.masked_fill(~(ar[None, :] < lens[:, None])[:, None, None, :],
                                float("-inf")).to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_err = (sdpa(q_u, k, v, attn_mask=bias).float() - want).abs().max().item()
        library_ms = time_ms(lambda: sdpa(q_u, k, v, attn_mask=bias), 20)
        del bias, rel
        flops = sum(6 * h * d * t * int(n) for n in lens.tolist())
        nbytes = 2 * (4 * b * h * t * d + h * (2 * t - 1) * d) + 4 * (b * h * t * d + b)
        bound_ms, bound_by = bound(flops, nbytes, PEAK["bf16"])
        log("k1_bf16", f"{label}: B={b} H={h} T={t} d={d} lengths={lens.tolist()} "
                       f"max_abs_err={err:.3e} (tolerance {TOL_K1}) kernel_ms={ms:.4f} "
                       f"f32_kernel_ms={f32_ms:.4f} plain_ms={plain_ms:.4f} "
                       f"library_ms={library_ms:.4f} (sdpa bf16 err {lib_err:.2e}) "
                       f"bound_ms={bound_ms:.4f} ({bound_by}, bf16) "
                       f"achieved_tflops={flops / ms / 1e9:.2f}")
        if not err <= TOL_K1:
            raise AssertionError(f"K1 bf16 disagrees with its plain version: {label}: {err:.3e}")
        if label == "B=2 T=2048":
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)
    return dict(row, max_abs_err=worst)


def k5_bf16_error(x, alpha, beta):
    """(max abs err, max of err / (one bf16 ulp of |plain| + TOL_K5)) of
    K5's bf16 instantiation against its plain version: both round one f32
    value to bf16, and the two f32 values differ by up to TOL_K5 (the
    kernel's reduced sine), so a rounding may fall one ulp apart."""
    got = alias_free_snake(x, alpha, beta)
    torch.cuda.synchronize()
    want = alias_free_snake_plain(x, alpha, beta).float()
    diff = (got.float() - want).abs()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
    return diff.max().item(), (diff / (ulp + TOL_K5)).max().item()


def phase_k5_bf16(dev, gen):
    """K5's bf16 instantiation at BigVGAN's four stage shapes of 512 and
    2048 frames (B = 1) against its plain version (``k5_bf16_error``), each
    timed beside the f32 kernel on the same values, with the share of its
    bytes bound (2 bytes in and out a sample) and GB/s; then T = 4099 (rows
    not 16-byte aligned) and T = 8.  The row: one activation at each
    512-frame stage shape, summed."""
    rows, worst = {}, 0.0
    for frames in (512, 2048):
        totals = dict(ms=0.0, plain_ms=0.0, flops=0, nbytes=0)
        for scale, c in BIGVGAN_STAGES:
            t = scale * frames
            x, alpha, beta = (v.to(torch.bfloat16) for v in k5_inputs(gen, dev, 1, t, c))
            err, ratio = k5_bf16_error(x, alpha, beta)
            worst = max(worst, err)
            ms = graph_ms(lambda: alias_free_snake(x, alpha, beta))
            x32, a32, b32 = x.float(), alpha.float(), beta.float()
            f32_ms = graph_ms(lambda: alias_free_snake(x32, a32, b32))
            plain_ms = time_ms(lambda: alias_free_snake_plain(x, alpha, beta), 5)
            flops, nbytes = 56 * t * c, 2 * (2 * t * c + 2 * c)
            bound_ms, _ = bound(flops, nbytes)
            log("k5_bf16", f"{frames} frames: B=1 T={t} C={c} max_abs_err={err:.3e} "
                           f"(at most {ratio:.3f} of one bf16 ulp + {TOL_K5}) "
                           f"kernel_ms={ms:.4f} f32_kernel_ms={f32_ms:.4f} "
                           f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                           f"share_of_bound={bound_ms / ms:.4f} GB/s={nbytes / ms / 1e6:.1f} "
                           f"{k5_geometry(x)}")
            if not ratio <= 1.0:
                raise AssertionError(f"K5 bf16 disagrees with its plain version at T={t} C={c}")
            del x, x32
            totals["ms"] += ms
            totals["plain_ms"] += plain_ms
            totals["flops"] += flops
            totals["nbytes"] += nbytes
        bound_ms, bound_by = bound(totals["flops"], totals["nbytes"])
        log("k5_bf16", f"one activation at each of the four stage shapes of {frames} frames: "
                       f"kernel_ms={totals['ms']:.4f} plain_ms={totals['plain_ms']:.4f} "
                       f"bound_ms={bound_ms:.4f} share_of_bound={bound_ms / totals['ms']:.4f}")
        rows[frames] = dict(ms=totals["ms"], plain_ms=totals["plain_ms"], bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
    for b, t, c in ((1, 8, 256), (2, 4099, 20), (1, 4100, 32)):
        x, alpha, beta = (v.to(torch.bfloat16) for v in k5_inputs(gen, dev, b, t, c))
        err, ratio = k5_bf16_error(x, alpha, beta)
        log("k5_bf16", f"B={b} T={t} C={c}: max_abs_err={err:.3e} (at most {ratio:.3f} of one "
                       f"bf16 ulp + {TOL_K5}) {k5_geometry(x)}")
        if not ratio <= 1.0:
            raise AssertionError(f"K5 bf16 disagrees with its plain version at B={b} T={t} C={c}")
        worst = max(worst, err)
    return dict(rows[512], max_abs_err=worst)


def check_prepared_as_on_cpu(what, sw, card, prepare, *args):
    """The stage weights ``prepare`` gives on the card equal, bit for bit,
    what it gives on the CPU from the same weights: the quantization's
    divisions are IEEE on both devices."""
    cpu = prepare(dataclasses.replace(sw, w=sw.w.cpu(), b=sw.b.cpu()),
                  *(a.cpu() if torch.is_tensor(a) else a for a in args))
    for field in ("w", "scale", "qin", "deq", "bias"):
        if hasattr(card, field) and not torch.equal(getattr(card, field).cpu(),
                                                    getattr(cpu, field)):
            raise AssertionError(f"{what}: {field} prepared on the card differs from the CPU's")


def k3_error(x, qs):
    """(max abs err, max|plain|, elements that differ, elements)."""
    got = quantized_stage(x, qs)
    torch.cuda.synchronize()
    want = quantized_stage_plain(x, qs)
    diff = (got - want).abs()
    return diff.max().item(), want.abs().max().item(), int((diff > 0).sum()), diff.numel()


def k3_tiling(x, qs):
    """The tiling a K3 launch on x takes, for the log."""
    tl = stage_module.tiling_for(x, qs)
    return (f"tile={tl.tile} cluster={tl.cluster} tiles={tl.jobs} clusters={tl.clusters} "
            f"smem_kb={tl.smem / 1024:.1f}")


def k3_single_blocks(fn):
    """fn() with K3's tiles each in one block (no cluster)."""
    chosen = stage_module.tiling_for
    stage_module.tiling_for = functools.partial(chosen, max_cluster=1)
    try:
        return fn()
    finally:
        stage_module.tiling_for = chosen


def k3_cluster_ab(x, qs):
    """Where the chooser splits a tile over a cluster: the same launch with
    one block per tile must give the same output bit for bit (the sums run
    in the same order), and the two are timed in turns (cluster, single,
    single, cluster).  Returns (the cluster's ms, the single block's ms,
    its tiling) or None."""
    if stage_module.tiling_for(x, qs).cluster == 1:
        return None
    single = k3_single_blocks(lambda: quantized_stage(x, qs))
    if not torch.equal(single, quantized_stage(x, qs)):
        raise AssertionError("K3 with clusters differs from K3 with one block per tile")
    a = time_ms(lambda: quantized_stage(x, qs), 3)
    b = k3_single_blocks(lambda: time_ms(lambda: quantized_stage(x, qs), 3))
    b2 = k3_single_blocks(lambda: time_ms(lambda: quantized_stage(x, qs), 3))
    a2 = time_ms(lambda: quantized_stage(x, qs), 3)
    return (a + a2) / 2, (b + b2) / 2, k3_single_blocks(lambda: k3_tiling(x, qs))


def phase_k3(dev, gen, vocoder, k2_stage_ms):
    """K3 in both modes at the four HiFiGAN stage shapes of 512 frames, with
    int8 scales calibrated on the same input.  Returns the int8 totals (the
    main path's mode)."""
    totals = {m: dict(ms=0.0, plain_ms=0.0, flops=0, nbytes=0, err=0.0) for m in ("int8", "bf16")}
    int8_stage_ms = []
    for i, scale in enumerate(STAGE_SCALES):
        sw = vocoder.stage_weights(i)
        c, t = sw.channels, scale * K2_FRAMES
        x = torch.randn(1, t, c, generator=gen, device=dev)
        scales = calibrate_stage_scales(x, sw)
        for mode, tot in totals.items():
            qs = quantize_stage(sw, mode, scales if mode == "int8" else None)
            check_prepared_as_on_cpu(f"K3 {mode} stage {i}", sw, qs, quantize_stage, mode,
                                     scales if mode == "int8" else None)
            err, peak, n_diff, n = k3_error(x, qs)
            ab = k3_cluster_ab(x, qs)
            ms = ab[0] if ab else time_ms(lambda: quantized_stage(x, qs), 3)
            plain_ms = time_ms(lambda: quantized_stage_plain(x, qs), 1)
            flops = 252 * t * c * c
            nbytes = (8 * t * c + qs.w.numel() * qs.w.element_size()
                      + 4 * (qs.deq.numel() + qs.bias.numel() + qs.qin.numel()))
            bound_ms, bound_by = bound(flops, nbytes, PEAK[mode])
            log("k3", f"{mode} stage {i}: B=1 T={t} C={c} max_abs_err={err:.3e} "
                      f"(max|out| {peak:.3e}, {n_diff} of {n} elements differ) "
                      f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} k2_ms={k2_stage_ms[i]:.3f} "
                      f"bound_ms={bound_ms:.4f} ({bound_by}) share_of_bound={bound_ms / ms:.4f} "
                      f"achieved_tops={flops / ms / 1e9:.2f} {k3_tiling(x, qs)}"
                      + (f"; one block per tile ({ab[2]}): {ab[1]:.3f} ms, output equal, "
                         f"timed in turns" if ab else ""))
            if not err <= TOL_K3[mode] * peak:
                raise AssertionError(f"K3 {mode} disagrees with its plain version at stage {i}")
            if mode == "int8":
                int8_stage_ms.append(ms)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["flops"] += flops
            tot["nbytes"] += nbytes
            tot["err"] = max(tot["err"], err)
    for mode, tot in totals.items():
        tot["bound_ms"], tot["bound_by"] = bound(tot["flops"], tot["nbytes"], PEAK[mode])
        log("k3", f"{mode}, four stages of {K2_FRAMES} frames: kernel_ms={tot['ms']:.3f} "
                  f"plain_ms={tot['plain_ms']:.3f} bound_ms={tot['bound_ms']:.4f} "
                  f"k2_ms={sum(k2_stage_ms):.3f}")
    tot = totals["int8"]
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                bound_by=tot["bound_by"], library_ms=None, max_abs_err=tot["err"]), int8_stage_ms


def k4_error(x, st):
    """(max abs err, max|plain|, elements that differ, elements)."""
    fold = imcol_fold(x.shape[-1])
    got = imcol_stage(x, st, fold)
    torch.cuda.synchronize()
    want = imcol_stage_plain(x, st, fold)
    diff = (got - want).abs()
    return diff.max().item(), want.abs().max().item(), int((diff > 0).sum()), diff.numel()


def check_k4(what, mode, err, peak, n_diff):
    """int8 bit for bit (the same integer sums and the same f32 chain in the
    same order), bf16 within TOL_K4 of the peak."""
    if (mode == "int8" and n_diff) or not err <= TOL_K4[mode] * peak:
        raise AssertionError(f"K4 {mode} disagrees with its plain version: {what} "
                             f"({n_diff} elements differ, max abs err {err:.3e})")


def k4_tiling(x, st):
    """The tiling a K4 launch on x takes, for the log."""
    tl = imcol_module.tiling_for(x, st, imcol_fold(x.shape[-1]))
    return (f"cluster={tl.cluster} blocks={tl.grid} per_sm={tl.per_sm} windows={tl.windows} "
            f"k_walk={'flat' if tl.flat else 'taps'} weight_buffers={tl.wslots} "
            f"smem_kb={tl.smem / 1024:.1f} scratch_mb={tl.scratch_bytes / 1e6:.2f}")


def k4_clusters(clusters, fn):
    """fn() with K4's launches taking only the given cluster sizes."""
    chosen = imcol_module.tiling_for
    imcol_module.tiling_for = functools.partial(chosen, clusters=clusters)
    try:
        return fn()
    finally:
        imcol_module.tiling_for = chosen


def k4_cluster_ab(x, st):
    """The chooser's launch against the other kind: one block per window
    where it takes clusters, the best split (2 or 4 blocks) where it takes
    one block.  The two must give the same output bit for bit where they
    walk K alike (each output's sums run in the same order; int8 sums are
    exact in any order), and are timed in turns (chosen, other, other,
    chosen).  Returns (chosen ms, other ms, the other's tiling, what was
    compared)."""
    fold = imcol_fold(x.shape[-1])
    chosen = imcol_module.tiling_for(x, st, fold)
    other = (1,) if chosen.cluster > 1 else (2, 4)

    def run():
        return imcol_stage(x, st, fold)
    same_walk = k4_clusters(other, lambda: imcol_module.tiling_for(x, st, fold)).flat == chosen.flat
    got, want = k4_clusters(other, run), run()
    if st.mode == "int8" or same_walk:
        if not torch.equal(got, want):
            raise AssertionError("K4 on clusters differs from K4 with one block per window")
        agree = "output equal"
    else:
        check_k4("the other launch", st.mode, (got - want).abs().max().item(),
                 want.abs().max().item(), 0)
        agree = "K walked otherwise, output within TOL_K4"
    a = time_ms(run, 5)
    b = k4_clusters(other, lambda: time_ms(run, 5))
    b2 = k4_clusters(other, lambda: time_ms(run, 5))
    a2 = time_ms(run, 5)
    return (a + a2) / 2, (b + b2) / 2, k4_clusters(other, lambda: k4_tiling(x, st)), agree


def phase_k4(dev, gen, vocoder, k2_stage_ms, k3_stage_ms):
    """K4 in both modes at the shapes of stages 1-3 of 512 frames, each with
    the tiling its launch took, and timed in turns against the other kind
    of launch (clusters or one block per window).  The bound counts least
    work: 252 T C^2 operations (the halo rows each window recomputes do not
    count) at the int8 (or bf16) tensor-core rate, against f32 in and out
    plus the weights.  Returns the int8 totals (the main path's mode)."""
    totals = {m: dict(ms=0.0, plain_ms=0.0, flops=0, nbytes=0, err=0.0) for m in ("int8", "bf16")}
    for i in K4_STAGES:
        sw = vocoder.stage_weights(i)
        c, t = sw.channels, STAGE_SCALES[i] * K2_FRAMES
        x = torch.randn(1, t, c, generator=gen, device=dev)
        fold = imcol_fold(c)
        for mode, tot in totals.items():
            st = prepare_imcol_stage(sw, mode)
            check_prepared_as_on_cpu(f"K4 {mode} stage {i}", sw, st, prepare_imcol_stage, mode)
            err, peak, n_diff, n = k4_error(x, st)
            clustered = imcol_module.tiling_for(x, st, fold).cluster > 1
            ms, other_ms, other_tiling, agree = k4_cluster_ab(x, st)
            plain_ms = time_ms(lambda: imcol_stage_plain(x, st, fold), 1)
            flops = 252 * t * c * c
            nbytes = (8 * t * c + st.w.numel() * st.w.element_size()
                      + 4 * (st.scale.numel() + st.bias.numel()))
            bound_ms, bound_by = bound(flops, nbytes, PEAK[mode])
            log("k4", f"{mode} stage {i}: B=1 T={t} C={c} fold={fold} max_abs_err={err:.3e} "
                      f"(max|out| {peak:.3e}, {n_diff} of {n} elements differ; weights "
                      f"prepared as on the CPU) "
                      f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} k2_ms={k2_stage_ms[i]:.3f} "
                      f"k3_int8_ms={k3_stage_ms[i]:.3f} bound_ms={bound_ms:.4f} ({bound_by}) "
                      f"share_of_bound={bound_ms / ms:.4f} achieved_tops={flops / ms / 1e9:.2f} "
                      f"{k4_tiling(x, st)}; "
                      f"{'one block per window' if clustered else 'on clusters'} "
                      f"({other_tiling}): {other_ms:.3f} ms, {agree}, timed in turns")
            check_k4(f"stage {i}", mode, err, peak, n_diff)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["flops"] += flops
            tot["nbytes"] += nbytes
            tot["err"] = max(tot["err"], err)
    for mode, tot in totals.items():
        tot["bound_ms"], tot["bound_by"] = bound(tot["flops"], tot["nbytes"], PEAK[mode])
        log("k4", f"{mode}, stages 1-3 of {K2_FRAMES} frames: kernel_ms={tot['ms']:.3f} "
                  f"plain_ms={tot['plain_ms']:.3f} bound_ms={tot['bound_ms']:.4f} "
                  f"k2_ms={sum(k2_stage_ms[i] for i in K4_STAGES):.3f} "
                  f"k3_int8_ms={sum(k3_stage_ms[i] for i in K4_STAGES):.3f}")
    tot = totals["int8"]
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                bound_by=tot["bound_by"], library_ms=None, max_abs_err=tot["err"])


def k4_widths(dev, gen, row):
    """K4 in both modes at the widths of other generators (K4_WIDTHS), on
    stage weights at unit gain (a 384-channel generator's stages 1 and 2 at
    512 frames); the int8 error folds into ``row``."""
    for c, fold in K4_WIDTHS.items():
        sw = pack_stage([(torch.randn(c, c, k, generator=gen, device=dev) / math.sqrt(k * c),
                          0.1 * torch.randn(c, generator=gen, device=dev))
                         for k in (3, 7, 11) for _ in range(6)], c, (3, 7, 11), (1, 3, 5), 0.1)
        t = (48 if fold == 1 else 192) * K2_FRAMES
        x = torch.randn(1, t, c, generator=gen, device=dev)
        for mode in ("int8", "bf16"):
            st = prepare_imcol_stage(sw, mode)
            err, peak, n_diff, n = k4_error(x, st)
            ms = time_ms(lambda: imcol_stage(x, st, fold), 3)
            log("shapes", f"k4 {mode} at C={c} fold={fold} B=1 T={t}: max_abs_err={err:.3e} "
                          f"(max|out| {peak:.3e}, {n_diff} of {n} elements differ) "
                          f"kernel_ms={ms:.3f} {k4_tiling(x, st)}")
            check_k4(f"C={c}", mode, err, peak, n_diff)
            if mode == "int8":
                row["max_abs_err"] = max(row["max_abs_err"], err)


def main_path_cases():
    """The syntheses of the main path: ``__call__`` on LONG_TEXT, the same
    with 8 frames per phone, and ``synthesize_batch(BATCH_TEXTS)``.  Each
    with its phone counts and bucket (the encoder's K1), its vocoder frames
    and mel lengths (the decoder's K1; the vocoder's stages run over scale x
    frames).  Seeded random weights predict 1 frame per phone."""
    fe = TextFrontend(language="en")
    n = len(fe.string_to_features(LONG_TEXT))
    batch = [len(fe.string_to_features(t)) for t in BATCH_TEXTS]
    bucket, b_bucket = _round_up(n, PHONE_BUCKET), _round_up(max(batch), PHONE_BUCKET)
    return [("call", [n], bucket, bucket * FRAMES_PER_PHONE, [n]),
            ("call, 8 frames per phone", [n], bucket, _round_up(8 * n + 2, 64), [8 * n]),
            ("synthesize_batch", batch, b_bucket, b_bucket * FRAMES_PER_PHONE, batch)]


def phase_shapes(dev, gen, vocoder, unit, rows):
    """K1, K2 (also on ``unit``, the stages at unit gain), K3 (int8, scales
    calibrated on the same input), K4 (int8, stages 1-3) and K5 against
    their plain versions at the shapes the main path gives them, then K4 at
    other generators' widths (``k4_widths``); each error folds into its
    kernel's row of ``rows``."""
    cfg = ToucanTTSConfig()
    h, d = cfg.aheads, cfg.adim // cfg.aheads
    for name, counts, bucket, frames, mel_lens in main_path_cases():
        b = len(counts)
        for t, lens in ((bucket, counts), (frames, mel_lens)):
            err, _ = k1_error(k1_inputs(gen, dev, b, h, d, t, lens))
            log("shapes", f"{name}: k1 B={b} H={h} T={t} d={d} lengths={lens} "
                          f"max_abs_err={err:.3e}")
            if not err <= TOL_K1:
                raise AssertionError(f"K1 disagrees with its plain version: {name}, T={t}")
            rows["k1"]["max_abs_err"] = max(rows["k1"]["max_abs_err"], err)
        for i, scale in enumerate(STAGE_SCALES):
            sw = vocoder.stage_weights(i)
            c, t = sw.channels, scale * frames
            x = torch.randn(b, t, c, generator=gen, device=dev)
            err2, excess = k2_error(x, sw)
            err2_u, excess_u = k2_error(x, unit[i])
            qs = quantize_stage(sw, "int8", calibrate_stage_scales(x, sw))
            err3, peak, n_diff, n = k3_error(x, qs)
            k3_tl = k3_tiling(x, qs)
            err4, peak4 = 0.0, 0.0
            if i in K4_STAGES:
                st4 = prepare_imcol_stage(sw, "int8")
                err4, peak4, n_diff4, _ = k4_error(x, st4)
                k4_tl = k4_tiling(x, st4)
                check_k4(f"{name}, stage {i}", "int8", err4, peak4, n_diff4)
            del x
            err5 = k5_error(*k5_inputs(gen, dev, b, t, c))
            log("shapes", f"{name}: stage {i} B={b} T={t} C={c} max_abs_err k2={err2:.3e} "
                          f"(excess {excess:.2e}; unit gain {err2_u:.3e}, "
                          f"excess {excess_u:.2e}) "
                          f"k3 int8={err3:.3e} (max|out| {peak:.3e}, {n_diff} of {n} differ; "
                          f"{k3_tl}) "
                          + (f"k4 int8={err4:.3e} (max|out| {peak4:.3e}, {n_diff4} differ; "
                             f"{k4_tl}) " if i in K4_STAGES else "") + f"k5={err5:.3e}")
            if not (excess <= TOL_K2[0] and excess_u <= TOL_K2[0]):
                raise AssertionError(f"K2 disagrees with its plain version: {name}, stage {i}")
            if not err3 <= TOL_K3["int8"] * peak:
                raise AssertionError(f"K3 disagrees with its plain version: {name}, stage {i}")
            if not err5 <= TOL_K5:
                raise AssertionError(f"K5 disagrees with its plain version: {name}, stage {i}")
            for k, err in (("k2", max(err2, err2_u)), ("k3", err3), ("k4", err4), ("k5", err5)):
                rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], err)
    k4_widths(dev, gen, rows["k4"])


def phase_widths(dev, gen, rows):
    """K1 at the head dims of K1_WIDTHS and K2 at the widths of K2_WIDTHS
    against their plain versions, timed; each error folds into its row."""
    h, t = 4, 2048
    for d in K1_WIDTHS:
        args = k1_inputs(gen, dev, 1, h, d, t, [t])
        err, _ = k1_error(args)
        ms = time_ms(lambda: flash_rel_attention(*args), 20)
        flops = 6 * h * d * t * t
        bound_ms, bound_by = bound(flops, 4 * (5 * h * t * d + h * (2 * t - 1) * d + 1),
                                   SPLIT_TF32_PEAK)
        built = d in BUILT_HEAD_DIMS
        log("shapes", f"k1 at d={d} ({'built' if built else 'padded'}): B=1 H={h} T={t} "
                      f"max_abs_err={err:.3e} kernel_ms={ms:.4f} bound_ms={bound_ms:.4f} "
                      f"({bound_by}, split TF32) achieved_tflops={flops / ms / 1e9:.2f}")
        if not err <= TOL_K1:
            raise AssertionError(f"K1 disagrees with its plain version at d={d}")
        rows["k1"]["max_abs_err"] = max(rows["k1"]["max_abs_err"], err)
    for c, channels, i in K2_WIDTHS:
        torch.manual_seed(SEED)
        sw = HiFiGANGenerator(channels=channels).to(dev).eval().stage_weights(i)
        if sw.channels != c:
            raise AssertionError(f"stage {i} of a {channels}-channel generator has "
                                 f"{sw.channels} channels, not {c}")
        unit = pack_stage([(torch.randn(c, c, k, generator=gen, device=dev) / math.sqrt(k * c),
                            0.1 * torch.randn(c, generator=gen, device=dev))
                           for k in sw.kernel_sizes for _ in range(6)],
                          c, sw.kernel_sizes, sw.dilations, sw.slope)
        t2 = STAGE_SCALES[i] * K2_FRAMES
        x = torch.randn(1, t2, c, generator=gen, device=dev)
        err, excess = k2_error(x, sw)
        err_u, excess_u = k2_error(x, unit)
        ms = time_ms(lambda: hifigan_stage(x, sw), 3)
        tl = tiling_for(x, sw)
        log("shapes", f"k2 at C={c} (stage {i} of a {channels}-channel generator; kernel width "
                      f"{kernel_channels(c)}): B=1 T={t2} max_abs_err={err:.3e} "
                      f"(excess {excess:.2e}; unit gain {err_u:.3e}, excess {excess_u:.2e}; "
                      f"tolerance {TOL_K2[0]} over the rtol share) kernel_ms={ms:.3f} "
                      f"tile={tl.tile} cluster={tl.cluster} channels_per_block={tl.block_channels} "
                      f"clusters={tl.clusters}")
        if not (excess <= TOL_K2[0] and excess_u <= TOL_K2[0]):
            raise AssertionError(f"K2 disagrees with its plain version at C={c}")
        rows["k2"]["max_abs_err"] = max(rows["k2"]["max_abs_err"], err, err_u)
        del x


def phase_other_models(dev):
    """Models of other widths on the card against the CPU: the generators
    of 1024 channels (stage 0 on K2 clusters of 8) and of 64 (stages of
    32 to 4 channels, widened) on 64 mel frames, and a ToucanTTS at adim
    384 with 4 heads (d = 96 on K1; 2 encoder, decoder and glow blocks)
    through the interface with the 64-channel generator (``phase_ref``)."""
    mel = torch.from_numpy(np.random.RandomState(SEED).randn(1, 64, 80).astype(np.float32))
    for channels in (1024, 64):
        torch.manual_seed(SEED)
        card = HiFiGANGenerator(channels=channels).eval()
        cpu = HiFiGANGenerator(channels=channels).eval()
        cpu.load_state_dict(card.state_dict())
        card.to(dev)
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        wave = card(mel.to(dev)).cpu()
        want = cpu(mel)
        err, peak = (wave - want).abs().max().item(), want.abs().max().item()
        log("ref", f"HiFiGANGenerator(channels={channels}) on 64 frames, card against CPU: "
                   f"max_abs_err={err:.3e} (peak {peak:.3e}, tolerance {TOL_WAVE}); "
                   f"k2_launches={hifigan_stage.launches}")
        if not (wave.shape == want.shape and err <= TOL_WAVE):
            raise AssertionError(f"the {channels}-channel generator disagrees with the CPU")
        if hifigan_stage.launches != 4:
            raise AssertionError(f"the {channels}-channel generator ran K2 "
                                 f"{hifigan_stage.launches} times, not 4")
    torch.manual_seed(SEED)
    cfg = ToucanTTSConfig(adim=384, aheads=4, enc_layers=2, dec_layers=2, glow_blocks=2)
    tts_sd = ToucanTTS(cfg).state_dict()
    voc_sd = HiFiGANGenerator(channels=64).state_dict()
    card = ToucanTTSInterface(tts_sd, voc_sd, config=cfg, vocoder=HiFiGANGenerator(channels=64),
                              seed=SEED)
    cpu = ToucanTTSInterface(tts_sd, voc_sd, config=cfg, vocoder=HiFiGANGenerator(channels=64),
                             device="cpu", seed=SEED)
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    phase_ref("adim 384, 4 heads (d = 96), 64-channel HiFiGAN", card, cpu, TOL_REF)
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    log("ref", f"adim 384: launches {counts}")
    if not (counts["k1"] and counts["k2"]):
        raise AssertionError("the adim-384 model did not run K1 and K2 on the card")


WRAPPERS = {"k1": flash_rel_attention, "k2": hifigan_stage, "k3": quantized_stage,
            "k4": imcol_stage, "k5": alias_free_snake,
            # the bf16 instantiations' launches, also counted in k1 and k5
            "k1_bf16": flash_rel_attention.bf16, "k5_bf16": alias_free_snake.bf16}


def phase_grad_refusal(dev, gen, vocoder):
    """Each wrapper on CUDA inputs that require grad, with grad enabled: the
    kernels have no backward, so each must raise ValueError before it
    launches, and no launch count may move."""
    sw = vocoder.stage_weights(len(STAGE_SCALES) - 1)
    c, t = sw.channels, 384
    x = torch.randn(1, t, c, generator=gen, device=dev)
    qs = quantize_stage(sw, "int8", calibrate_stage_scales(x, sw))
    st = prepare_imcol_stage(sw, "int8")
    k1 = k1_inputs(gen, dev, 1, 4, 48, 128, [100])
    x5, alpha, beta = k5_inputs(gen, dev, 1, t, c)
    cases = {"k1": lambda g: flash_rel_attention(g(k1[0]), *k1[1:]),
             "k2": lambda g: hifigan_stage(g(x), sw),
             "k3": lambda g: quantized_stage(g(x), qs),
             "k4": lambda g: imcol_stage(g(x), st, imcol_fold(c)),
             "k5": lambda g: alias_free_snake(x5, g(alpha), beta)}
    for name, call in cases.items():
        before = {k: w.launches for k, w in WRAPPERS.items()}
        with torch.enable_grad():
            try:
                call(lambda v: v.detach().clone().requires_grad_())
            except ValueError as e:
                msg = str(e)
            else:
                raise AssertionError(f"{name}: a grad-enabled call on an input that requires "
                                     "grad did not raise")
        after = {k: w.launches for k, w in WRAPPERS.items()}
        if after != before:
            raise AssertionError(f"{name}: launch counts moved from {before} to {after}")
        log("grad", f"{name}: ValueError before any launch ({msg}); launch counts unchanged")
    torch.cuda.synchronize()


def drive(name, fn, iface, per_call, launches, n=1, waves_of=lambda out: [out], frame=384,
          bucketed=True, warm=None):
    """One main-path run: every count to 0, drive, synchronize, read the
    counts.  ``per_call`` {kernel: launches of one synthesis}; the run makes
    ``n`` syntheses and one warm-up for each bucket of ``iface`` that it
    made (a bucket's first use, where ``precompile`` did not make it), and
    every other kernel must stay at 0.  ``warm``: the number of buckets the
    run must make (0 for a call after ``precompile`` or after its bucket's
    first use), None where it is a first use.  ``bucketed``: fn goes
    through the interface's buckets (not ``quantize_vocoder``'s
    calibration or ``set_utterance_embedding``, which run eagerly).  Adds
    the counts to ``launches`` and checks the waves."""
    before = {id(b) for b in buckets(iface)}
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = {k: w.launches for k, w in WRAPPERS.items()}
    for k, c in got.items():
        launches[k] += c
    warm, warm_want = sum(id(b) not in before for b in buckets(iface)), warm
    how = ("eager" if iface._eager or not bucketed else
           f"{warm} bucket(s) warmed up and captured, counted" if warm else "graph replays")
    waves = waves_of(out)
    audio = sum(len(w) for w in waves) / 24000
    log("main", f"{name}: latency_s={sec:.4f} audio_s={audio:.3f} "
                f"audio_s_per_s={audio / sec:.3f} ({how}) "
                + " ".join(f"{k}_launches={c}" for k, c in got.items()))
    if warm_want is not None and warm != warm_want:
        raise AssertionError(f"{name}: made {warm} bucket(s), expected {warm_want}")
    expect = per_synthesis(n + warm, **per_call)
    want = {k: expect.get(k, 0) for k in WRAPPERS}
    if got != want:
        raise AssertionError(f"{name}: expected launches {want}, got {got}")
    for w in waves:
        if not (len(w) > 0 and len(w) % frame == 0 and np.isfinite(w).all()):
            raise AssertionError(f"{name}: bad wave (len {len(w)})")
    return out


def buckets(iface):
    return [*iface._e2e_cache.values(), *iface._vocoder_cache.values()]


def per_synthesis(n, **kernels):
    return {k: v * n for k, v in kernels.items()}


def check_length(wave, dur, glow=True):
    """A glow drops an odd last frame; a glow-less model keeps it."""
    if len(wave) != (int(dur.sum()) // 2 * 2 if glow else int(dur.sum())) * 384:
        raise AssertionError(f"wave length {len(wave)} for durations summing to {dur.sum()}")


def phase_main(iface, launches, per_call, label):
    """``__call__`` (first, steady, profiled), explicit durations and
    ``synthesize_batch``; ``per_call`` the launches of one synthesis.
    Returns the steady call's wave."""
    n = len(iface.text2phone.string_to_features(LONG_TEXT))
    log("main", f"{label}: text of {n} phones -> bucket {-(-n // 32) * 32}, "
                f"{-(-n // 32) * 32 * 16} frames")
    for name, warm in (("call (first)", None), ("call", 0)):
        steady, dur, _, _ = drive(f"{label} {name}",
                                  lambda: iface(LONG_TEXT, return_duration_pitch_energy=True),
                                  iface, per_call, launches, waves_of=lambda out: out[:1],
                                  warm=warm)
        check_length(steady, dur, iface.config.use_postflow)
    profiled_call(iface, launches, per_call, label)
    wave, dur, _, _ = drive(f"{label} call, 8 frames per phone",
                            lambda: iface(LONG_TEXT, durations=np.full(n, 8),
                                          return_duration_pitch_energy=True),
                            iface, per_call, launches, waves_of=lambda out: out[:1])
    check_length(wave, dur, iface.config.use_postflow)
    log("main", f"{label} explicit durations: {len(wave) // 384} frames")
    drive(f"{label} synthesize_batch x4", lambda: iface.synthesize_batch(BATCH_TEXTS),
          iface, per_call, launches, waves_of=list)
    return steady


def profiled_call(iface, launches, per_call, label):
    """One steady ``__call__`` under the profiler; returns the device's
    idle share of it (None where the trace holds no device time)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(f"{label} call (profiled)", lambda: iface(LONG_TEXT), iface, per_call, launches,
              warm=0)
        wall_us = (time.perf_counter() - t0) * 1e6
    return report_profile(prof, wall_us, label)


def phase_main_hifigan(iface, launches):
    """Returns the steady call's wave."""
    wave = phase_main(iface, launches, dict(k1=12, k2=4), "hifigan")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.wav")
        # the file joins the waves with silences of 10600 samples
        drive("hifigan read_to_file x2", lambda: iface.read_to_file(BATCH_TEXTS[:2], path),
              iface, dict(k1=12, k2=4), launches, n=2, frame=1)
        log("main", f"read_to_file wrote {os.path.getsize(path)} bytes")
    return wave


def phase_main_int8(iface, launches):
    """quantize_vocoder on the card, then the int8 path; the int8 wave
    against the exact (K2) wave of the same call and noise."""
    n = len(iface.text2phone.string_to_features(LONG_TEXT))
    z = (0.8 * np.random.RandomState(SEED + 1).randn(-(-n // 32) * 32 * 16, 80)).astype(np.float32)
    exact = drive("int8 path: exact call, fixed noise", lambda: iface(LONG_TEXT, glow_noise=z),
                  iface, dict(k1=12, k2=4), launches)
    scales = drive("int8 path: quantize_vocoder (calibration pass)", iface.quantize_vocoder,
                   iface, dict(k1=12, k2=4), launches, waves_of=lambda out: [], bucketed=False)
    log("main", "int8 scales per stage (min..max): " + ", ".join(
        f"{i}: {v.min().item():.3e}..{v.max().item():.3e}" for i, v in scales.items()))
    wave = drive("int8 call, fixed noise", lambda: iface(LONG_TEXT, glow_noise=z),
                 iface, dict(k1=12, k3=4), launches)
    if wave.shape != exact.shape:
        raise AssertionError(f"int8 wave of {wave.shape} against exact {exact.shape}")
    err, peak = float(np.abs(wave - exact).max()), float(np.abs(exact).max())
    snr = 10 * np.log10((exact ** 2).mean() / max(((wave - exact) ** 2).mean(), 1e-30))
    log("main", f"int8 against exact wave: max_abs_err={err:.3e} "
                f"(bound {TOL_INT8_WAVE} x peak {peak:.3e}), SNR {snr:.1f} dB "
                f"(bound {INT8_SNR_DB} dB)")
    if not (peak > 0 and err <= TOL_INT8_WAVE * peak and snr > INT8_SNR_DB):
        raise AssertionError("the int8 wave is too far from the exact one")
    for name in ("int8 call", "int8 call (steady)"):
        drive(name, lambda: iface(LONG_TEXT), iface, dict(k1=12, k3=4), launches, warm=0)
    profiled_call(iface, launches, dict(k1=12, k3=4), "int8")
    drive("int8 synthesize_batch x4", lambda: iface.synthesize_batch(BATCH_TEXTS),
          iface, dict(k1=12, k3=4), launches, waves_of=list)
    return scales


def write_reference_files(tmp, tts_sd, voc_sd, gst_sd, default_emb):
    """The seeded weights as the reference release stores them: weight norm
    split on the Glow's WaveNet convs and on every vocoder conv."""
    paths = [os.path.join(tmp, name) for name in ("best.pt", "vocoder.pt", "embedding_function.pt")]
    torch.save({"model": split_weight_norm(tts_sd, GLOW_WEIGHT_NORM), "default_emb": default_emb},
               paths[0])
    torch.save({"generator": split_weight_norm(voc_sd, r".")}, paths[1])
    torch.save({"style_emb_func": gst_sd}, paths[2])
    return paths


def imcol_interface(paths, device=None):
    return interface_from_torch(*paths, vocoder_kind=HiFiGANGenerator(imcol_mode="int8"),
                                device=device, seed=SEED)


IMCOL_PER_CALL = dict(k1=12, k2=1, k4=3)


def phase_main_imcol(paths, ref_wave, launches):
    """Reference files -> interface with the int8 im2col vocoder -> the
    speaker from a 24 kHz wave -> the main path; the int8 wave against the
    exact (K2) wave of the same call and noise."""
    iface = imcol_interface(paths)
    for name in ("first", "steady"):
        drive(f"imcol set_utterance_embedding ({name}; 24 kHz wave, mel and GST on the card)",
              lambda: iface.set_utterance_embedding(wave=ref_wave, sr=24000), iface, {},
              launches, waves_of=lambda out: [], bucketed=False)
    emb = iface.default_utterance_embedding
    log("main", f"imcol: embedding of a {len(ref_wave) / 24000:.3f} s wave, shape {emb.shape}, "
                f"norm {np.linalg.norm(emb):.4f}")
    phase_main(iface, launches, IMCOL_PER_CALL, "imcol")
    n = len(iface.text2phone.string_to_features(LONG_TEXT))
    z = (0.8 * np.random.RandomState(SEED + 1).randn(-(-n // 32) * 32 * 16, 80)).astype(np.float32)
    iface.vocoder.imcol_mode = None
    iface._clear_caches()  # a graph keeps the vocoder's mode of its capture
    exact = drive("imcol path: exact call (imcol_mode None), fixed noise",
                  lambda: iface(LONG_TEXT, glow_noise=z), iface, dict(k1=12, k2=4), launches)
    iface.vocoder.imcol_mode = "int8"
    iface._clear_caches()
    wave = drive("imcol int8 call, fixed noise", lambda: iface(LONG_TEXT, glow_noise=z),
                 iface, IMCOL_PER_CALL, launches)
    if wave.shape != exact.shape:
        raise AssertionError(f"imcol wave of {wave.shape} against exact {exact.shape}")
    err, peak = float(np.abs(wave - exact).max()), float(np.abs(exact).max())
    snr = 10 * np.log10((exact ** 2).mean() / max(((wave - exact) ** 2).mean(), 1e-30))
    log("main", f"imcol int8 against exact wave: max_abs_err={err:.3e} "
                f"(bound {TOL_INT8_WAVE} x peak {peak:.3e}), SNR {snr:.1f} dB "
                f"(bound {INT8_SNR_DB} dB)")
    if not (peak > 0 and err <= TOL_INT8_WAVE * peak and snr > INT8_SNR_DB):
        raise AssertionError("the imcol int8 wave is too far from the exact one")
    return iface


def eager_mode(iface, eager):
    iface._eager = eager
    return iface


def read_sequential(iface, texts, path):
    """``read_to_file`` as it was before dispatch-ahead: each sentence
    fetched before the next is enqueued."""
    silence = np.zeros(SENTENCE_JOIN_SILENCE, np.float32)
    pieces = [silence]
    for text in texts:
        pieces += [iface(text), silence]
    write_wav(path, np.concatenate(pieces), 24000)


def in_turns(runs, order, rounds):
    """{name: [seconds, ...]}: each of ``runs`` ({name: fn}) timed on the
    host clock to a synchronize, in ``order`` (a, b, b, a, ...), ``rounds``
    times."""
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return times


def steady(iface, fn):
    """fn(), which must make no bucket: each of its calls replays a graph."""
    before = {id(b) for b in buckets(iface)}
    out = fn()
    if {id(b) for b in buckets(iface)} != before:
        raise AssertionError("a steady run made a new bucket")
    return out


def churn_position_tables(lengths, d_model, dtype):
    """Drop every cached position table, hand the allocator's free memory
    back to CUDA, and make, for each of ``lengths``, 40 tables of 1
    to 40 positions fewer: each a little smaller than a table that a graph
    reads, so that it fits in the memory such a table would leave free,
    with other values.  Fails unless the tables of ``lengths``, which a
    graph reads, outlive their cache.  Returns the new tables, to keep them
    in place across the next replay."""
    device = torch.device("cuda", torch.cuda.current_device())
    read = [weakref.ref(positional._cached_table(length, d_model, device, dtype))
            for length in lengths]
    positional._cached_table.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    if any(ref() is None for ref in read):
        raise AssertionError("a position table that a graph reads was freed with its cache")
    others = [positional.relative_position_encoding(length - k, d_model, device)
              for length in lengths for k in range(1, 41)]
    torch.cuda.synchronize()
    return others


def phase_graphs(iface, per_call, label, launches):
    """The CUDA-graph path against the eager one on one interface:
    ``precompile`` (each bucket's warm-up and capture time and the memory
    its capture added to the interface's one pool), the graph call's
    durations and wave against the eager call's on the same noise, and
    again after the position-table cache was churned, launch counts through
    replays, ``_vocode`` through its bucket against eager, the steady
    ``__call__`` eager against graph in turns, the graph call's profiled
    idle share, and ``read_to_file`` of two sentences, dispatch-ahead
    against one sentence at a time, in turns.  Every call after
    ``precompile`` replays a graph made before it, but ``_vocode``'s first."""
    texts = BATCH_TEXTS[:2]
    n = len(iface.text2phone.string_to_features(LONG_TEXT))
    phone_buckets = sorted({PHONE_BUCKET, 4 * PHONE_BUCKET, _round_up(n, PHONE_BUCKET)}
                           | {_round_up(len(iface.text2phone.string_to_features(t)),
                                        PHONE_BUCKET) for t in texts})
    iface._clear_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    iface.precompile(phone_buckets=phone_buckets)
    for key, bucket in iface._e2e_cache.items():
        log("graphs", f"{label}: precompile bucket (B, phones, frames, durations, pitch, "
                      f"energy) = {key}: warm-up and capture {bucket.capture_s * 1e3:.1f} ms, "
                      f"its capture added {bucket.reserved_bytes / 2 ** 20:.1f} MiB to the pool")
    log("graphs", f"{label}: precompile of phone buckets {phone_buckets}: the interface's graphs "
                  f"hold {(torch.cuda.memory_reserved() - reserved) / 2 ** 20:.1f} MiB "
                  f"in all (one pool)")
    z = (0.8 * np.random.RandomState(SEED + 3).randn(-(-n // 32) * 32 * 16, 80)).astype(np.float32)

    def fixed_noise_call():
        return iface(LONG_TEXT, glow_noise=z, return_duration_pitch_energy=True)

    def check_equal(graph, eager, what):
        same = all(np.array_equal(g, e) for g, e in zip(graph[1:], eager[1:]))
        err = (float(np.abs(graph[0] - eager[0]).max()) if graph[0].shape == eager[0].shape
               else float("inf"))
        log("graphs", f"{label}: {what} against eager on the same noise: durations, pitch and "
                      f"energy {'equal' if same else 'DIFFER'}, wave max_abs_err={err:.3e} "
                      f"(tolerance {TOL_GRAPH})")
        if not (same and err <= TOL_GRAPH):
            raise AssertionError(f"{label}: the {what} disagrees with the eager call")
    graph = drive(f"{label} graph call, fixed noise (precompiled)", fixed_noise_call, iface,
                  per_call, launches, waves_of=lambda out: out[:1], warm=0)
    eager = drive(f"{label} eager call, fixed noise", fixed_noise_call,
                  eager_mode(iface, True), per_call, launches, waves_of=lambda out: out[:1],
                  warm=0)
    eager_mode(iface, False)
    check_equal(graph, eager, "graph call")
    n_pad = _round_up(n, PHONE_BUCKET)
    others = churn_position_tables((n_pad, n_pad * FRAMES_PER_PHONE), iface.config.adim,
                                   iface.config.dtype)
    again = drive(f"{label} graph call, fixed noise, after the position tables were dropped "
                  f"from their cache and {len(others)} others made", fixed_noise_call, iface,
                  per_call, launches, waves_of=lambda out: out[:1], warm=0)
    del others
    check_equal(again, eager, "graph call after the table cache was churned")
    (_, after, *_, lens), _ = iface._dispatch_call(LONG_TEXT, glow_noise=z)
    mel = after[0, :int(lens[0])].cpu().numpy()
    per_vocoder = {k: c for k, c in per_call.items() if k != "k1"}
    for name, warm in (("first", 1), ("steady", 0)):
        wave = drive(f"{label} _vocode of the call's mel ({name})", lambda: iface._vocode(mel),
                     iface, per_vocoder, launches, warm=warm)
    want = drive(f"{label} _vocode, eager", lambda: iface._vocode(mel), eager_mode(iface, True),
                 per_vocoder, launches, warm=0)
    eager_mode(iface, False)
    err = float(np.abs(wave - want).max()) if wave.shape == want.shape else float("inf")
    log("graphs", f"{label}: _vocode graph against eager: max_abs_err={err:.3e} "
                  f"(tolerance {TOL_GRAPH})")
    if not err <= TOL_GRAPH:
        raise AssertionError(f"{label}: _vocode's graph disagrees with its eager run")
    times = steady(iface, lambda: in_turns(
        {"eager": lambda: eager_mode(iface, True)(LONG_TEXT),
         "graph": lambda: eager_mode(iface, False)(LONG_TEXT)},
        ("eager", "graph", "graph", "eager"), GRAPH_ROUNDS))
    eager_mode(iface, False)
    log("graphs", f"{label}: steady __call__ in turns (eager, graph, graph, eager) x "
                  f"{GRAPH_ROUNDS}: " + "; ".join(
                      f"{k} median {1e3 * np.median(v):.2f} ms ("
                      + ", ".join(f"{1e3 * t:.2f}" for t in v) + ")" for k, v in times.items()))
    bucket = iface._e2e_cache[(1, _round_up(n, PHONE_BUCKET),
                               _round_up(n, PHONE_BUCKET) * FRAMES_PER_PHONE, False, False, False)]
    replay_ms, call_ms = time_ms(bucket.graph.replay, 5), 1e3 * np.median(times["graph"])
    log("graphs", f"{label}: the bucket's graph replayed alone takes {replay_ms:.2f} ms of device "
                  f"time (CUDA events): the device is idle {100 * (1 - replay_ms / call_ms):.1f}% "
                  f"of the median graph call ({call_ms:.2f} ms)")
    profiled_call(iface, launches, per_call, f"{label} graph")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.wav")
        drive(f"{label} read_to_file x2 (dispatch-ahead)",
              lambda: iface.read_to_file(texts, path), iface, per_call, launches, n=2, frame=1,
              warm=0)
        times = steady(iface, lambda: in_turns(
            {"sequential": lambda: read_sequential(iface, texts, path),
             "dispatch-ahead": lambda: iface.read_to_file(texts, path)},
            ("sequential", "dispatch-ahead", "dispatch-ahead", "sequential"), GRAPH_ROUNDS))
    log("graphs", f"{label}: read_to_file of 2 sentences in turns x {GRAPH_ROUNDS}: " + "; ".join(
        f"{k} median {1e3 * np.median(v):.2f} ms (" + ", ".join(f"{1e3 * t:.2f}" for t in v) + ")"
        for k, v in times.items()))


def report_profile(prof, wall_us, label, what="one __call__"):
    """Device time by kernel and the device's busy share of ``what``."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log("profile", "no device time in the trace: device breakdown not measured")
        return None
    log("profile", f"{label}, {what}: wall {wall_us / 1e3:.2f} ms, "
                   f"device busy {busy / 1e3:.2f} ms "
                   f"({100 * busy / wall_us:.1f}%), idle {100 - 100 * busy / wall_us:.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        name = e.key
        for short in ("flash_rel_kernel", "stage_q_kernel", "imcol_kernel", "stage_kernel",
                      "alias_free_snake_kernel"):
            if short in name:
                name = f"{short} (port kernel)"
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {name[:90]}")
    return 1 - busy / wall_us


def phase_ref(label, iface, cpu, tol_wave, relative=False, mel_scale=False):
    """The card against the CPU (plain versions) on the same weights and
    noise; ``relative``: the wave's tolerance is a share of its peak;
    ``mel_scale``: the mel's is TOL_REF times the mel's peak where that
    passes 1 (f32 sums in other orders err in proportion to the values)."""
    text = "Hello world, this is a test."
    feats = iface.text2phone.string_to_features(text)
    n = len(feats)
    rng = np.random.RandomState(SEED)
    x = np.zeros((1, 32, feats.shape[1]), np.float32)
    x[0, :n] = feats
    noise = (0.8 * rng.randn(1, 512, 80)).astype(np.float32)
    utt = rng.randn(1, 64).astype(np.float32)
    outs = {}
    for name, it in (("cuda", iface), ("cpu", cpu)):
        d = it.device
        with torch.inference_mode():
            res = it.model.infer(torch.tensor(x, device=d), torch.tensor([n], device=d), 512,
                                 utterance_embedding=torch.tensor(utt, device=d),
                                 lang_ids=torch.tensor([[it.lang_id]], device=d),
                                 glow_noise=torch.tensor(noise, device=d))
        outs[name] = [r.cpu().numpy() for r in res]
    if not np.array_equal(outs["cuda"][2], outs["cpu"][2]):
        raise AssertionError(f"{label}: predicted durations differ between the card and the CPU")
    # the mel before the PostNet and glow too: seeded weights start the
    # glow's coupling ``end`` convs at zero, so the mel after it follows the
    # noise alone
    mel_err = max(np.abs(outs["cuda"][i] - outs["cpu"][i]).max() for i in (0, 1))
    tol_mel = TOL_REF * (max(1.0, np.abs(outs["cpu"][1]).max()) if mel_scale else 1.0)
    z = noise[0, :64]
    w_cuda = iface(text, durations=np.full(n, 2), glow_noise=z)
    w_cpu = cpu(text, durations=np.full(n, 2), glow_noise=z)
    wave_err = np.abs(w_cuda - w_cpu).max() if w_cuda.shape == w_cpu.shape else float("inf")
    peak = float(np.abs(w_cpu).max())
    if relative:
        tol_wave *= peak
    log("ref", f"{label}, {n} phones: durations equal, mel max_abs_err={mel_err:.3e}, "
               f"wave ({len(w_cuda)} samples, peak {peak:.3e}) "
               f"max_abs_err={wave_err:.3e}, tolerance {tol_mel:.3e} (mel), {tol_wave:.3e} (wave)")
    if not (peak > 0 and mel_err <= tol_mel and wave_err <= tol_wave):
        raise AssertionError(f"{label}: the card disagrees with the CPU reference")


def phase_tf32_default(iface):
    """``check_tf32_default`` on the HiFiGAN interface's dispatch of a
    sentence: its durations and its mel, each run captured anew."""
    text = "Hello world, this is a test."
    z = (0.8 * np.random.RandomState(SEED).randn(512, 80)).astype(np.float32)

    def call():
        (_, after, dur, *_), _ = iface._dispatch_call(text, glow_noise=z)
        return np.concatenate([dur.cpu().numpy().ravel().astype(np.float32),
                               after.cpu().numpy().ravel()])
    check_tf32_default("hifigan __call__ (durations and mel)", call, iface._clear_caches)


def check_tf32_default(label, fn, reset=lambda: None):
    """fn(), an entry point's output, with the caller's cudnn.allow_tf32
    off and then on, as PyTorch's default has it: the entry points pin f32
    (a graph is captured inside ``f32_precision``; ``reset`` drops the
    interface's graphs before each run, so that each run captures its own
    under the caller's flags), so the two agree within TOL_TF32_DEFAULT (a
    wave of another length, from other durations, fails), and the caller's
    flags are as it set them."""
    outs = []
    try:
        for allow in (False, True):
            torch.backends.cudnn.allow_tf32 = allow
            reset()
            outs.append(np.asarray(fn()))
            flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            if flags != (allow, False):
                raise AssertionError(f"{label} left the TF32 flags at {flags}")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    a, b = outs
    err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    log("ref", f"{label} with cudnn.allow_tf32=True set by the caller against TF32 off: "
               f"max_abs_err={err:.3e} (tolerance {TOL_TF32_DEFAULT}); caller's flags unchanged")
    if not err <= TOL_TF32_DEFAULT:
        raise AssertionError(f"{label} depends on the caller's TF32 setting")


# ---------------------------------------------------------- serving (PR 11)

BF16_HIFIGAN = dict(k1=12, k1_bf16=12, k3=4)
BF16_BIGVGAN = dict(k1=12, k1_bf16=12, k5=K5_LAUNCHES, k5_bf16=K5_LAUNCHES)
# bf16 against f32, and the bf16 card against the bf16 CPU, on the same
# input with durations given: each within BF16_FACTOR x the port's own
# bf16-against-f32 distance on the CPU (the rule the CPU tests hold the
# port's bf16 path to against JAX's)
BF16_FACTOR = 2.0
# "default" (TF32 in cuDNN and cuBLAS) against "float32" on one input with
# durations given: TF32 keeps 10 mantissa bits, and the differences pass
# through 12 conformer blocks, 18 glow blocks and the vocoder's upsamplers
TOL_TF32_MEL = 5e-2
TOL_RESAMPLE = 2e-6    # native against numpy: float32 rounding (tests/test_native_resample.py)
REF_TEXT = "Hello world, this is a test."


def fixed_outputs(it):
    """{name: numpy f32} of REF_TEXT at 2 frames a phone on fixed noise and a
    fixed speaker: from ``ToucanTTS.infer`` under the interface's policy the
    decoder's mel (``before``, before the PostNet and glow), the mel after
    the glow, and the predicted pitch and energy; from ``_dispatch_call`` the
    wave.  Seeded weights start the glow's coupling ``end`` convs at zero,
    so the glow maps its noise alone and the mel after it does not show the
    decoder; ``before`` does."""
    feats = it.text2phone.string_to_features(REF_TEXT)
    n = len(feats)
    rng = np.random.RandomState(SEED)
    x = np.zeros((1, 32, feats.shape[1]), np.float32)
    x[0, :n] = feats
    noise = (0.8 * rng.randn(1, 512, 80)).astype(np.float32)
    utt = rng.randn(1, 64).astype(np.float32)
    dur = np.zeros((1, 32), np.int32)
    dur[0, :n] = 2
    d = it.device
    with torch.inference_mode(), matmul_precision(it.matmul_precision):
        before, after, _, pitch, energy, lens = it.model.infer(
            torch.tensor(x, device=d), torch.tensor([n], device=d), 512,
            utterance_embedding=torch.tensor(utt, device=d),
            lang_ids=torch.tensor([[it.lang_id]], device=d),
            gold_durations=torch.tensor(dur, device=d), glow_noise=torch.tensor(noise, device=d))
    length = int(lens[0])
    (wave, *_, wave_lens), _ = it._dispatch_call(REF_TEXT, durations=np.full(n, 2),
                                                 glow_noise=noise[0, :64])
    out = dict(before=before[0, :length], mel=after[0, :length], pitch=pitch[0, :n],
               energy=energy[0, :n], wave=wave[0, :int(wave_lens[0]) * 384])
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def compare_bf16(label, card16, card32, cpu16, cpu32):
    """The bf16 card against the f32 card and against the bf16 CPU, each
    within BF16_FACTOR x the CPU's own bf16-against-f32 distance, for each
    of ``fixed_outputs``."""
    outs = {name: fixed_outputs(it) for name, it in (("card16", card16), ("card32", card32),
                                                      ("cpu16", cpu16), ("cpu32", cpu32))}
    msg = []
    for what in outs["cpu32"]:
        dist = lambda a, b: float(np.abs(outs[a][what] - outs[b][what]).max())
        spread = dist("cpu16", "cpu32")
        pairs = [("card bf16 - card f32", dist("card16", "card32")),
                 ("card bf16 - CPU bf16", dist("card16", "cpu16"))]
        msg.append(f"{what}: CPU bf16 - CPU f32 {spread:.3e}; " + ", ".join(
            f"{k} {v:.3e} ({v / spread:.3f} of it)" for k, v in pairs))
        if not (spread > 0 and all(v <= BF16_FACTOR * spread for _, v in pairs)):
            raise AssertionError(f"{label}: bf16 out of {BF16_FACTOR} x the CPU's bf16-against-"
                                 f"f32 distance: {msg[-1]}")
    log("bf16", f"{label}, {REF_TEXT!r} at 2 frames a phone, fixed noise, "
                f"tolerance {BF16_FACTOR} x the CPU's distance: " + "; ".join(msg))


def replay_ms(bucket):
    """Device ms of one replay of a bucket's graph (CUDA events)."""
    return time_ms(bucket.graph.replay, 5)


def graph_calls_in_turns(phase, label, runs):
    """The steady graph ``__call__`` of each of ``runs`` ({name: interface},
    every bucket made) on LONG_TEXT in turns (a, b, b, a) x GRAPH_ROUNDS,
    and each bucket's graph replayed alone by CUDA events."""
    names = list(runs)
    n = len(next(iter(runs.values())).text2phone.string_to_features(LONG_TEXT))
    key = (1, _round_up(n, PHONE_BUCKET), _round_up(n, PHONE_BUCKET) * FRAMES_PER_PHONE,
           False, False, False)
    for it in runs.values():
        it(LONG_TEXT)  # the bucket, made here where an earlier phase dropped it
    times = in_turns({k: (lambda it=it: steady(it, lambda: it(LONG_TEXT))) for k, it in
                      runs.items()}, names + names[::-1], GRAPH_ROUNDS)
    replay = {k: replay_ms(it._e2e_cache[key]) for k, it in runs.items()}
    log(phase, f"{label}: steady graph __call__ in turns ({', '.join(names + names[::-1])}) "
               f"x {GRAPH_ROUNDS}: " + "; ".join(
                   f"{k} median {1e3 * np.median(v):.2f} ms ("
                   + ", ".join(f"{1e3 * t:.2f}" for t in v) + f"), replay alone "
                   f"{replay[k]:.2f} ms" for k, v in times.items()))


def phase_main_bf16(label, card32, cpu32, vocoder, tts_sd, voc_sd, per_call, launches, card):
    """The full-width interface with ``dtype=torch.bfloat16`` (``vocoder``
    named by string, so it is bf16 too): the main path with its launches
    counted (K1's bf16 instantiation; K3 bf16 stages or K5 bf16), the bf16
    card against the f32 card and the bf16 CPU (``compare_bf16``), and the
    steady graph call in turns with the f32 interface ``card32``."""
    t0 = time.perf_counter()
    b16 = ToucanTTSInterface(tts_sd, voc_sd, vocoder=vocoder, seed=SEED, dtype=torch.bfloat16)
    phase_main(b16, launches, per_call, label)
    cpu16 = ToucanTTSInterface(tts_sd, voc_sd, vocoder=vocoder, seed=SEED, device="cpu",
                               dtype=torch.bfloat16)
    compare_bf16(label, b16, card32, cpu16, cpu32)
    graph_calls_in_turns("bf16", label, {"f32": card32, "bf16": b16})
    log("bf16", f"{label}: phase wall time {time.perf_counter() - t0:.1f} s ({card})")
    return b16


def phase_precision(tts_sd, voc_sd, card32, launches, card):
    """``matmul_precision="default"`` (TF32 in cuDNN and cuBLAS) against the
    f32 interface ``card32``: the main call's launches (the kernels keep
    their arithmetic: K1 12 + K2 4), the mel of one input with durations
    given, the steady graph call in turns, and the caller's flags as they
    were."""
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    tf32 = ToucanTTSInterface(tts_sd, voc_sd, seed=SEED, matmul_precision="default")
    for name, warm in (("call (first)", None), ("call", 0)):
        drive(f"default policy {name}", lambda: tf32(LONG_TEXT), tf32, dict(k1=12, k2=4),
              launches, warm=warm)
    got, want = fixed_outputs(tf32), fixed_outputs(card32)
    err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    log("precision", f"'default' against 'float32', {REF_TEXT!r} at 2 frames a phone: "
                     + ", ".join(f"{k} max_abs_err={v:.3e} (peak {np.abs(want[k]).max():.3e})"
                                 for k, v in err.items())
                     + f"; tolerance {TOL_TF32_MEL} (decoder's mel and mel); the caller's "
                     f"flags {flags} -> {after}")
    if not (max(err["before"], err["mel"]) <= TOL_TF32_MEL and after == flags):
        raise AssertionError("the 'default' policy's mel is too far from 'float32', or the "
                             "caller's flags moved")
    graph_calls_in_turns("precision", "hifigan", {"float32": card32, "default": tf32})
    log("precision", f"phase wall time {time.perf_counter() - t0:.1f} s ({card})")


def phase_fastspeech2(launches, card):
    """A full-width ``fastspeech2_config()`` (adim 384, 4 heads: K1 at
    d = 96; no glow; unconditional predictors) written as reference-format
    ``.pt`` files with a 512-channel HiFiGAN and a GST, read back by
    ``load.interface_from_torch`` (the sniffed config checked), the main
    path with its launches counted (K1 12 + K2 4), and the card against the
    CPU (``phase_ref``)."""
    t0 = time.perf_counter()
    torch.manual_seed(SEED + 7)
    cfg = fastspeech2_config()
    tts_sd = ToucanTTS(cfg).state_dict()
    voc_sd = HiFiGANGenerator().state_dict()
    gst_sd = StyleEmbedding().state_dict()
    emb = torch.from_numpy(np.random.RandomState(SEED + 8).randn(64).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_reference_files(tmp, tts_sd, voc_sd, gst_sd, emb)
        fs2 = interface_from_torch(*paths, seed=SEED)
        cpu = interface_from_torch(*paths, seed=SEED, device="cpu")
    if fs2.config != cfg:
        raise AssertionError(f"the FastSpeech2 checkpoint was sniffed as {fs2.config}")
    log("fastspeech2", f"reference files sniffed as adim {cfg.adim}, {cfg.aheads} heads "
                       f"(d = {cfg.adim // cfg.aheads}), use_postflow={cfg.use_postflow}, "
                       f"conditional_predictors={cfg.conditional_predictors}")
    phase_main(fs2, launches, dict(k1=12, k2=4), "fastspeech2")
    # without a glow the mel is the PostNet's, which reaches |26| on these
    # seeded weights: its tolerance scales with its peak
    phase_ref("fastspeech2 (d = 96, no glow)", fs2, cpu, TOL_REF, mel_scale=True)
    log("fastspeech2", f"phase wall time {time.perf_counter() - t0:.1f} s ({card})")


def check_native_resample(ref, card):
    """The native resampler against the numpy path on the clone reference
    (24 -> 16 kHz), equal within float32 rounding, each timed on the host
    in turns."""
    before = dict(native.resample_calls)
    got = native.resample(ref, 24000, 16000)
    if native.resample_calls["native"] != before["native"] + 1:
        raise AssertionError(f"the resampler did not take the native path: "
                             f"{native.resample_calls}")
    want = audio.resample_numpy(ref, 24000, 16000)
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    times = in_turns({"native": lambda: native.resample(ref, 24000, 16000),
                      "numpy": lambda: audio.resample_numpy(ref, 24000, 16000)},
                     ("native", "numpy", "numpy", "native"), GRAPH_ROUNDS)
    log("clone", f"resampler on the {len(ref) / 24000:.3f} s reference, 24 -> 16 kHz, host "
                 f"clock in turns ({card}): " + "; ".join(
                     f"{k} median {1e3 * np.median(v):.2f} ms" for k, v in times.items())
        + f"; max_abs_err={err:.3e} (tolerance {TOL_RESAMPLE})")
    if not err <= TOL_RESAMPLE:
        raise AssertionError("the native resampler disagrees with the numpy path")


CLONE_FRAMES_PER_PHONE = 5  # the reference recording: LONG_TEXT at 5 frames a phone, 24 kHz
# card against CPU in the cloning phase: pitch and energy are token
# averages normalized to a nonzero mean of 1 (the energy's STFT runs on each
# device; F0 is the same host code on both); the aligner's logits on equal
# weights run cuDNN's convs and LSTM against the CPU's in other orders
TOL_PROSODY = 1e-4
TOL_ALIGNER_LOGITS = 1e-4
# the fine-tune (5 SGD steps) in float64, card against CPU: in float32 the
# two runs can part at a ReLU input near zero, which BatchNorm over
# near-dead channels magnifies (tests/test_torch_clone.py::fine_tuned)
TOL_FINE_TUNE_F64 = 1e-5
# the reference's mel, card against CPU, in power relative to its peak:
# float32 rounding of a 1024-point STFT, bounded by n_fft * 2**-24 = 6.1e-5
# of the frame's energy (the log10 that the aligner reads magnifies it in
# the quietest bins, by up to ~0.2)
TOL_MEL_POWER = 1e-4
# a path's score (a float64 sum of ~450 terms of order 1) in two orders:
# the pathfinding's and ``path_score``'s
TOL_PATH_SUM = 1e-9
# modify_embed, card against CPU on the same bank and basis
TOL_GAN = 1e-5
GAN_SLIDERS = ([0.0] * 6, [3.0, 0, 0, 0, 0, 0], [0.5, -1.0, 2.0, 0.0, -0.3, 1.5])


def timed(fn):
    """(fn(), host seconds to a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def seeded_aligner_state(seed):
    """A full-size aligner's state dict (PyTorch's init, seeded), with
    BatchNorm statistics and affine terms away from their init values."""
    torch.manual_seed(seed)
    aligner = Aligner()
    with torch.no_grad():
        for name, t in aligner.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn_like(t))
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5)
            elif ".bnorm." in name and t.dim() == 1 and t.is_floating_point():
                t.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * torch.randn_like(t))
    return aligner.state_dict()


def fine_tune_f64(cloner, mel, ids):
    """The cloner's 5-step fine-tune of a float64 copy of its aligner, on
    ``mel`` (T, 80); the tuned aligner's logits (T, 145) on the host."""
    cl = copy.copy(cloner)
    cl.aligner = copy.deepcopy(cloner.aligner).double()
    mel = mel.double().to(cloner.device)
    return cl.logits(cl._fine_tune_aligner(mel, ids), mel)


def check_alignments(method, preds, aligns):
    """The card's alignment against the CPU's, each from its own logits
    (``preds``: the transcript's token columns): equal, or a near-tie that
    the two sides' logits explain.  Where the paths part, each must score
    at least as high as the other under its own side's logits (each
    pathfinding found its optimum), and its lead there (the decision's
    margin) can be no more than the two sides' logits move the two paths'
    scores.  Returns a line that says which it was."""
    if np.array_equal(aligns[0], aligns[1]):
        return "paths equal"
    score = [[path_score(p, a, method) for a in aligns] for p in preds]
    margins = (score[0][0] - score[0][1], score[1][1] - score[1][0])
    moved = abs(score[0][0] - score[1][0]) + abs(score[0][1] - score[1][1])
    cols = [a.argmax(1) for a in aligns]
    line = (f"paths part on {int((cols[0] != cols[1]).sum())} of {len(cols[0])} frames: a "
            f"near-tie, the margin of the card's path under its logits {margins[0]:.3e}, of "
            f"the CPU's under its own {margins[1]:.3e}, against {moved:.3e} that the logits' "
            f"difference moves the two paths' scores")
    if not all(-TOL_PATH_SUM <= m <= moved + TOL_PATH_SUM for m in margins):
        raise AssertionError(f"{method}: the alignments part by more than a near-tie: {line}")
    return line


def phase_clone(iface, cpu, launches, card):
    """Prosody cloning at full width (``Aligner()``: conv 512, BiLSTM 512,
    145 classes; seeded weights) on the HiFiGAN interface: ``clone_utterance``
    (5-step fine-tune, MAS) with its launches counted, ``extract_prosody``
    with MAS and with dijkstra, each part on the host clock, and the card
    against the CPU: the fine-tune in float64; on the same (the card's
    fine-tuned) aligner the logits, the alignments (equal in float64; in
    float32 equal or a near-tie, ``check_alignments``), and pitch and energy
    on the card's path; and the synthesis of the cloned prosody on the same
    noise."""
    n = len(iface.text2phone.string_to_features(LONG_TEXT))
    ref = iface(LONG_TEXT, durations=np.full(n, CLONE_FRAMES_PER_PHONE))
    aligner_sd = seeded_aligner_state(SEED + 4)
    cloner, cpu_cloner = UtteranceCloner(iface, aligner_sd), UtteranceCloner(cpu, aligner_sd)
    log("clone", f"reference: {len(ref) / 24000:.3f} s at 24 kHz ({n} phones at "
                 f"{CLONE_FRAMES_PER_PHONE} frames each); transcript of {n} phones")
    calls = dict(native.f0_calls)

    def clone(name, warm):
        return drive(f"clone_utterance ({name}; 5-step fine-tune on the card, MAS)",
                     lambda: cloner.clone_utterance(ref, LONG_TEXT, sr=24000), iface,
                     dict(k1=12, k2=4), launches, frame=1, warm=warm)
    clone("first", None)
    wave = clone("steady", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, sec = timed(lambda: clone("steady, profiled", 0))
    report_profile(prof, sec * 1e6, "clone", "one steady clone_utterance")
    for method in ("MAS", "dijkstra"):
        dur, *_ = drive(f"extract_prosody ({method}, 5-step fine-tune on the card)",
                        lambda: cloner.extract_prosody(LONG_TEXT, ref, sr=24000,
                                                       pathfinding=method),
                        iface, {}, launches, waves_of=lambda out: [], bucketed=False)
        log("clone", f"extract_prosody ({method}): {len(dur)} phones, {int(dur.sum())} frames, "
                     f"{int((dur > 0).sum())} phones with frames")
    ran = {k: native.f0_calls[k] - calls[k] for k in calls}
    log("clone", f"F0 path taken: {ran} (native: toucan_tpu_torch/native/f0.cpp through g++)")
    if not (ran["native"] > 0 and ran["numpy"] == 0):
        raise AssertionError(f"the F0 tracker did not take the native path: {ran}")

    # each part of extract_prosody and the synthesis on the host clock
    parts = {}
    r, parts["audio front end (loudness, resample, trim, G2P, mel)"] = timed(
        lambda: cloner.prepare(LONG_TEXT, ref, sr=24000))
    logits, parts["aligner forward"] = timed(lambda: cloner.logits(cloner.aligner, r.mel))
    tuned, parts["5 fine-tune steps"] = timed(lambda: cloner._fine_tune_aligner(r.mel,
                                                                              r.token_ids))
    logits, _ = timed(lambda: cloner.logits(tuned, r.mel))
    alignment, parts["MAS"] = timed(lambda: alignment_from_logits(logits, r.token_ids))
    _, parts["F0 (native)"] = timed(lambda: native.estimate_f0(r.wave))
    _, parts["energy (STFT on the card)"] = timed(
        lambda: compute_frame_energy(r.wave, device=iface.device))
    dur, pitch, energy, *_ = cloner.extract_prosody(LONG_TEXT, ref, sr=24000,
                                                    on_line_fine_tune=False)
    _, parts["synthesis (cloned durations, pitch, energy)"] = timed(
        lambda: iface(LONG_TEXT, durations=dur, pitch=pitch, energy=energy))
    log("clone", f"{len(r.mel)} mel frames, {len(r.token_ids)} CTC labels; parts, host clock "
                 f"({card}): " + "; ".join(f"{k} {1e3 * v:.2f} ms" for k, v in parts.items()))
    check_native_resample(ref, card)

    # card against CPU
    rng = np.random.RandomState(SEED + 5)
    mel = torch.tensor(rng.randn(128, 80) - 4, dtype=torch.float32)
    ids = list(rng.randint(0, 144, 24))
    got = fine_tune_f64(cloner, mel, ids)
    want = fine_tune_f64(cpu_cloner, mel, ids)
    err = float(np.abs(got - want).max())
    log("clone", f"fine-tune in float64 (128 frames, 24 labels), card against CPU: logits "
                 f"max_abs_err={err:.3e} (tolerance {TOL_FINE_TUNE_F64}, peak "
                 f"{np.abs(want).max():.3e})")
    if not err <= TOL_FINE_TUNE_F64:
        raise AssertionError("the fine-tune on the card disagrees with the CPU's")
    saved = cloner.aligner, cpu_cloner.aligner
    cloner.aligner = tuned
    cpu_cloner.aligner = copy.deepcopy(tuned).cpu()
    try:
        err = float(np.abs(cloner.logits(tuned, r.mel)
                           - cpu_cloner.logits(cpu_cloner.aligner, r.mel.cpu())).max())
        log("clone", f"the card's fine-tuned aligner, card against CPU: logits "
                     f"max_abs_err={err:.3e} (tolerance {TOL_ALIGNER_LOGITS})")
        if not err <= TOL_ALIGNER_LOGITS:
            raise AssertionError("the fine-tuned aligner's logits differ between card and CPU")
        # extract_prosody's steps (prepare, logits, pathfinding, prosody) on
        # each side: the host's front end gives both the same wave and phones
        sides = (cloner, cpu_cloner)
        refs = [c.prepare(LONG_TEXT, ref, sr=24000) for c in sides]
        if not (np.array_equal(refs[0].wave, refs[1].wave) and np.array_equal(
                refs[0].text, refs[1].text) and refs[0][3:] == refs[1][3:]):
            raise AssertionError("the host's front end differs between the two sides")
        mels = [r.mel.double().cpu().numpy() for r in refs]
        err = float(np.abs(10.0 ** mels[0] - 10.0 ** mels[1]).max() / (10.0 ** mels[1]).max())
        log("clone", f"the mel, card against CPU: in power max_abs_err={err:.3e} of the peak "
                     f"(tolerance {TOL_MEL_POWER}); in log10 {np.abs(mels[0] - mels[1]).max():.3e}"
                     f" (the log magnifies the rounding of the quietest bins)")
        if not err <= TOL_MEL_POWER:
            raise AssertionError("the reference's mel differs between card and CPU")
        ids = refs[0].token_ids
        logits = [c.logits(c.aligner, r.mel) for c, r in zip(sides, refs)]
        log("clone", f"the fine-tuned aligner, each side on its own mel, card against CPU: "
                     f"logits max_abs_err={np.abs(logits[0] - logits[1]).max():.3e} (the mel's "
                     f"log10 difference carried through; on one mel above)")
        # in float64 on the card's mel the logits agree to ~1e-14, far inside
        # any decision's margin: the alignments must be equal
        mel64 = refs[0].mel.double()
        logits64 = [c.logits(copy.deepcopy(c.aligner).double(), mel64.to(c.device))
                    for c in sides]
        log("clone", f"the same in float64 on the card's mel: logits max_abs_err="
                     f"{float(np.abs(logits64[0] - logits64[1]).max()):.3e}")
        for method in ("MAS", "dijkstra"):
            aligns = [alignment_from_logits(lg, ids, method) for lg in logits64]
            if not np.array_equal(*aligns):
                raise AssertionError(f"{method} on float64 logits differs between card and CPU")
            aligns = [alignment_from_logits(lg, ids, method) for lg in logits]
            tie = check_alignments(method, [lg[:, ids] for lg in logits], aligns)
            # the prosody of the card's path on each side
            outs = [c.prosody(r, aligns[0]) for c, r in zip(sides, refs)]
            same = np.array_equal(outs[0][0], outs[1][0]) and outs[0][3:] == outs[1][3:]
            errs = [float(np.abs(a - b).max()) for a, b in zip(outs[0][1:3], outs[1][1:3])]
            if not np.array_equal(*aligns):
                parted = outs[0][0] != cloner.prosody(refs[0], aligns[1])[0]
                tie += f" ({int(parted.sum())} phones' durations part)"
            log("clone", f"extract_prosody ({method}) on the fine-tuned aligner, card against "
                         f"CPU: in float64 on one mel the paths are equal; in float32 each on "
                         f"its own mel, {tie}; on the card's "
                         f"path durations and silences {'equal' if same else 'DIFFER'}, pitch "
                         f"max_abs_err={errs[0]:.3e}, energy {errs[1]:.3e} (tolerance "
                         f"{TOL_PROSODY})")
            if not (same and max(errs) <= TOL_PROSODY):
                raise AssertionError(f"extract_prosody ({method}) differs between card and CPU")
        dur, pitch, energy = outs[0][:3]
    finally:
        cloner.aligner, cpu_cloner.aligner = saved
    z = (0.8 * rng.randn(int(dur.sum()) + 66, 80)).astype(np.float32)
    kw = dict(durations=dur, pitch=pitch, energy=energy, glow_noise=z)
    w_card, w_cpu = iface(LONG_TEXT, **kw), cpu(LONG_TEXT, **kw)
    err = float(np.abs(w_card - w_cpu).max()) if w_card.shape == w_cpu.shape else float("inf")
    log("clone", f"synthesis of the cloned prosody ({len(w_card)} samples), card against CPU on "
                 f"the same noise: max_abs_err={err:.3e} (tolerance {TOL_REF})")
    if not err <= TOL_REF:
        raise AssertionError("the cloned synthesis differs between card and CPU")
    return wave


def phase_controllable(iface, launches, card):
    """The embedding GAN at JAX's defaults (``ResNetG()``, 1100 latents,
    50 000 PCA samples; seeded weights) on the card: the set-up's time,
    ``modify_embed`` card against CPU on the same bank and basis, and
    ``ControllableInterface.read`` (no plot: the card's machine has no
    matplotlib) with its launches counted."""
    torch.manual_seed(SEED + 6)
    gan_sd = ResNetG().state_dict()
    wrapper, sec = timed(lambda: GanWrapper(gan_sd, seed=SEED))
    z = torch.randn((50000, wrapper.generator.z_dim), device=iface.device)
    inter, gen_s = timed(lambda: wrapper.intermediate(z))
    _, copy_s = timed(lambda: (inter.cpu().numpy(), z.cpu().numpy()))
    log("controllable", f"GanWrapper set-up on the card (1100 latents, 50000 PCA samples in "
                        f"batches of 5000, SVD and least squares on the host): {1e3 * sec:.1f} ms; "
                        f"again on 50000 latents, the generator on the card {1e3 * gen_s:.1f} ms "
                        f"and the copy to the host {1e3 * copy_s:.1f} ms, so the host's SVD and "
                        f"least squares take about {1e3 * (sec - gen_s - copy_s):.1f} ms ({card})")
    del z, inter
    cpu = GanWrapper(gan_sd, device="cpu", state=wrapper.state())
    for seed in (0, 7):
        wrapper.set_latent(seed)
        cpu.set_latent(seed)
        for sliders in GAN_SLIDERS:
            got, want = (w.modify_embed(np.asarray(sliders, np.float32)) for w in (wrapper, cpu))
            err = float(np.abs(got - want).max())
            log("controllable", f"modify_embed(latent {seed}, sliders {sliders}), card against "
                                f"CPU: max_abs_err={err:.3e} (tolerance {TOL_GAN})")
            if not (got.shape == (64,) and err <= TOL_GAN):
                raise AssertionError("modify_embed differs between card and CPU")
    ci, speaker = ControllableInterface(iface, wrapper), iface.default_utterance_embedding
    text = BATCH_TEXTS[0]
    for name, warm in (("first", None), ("steady", 0)):
        sr, wave = drive(f"ControllableInterface.read ({name})",
                         lambda: ci.read(text, voice_seed=3, emb_slider_1=1.0, emb_slider_4=-0.5),
                         iface, dict(k1=12, k2=4), launches, waves_of=lambda out: [out[1]],
                         frame=768, warm=warm)
    plain = iface(text)
    log("controllable", f"read: {sr} Hz, {len(wave)} samples against the 24 kHz call's "
                        f"{len(plain)}")
    if not (sr == 48000 and len(wave) == 2 * len(plain)
            and np.array_equal(wave[::2], wave[1::2])):
        raise AssertionError("read did not return the call's wave doubled to 48 kHz")
    iface.set_utterance_embedding(embedding=speaker)


# phase_train: 48 seeded utterances of 40-120 phones at 1-12 frames each in
# two languages, batch 24 (two steps an epoch, a checkpoint after each), the
# glow from step 4 (postnet_start_steps 3), 8 steps, then a resumed run of
# 2 more whose checkpoint at step 10 passes 3 x 3 and starts SWA into best.pt
TRAIN_UTTERANCES = 48
TRAIN_BATCH = 24
TRAIN_GLOW_AFTER = 3
TRAIN_STEPS = (7, 9)   # train_loop's ``steps`` of the first run and of the resumed one
TRAIN_TIMED_STEPS = 4  # steps timed alone, without and with the glow, on one batch
# the first step on the card against the CPU, at full width, dropout 0, on 2
# utterances: sums in other orders through 12 conformer blocks, the glow and
# the critic, forward and backward (the gradients in float64,
# ``check_train_step_against_cpu``)
TOL_TRAIN_LOSS = 1e-4       # relative, f32
TOL_TRAIN_GRAD = 1e-4       # of each gradient tensor's own peak, float64
TOL_TRAIN_STATS = 1e-5      # BatchNorm running statistics, f32
# gradients that are 0 in exact arithmetic (``ZERO_GRADIENTS``): noise on
# both sides, held below this share of the largest gradient
TOL_ZERO_GRAD = 1e-6
# the rest of training's first steps: float64 gradients, card against
# CPU, of each tensor's peak
TOL_TRAIN_GRAD64 = 1e-6
TOL_VAE = 1e-5
STOCHASTIC_FRAMES = 1024


def training_data(seed, n=TRAIN_UTTERANCES, mels=80, phones=(40, 120), per_phone=(1, 12)):
    """Seeded datapoints shaped like real utterances: 40-120 phones of
    binary articulatory features, 1-12 frames a phone (~200-1000 mel
    frames), a pitch and an energy per phone, two language ids."""
    rng = np.random.RandomState(seed)
    data = []
    for i in range(n):
        t = rng.randint(phones[0], phones[1] + 1)
        durations = rng.randint(per_phone[0], per_phone[1] + 1, size=t)
        frames = int(durations.sum())
        data.append(dict(text=(rng.rand(t, 62) > 0.5).astype(np.float32),
                         mel=(rng.randn(frames, mels) - 5.0).astype(np.float32),
                         durations=durations,
                         pitch=np.abs(1.0 + 0.3 * rng.randn(t, 1)).astype(np.float32),
                         energy=np.abs(1.0 + 0.3 * rng.randn(t, 1)).astype(np.float32),
                         lang_id=(12, 37)[i % 2]))
    return data


def first_step(cfg, gst_sd, batch, starts, device, dtype):
    """(metrics, gradients, BatchNorm statistics) of the first step of a
    fresh state (seed SEED, dropout 0, the critic) in ``dtype``."""
    state = create_train_state(cfg, gst_sd, use_discriminator=True, device=device, seed=SEED)
    state.model.conv_postnet.dropout_rate = 0.0   # no config field reaches it
    for module in (state.model, state.disc, state.gst):
        module.to(dtype)
    tensors = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in to_tensors(batch, device).items()}
    with matmul_precision("float32"):
        metrics = compute_gradients(state, tensors, run_glow=True, use_discriminator=True,
                                    window_starts=starts.to(device))
    params = [*state.model.named_parameters(),
              *(("disc." + k, v) for k, v in state.disc.named_parameters())]
    return ({k: v.item() for k, v in metrics.items()},
            {k: p.grad.cpu().double() for k, p in params},
            {k: b.cpu().double() for k, b in state.model.named_buffers()
             if k.endswith(("running_mean", "running_var"))})


def gradient_errors(card, cpu, zero_names):
    """(each tensor's max error as a share of its peak, sorted worst
    first; the largest magnitude of the gradients named by the suffixes
    ``zero_names``, 0 in exact arithmetic, as a share of the largest
    gradient)."""
    peak = max(g.abs().max().item() for g in cpu.values())
    errs, zero = [], 0.0
    for k, want in cpu.items():
        if zero_names and k.endswith(tuple(zero_names)):
            zero = max(zero, max(card[k].abs().max().item(), want.abs().max().item()) / peak)
        else:
            errs.append(((card[k] - want).abs().max().item()
                         / max(want.abs().max().item(), 1e-300), k))
    return sorted(errs, reverse=True), zero


def check_train_step_against_cpu(dev, gst_sd, data, config):
    """The first step at full width with dropout 0 on the 2 shortest
    utterances, card against CPU under the "float32" policy, the critic's
    windows at the same starts: in f32 the losses and the BatchNorm
    statistics; the gradients in float64, where no ReLU or leaky-ReLU
    input rounds to the other side of 0 on one device only (in f32 one
    such flip moves a weight's gradient by one frame's share of its sum,
    ~1e-3 of its peak at this width: the f32 errors are printed)."""
    cfg = dataclasses.replace(config, dropout=0.0, duration_dropout=0.0, pitch_dropout=0.0,
                              energy_dropout=0.0)
    batch = batching.pad_batch(sorted(data, key=lambda d: len(d["mel"]))[:2])
    compare_step("train", f"first step at full width, dropout 0, 2 utterances "
                          f"({int(batch['speech_lengths'].sum())} frames)",
                 functools.partial(first_step, cfg, gst_sd, batch, torch.tensor([5, 17])), dev,
                 TOL_TRAIN_LOSS, tol_grad=TOL_TRAIN_GRAD, extra=stats_within(TOL_TRAIN_STATS),
                 zero=ZERO_GRADIENTS)


def stats_within(tol):
    def check(card_s, cpu_s):
        err = max((card_s[k] - cpu_s[k]).abs().max().item() for k in cpu_s)
        return f"BatchNorm statistics max abs err {err:.3e} (tolerance {tol}); ", err <= tol
    return check


def compare_step(phase, what, run, dev, tol_loss, tol_grad=TOL_TRAIN_GRAD64, extra=None,
                 zero=()):
    """``run(device, dtype)`` -> (metrics, gradients, other) on ``dev`` (the
    card) and on the CPU, in f32 and float64: the f32 losses within ``tol_loss``
    relative, the float64 gradients within ``tol_grad`` of each tensor's
    peak (f32 ones printed), except those named by the suffixes ``zero``
    (0 in exact arithmetic, noise on both sides: below TOL_ZERO_GRAD of the
    largest gradient, as ``gradient_errors`` holds ``ZERO_GRADIENTS``);
    ``extra(card32, cpu32)`` -> (message, ok)."""

    sides = {(dt, name): run(device, dt) for dt in (torch.float32, torch.float64)
             for name, device in (("card", dev), ("cpu", torch.device("cpu")))}
    (m_card, g_card, o_card), (m_cpu, g_cpu, o_cpu) = (sides[torch.float32, "card"],
                                                      sides[torch.float32, "cpu"])
    loss_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30) for k in m_cpu)
    errs32, _ = gradient_errors(g_card, g_cpu, zero)
    errs64, zero64 = gradient_errors(sides[torch.float64, "card"][1],
                                     sides[torch.float64, "cpu"][1], zero)
    msg, ok = extra(o_card, o_cpu) if extra else ("", True)
    if zero:
        msg += (f"the gradients 0 in exact arithmetic ({', '.join(zero)}) within "
                f"{zero64:.3e} of the largest (tolerance {TOL_ZERO_GRAD}); ")
    log(phase, f"{what}, card against CPU: f32 losses max rel err {loss_err:.3e} (tolerance "
               f"{tol_loss}); float64 gradients max err {errs64[0][0]:.3e} of their tensor's "
               f"peak (at {errs64[0][1]}; tolerance {tol_grad}); {msg}f32 gradients, not held: "
               + ", ".join(f"{k} {e:.2e}" for e, k in errs32[:3]) + "; "
               + ", ".join(f"{k}={v:.5f}" for k, v in m_cpu.items()))
    if not (loss_err <= tol_loss and errs64[0][0] <= tol_grad and zero64 <= TOL_ZERO_GRAD
            and ok):
        raise AssertionError(f"{phase}: {what} on the card disagrees with the CPU")


def phase_train(dev, voc_sd, gst_sd, launches, card, config=None):
    """``train_loop`` at full width (the default ``ToucanTTSConfig``, the
    GST frozen) on ``training_data``: batch 24 with the critic, the glow
    joining at step 4, 8 steps, then ``resume=True`` for 2 more, whose
    checkpoint starts SWA into ``best.pt``; ``best.pt`` (with the HiFiGAN
    and GST weights as reference files) loads through
    ``load.interface_from_torch`` into an interface that synthesizes
    LONG_TEXT (K1 12 + K2 4 a synthesis).  No train step may launch a
    kernel.  Prints the loop's step times (host clock), then the median of
    TRAIN_TIMED_STEPS steps on one batch without and with the glow (the
    critic in both), utterances/s and mel frames/s, the peak device memory,
    and the profiler's top device items of one glow step; then
    ``check_train_step_against_cpu``."""
    t_phase = time.perf_counter()
    config = config or ToucanTTSConfig()
    data = training_data(SEED + 11)
    marks = []

    def mark(step, metrics):
        marks.append((step, time.perf_counter(), metrics))
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"train step {step}: a loss is not finite: {metrics}")

    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "run")
        common = dict(config=config, batch_size=TRAIN_BATCH, warmup_steps=8,
                      postnet_start_steps=TRAIN_GLOW_AFTER, use_discriminator=True, log_every=1,
                      callbacks=[mark], device=dev)
        t0 = time.perf_counter()
        state, _ = train_loop(data, gst_sd, save, steps=TRAIN_STEPS[0], **common)
        first_s = time.perf_counter() - t0
        state, _ = train_loop(data, gst_sd, save, steps=TRAIN_STEPS[1], resume=True, **common)
        got = {k: w.launches for k, w in WRAPPERS.items()}
        if any(got.values()):
            raise AssertionError(f"train steps launched kernels: {got}")
        steps = [m[0] for m in marks]
        if steps != list(range(TRAIN_STEPS[0] + 1)) + [8, 9] or state.step != 10:
            raise AssertionError(f"train_loop ran steps {steps} to {state.step}")
        if not os.path.exists(os.path.join(save, "best.pt")):
            raise AssertionError("SWA wrote no best.pt")
        # in the loop, a step's time runs from the previous step's metrics
        # read on the host to its own (each callback's read waits for its
        # step); a step that opens an epoch also holds the checkpoint before it
        in_loop = {s: marks[i][1] - marks[i - 1][1] for i, s in enumerate(steps)
                   if i > 0 and s % (TRAIN_UTTERANCES // TRAIN_BATCH)}
        log("train", f"first run: 8 steps and 4 checkpoints in {first_s:.2f} s; steps inside "
                     "an epoch, host clock: " + ", ".join(
                         f"{s}{' (glow)' if s > TRAIN_GLOW_AFTER else ''} {1e3 * t:.2f} ms"
                         for s, t in in_loop.items()) + f" ({card})")
        log("train", "losses at step 9: "
                     + ", ".join(f"{k}={v:.4f}" for k, v in marks[-1][2].items()))
        batch = to_tensors(batching.pad_batch(data[:TRAIN_BATCH]), dev)
        log("train", f"timed steps on one batch of {TRAIN_BATCH}: {batch['text'].shape[1]} "
                     f"phones, {batch['gold_speech'].shape[1]} frames padded, "
                     f"{int(batch['speech_lengths'].sum())} real")
        for glow in (False, True):
            step = make_train_step(run_glow=glow, use_discriminator=True)
            with matmul_precision("float32"):
                ts = [timed(lambda: step(state, batch))[1] for _ in range(TRAIN_TIMED_STEPS)]
            med = float(np.median(ts))
            frames = int(batch["speech_lengths"].sum())
            log("train", f"step {'with glow and critic' if glow else 'without glow, with critic'}"
                         f": median {1e3 * med:.2f} ms of {len(ts)} ("
                         + ", ".join(f"{1e3 * t:.2f}" for t in ts) + f"); "
                         f"{TRAIN_BATCH / med:.2f} utterances/s, {frames / med:.0f} mel frames/s "
                         f"({card})")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else None
        log("train", f"peak device memory over the phase's steps: "
                     f"{'not measured' if peak_gb is None else f'{peak_gb:.3f} GiB'} "
                     f"(torch.cuda.max_memory_allocated; {card})")
        with matmul_precision("float32"), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, sec = timed(lambda: step(state, batch))
        report_profile(prof, sec * 1e6, "train", "one glow step with the critic")
        if any(w.launches for w in WRAPPERS.values()):
            raise AssertionError("a train step launched a kernel")
        del state, batch

        paths = [os.path.join(save, "best.pt"), os.path.join(tmp, "vocoder.pt"),
                 os.path.join(tmp, "embedding_function.pt")]
        torch.save({"generator": voc_sd}, paths[1])
        torch.save({"style_emb_func": gst_sd}, paths[2])
        iface = interface_from_torch(*paths, seed=SEED)
    wave = drive("train best.pt call", lambda: iface(LONG_TEXT), iface, dict(k1=12, k2=4),
                 launches)
    log("train", f"best.pt synthesized {len(wave) / 24000:.3f} s of audio")
    del iface
    check_train_step_against_cpu(dev, gst_sd, data, config)
    log("train", f"phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")


def phase_stochastic(dev, launches, card, config=None):
    """``StochasticToucanTTS`` at full width (the default config; seeded
    weights, the flows' ``proj`` convs and affines away from their zero
    init so every spline is live) on LONG_TEXT's ~110 phones with injected
    flow and glow noise: ``infer`` on the card (K1 12: 6 encoder and 6
    decoder blocks) against the CPU, durations equal and the mels within
    TOL_REF; then one ``EmbeddingVAE`` loss and one sample, card against
    CPU within TOL_VAE."""
    t0 = time.perf_counter()
    config = config or ToucanTTSConfig()
    torch.manual_seed(SEED + 21)
    cpu = StochasticToucanTTS(config).eval()
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "_flow." in name and (".proj." in name or ".flows.0." in name):
                p.copy_(0.05 * torch.randn_like(p))
    model = copy.deepcopy(cpu).to(dev)
    feats = TextFrontend(language="en").string_to_features(LONG_TEXT)
    n = len(feats)
    rng = np.random.RandomState(SEED + 22)
    x = np.zeros((1, _round_up(n, PHONE_BUCKET), feats.shape[1]), np.float32)
    x[0, :n] = feats
    utt = rng.randn(1, 64).astype(np.float32)
    flow_noise = [rng.randn(1, x.shape[1], 2).astype(np.float32) for _ in range(3)]
    glow_noise = (0.8 * rng.randn(1, STOCHASTIC_FRAMES, 80)).astype(np.float32)
    outs = {}
    # the card twice: its first call (with the library's first-use costs) and a steady one
    for name, m, d in (("card, first", model, dev), ("card", model, dev),
                       ("cpu", cpu, torch.device("cpu"))):
        args = dict(utterance_embedding=torch.tensor(utt, device=d),
                    lang_ids=torch.tensor([[12]], device=d),
                    glow_noise=torch.tensor(glow_noise, device=d),
                    flow_noise=[torch.tensor(z, device=d) for z in flow_noise])
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        with matmul_precision("float32"):
            res, sec = timed(lambda: m.infer(torch.tensor(x, device=d), torch.tensor([n], device=d),
                                             STOCHASTIC_FRAMES, **args))
        counts = {k: w.launches for k, w in WRAPPERS.items()}
        outs[name] = [r.cpu().numpy() for r in res]
        if name != "cpu":
            expect = per_synthesis(1, k1=12)
            want = {k: expect.get(k, 0) for k in WRAPPERS}
            log("stochastic", f"infer ({name}) on {n} phones, {STOCHASTIC_FRAMES} frames: "
                              f"{1e3 * sec:.2f} ms, host clock ({card}); "
                              + " ".join(f"{k}_launches={c}" for k, c in counts.items()))
            if counts != want:
                raise AssertionError(f"stochastic infer: expected launches {want}, got {counts}")
            launches["k1"] += counts["k1"]
    dur_card, dur_cpu = outs["card"][2], outs["cpu"][2]
    if not np.array_equal(dur_card, dur_cpu):
        raise AssertionError("stochastic durations differ between the card and the CPU")
    mel_err = max(np.abs(outs["card"][i] - outs["cpu"][i]).max() for i in (0, 1))
    log("stochastic", f"card against CPU: durations equal ({int(dur_cpu.sum())} frames, "
                      f"{int(dur_cpu.min())}-{int(dur_cpu.max())} a phone), mel max_abs_err="
                      f"{mel_err:.3e} (tolerance {TOL_REF})")
    if not (mel_err <= TOL_REF and dur_cpu.max() > 1):
        raise AssertionError("the stochastic model on the card disagrees with the CPU")

    torch.manual_seed(SEED + 23)
    vae_cpu = EmbeddingVAE()
    vae = copy.deepcopy(vae_cpu).to(dev)
    target = rng.randn(4, 64).astype(np.float32)
    eps, z = rng.randn(4, 16).astype(np.float32), rng.randn(1, 16).astype(np.float32)
    errs = []
    with torch.no_grad(), matmul_precision("float32"):
        got = vae(torch.tensor(target, device=dev), noise=torch.tensor(eps, device=dev))
        want = vae_cpu(torch.tensor(target), noise=torch.tensor(eps))
        errs += [(g.cpu() - w).abs().max().item() for g, w in zip(got, want)]
        got = vae(noise=torch.tensor(z, device=dev))
        errs.append((got.cpu() - vae_cpu(noise=torch.tensor(z))).abs().max().item())
    log("stochastic", f"EmbeddingVAE card against CPU: reconstruction, KL, loss, sample max "
                      f"abs errs {', '.join(f'{e:.3e}' for e in errs)} (tolerance {TOL_VAE}); "
                      f"phase wall time {time.perf_counter() - t0:.1f} s ({card})")
    if not max(errs) <= TOL_VAE:
        raise AssertionError("the EmbeddingVAE on the card disagrees with the CPU")


# ------------------------------------------------------ training slice 2

VOC_STEPS = 12            # avocodo_pipeline's steps: 0-2 warm-up, 3-11 adversarial
VOC_BATCH = 18            # the reference's batch
VOC_WARMUP = -98          # generator_warmup: steps s <= warmup + 100 are warm-up
VOC_CHECK_FRAMES = 16     # card against CPU: one adversarial step on 6144 samples
SERVE_FRAMES = 64
BIGVGAN_BATCH = 8
BIGVGAN_STEPS = 3
TOL_SIGMA = 1e-6          # spectral sigmas, relative
ALIGNER_STEPS = 8
ALIGNER_BATCH = 8
ALIGNER_FRAMES = (200, 800)
ALIGNER_TOKENS = (20, 80)
EMB_BATCH = 16
EMB_STEPS = 4
TRIPLETS = 8
# gradients 0 in exact arithmetic besides the TTS's ``ZERO_GRADIENTS``: the
# GST's key bias shifts every score of a query alike, which its softmax
# ignores; the WGAN generator's ``fc`` bias (below) is taken out by the
# train-mode BatchNorm after it
EMBEDDING_ZERO_GRADIENTS = ZERO_GRADIENTS + ("stl.mha.linear_k.bias",)
WGAN_BATCH = 32
WGAN_STEPS = 5


def joint_discriminator(segment, seed):
    return AvocodoJointDiscriminator(segment=segment,
                                     generator=torch.Generator().manual_seed(seed))


def write_ljspeech(root, n=12, seed=SEED, sr=22050):
    """A seeded LJSpeech layout (``metadata.csv`` and ``wavs/``) of harmonic
    tones with noise, 2-4 s at 22 050 Hz: made here, nothing is downloaded."""
    base = os.path.join(root, "LJSpeech", "LJSpeech-1.1")
    os.makedirs(os.path.join(base, "wavs"))
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        t = np.arange(int(sr * rng.uniform(2.0, 4.0))) / sr
        f0 = rng.uniform(90, 250) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wave = sum(np.sin(k * phase) / k for k in range(1, 8))
        wave = 0.3 * wave / np.abs(wave).max() + 0.01 * rng.randn(len(t))
        write_wav(os.path.join(base, "wavs", f"LJ{i:03d}.wav"), wave.astype(np.float32), sr)
        lines.append(f"LJ{i:03d}|utterance {i}|utterance {i}")
    with open(os.path.join(base, "metadata.csv"), "w") as f:
        f.write("\n".join(lines))


def reset_counts():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def check_no_launches(what):
    got = {k: w.launches for k, w in WRAPPERS.items()}
    if any(got.values()):
        raise AssertionError(f"{what} launched kernels: {got}")


def marker(marks):
    def mark(step, metrics):  # the metrics' read waits for the step
        values = {k: v.item() for k, v in metrics.items()}
        marks.append((step, time.perf_counter(), values))
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"step {step}: a loss is not finite: {values}")
    return mark


def step_times(marks, kinds):
    """{kind: [host seconds of each step of that kind]}: a step's time runs
    from the previous step's metrics read to its own; the first step of
    each kind (the build of its cuDNN plans) is left out."""
    out, seen = {}, set()
    for (_, t_prev, _), (s, t, _) in zip([(None, None, None)] + marks[:-1], marks):
        if kinds(s) in seen:
            out.setdefault(kinds(s), []).append(t - t_prev)
        seen.add(kinds(s))
    return out


def fmt_ms(ts):
    return (f"median {1e3 * float(np.median(ts)):.2f} ms of {len(ts)} ("
            + ", ".join(f"{1e3 * t:.2f}" for t in ts) + ")")


def peak_memory(what, card):
    gb = torch.cuda.max_memory_allocated() / 2 ** 30 if torch.cuda.is_available() else None
    return (f"{what}: peak device memory "
            f"{'not measured' if gb is None else f'{gb:.3f} GiB'} "
            f"(torch.cuda.max_memory_allocated; {card})")


def reset_peak():
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def serve_against_train_path(label, generator, mel, kernel, per_call, launches, tol):
    """The no-grad path (through ``kernel``, ``per_call`` launches, counted
    into ``launches``) against the differentiable path on the same mel."""
    generator.eval()
    reset_counts()
    with torch.no_grad():
        served, sec = timed(lambda: generator(mel))
    got = {k: w.launches for k, w in WRAPPERS.items()}
    expect = per_synthesis(1, **{kernel: per_call})
    want = {k: expect.get(k, 0) for k in WRAPPERS}
    if got != want:
        raise AssertionError(f"{label}: expected launches {want}, got {got}")
    for k, c in got.items():
        launches[k] += c
    reset_counts()
    with torch.no_grad(), matmul_precision("float32"):
        train_path = generator(mel, differentiable=True)
    check_no_launches(f"{label}: the differentiable path")
    err = (served - train_path).abs().max().item()
    log("serve", f"{label}: {mel.shape[1]} frames through {kernel} ({per_call} launches, "
                 f"{1e3 * sec:.2f} ms) against the differentiable path: max_abs_err={err:.3e} "
                 f"(tolerance {tol})")
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{label}: the served wave disagrees with the training path")


def first_vocoder_step(device, dtype, frames=VOC_CHECK_FRAMES):
    """(metrics, gradients of both nets, spectral sigmas) of one adversarial
    step with the critic update of a fresh seeded state, batch 1."""
    torch.manual_seed(SEED + 31)
    gen = HiFiGANGenerator()
    disc = joint_discriminator(frames * 384, SEED + 32)
    state = create_vocoder_train_state(gen, disc, device=device)
    for m in (state.generator, state.discriminator):
        m.to(dtype)
    rng = np.random.RandomState(SEED + 33)
    batch = {"gold_wave": torch.from_numpy(0.1 * rng.randn(1, frames * 384, 1)),
             "mel": torch.from_numpy(rng.randn(1, frames, 80) - 4.0)}
    batch = {k: v.to(device, dtype) for k, v in batch.items()}
    with matmul_precision("float32"):
        metrics = make_vocoder_train_step(use_adversarial=True)(state, batch, True)
        sigmas = {k: v.item() for k, v in spectral_sigmas(state.discriminator).items()}
    grads = {f"{net}.{k}": p.grad.cpu().double()
             for net, m in (("g", state.generator), ("d", state.discriminator))
             for k, p in m.named_parameters()}
    return {k: v.item() for k, v in metrics.items()}, grads, sigmas


def phase_vocoder_train(dev, launches, card):
    """``avocodo_pipeline`` at full width (``HiFiGANGenerator()``, the joint
    critic at ``channel_scale=1.0``) on a seeded synthetic LJSpeech corpus
    (12 files, 2-4 s at 22 050 Hz, resampled to 24 and 16 kHz by the
    dataset), batch 18, VOC_STEPS steps: 0-2 warm-up, then adversarial, the
    critic updating at steps 3, 6 and 9; no step may launch a kernel.  The
    loop's step times by kind (host clock), segments/s and seconds of
    audio trained per second, the peak device memory, the profiler's top
    device items of one adversarial step with the critic update; then
    ``checkpoint_0.pt`` (through ``load.load_vocoder``) and the returned
    generator each served through K2 (4 launches) against their
    differentiable path (TOL_WAVE); then one adversarial step card against
    CPU (batch 1, 16 frames): losses, float64 gradients of both nets, the
    spectral sigmas."""
    t_phase = time.perf_counter()
    marks = []
    reset_counts()
    reset_peak()
    with tempfile.TemporaryDirectory() as tmp:
        write_ljspeech(os.path.join(tmp, "corpora"))
        old = os.environ.get("TOUCAN_CORPORA_ROOT")
        os.environ["TOUCAN_CORPORA_ROOT"] = os.path.join(tmp, "corpora")
        try:
            torch.manual_seed(SEED + 21)
            t0 = time.perf_counter()
            state = avocodo_pipeline(steps=VOC_STEPS, batch_size=VOC_BATCH,
                                     generator_warmup=VOC_WARMUP, model_dir=os.path.join(
                                         tmp, "run"), device=dev, seed=SEED,
                                     discriminator=joint_discriminator(SEGMENT_24K, SEED + 22),
                                     callbacks=[marker(marks)])
            run_s = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("TOUCAN_CORPORA_ROOT")
            else:
                os.environ["TOUCAN_CORPORA_ROOT"] = old
        check_no_launches("the vocoder train steps")
        if [m[0] for m in marks] != list(range(VOC_STEPS)) or state.step != VOC_STEPS:
            raise AssertionError(f"avocodo_pipeline ran steps {[m[0] for m in marks]}")
        warm_end = VOC_WARMUP + 100
        kinds = step_times(marks, lambda s: "warm-up" if s <= warm_end else
                           "adversarial with the critic update" if s % 3 == 0 else
                           "adversarial without the critic update")
        sec_audio = VOC_BATCH * SEGMENT_24K / 24000
        log("vocoder_train", f"avocodo_pipeline: {VOC_STEPS} steps of {VOC_BATCH} segments of "
                             f"{SEGMENT_24K} samples in {run_s:.2f} s with the first checkpoint "
                             f"({card})")
        for kind, ts in kinds.items():
            med = float(np.median(ts))
            log("vocoder_train", f"{kind} step: {fmt_ms(ts)}; {VOC_BATCH / med:.2f} segments/s, "
                                 f"{sec_audio / med:.3f} s of audio trained per s ({card})")
        log("vocoder_train", "losses at the last step: "
                             + ", ".join(f"{k}={v:.4f}" for k, v in marks[-1][2].items()))
        log("vocoder_train", peak_memory("the pipeline's steps", card))
        dataset_batch = VocoderDataset([os.path.join(tmp, "corpora", "LJSpeech", "LJSpeech-1.1",
                                                     "wavs", f"LJ{i:03d}.wav") for i in range(12)],
                                       seed=SEED).sample_batch(VOC_BATCH)
        batch = to_tensors(dataset_batch, dev)
        step = make_vocoder_train_step(use_adversarial=True)
        with matmul_precision("float32"), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, sec = timed(lambda: step(state, batch, True))
        report_profile(prof, sec * 1e6, "vocoder_train",
                       "one adversarial step with the critic update")
        check_no_launches("the profiled vocoder step")
        names = sorted(os.listdir(os.path.join(tmp, "run")))
        if names != ["checkpoint_0.pt"]:
            raise AssertionError(f"the pipeline wrote {names}")
        served = HiFiGANGenerator()
        served.load_state_dict(load_vocoder(os.path.join(tmp, "run", "checkpoint_0.pt")))
    mel = torch.from_numpy(np.random.RandomState(SEED + 23).randn(1, SERVE_FRAMES, 80)
                           .astype(np.float32) - 4.0).to(dev)
    serve_against_train_path("checkpoint_0.pt", served.to(dev), mel, "k2", 4, launches, TOL_WAVE)
    serve_against_train_path("the returned generator", state.generator, mel, "k2", 4, launches,
                             TOL_WAVE)
    del state, served, batch

    def sigmas(card_s, cpu_s):
        err = max(abs(card_s[k] / cpu_s[k] - 1) for k in cpu_s)
        return f"spectral sigmas max rel err {err:.3e} (tolerance {TOL_SIGMA}); ", err <= TOL_SIGMA

    compare_step("vocoder_train", f"one adversarial step with the critic update, batch 1, "
                 f"{VOC_CHECK_FRAMES} frames", first_vocoder_step, dev, TOL_TRAIN_LOSS,
                 extra=sigmas)
    log("vocoder_train", f"phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")


def phase_bigvgan_train(dev, launches, card):
    """Full-width ``BigVGAN()`` (seeded; SnakeBeta parameters 0.3 x N(0, 1))
    with the joint critic: BIGVGAN_STEPS adversarial steps of
    ``make_vocoder_train_step`` on batches of BIGVGAN_BATCH 12288-sample
    segments, the critic updating at the first; step times and peak
    memory; no step may launch a kernel; then the trained generator served
    through K5 (73 launches) against its differentiable path (TOL_REF)."""
    t_phase = time.perf_counter()
    torch.manual_seed(SEED + 41)
    gen = BigVGAN()
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith(("alpha", "beta")):
                p.copy_(0.3 * torch.randn_like(p))
    state = create_vocoder_train_state(gen, joint_discriminator(SEGMENT_24K, SEED + 42),
                                       device=dev)
    rng = np.random.RandomState(SEED + 43)
    reset_counts()
    reset_peak()
    step = make_vocoder_train_step(use_adversarial=True)
    ts = []
    for s in range(BIGVGAN_STEPS):
        batch = {"gold_wave": torch.from_numpy(
                     (0.1 * rng.randn(BIGVGAN_BATCH, SEGMENT_24K, 1)).astype(np.float32)).to(dev),
                 "mel": torch.from_numpy((rng.randn(BIGVGAN_BATCH, SEGMENT_24K // 384, 80)
                                          - 4.0).astype(np.float32)).to(dev)}
        with matmul_precision("float32"):
            metrics, sec = timed(lambda: step(state, batch, s % 3 == 0))
        ts.append(sec)
        if not all(np.isfinite(v.item()) for v in metrics.values()):
            raise AssertionError(f"bigvgan step {s}: a loss is not finite")
    check_no_launches("the BigVGAN train steps")
    log("bigvgan_train", f"adversarial steps (the first with the critic update and the cuDNN "
                         f"plans' build), batch {BIGVGAN_BATCH}: "
                         + ", ".join(f"{1e3 * t:.2f} ms" for t in ts)
                         + f"; {BIGVGAN_BATCH / ts[-1]:.2f} segments/s at the last ({card})")
    log("bigvgan_train", peak_memory("the BigVGAN steps", card))
    mel = torch.from_numpy(np.random.RandomState(SEED + 44).randn(1, SERVE_FRAMES, 80)
                           .astype(np.float32) - 4.0).to(dev)
    serve_against_train_path("trained BigVGAN", state.generator, mel, "k5", K5_LAUNCHES,
                             launches, TOL_REF)
    log("bigvgan_train", f"phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")


def aligner_data(seed, n=24, frame_range=None, token_range=None):
    """Seeded aligner datapoints: ALIGNER_TOKENS phones drawn from the
    inventory and mels of ALIGNER_FRAMES frames (or the ranges given), at
    least 3 frames a phone (feasible for CTC), a speaker embedding each."""
    frame_range, token_range = frame_range or ALIGNER_FRAMES, token_range or ALIGNER_TOKENS
    rng = np.random.RandomState(seed)
    phones = phone_feature_matrix()
    data = []
    for _ in range(n):
        tokens = rng.randint(token_range[0], token_range[1] + 1)
        frames = rng.randint(max(frame_range[0], 3 * tokens), frame_range[1] + 1)
        data.append(dict(text=phones[rng.randint(0, len(phones), tokens)].astype(np.float32),
                         mel=(rng.randn(frames, 80) - 4.0).astype(np.float32),
                         speaker_embedding=rng.randn(192).astype(np.float32)))
    return data


def first_aligner_step(device, dtype, data):
    """(metrics, gradients of both nets, BatchNorm statistics) of one step
    of a fresh seeded state at step 1000 (the reconstruction at 0.5),
    without dropout, on the first two datapoints."""
    torch.manual_seed(SEED + 51)
    state = create_aligner_train_state(device=device, asr=Aligner(), tts=TinyTTS())
    for m in (state.asr, state.tts):
        m.to(dtype)
    state.step = 1000
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_tensors(aligner_batch(data[:2]), device).items()}
    with matmul_precision("float32"):
        metrics = make_aligner_train_step()(state, batch, deterministic=True)
    grads = {f"{net}.{k}": p.grad.cpu().double()
             for net, m in (("asr", state.asr), ("tts", state.tts))
             for k, p in m.named_parameters()}
    stats = {k: b.cpu().double() for k, b in state.asr.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return {k: v.item() for k, v in metrics.items()}, grads, stats


def phase_aligner_train(dev, card):
    """``_aligner_train_fn`` with full-size ``Aligner()`` and ``TinyTTS()``
    on seeded datapoints (mels of 200-800 frames, 20-80 feasible tokens),
    batch 8, 8 steps (past RAdam's rectification at step 6); no step may
    launch a kernel; step times and mel frames/s; the first step card
    against CPU (losses, BatchNorm statistics, float64 gradients); and
    ``mas_torch`` on the card equal to ``mas_numpy`` on the trained
    aligner's scores of an 800-frame mel."""
    t_phase = time.perf_counter()
    data = aligner_data(SEED + 52)
    marks = []
    reset_counts()
    reset_peak()
    state = _aligner_train_fn(data, ALIGNER_STEPS, batch_size=ALIGNER_BATCH, device=dev,
                              seed=SEED, callbacks=[marker(marks)])
    check_no_launches("the aligner train steps")
    ts = step_times(marks, lambda s: "step")["step"]
    frames = ALIGNER_BATCH * np.mean([len(d["mel"]) for d in data])
    log("aligner_train", f"{ALIGNER_STEPS} steps of batch {ALIGNER_BATCH}: {fmt_ms(ts)}; "
                         f"~{frames / np.median(ts):.0f} mel frames/s (the corpus mean length; "
                         f"{card})")
    log("aligner_train", "losses at the last step: "
                         + ", ".join(f"{k}={v:.4f}" for k, v in marks[-1][2].items()))
    log("aligner_train", peak_memory("the aligner steps", card))
    longest = max(data, key=lambda d: len(d["mel"]))
    tokens = vectors_to_ctc_ids(longest["text"])
    with torch.no_grad():
        logits = state.asr(torch.from_numpy(longest["mel"][None]).to(dev))[0]
    scores = logits.softmax(-1)[:, tokens]
    (path, sec) = timed(lambda: mas_torch(scores))
    want = mas_numpy(scores.cpu().numpy())
    equal = bool((path.cpu().numpy() == want).all())
    log("aligner_train", f"mas_torch on the card ({scores.shape[0]} frames x {len(tokens)} "
                         f"tokens, {1e3 * sec:.2f} ms) equal to mas_numpy: {equal}")
    if not equal:
        raise AssertionError("mas_torch on the card differs from mas_numpy")
    compare_step("aligner_train", "the first step (step 1000, dropout 0, 2 utterances)",
                 functools.partial(first_aligner_step, data=data), dev, TOL_TRAIN_LOSS,
                 extra=stats_within(TOL_TRAIN_STATS))
    log("aligner_train", f"phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")


def embedding_state(device, dtype=torch.float32, dropout=True):
    config = fastspeech2_config() if dropout else dataclasses.replace(
        fastspeech2_config(), dropout=0.0, duration_dropout=0.0, pitch_dropout=0.0,
        energy_dropout=0.0)
    state = create_embedding_train_state(config, device=device, seed=SEED + 61)
    if not dropout:
        state.model.conv_postnet.dropout_rate = 0.0   # no config field reaches it
    for m in (state.model, state.gst):
        m.to(dtype)
    return state


def first_embedding_step(device, dtype, data):
    state = embedding_state(device, dtype, dropout=False)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_tensors(batching.pad_batch(data), device).items()}
    with matmul_precision("float32"):
        metrics = make_embedding_train_step()(state, batch)
    grads = {f"{net}.{k}": p.grad.cpu().double()
             for net, m in (("tts", state.model), ("gst", state.gst))
             for k, p in m.named_parameters()}
    stats = {k: b.cpu().double() for m in (state.model, state.gst)
             for k, b in m.named_buffers() if k.endswith(("running_mean", "running_var"))}
    return {k: v.item() for k, v in metrics.items()}, grads, stats


def phase_embedding_train(dev, card):
    """``fastspeech2_config()`` ToucanTTS and ``StyleEmbedding()`` at full
    width: EMB_STEPS co-training steps at batch 16 (the GST in training
    mode), one token-spread step, one fine-tune step on 8 triplets (the
    GST's running statistics must stay); step times; no step may launch a
    kernel; the first co-training step (dropout 0, 2 utterances) card
    against CPU."""
    t_phase = time.perf_counter()
    data = training_data(SEED + 62, n=EMB_BATCH)
    reset_counts()
    reset_peak()
    state = embedding_state(dev)
    batch = to_tensors(batching.pad_batch(data), dev)
    step = make_embedding_train_step()
    with matmul_precision("float32"):
        ts = [timed(lambda: step(state, batch))[1] for _ in range(EMB_STEPS)]
        reg_loss, reg_s = timed(lambda: make_spread_regularization_step()(state))
        rng = np.random.RandomState(SEED + 63)
        mels = [torch.from_numpy(d["mel"]) for d in data]
        triplets = {}
        for name in ("anchor", "positive", "negative"):
            pick = rng.randint(0, len(mels), TRIPLETS)
            lengths = torch.tensor([len(mels[i]) for i in pick])
            padded = torch.zeros(TRIPLETS, int(lengths.max()), 80)
            for j, i in enumerate(pick):
                padded[j, :len(mels[i])] = mels[i]
            triplets[name], triplets[f"{name}_lengths"] = padded.to(dev), lengths.to(dev)
        stats = {k: v.clone() for k, v in state.gst.state_dict().items() if "running" in k}
        opt = torch.optim.Adam(state.gst.parameters(), lr=1e-4)
        ft, ft_s = timed(lambda: make_finetune_step()(state.gst, opt, triplets))
    check_no_launches("the embedding train steps")
    moved = [k for k, v in stats.items() if not torch.equal(state.gst.state_dict()[k], v)]
    if moved:
        raise AssertionError(f"the fine-tune step changed the GST's statistics {moved}")
    log("embedding_train", f"co-training steps, batch {EMB_BATCH} "
                           f"({int(batch['speech_lengths'].sum())} frames): {fmt_ms(ts[1:])} "
                           f"after a first of {1e3 * ts[0]:.2f} ms; spread step "
                           f"{1e3 * reg_s:.2f} ms (loss {reg_loss.item():.2f}); fine-tune step "
                           f"on {TRIPLETS} triplets {1e3 * ft_s:.2f} ms (triplet "
                           f"{ft['triplet'].item():.4f}, barlow {ft['barlow'].item():.4f}); "
                           f"the GST's running statistics unchanged ({card})")
    log("embedding_train", peak_memory("the embedding steps", card))
    del state, batch
    shortest = sorted(data, key=lambda d: len(d["mel"]))[:2]
    compare_step("embedding_train", "the first co-training step (dropout 0, 2 utterances)",
                 functools.partial(first_embedding_step, data=shortest), dev, TOL_TRAIN_LOSS,
                 extra=stats_within(TOL_TRAIN_STATS), zero=EMBEDDING_ZERO_GRADIENTS)
    log("embedding_train", f"phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")


def wgan_step(device, dtype, real, z, ot):
    """(losses, gradients, -) of one WGAN-QC step of a fresh seeded state
    with ``z`` and the LP's solution ``ot`` given."""
    state = create_wgan_qc_state(device=device, seed=SEED + 71)
    for m in (state.generator, state.critic):
        m.to(dtype)
    with matmul_precision("float32"):
        metrics = make_wgan_qc_train_step()(state, torch.from_numpy(real).to(device, dtype),
                                            z=torch.from_numpy(z).to(device, dtype), ot=ot)
    grads = {f"{net}.{k}": p.grad.cpu().double()
             for net, m in (("g", state.generator), ("d", state.critic))
             for k, p in m.named_parameters()}
    return metrics, grads, None


def phase_wgan_qc(dev, card):
    """``ResNetG()`` and ``ResNetD()`` at full size, batch 32, WGAN_STEPS
    WGAN-QC steps on seeded embeddings, the host LP (scipy HiGHS) timed
    apart from the step; one step card against CPU with ``z``, the
    potentials and the ordered reals given to both."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 72)
    reals = [rng.randn(WGAN_BATCH, 64).astype(np.float32) for _ in range(WGAN_STEPS)]
    state = create_wgan_qc_state(device=dev, seed=SEED + 71)
    step = make_wgan_qc_train_step()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    reset_counts()
    ts, lp = [], []

    def timed_lp(dist):  # the step's own LP, on the host clock
        t0 = time.perf_counter()
        out = solve_ot_lp(dist)
        lp.append(time.perf_counter() - t0)
        return out

    embedding_gan_module.solve_ot_lp = timed_lp
    try:
        with matmul_precision("float32"):
            for real in reals:
                losses, sec = timed(lambda: step(state, real, generator=gen))
                ts.append(sec)
    finally:
        embedding_gan_module.solve_ot_lp = solve_ot_lp
    check_no_launches("the WGAN-QC steps")
    log("wgan_qc", f"steps of batch {WGAN_BATCH}: {fmt_ms(ts)}; of which the host LP "
                   f"(a {WGAN_BATCH} x {WGAN_BATCH} plan, HiGHS) {fmt_ms(lp)}; last losses "
                   + ", ".join(f"{k}={v:.4f}" for k, v in losses.items()) + f" ({card})")
    real = reals[0]
    z = np.random.RandomState(SEED + 73).randn(WGAN_BATCH, 32).astype(np.float32)
    with torch.no_grad():
        probe = create_wgan_qc_state(device="cpu", seed=SEED + 71)
        fake = probe.generator(torch.from_numpy(z), train=True).numpy()
    dist = 0.5 / 64 * ((real[:, None] - fake[None]) ** 2).sum(-1)
    potentials, plan = solve_ot_lp(dist)
    ot = (potentials, real[np.argmax(plan, axis=0)])
    compare_step("wgan_qc", "one step with z, potentials and ordered reals given",
                 functools.partial(wgan_step, real=real, z=z, ot=ot), dev, TOL_TRAIN_LOSS,
                 zero=("g.fc.bias",))
    log("wgan_qc", f"phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")


# ------------------------------------------------------------- distribution

# The distribution phases.  Two gloo ranks share the card (NCCL refuses two
# ranks on one device; gloo takes all_reduce on CUDA tensors, which every
# gather of the port is written as), and one NCCL rank runs at world size 1,
# which builds a real communicator and runs each collective on the card.
# The ranks are processes started with ``spawn`` after the kernels were
# built, so each loads the built libraries; every rank has its own clock
# and a failure tears the group down (``dist/launch.py::run_ranks``).  The
# sizes are in DIST, which the CPU rehearsal shrinks.
DIST = dict(
    device="cuda:0", nccl=True, count=True, timeout_s=900,
    config={},                    # ToucanTTSConfig fields: the default, full width
    vocoder={},                   # HiFiGANGenerator / BigVGAN kwargs: full width
    critic_scale=1.0, aligner={}, tinytts={},
    train_batch=24, train_phones=(20, 60), train_frames=(1, 4),
    ckpt_depth=dict(enc_layers=2, dec_layers=2, glow_blocks=6),  # full width, depth cut
    voc_frames=VOC_CHECK_FRAMES, aligner_frames=(200, 400), aligner_tokens=(20, 60),
    longform_frames=4099, iface_longform=1024, iface_frames_per_phone=10,
    pipe_batches=6, pipe_batch=2, pipe_phones=64, pipe_frames=1024,
    scaling=dict(batch_per_device=8, tmax=64, lmax=384, steps=10))
# a mesh step in float64 against the single-process step on the global batch,
# of each tensor's peak (the bar of check_train_step_against_cpu's float64)
TOL_DIST64 = 1.8e-7
TOL_LONGFORM = 2e-5       # the HiFiGAN wave's bar (tests/test_longform.py)
TOL_PIPE = 1e-6           # a streamed wave against its standalone dispatch


def dist_acoustic_batch(spec):
    """The global batch (padded to its dataset's shapes, as every rank pads
    its share) and the critic's window starts, drawn once for all rows."""
    points = training_data(SEED + 141, spec["train_batch"], phones=spec["train_phones"],
                           per_phone=spec["train_frames"])
    pad_to = (batching._ceil_to(max(len(p["text"]) for p in points), 32),
              batching._ceil_to(max(len(p["mel"]) for p in points), 64))
    batch = batching.pad_batch(points, pad_to=pad_to)
    g = torch.Generator().manual_seed(SEED + 142)
    starts = (torch.rand(len(points), generator=g)
              * torch.from_numpy(batch["speech_lengths"]).double()).long()
    return batch, starts


def _rows(mesh, b):
    if mesh is None:
        return slice(0, b)
    n, r = mesh.size(0), mesh.get_local_rank("data")
    return slice(r * b // n, (r + 1) * b // n)


def _whole(module, prefix):
    """{prefix.name: (gradient, parameter)} whole, float64 copies on the
    device (sharded ones gathered over 'model': a collective)."""
    return {f"{prefix}.{k}": (unshard(p, p.grad).double().clone(), unshard(p, p).double().clone())
            for k, p in module.named_parameters()}


def dist_acoustic_step(spec, dev, dtype, mesh):
    """One ToucanTTS step with the critic, dropout 0, of a fresh seeded
    state, on the mesh (this rank's rows) or in one process (``mesh=None``,
    the global batch): (metrics, {name: (gradient, parameter after)},
    BatchNorm statistics)."""
    cfg = dataclasses.replace(ToucanTTSConfig(**spec["config"]), dropout=0.0,
                              duration_dropout=0.0, pitch_dropout=0.0, energy_dropout=0.0)
    torch.manual_seed(SEED)
    gst_sd = StyleEmbedding().state_dict()
    state = create_train_state(cfg, gst_sd, use_discriminator=True, device=dev, seed=SEED)
    state.model.conv_postnet.dropout_rate = 0.0
    for m in (state.model, state.disc, state.gst):
        m.to(dtype)
    batch, starts = dist_acoustic_batch(spec)
    if mesh is not None:
        shard_train_state(state, mesh)
        tensors = make_global_batch(batch, mesh, dev)
    else:
        tensors = to_tensors(batch, dev)
    tensors = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}
    starts = starts[_rows(mesh, len(starts))].to(dev)
    with matmul_precision("float32"):
        metrics = make_train_step(True, True, mesh=mesh)(state, tensors, window_starts=starts)
    stats = {k: b.double().clone() for k, b in state.model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return ({k: v.item() for k, v in metrics.items()},
            {**_whole(state.model, "tts"), **_whole(state.disc, "disc")}, stats)


def dist_vocoder_step(spec, dev, dtype, mesh):
    """One adversarial HiFiGAN step with the critic update at batch 2 (one
    segment a data rank), seeded: (metrics, {name: (gradient, parameter)},
    the spectral sigmas)."""
    frames = spec["voc_frames"]
    torch.manual_seed(SEED + 143)
    gen = HiFiGANGenerator(**spec["vocoder"])
    disc = AvocodoJointDiscriminator(segment=frames * 384, channel_scale=spec["critic_scale"],
                                     generator=torch.Generator().manual_seed(SEED + 144))
    state = create_vocoder_train_state(gen, disc, device=dev)
    for m in (state.generator, state.discriminator):
        m.to(dtype)
    if mesh is not None:
        _, step, state = make_sharded_vocoder_steps(state, mesh)
    else:
        step = make_vocoder_train_step(use_adversarial=True)
    rng = np.random.RandomState(SEED + 145)
    batch = {"gold_wave": 0.1 * rng.randn(2, frames * 384, 1),
             "mel": rng.randn(2, frames, 80) - 4.0}
    rows = _rows(mesh, 2)
    batch = {k: torch.from_numpy(v[rows]).to(dev, dtype) for k, v in batch.items()}
    with matmul_precision("float32"):
        metrics = step(state, batch, True)
        sigmas = {k: v.item() for k, v in spectral_sigmas(state.discriminator).items()}
    return ({k: v.item() for k, v in metrics.items()},
            {**_whole(state.generator, "g"), **_whole(state.discriminator, "d")}, sigmas)


def dist_aligner_step(spec, dev, dtype, mesh):
    """One aligner step (step 1000, deterministic) at batch 2 of unequal
    lengths, seeded: (metrics, {name: (gradient, parameter)}, statistics)."""
    data = aligner_data(SEED + 146, 2, spec["aligner_frames"], spec["aligner_tokens"])
    pad_to = (batching._ceil_to(max(len(vectors_to_ctc_ids(d["text"])) for d in data), 8),
              batching._ceil_to(max(len(d["mel"]) for d in data), 64))
    torch.manual_seed(SEED + 147)
    state = create_aligner_train_state(device=dev, asr=Aligner(**spec["aligner"]),
                                       tts=TinyTTS(**spec["tinytts"]))
    for m in (state.asr, state.tts):
        m.to(dtype)
    state.step = 1000
    step = make_aligner_train_step()
    if mesh is not None:
        step, state = make_sharded_aligner_step(state, mesh)
    batch = aligner_batch(data[_rows(mesh, 2)], pad_to=pad_to)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_tensors(batch, dev).items()}
    with matmul_precision("float32"):
        metrics = step(state, batch, deterministic=True)
    stats = {k: b.double().clone() for k, b in state.asr.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return ({k: v.item() for k, v in metrics.items()},
            {**_whole(state.asr, "asr"), **_whole(state.tts, "tts")}, stats)


def step_errors(got, want, zero=()):
    """(worst share of its tensor's peak over metrics, gradients, updated
    parameters and the third part, where; the largest of the gradients
    named by ``zero`` (0 in exact arithmetic) as a share of the largest)."""
    (m_got, t_got, o_got), (m_want, t_want, o_want) = got, want
    errs = [(abs(m_got[k] - v) / max(abs(v), 1e-30), f"metric {k}") for k, v in m_want.items()]
    peak = max(g.abs().max().item() for g, _ in t_want.values())
    zero_share = 0.0
    for k, (g, p) in t_want.items():
        if zero and k.endswith(tuple(zero)):
            zero_share = max(zero_share, max(g.abs().max().item(),
                                             t_got[k][0].abs().max().item()) / peak)
        else:
            errs.append(((t_got[k][0] - g).abs().max().item() / max(g.abs().max().item(), 1e-300),
                         f"gradient {k}"))
        errs.append(((t_got[k][1] - p).abs().max().item() / max(p.abs().max().item(), 1e-300),
                     f"parameter {k}"))
    for k, v in o_want.items():
        v, w = (torch.as_tensor(t, dtype=torch.float64) for t in (o_got[k], v))
        errs.append(((v - w).abs().max().item() / max(w.abs().max().item(), 1e-300), k))
    return max(errs), zero_share


def dist_step_checks(spec, dev, meshes, rank, fns):
    """Each named step on each mesh against one process on the global batch
    in float64 (held), and where asked in float32 (printed); rank 0
    compares."""
    out = {}
    for name, (fn, zero, dtypes) in fns.items():
        t0 = time.perf_counter()
        single = {dt: fn(spec, dev, dt, None) for dt in dtypes} if rank == 0 else {}
        single_s = time.perf_counter() - t0
        for label, mesh in meshes.items():
            t0 = time.perf_counter()
            got = {dt: fn(spec, dev, dt, mesh) for dt in dtypes}
            if rank == 0:
                row = dict(seconds=time.perf_counter() - t0, single_seconds=single_s,
                           metrics=got[dtypes[-1]][0])
                (row["err64"], row["at64"]), row["zero64"] = step_errors(
                    got[torch.float64], single[torch.float64], zero)
                if torch.float32 in dtypes:
                    (row["err32"], row["at32"]), _ = step_errors(
                        got[torch.float32], single[torch.float32], zero)
                out[f"{name} {label}"] = row
            del got
        del single
    return out


def _state_snapshot(state):
    """Every tensor of a train state whole, and its step and schedule."""
    out = {"step": state.step, "scheduler": state.scheduler.state_dict()}
    for net, m in (("model", state.model), ("disc", state.disc)):
        for k, p in m.named_parameters():
            out[f"{net}.{k}"] = unshard(p, p).cpu().clone()
            for key, v in state.optimizer.state[p].items():
                out[f"{net}.{k}.{key}"] = (unshard(p, v) if v.dim() else v).cpu().clone()
        for k, b in m.named_buffers():
            out[f"{net}.{k}"] = b.cpu().clone()
    return out


def _same_snapshots(got, want):
    bad = [k for k, v in want.items()
           if not (torch.equal(got[k], v) if torch.is_tensor(v) else got[k] == v)]
    return bad


def dist_checkpoints(spec, dev, world, directory):
    """Two float32 steps on the (1, n) layout, each saved; restored onto
    (1, n) and (n, 1); the SWA of both: every tensor equal to the saved
    state's, gathered whole.  Full width, the depth cut (``ckpt_depth``)."""
    layouts = {"1xn": make_mesh(1, world, device_type=dev.type),
               "nx1": make_mesh(world, 1, device_type=dev.type)}
    cfg = dataclasses.replace(ToucanTTSConfig(**{**spec["config"], **spec["ckpt_depth"]}),
                              dropout=0.0, duration_dropout=0.0, pitch_dropout=0.0,
                              energy_dropout=0.0)
    torch.manual_seed(SEED)
    gst_sd = StyleEmbedding().state_dict()

    def fresh(layout, seed):
        state = create_train_state(cfg, gst_sd, use_discriminator=True, device=dev, seed=seed)
        state.model.conv_postnet.dropout_rate = 0.0
        return shard_train_state(state, layouts[layout])

    batch, starts = dist_acoustic_batch(spec)
    tensors = to_tensors(batch, dev)
    t0 = time.perf_counter()
    src = fresh("1xn", SEED)
    step = make_train_step(True, True, mesh=layouts["1xn"])
    saved, save_s = [], []
    with matmul_precision("float32"):
        for _ in range(2):
            step(src, tensors, window_starts=starts.to(dev))
            t1 = time.perf_counter()
            sharded_ckpt.save_sharded_checkpoint(directory, src, src.step)
            save_s.append(time.perf_counter() - t1)
            saved.append(_state_snapshot(src))
    bad = {}
    for layout in layouts:
        t1 = time.perf_counter()
        got = _state_snapshot(sharded_ckpt.restore_sharded_checkpoint(directory,
                                                                      fresh(layout, SEED + 5)))
        bad[f"restore onto {layout} ({time.perf_counter() - t1:.2f} s)"] = \
            _same_snapshots(got, saved[1])
    swa = _state_snapshot(sharded_ckpt.swa_average(directory, fresh("nx1", SEED + 6), n=2))
    params = {f"{net}.{k}" for net, m in (("model", src.model), ("disc", src.disc))
              for k, _ in m.named_parameters()}
    want = {k: (saved[0][k] / 2 + v / 2 if k in params else v) for k, v in saved[1].items()}
    bad["swa of 2"] = _same_snapshots(swa, want)
    return dict(bad=bad, steps=sharded_ckpt.list_sharded_steps(directory), save_s=save_s,
                tensors=len(saved[1]), seconds=time.perf_counter() - t0)


def _live_biases(module, seed):
    """Every bias N(0, 0.1): a wrong edge halo then shows in the wave."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, p in module.named_parameters():
            if k.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return module


def dist_longform(spec, dev, mesh, rank):
    """HiFiGAN (K2) and BigVGAN (K5) at full width with live biases on a
    ragged mel of ``longform_frames`` frames, time-sharded over the ranks,
    against the unsharded synthesis (rank 0); each rank's launches for its
    chunk and for the tail's patch."""
    out = {}
    mel = torch.from_numpy(np.random.RandomState(SEED + 148).randn(
        spec["longform_frames"], 80).astype(np.float32) - 4.0).to(dev)
    torch.manual_seed(SEED + 149)
    big = BigVGAN(**spec["vocoder"])
    with torch.no_grad():
        for k, p in big.named_parameters():
            if k.endswith(("alpha", "beta")):
                p.copy_(0.3 * torch.randn_like(p))
    for name, voc, kernel in (("hifigan", HiFiGANGenerator(**spec["vocoder"]), "k2"),
                              ("bigvgan", big, "k5")):
        voc = _live_biases(voc, SEED + 150).to(dev).eval()
        reset_counts()
        t0 = time.perf_counter()
        wave = synthesize_longform(voc, mel, mesh)   # returns on the host: the card is done
        sec = time.perf_counter() - t0
        counts = {k: w.launches for k, w in WRAPPERS.items()}
        row = dict(seconds=sec, launches=counts, samples=len(wave))
        if rank == 0:
            reset_counts()
            with torch.no_grad():
                want = voc(mel[None])[0, :, 0].cpu().numpy()
            row["unsharded_launches"] = {k: w.launches for k, w in WRAPPERS.items()}
            row["err"] = float(np.abs(wave - want).max())
        out[name] = row
        del voc
    return out


def dist_interface(spec, dev, mesh, rank):
    """``ToucanTTSInterface(mesh=..., longform_frames=...)`` at full width on
    LONG_TEXT with durations and glow noise given: every rank's wave, K1 in
    the acoustic part; rank 0 holds it against the interface without a mesh
    whose mel is vocoded unsharded to its true end (the long path's
    semantics; the plain call's bucket, zeroed past the mel, is printed)."""
    torch.manual_seed(SEED)
    tts_sd = ToucanTTS(ToucanTTSConfig(**spec["config"])).state_dict()
    voc_sd = _live_biases(HiFiGANGenerator(**spec["vocoder"]), SEED + 151).state_dict()
    kw = dict(config=ToucanTTSConfig(**spec["config"]),
              vocoder=HiFiGANGenerator(**spec["vocoder"]), device=dev, seed=SEED)
    iface = ToucanTTSInterface(tts_sd, voc_sd, mesh=mesh,
                               longform_frames=spec["iface_longform"], **kw)
    n = len(iface.text2phone.string_to_features(LONG_TEXT))
    durations = np.full(n, spec["iface_frames_per_phone"])
    noise = (0.8 * np.random.RandomState(SEED + 152).randn(n * spec["iface_frames_per_phone"]
                                                           + 64, 80)).astype(np.float32)
    reset_counts()
    t0 = time.perf_counter()
    wave, dur, _, _ = iface(LONG_TEXT, durations=durations, glow_noise=noise,
                            return_duration_pitch_energy=True)
    out = dict(seconds=time.perf_counter() - t0, samples=len(wave),
               launches={k: w.launches for k, w in WRAPPERS.items()})
    if rank == 0:
        plain = ToucanTTSInterface(tts_sd, voc_sd, **kw)
        (p_wave, after, p_dur, _, _, lens), _ = plain._dispatch_call(
            LONG_TEXT, durations=durations, glow_noise=noise)
        mel_len = int(lens[0])
        with torch.no_grad(), matmul_precision("float32"):
            want = plain.vocoder(after[:, :mel_len])[0, :, 0].cpu().numpy()
        out["err"] = float(np.abs(wave - want).max())
        out["bucket_err"] = float(np.abs(wave - p_wave[0, :mel_len * 384].cpu().numpy()).max())
        out["durations_equal"] = bool(np.array_equal(dur, p_dur[0, :n].cpu().numpy()))
        out["frames"] = mel_len
    return out


def dist_rank(rank, world, spec):
    """One rank of the distribution phases; returns what rank 0 compared
    (small values only) and this rank's launches."""
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, torch.get_num_threads() // max(world, 1)))
    launches = dict.fromkeys(WRAPPERS, 0)
    out = {}
    t0 = time.perf_counter()
    meshes = ({f"{world}x1": make_mesh(world, 1, device_type=dev.type),
               f"1x{world}": make_mesh(1, world, device_type=dev.type)} if world > 1
              else {"1x1": make_mesh(1, 1, device_type=dev.type)})
    # the gathers' two routes, on the card: the all-reduce over a zeroed slot
    # buffer (every backend) and, on NCCL, all_gather_into_tensor
    group = next(iter(meshes.values())).get_group("data")
    x = torch.arange(12.0, device=dev).reshape(3, 4) + 100 * rank
    routes = [all_gather(x, group, native=False)]
    if torch.distributed.get_backend(group) == "nccl":
        routes.append(all_gather(x, group, native=True))
    want = torch.stack([torch.arange(12.0, device=dev).reshape(3, 4) + 100 * r
                        for r in range(group.size())])
    out["gather_routes"] = [bool(torch.equal(r, want)) for r in routes]
    f64, f32 = torch.float64, torch.float32
    fns = {"acoustic": (dist_acoustic_step, ZERO_GRADIENTS, (f64, f32) if world > 1 else (f64,))}
    if world > 1:
        fns.update(vocoder=(dist_vocoder_step, (), (f64,)),
                   aligner=(dist_aligner_step, (), (f64,)))
    out["train"] = dist_step_checks(spec, dev, meshes, rank, fns)
    out["train_seconds"] = time.perf_counter() - t0
    if world > 1:
        t0 = time.perf_counter()
        out["ckpt"] = dist_checkpoints(spec, dev, world, spec["ckpt_dir"])
        out["ckpt_seconds"] = time.perf_counter() - t0
        data_mesh = meshes[f"{world}x1"]
        t0 = time.perf_counter()
        out["longform"] = dist_longform(spec, dev, data_mesh, rank)
        for row in out["longform"].values():
            for k, c in row["launches"].items():
                launches[k] += c
        out["interface"] = dist_interface(spec, dev, data_mesh, rank)
        for k, c in out["interface"]["launches"].items():
            launches[k] += c
        out["longform_seconds"] = time.perf_counter() - t0
    out["launches"] = launches
    return out


def phase_dist_train(card):
    """The train steps on meshes against one process: ``run_ranks`` of one
    NCCL rank (mesh 1x1), then of two gloo ranks sharing the card, whose
    checks of the later phases it also returns."""
    from toucan_tpu_torch.dist.launch import run_ranks

    spec = dict(DIST, ckpt_dir=tempfile.mkdtemp(prefix="toucan_ckpt_"))
    results = {}
    for backend, world in ((("nccl" if spec["nccl"] else "gloo"), 1), ("gloo", 2)):
        t0 = time.perf_counter()
        res = run_ranks(dist_rank, world, args=(spec,), backend=backend,
                        timeout_s=spec["timeout_s"])
        results[world] = res
        routes = res[0]["gather_routes"]
        log("dist_train", f"{backend}, {world} rank(s): all_gather as an all-reduce"
                          + (" and NCCL's all_gather_into_tensor" if len(routes) > 1 else "")
                          + f" on the card, each equal to the ranks' tensors: {routes}")
        if not all(routes):
            raise AssertionError(f"dist_train: a gather route is wrong on {backend}")
        for check, row in res[0]["train"].items():
            f32 = (f"float32, not held: {row['err32']:.3e} at {row['at32']}; "
                   if "err32" in row else "")
            log("dist_train", f"{backend}, {world} rank(s), {check}: float64 max err "
                              f"{row['err64']:.3e} of its tensor's peak at {row['at64']} "
                              f"(tolerance {TOL_DIST64}); the gradients 0 in exact "
                              f"arithmetic within {row['zero64']:.3e} of the largest "
                              f"(tolerance {TOL_ZERO_GRAD}); {f32}{row['seconds']:.1f} s on "
                              f"the mesh, {row['single_seconds']:.1f} s in one process "
                              f"(state, step and gathering, host clock)")
            if not (row["err64"] <= TOL_DIST64 and row["zero64"] <= TOL_ZERO_GRAD):
                raise AssertionError(f"dist_train: {check} on {world} rank(s) disagrees with "
                                     f"one process on the global batch")
        log("dist_train", f"{backend}, {world} rank(s): wall time "
                          f"{time.perf_counter() - t0:.1f} s (each rank started by spawn; "
                          f"the steps {res[0]['train_seconds']:.1f} s of rank 0; {card})")
    shutil.rmtree(spec["ckpt_dir"], ignore_errors=True)
    return results[2]


def phase_sharded_ckpt(ranks, card):
    ck = ranks[0]["ckpt"]
    saves = ", ".join(f"{s:.2f}" for s in ck["save_s"])
    log("sharded_ckpt", f"{ck['tensors']} tensors a state, saved by two ranks on the (1, 2) "
                        f"layout at steps {ck['steps']} ({saves} s a save); "
        + "; ".join(f"{k}: {len(v)} unequal" for k, v in ck["bad"].items())
        + f"; wall time {ck['seconds']:.1f} s ({card})")
    for what, bad in ck["bad"].items():
        if bad:
            raise AssertionError(f"sharded_ckpt: {what}: unequal {bad[:5]}")
    if ck["steps"] != [1, 2]:
        raise AssertionError(f"sharded_ckpt: steps on disk {ck['steps']}")


def phase_longform(ranks, launches, card):
    """The long-form and interface checks the two ranks ran: each rank's
    launches per chunk (one synthesis of its chunk plus one of the tail's
    window when T was padded) and over the phase, rank 0's errors."""
    count = DIST["count"]
    per_call = {"hifigan": dict(k2=4), "bigvgan": dict(k5=K5_LAUNCHES)}
    for name, row in ranks[0]["longform"].items():
        log("longform", f"{name}: {DIST['longform_frames']} frames over 2 ranks sharing the card: "
                        f"max_abs_err against the unsharded synthesis {row['err']:.3e} "
                        f"(tolerance {TOL_LONGFORM}); {row['samples']} samples; rank 0 "
                        f"{1e3 * row['seconds']:.1f} ms (host clock, {card})")
        if not row["err"] <= TOL_LONGFORM:
            raise AssertionError(f"longform: {name} sharded disagrees with unsharded")
        padded = DIST["longform_frames"] % 2 != 0
        want = {k: v * (2 if padded else 1) for k, v in per_call[name].items()}
        for r, rank in enumerate(ranks):
            got = {k: c for k, c in rank["longform"][name]["launches"].items() if c}
            log("longform", f"{name}: rank {r} launches {got} (a chunk and "
                            f"{'the tail window' if padded else 'no tail'}: expected {want})")
            if count and got != want:
                raise AssertionError(f"longform: {name} rank {r} launched {got}, not {want}")
        if count and {k: c for k, c in row["unsharded_launches"].items() if c} != per_call[name]:
            raise AssertionError(f"longform: the unsharded {name} launched "
                                 f"{row['unsharded_launches']}")
    it = ranks[0]["interface"]
    log("longform", f"interface(mesh=..., longform_frames={DIST['iface_longform']}): "
                    f"{it['frames']} frames, durations equal to the plain interface's: "
                    f"{it['durations_equal']}; max_abs_err against its mel vocoded whole "
                    f"{it['err']:.3e} (tolerance {TOL_LONGFORM}); against the plain call's "
                    f"bucket (zeroed frames past the mel), not held: {it['bucket_err']:.3e}; "
                    f"rank 0 {it['seconds']:.2f} s ({card})")
    if not (it["err"] <= TOL_LONGFORM and it["durations_equal"]):
        raise AssertionError("longform: the interface's mesh path disagrees")
    for r, rank in enumerate(ranks):
        got = {k: c for k, c in rank["interface"]["launches"].items() if c}
        log("longform", f"interface: rank {r} launches {got}")
        if count and not (got.get("k1") == 12 and got.get("k2") in (4, 8)):
            raise AssertionError(f"longform: the interface's mesh path launched {got}")
    for rank in ranks:
        for k, c in rank["launches"].items():
            launches[k] += c


def phase_pipelined(dev, launches, card):
    """``PipelinedSynthesizer`` at full width on ``[dev]``: a stream of
    ``pipe_batches`` batches, each wave against its standalone dispatch,
    K1 12 and K2 4 a batch; then ``bench_pipelined_vs_sequential``."""
    t_phase = time.perf_counter()
    torch.manual_seed(SEED)
    model = ToucanTTS(ToucanTTSConfig(**DIST["config"]))
    vocoder = HiFiGANGenerator(**DIST["vocoder"])
    pipe = PipelinedSynthesizer(model, None, vocoder, None, DIST["pipe_frames"], devices=[dev])
    g = torch.Generator().manual_seed(SEED + 153)
    b, t, f = DIST["pipe_batch"], DIST["pipe_phones"], DIST["pipe_frames"]
    batches = [((torch.rand(b, t, 62, generator=g) > 0.5).float(),
                torch.tensor([t, t - 1 - (5 * i) % (t // 2)][:b]), torch.randn(b, 64, generator=g),
                torch.zeros(b, 1, dtype=torch.int64), 0.8 * torch.randn(b, f, 80, generator=g),
                torch.ones(4)) for i in range(DIST["pipe_batches"])]
    reset_counts()
    t0 = time.perf_counter()
    results = list(pipe.synthesize_stream(batches))
    stream_s = time.perf_counter() - t0
    got = {k: w.launches for k, w in WRAPPERS.items()}
    want = {k: 0 for k in WRAPPERS}
    want.update(k1=12 * len(batches), k2=4 * len(batches))
    for k, c in got.items():
        launches[k] += c
    errs = []
    for (wave, lens), batch in zip(results, batches):
        mel, want_lens = pipe.acoustic_fn(*[x.to(dev) for x in batch])
        alone = pipe.vocode_fn(mel).cpu().numpy()
        if not np.array_equal(lens, want_lens.cpu().numpy()):
            raise AssertionError("pipelined: a stream's lengths differ from standalone dispatch")
        errs.append(float(np.abs(wave - alone).max()))
    log("pipelined", f"{len(batches)} batches of {b} x {t} phones, {f} frames on {[str(dev)]} "
                     f"(two_stage={pipe.two_stage}: one card, so both stages share it): "
                     f"stream {stream_s:.2f} s (host clock), launches {got} (expected "
                     f"{ {k: v for k, v in want.items() if v} }); max_abs_err against "
                     f"standalone dispatch {max(errs):.3e} (tolerance {TOL_PIPE}); {card}")
    if DIST["count"] and got != want:
        raise AssertionError(f"pipelined: expected launches {want}, got {got}")
    if not max(errs) <= TOL_PIPE:
        raise AssertionError("pipelined: a streamed wave differs from its standalone dispatch")
    if DIST["count"]:
        bench = bench_pipelined_vs_sequential(dev)
        log("pipelined", "bench_pipelined_vs_sequential (CUDA events; B = 8, 128 phones, 1024 "
                         "frames, 8 batches): " + ", ".join(
                             f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in bench.items())
            + f"; two_stage False: one card, so the stream only hides the host's work "
              f"({card})")
    log("pipelined", f"phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")


def phase_scaling(dev, card):
    """``scaling_bench.measure(1, 1)`` at full width on the card."""
    t0 = time.perf_counter()
    res = measure(1, 1, device=dev, config=ToucanTTSConfig(**DIST["config"]), **DIST["scaling"])
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    log("scaling", f"measure(1, 1): mesh {res['mesh']}, batch {res['batch_size']}, step "
                   f"{1e3 * res['step_seconds']:.2f} ms ({clock}), "
                   f"{res['utterances_per_second']:.2f} utterances/s, "
                   f"{res['mel_frames_per_second']:.1f} mel frames/s per device; card "
                   f"{res['card']}; wall time {time.perf_counter() - t0:.1f} s ({card})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off (matmul.allow_tf32=False, cudnn.allow_tf32=False)", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase_build()
    k1 = phase_k1(dev, gen)
    k1_bf16 = phase_k1_bf16(dev, gen)

    torch.manual_seed(SEED)
    tts = ToucanTTS(ToucanTTSConfig())
    vocoder = HiFiGANGenerator()
    bigvgan = BigVGAN()
    with torch.no_grad():  # log-scale SnakeBeta parameters away from 0
        for name, p in bigvgan.named_parameters():
            if name.endswith(("alpha", "beta")):
                p.copy_(0.3 * torch.randn_like(p))
    tts_sd = {k: v.clone() for k, v in tts.state_dict().items()}
    voc_sd = {k: v.clone() for k, v in vocoder.state_dict().items()}
    big_sd = {k: v.clone() for k, v in bigvgan.state_dict().items()}
    unit = unit_gain_stages(vocoder.to(dev).eval(), gen)
    k2, k2_stage_ms = phase_k2(dev, gen, vocoder, unit)
    k5 = phase_k5(dev, gen)
    k5_bf16 = phase_k5_bf16(dev, gen)
    k3, k3_stage_ms = phase_k3(dev, gen, vocoder, k2_stage_ms)
    k4 = phase_k4(dev, gen, vocoder, k2_stage_ms, k3_stage_ms)
    rows = dict(k1=k1, k2=k2, k3=k3, k4=k4, k5=k5)
    phase_shapes(dev, gen, vocoder, unit, rows)
    phase_widths(dev, gen, rows)
    del unit
    phase_grad_refusal(dev, gen, vocoder)
    phase_other_models(dev)

    launches = dict.fromkeys(WRAPPERS, 0)
    iface = ToucanTTSInterface(tts_sd, voc_sd, seed=SEED)
    ref_wave = phase_main_hifigan(iface, launches)
    phase_graphs(iface, dict(k1=12, k2=4), "hifigan", launches)
    cpu = ToucanTTSInterface(tts_sd, voc_sd, device="cpu", seed=SEED)
    phase_ref("hifigan", iface, cpu, TOL_REF)
    phase_tf32_default(iface)
    phase_clone(iface, cpu, launches, smi)
    phase_controllable(iface, launches, smi)
    b16 = phase_main_bf16("bf16 hifigan", iface, cpu, "hifigan", tts_sd, voc_sd, BF16_HIFIGAN,
                          launches, smi)
    del b16
    phase_precision(tts_sd, voc_sd, iface, launches, smi)
    del cpu
    big = ToucanTTSInterface(tts_sd, big_sd, vocoder="bigvgan", seed=SEED)
    phase_main(big, launches, dict(k1=12, k5=K5_LAUNCHES), "bigvgan")
    phase_graphs(big, dict(k1=12, k5=K5_LAUNCHES), "bigvgan", launches)
    cpu_big = ToucanTTSInterface(tts_sd, big_sd, vocoder="bigvgan", device="cpu", seed=SEED)
    phase_ref("bigvgan", big, cpu_big, TOL_REF)
    b16 = phase_main_bf16("bf16 bigvgan", big, cpu_big, "bigvgan", tts_sd, big_sd,
                          BF16_BIGVGAN, launches, smi)
    del b16, cpu_big
    z = (0.8 * np.random.RandomState(SEED).randn(512, 80)).astype(np.float32)
    check_tf32_default("bigvgan __call__ (wave)",
                       lambda: big("Hello world, this is a test.", glow_noise=z), big._clear_caches)
    del big
    scales = phase_main_int8(iface, launches)
    phase_graphs(iface, dict(k1=12, k3=4), "int8", launches)
    cpu_int8 = ToucanTTSInterface(tts_sd, voc_sd, device="cpu", seed=SEED)
    cpu_int8.quantize_vocoder(act_scales={i: v.cpu() for i, v in scales.items()})
    phase_ref("int8 hifigan", iface, cpu_int8, TOL_REF_INT8, relative=True)
    del iface, cpu_int8

    torch.manual_seed(SEED)
    gst_sd = StyleEmbedding().state_dict()
    default_emb = torch.from_numpy(np.random.RandomState(SEED + 2).randn(64).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_reference_files(tmp, tts_sd, voc_sd, gst_sd, default_emb)
        imcol = phase_main_imcol(paths, ref_wave, launches)
        phase_graphs(imcol, IMCOL_PER_CALL, "imcol", launches)
        cpu_imcol = imcol_interface(paths, device="cpu")
    cpu_imcol.set_utterance_embedding(wave=ref_wave, sr=24000)
    emb_err = float(np.abs(imcol.default_utterance_embedding
                           - cpu_imcol.default_utterance_embedding).max())
    log("ref", f"imcol: embedding of the same wave, card against CPU: max_abs_err={emb_err:.3e} "
               f"(tolerance {TOL_EMB})")
    if not emb_err <= TOL_EMB:
        raise AssertionError("the GST embedding on the card disagrees with the CPU's")
    check_tf32_default("imcol set_utterance_embedding (embedding)", lambda: (
        imcol.set_utterance_embedding(wave=ref_wave, sr=24000),
        imcol.default_utterance_embedding)[1])
    phase_ref("imcol int8 hifigan", imcol, cpu_imcol, TOL_REF_INT8, relative=True)
    del imcol, cpu_imcol
    phase_fastspeech2(launches, smi)
    phase_stochastic(dev, launches, smi)
    phase_train(dev, voc_sd, gst_sd, launches, smi)
    phase_vocoder_train(dev, launches, smi)
    phase_bigvgan_train(dev, launches, smi)
    phase_aligner_train(dev, smi)
    phase_embedding_train(dev, smi)
    phase_wgan_qc(dev, smi)
    ranks = phase_dist_train(smi)
    phase_sharded_ckpt(ranks, smi)
    phase_longform(ranks, launches, smi)
    phase_pipelined(dev, launches, smi)
    phase_scaling(dev, smi)
    log("main", f"launches over the main-path phases: {launches}")

    kernels = [
        dict(name="flash_rel_attention", route="cuda",
             source="toucan_tpu_torch/csrc/flash_rel_attention.cu",
             replaces="toucan_tpu/kernels/pallas_attention.py:109",
             launches=launches["k1"] - launches["k1_bf16"], **k1),
        dict(name="flash_rel_attention_bf16", route="cuda",
             source="toucan_tpu_torch/csrc/flash_rel_attention.cu",
             replaces="toucan_tpu/kernels/pallas_attention.py:109",
             launches=launches["k1_bf16"], **k1_bf16),
        dict(name="hifigan_stage", route="cuda",
             source="toucan_tpu_torch/csrc/hifigan_stage.cu",
             replaces="toucan_tpu/kernels/pallas_resstack.py:122", launches=launches["k2"],
             **k2),
        dict(name="hifigan_stage_q", route="cuda",
             source="toucan_tpu_torch/csrc/hifigan_stage_q.cu",
             replaces="toucan_tpu/kernels/pallas_stage.py:259", launches=launches["k3"],
             **k3),
        dict(name="hifigan_imcol", route="cuda",
             source="toucan_tpu_torch/csrc/hifigan_imcol.cu",
             replaces="toucan_tpu/kernels/pallas_imcol.py:244", launches=launches["k4"],
             **k4),
        dict(name="alias_free_snake", route="cuda",
             source="toucan_tpu_torch/csrc/alias_free_snake.cu",
             replaces="toucan_tpu/kernels/pallas_aliasfree.py:117",
             launches=launches["k5"] - launches["k5_bf16"], **k5),
        dict(name="alias_free_snake_bf16", route="cuda",
             source="toucan_tpu_torch/csrc/alias_free_snake.cu",
             replaces="toucan_tpu/kernels/pallas_aliasfree.py:117",
             launches=launches["k5_bf16"], **k5_bf16),
    ]
    for row in kernels:
        if not row["launches"]:
            raise AssertionError(f"{row['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
