#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``toucan_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. build: nvcc compiles every kernel of the main path for sm_90a, all at
   once, and prints ptxas's registers / shared memory / spills;
2. k1: the rel-pos flash attention kernel against its plain PyTorch version
   at B=2, H=4, d=48, T in (128, 2048), with its time, the plain version's
   and that of ``scaled_dot_product_attention`` on a materialised bias;
3. k2: the fused HiFiGAN stage kernel against its plain version at the four
   stage shapes of 512 mel frames;
4. main: the full-width model (default ToucanTTSConfig, HiFiGAN 512
   channels, seeded random weights) through ``ToucanTTSInterface``:
   ``__call__`` on ~110 phones, ``__call__`` with explicit durations,
   ``synthesize_batch`` of four sentences and ``read_to_file``; each run
   must launch K1 12 times and K2 4 times per synthesis;
5. ref: the same weights on the CPU (plain versions) against the card, on a
   short input.

It then prints one JSON line of per-kernel numbers, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failure exits
nonzero.  TF32 is off for matmuls and cuDNN so every path is f32.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.kernels.flash_attention import (flash_rel_attention,
                                                      flash_rel_attention_plain)
from toucan_tpu_torch.kernels.resstack import hifigan_stage, hifigan_stage_plain
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator

SEED = 0
F32_PEAK = 67e12      # H100 SXM f32 CUDA-core FLOP/s (NVIDIA data sheet)
HBM_RATE = 3.35e12    # H100 SXM bytes/s
TOL_K1 = 2e-5
TOL_K2 = (2e-4, 2e-3)  # atol, rtol
# the full-width path on the card against the CPU: f32 throughout, but the
# sums run in other orders (cuDNN, the kernels' tiles) through 12 conformer
# blocks and 18 glow blocks
TOL_REF = 1e-3
K2_FRAMES = 512
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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    t0 = time.perf_counter()
    logs = build.build(["flash_rel_attention", "hifigan_stage"])
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line or "spill" in line or "error" in line.lower():
                log("build", f"{name}: {line.strip()}")
    log("build", f"nvcc built {sorted(logs)} for sm_90a in {time.perf_counter() - t0:.1f} s")


def phase_k1(dev, gen):
    b, h, d = 2, 4, 48
    worst, row = 0.0, None
    for t in (128, 2048):
        lens = torch.tensor([t, int(0.7 * t)], dtype=torch.int32, device=dev)
        q_u, q_v, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev) for _ in range(4))
        p = torch.randn(h, 2 * t - 1, d, generator=gen, device=dev)
        args = (q_u, q_v, k, v, p, lens)
        got = flash_rel_attention(*args)
        torch.cuda.synchronize()
        want = flash_rel_attention_plain(*args)
        err = (got - want).abs().max().item()
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
        flops = sum(6 * h * d * t * int(n) for n in lens.tolist())
        nbytes = 4 * (5 * b * h * t * d + h * (2 * t - 1) * d + b)
        bound_ms, bound_by = bound(flops, nbytes)
        log("k1", f"B={b} H={h} T={t} d={d} lengths={lens.tolist()} max_abs_err={err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"(sdpa err {lib_err:.2e}) bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"gflop={flops / 1e9:.2f} achieved_tflops={flops / ms / 1e9:.2f}")
        if not err <= TOL_K1:
            raise AssertionError(f"K1 disagrees with its plain version at T={t}: {err:.3e}")
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
    return dict(row, max_abs_err=worst)


def phase_k2(dev, gen, vocoder):
    frames = K2_FRAMES
    totals = dict(ms=0.0, plain_ms=0.0, flops=0, nbytes=0)
    worst = 0.0
    for i, scale in enumerate((8, 48, 192, 384)):
        sw = vocoder.stage_weights(i)
        c, t = sw.channels, scale * frames
        x = torch.randn(1, t, c, generator=gen, device=dev)
        got = hifigan_stage(x, sw)
        torch.cuda.synchronize()
        want = hifigan_stage_plain(x, sw)
        diff = (got - want).abs()
        err = diff.max().item()
        excess = (diff - TOL_K2[1] * want.abs()).max().item()
        worst = max(worst, err)
        ms = time_ms(lambda: hifigan_stage(x, sw), 3)
        plain_ms = time_ms(lambda: hifigan_stage_plain(x, sw), 3)
        flops = 252 * t * c * c
        nbytes = 4 * (2 * t * c + sw.w.numel() + sw.b.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        log("k2", f"stage {i}: B=1 T={t} C={c} max_abs_err={err:.3e} kernel_ms={ms:.3f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.3f} ({bound_by}) "
                  f"gflop={flops / 1e9:.1f} achieved_tflops={flops / ms / 1e9:.2f}")
        if not excess <= TOL_K2[0]:
            raise AssertionError(f"K2 disagrees with its plain version at stage {i}: {err:.3e}")
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["flops"] += flops
        totals["nbytes"] += nbytes
    bound_ms, bound_by = bound(totals["flops"], totals["nbytes"])
    log("k2", f"four stages of {frames} frames: kernel_ms={totals['ms']:.3f} "
              f"plain_ms={totals['plain_ms']:.3f} bound_ms={bound_ms:.3f}")
    return dict(ms=totals["ms"], plain_ms=totals["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, max_abs_err=worst)


def phase_main(iface, launches):
    """Each run: counts to 0, drive, synchronize, read the counts."""
    def run(name, fn, n_synth, waves_of=lambda out: [out], frame=384):
        flash_rel_attention.launches = hifigan_stage.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        k1, k2 = flash_rel_attention.launches, hifigan_stage.launches
        launches[0] += k1
        launches[1] += k2
        waves = waves_of(out)
        audio = sum(len(w) for w in waves) / 24000
        log("main", f"{name}: latency_s={sec:.4f} audio_s={audio:.3f} "
                    f"audio_s_per_s={audio / sec:.3f} k1_launches={k1} k2_launches={k2}")
        if (k1, k2) != (12 * n_synth, 4 * n_synth):
            raise AssertionError(f"{name}: expected K1 {12 * n_synth}x and K2 {4 * n_synth}x, "
                                 f"got {k1} and {k2}")
        for w in waves:
            if not (len(w) > 0 and len(w) % frame == 0 and np.isfinite(w).all()):
                raise AssertionError(f"{name}: bad wave (len {len(w)})")
        return out

    n = len(iface.text2phone.string_to_features(LONG_TEXT))
    log("main", f"text of {n} phones -> bucket {-(-n // 32) * 32}, {-(-n // 32) * 32 * 16} frames")
    for name in ("call (first)", "call"):
        wave, dur, _, _ = run(name, lambda: iface(LONG_TEXT, return_duration_pitch_energy=True),
                              1, lambda out: out[:1])
        if len(wave) != int(dur.sum()) // 2 * 2 * 384:
            raise AssertionError(f"wave length {len(wave)} for durations summing to {dur.sum()}")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run("call (profiled)", lambda: iface(LONG_TEXT), 1)
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us)
    wave, dur, _, _ = run("call, 8 frames per phone",
                          lambda: iface(LONG_TEXT, durations=np.full(n, 8),
                                        return_duration_pitch_energy=True), 1, lambda out: out[:1])
    if len(wave) != int(dur.sum()) // 2 * 2 * 384:
        raise AssertionError(f"wave length {len(wave)} for durations summing to {dur.sum()}")
    log("main", f"explicit durations: {len(wave) // 384} frames")
    run("synthesize_batch x4", lambda: iface.synthesize_batch(BATCH_TEXTS), 1, list)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.wav")
        # the file joins the waves with silences of 10600 samples
        run("read_to_file x2", lambda: iface.read_to_file(BATCH_TEXTS[:2], path), 2, frame=1)
        log("main", f"read_to_file wrote {os.path.getsize(path)} bytes")


def report_profile(prof, wall_us):
    """Device time by kernel and the device's busy share of one __call__."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log("profile", "no device time in the trace: device breakdown not measured")
        return
    log("profile", f"one __call__: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
                   f"({100 * busy / wall_us:.1f}%), idle {100 - 100 * busy / wall_us:.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        name = e.key
        for short in ("flash_rel_kernel", "stage_kernel"):
            if short in name:
                name = f"{short} (port kernel)"
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {name[:90]}")


def phase_ref(iface, tts_sd, voc_sd):
    """The card against the CPU (plain versions) on the same weights and noise."""
    cpu = ToucanTTSInterface(tts_sd, voc_sd, device="cpu", seed=SEED)
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
        raise AssertionError("predicted durations differ between the card and the CPU")
    mel_err = np.abs(outs["cuda"][1] - outs["cpu"][1]).max()
    z = noise[0, :64]
    w_cuda = iface(text, durations=np.full(n, 2), glow_noise=z)
    w_cpu = cpu(text, durations=np.full(n, 2), glow_noise=z)
    wave_err = np.abs(w_cuda - w_cpu).max() if w_cuda.shape == w_cpu.shape else float("inf")
    log("ref", f"{n} phones: durations equal, mel max_abs_err={mel_err:.3e}, "
               f"wave ({len(w_cuda)} samples, peak {np.abs(w_cpu).max():.3e}) "
               f"max_abs_err={wave_err:.3e}, tolerance {TOL_REF}")
    if not (mel_err <= TOL_REF and wave_err <= TOL_REF):
        raise AssertionError("the card disagrees with the CPU reference")


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

    torch.manual_seed(SEED)
    tts = ToucanTTS(ToucanTTSConfig())
    vocoder = HiFiGANGenerator()
    tts_sd = {k: v.clone() for k, v in tts.state_dict().items()}
    voc_sd = {k: v.clone() for k, v in vocoder.state_dict().items()}
    k2 = phase_k2(dev, gen, vocoder.to(dev).eval())

    iface = ToucanTTSInterface(tts_sd, voc_sd, seed=SEED)
    launches = [0, 0]
    phase_main(iface, launches)
    phase_ref(iface, tts_sd, voc_sd)

    kernels = [
        dict(name="flash_rel_attention", route="cuda",
             source="toucan_tpu_torch/csrc/flash_rel_attention.cu",
             replaces="toucan_tpu/kernels/pallas_attention.py:109", launches=launches[0],
             **k1),
        dict(name="hifigan_stage", route="cuda",
             source="toucan_tpu_torch/csrc/hifigan_stage.cu",
             replaces="toucan_tpu/kernels/pallas_resstack.py:122", launches=launches[1],
             **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
