#!/usr/bin/env python3
"""Time K2 (csrc/hifigan_stage.cu) stage by stage at a vocoder bucket, and
check each launch against the plain version.

    python3 scripts/k2_stages.py [--root DIR] [--frames 448 512 2048] [--iters 10] [--force-nb 64 32]

``--root`` times another checkout's kernel (such as the parent commit
unpacked by ``git archive``): its package is imported in place of this
one's.  Weights: HiFiGAN's init (512 channels, seed 0) and, for the check
only, the same stages at unit gain (std 1/sqrt(k C), biases 0.1).  For each
stage it prints the kernel's mean device time over ``--iters`` launches
(CUDA events, after two warm-up launches), the achieved TFLOP/s (252 T C^2
flops a stage) against the split-TF32 bound (495 / 3 TFLOP/s), the tiling
the wrapper chose, the variant it launched (where the checkout counts
variants), the rows the convs compute over the rows they deliver (where the
checkout has ``rows_computed_share``) and the error against the plain
version, then one JSON line of it all.  ``--force-nb`` times every stage
again with the chooser held to blocks of that many channels (where the
checkout's ``resstack.BLOCK_CHANNELS`` offers it), to compare the kernel's
instances; the served path never holds it.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch

SPLIT_TF32_PEAK = 495e12 / 3
TOL_K2 = (2e-4, 2e-3)  # atol, rtol
STAGE_SCALES = (8, 48, 192, 384)  # vocoder samples per mel frame at each stage


def time_ms(fn, iters):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, nargs="+", default=[448, 512, 2048])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--force-nb", type=int, nargs="*", default=[])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from toucan_tpu_torch.kernels import resstack
    from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; kernel from {root}", flush=True)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    vocoder = HiFiGANGenerator().to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    share = getattr(resstack, "rows_computed_share", None)
    variants = getattr(resstack.hifigan_stage, "variants", None)
    rows = []

    def run(forced):
        label = f"nb {forced}" if forced else "chosen"
        for frames in args.frames:
            total_ms = total_flops = 0.0
            for i, scale in enumerate(STAGE_SCALES):
                sw = vocoder.stage_weights(i)
                c, t = sw.channels, scale * frames
                if forced and not resstack._block_options(c, sw.kernel_sizes[-1],
                                                          sw.dilations[-1]):
                    print(f"[k2] {label}: stage {i} (C = {c}) has no such block", flush=True)
                    continue
                unit = resstack.pack_stage(
                    [(torch.randn(c, c, k, generator=gen, device=dev) / math.sqrt(k * c),
                      0.1 * torch.randn(c, generator=gen, device=dev))
                     for k in sw.kernel_sizes for _ in range(2 * len(sw.dilations))],
                    c, sw.kernel_sizes, sw.dilations, sw.slope)
                x = torch.randn(1, t, c, generator=gen, device=dev)
                before = dict(variants) if variants is not None else None
                excess = []
                for weights in (sw, unit):
                    got = resstack.hifigan_stage(x, weights)
                    torch.cuda.synchronize()
                    want = resstack.hifigan_stage_plain(x, weights)
                    excess.append(((got - want).abs() - TOL_K2[1] * want.abs()).max().item())
                taken = None if before is None else \
                    [k for k, n in variants.items() if n != before.get(k, 0)]
                ms = time_ms(lambda: resstack.hifigan_stage(x, sw), args.iters)
                flops = 252 * t * c * c
                tl = resstack.tiling_for(x, sw)
                row = dict(forced_nb=forced, frames=frames, stage=i, T=t, C=c, ms=round(ms, 4),
                           tflops=round(flops / ms / 1e9, 2),
                           bound_pct=round(100 * flops / SPLIT_TF32_PEAK / (ms * 1e-3), 2),
                           tiling=dict(vars(tl)), variant=taken,
                           rows_computed=None if share is None else round(
                               share(1, t, tl.tile, sw.kernel_sizes, sw.dilations), 4),
                           excess=[float(f"{e:.3e}") for e in excess])
                rows.append(row)
                print(f"[k2] {label}, {frames} frames, stage {i}: T={t} C={c} {ms:.4f} ms "
                      f"{row['tflops']} TFLOP/s ({row['bound_pct']} % of split TF32) "
                      f"tiling {row['tiling']} variant {taken} rows computed / delivered "
                      f"{row['rows_computed']} excess {row['excess']} (tolerance {TOL_K2[0]})",
                      flush=True)
                if max(excess) > TOL_K2[0]:
                    raise AssertionError(f"K2 disagrees with its plain version: {row}")
                total_ms += ms
                total_flops += flops
            print(f"[k2] {label}, {frames} frames, four stages: {total_ms:.4f} ms, "
                  f"{100 * total_flops / SPLIT_TF32_PEAK / (total_ms * 1e-3):.2f} % of split TF32",
                  flush=True)

    with torch.no_grad():
        run(None)
        for nb in args.force_nb:
            every = getattr(resstack, "BLOCK_CHANNELS", ())
            if nb not in every:
                print(f"[k2] this checkout has no blocks of {nb} channels", flush=True)
                continue
            resstack.BLOCK_CHANNELS = (nb,)
            resstack.stage_tiling.cache_clear()
            resstack._max_clusters_cache.clear()
            run(nb)
            resstack.BLOCK_CHANNELS = every
            resstack.stage_tiling.cache_clear()
            resstack._max_clusters_cache.clear()
    print(json.dumps({"card": smi, "root": root, "stages": rows}), flush=True)


if __name__ == "__main__":
    main()
