#!/usr/bin/env python3
"""Time K4 (csrc/hifigan_imcol.cu) against variants of itself that undo one
design choice each, at the shapes of HiFiGAN stages 1-3 at 512 mel frames,
in turns on one card, and check that every variant gives the same output.

    python3 scripts/k4_variants.py          # from the repository root, one CUDA card

Variants (each against the launch the wrapper picks):

- ``one_block_per_sm``: clusters only at one block per SM (the stage with
  fewer windows than half the SMs otherwise runs clusters of 4 blocks, two
  to an SM);
- ``no_resident_weights``: every conv staged step by step in two buffers
  (otherwise a conv whose weight steps fit in shared memory is staged once);
- ``no_epilogue_prefetch``: the plain conv's stream loads issued in the
  epilogue (otherwise before the last step's products);
- ``quantize_unroll_4``: 4 float4 loads in flight a thread in the quantize
  pass instead of 8.

The last two are rebuilt from the source with one line changed.  Prints one
line per variant and mode: the ms of each stage, the variant's, and its sum.
"""

import ctypes
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from toucan_tpu_torch.kernels import build  # noqa: E402
from toucan_tpu_torch.kernels import imcol  # noqa: E402
from toucan_tpu_torch.kernels.resstack import pack_stage  # noqa: E402

KS, DIL = (3, 7, 11), (1, 3, 5)
STAGES = ((48 * 512, 128), (192 * 512, 64), (384 * 512, 32))  # (T, C) of stages 1-3
SOURCE = build.SRC_DIR / "hifigan_imcol.cu"
# (text in the source, its replacement) of the rebuilt variants
EDITS = {
    "no_epilogue_prefetch": [
        ("if constexpr (MINB == 1)\n                                   return *",
         "if constexpr (false)\n                                   return *"),
        ("if constexpr (MINB > 1)\n                                   o = *",
         "if constexpr (true)\n                                   o = *")],
    "quantize_unroll_4": [("constexpr int QUNR = 8;", "constexpr int QUNR = 4;")],
}


def time_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_variants(out_dir):
    """{variant: path of its library}, compiled in parallel with the
    source's own library."""
    src = SOURCE.read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    build.build(["hifigan_imcol"])
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def use_library(path):
    """Bind K4's wrapper to the library at ``path`` (None: the source's own)."""
    lib = ctypes.CDLL(str(path or build.library_path("hifigan_imcol")))
    lib.toucan_error_string.restype = ctypes.c_char_p
    lib.toucan_error_string.argtypes = [ctypes.c_int]
    build._libs["hifigan_imcol"] = lib
    imcol._max_clusters_cache.clear()


class Variant:
    """A variant's library and chooser, set for the block of code it guards."""

    def __init__(self, name, libs):
        self.name, self.libs = name, libs

    def __enter__(self):
        self.saved = imcol.TWO_BLOCK_SMEM, imcol._layouts
        if self.name == "one_block_per_sm":
            imcol.TWO_BLOCK_SMEM = 0
        elif self.name == "no_resident_weights":
            layouts = imcol._layouts
            imcol._layouts = lambda mode, c, ks: [lay for lay in layouts(mode, c, ks)
                                                  if lay[2] == 2]
        use_library(self.libs.get(self.name))
        imcol.imcol_tiling.cache_clear()
        return self

    def __exit__(self, *exc):
        imcol.TWO_BLOCK_SMEM, imcol._layouts = self.saved
        use_library(None)
        imcol.imcol_tiling.cache_clear()


def main():
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_variants(str(out_dir))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for t, c in STAGES:
        convs = [(torch.randn(c, c, k, generator=gen, device=dev) / math.sqrt(k * c),
                  0.1 * torch.randn(c, generator=gen, device=dev)) for k in KS for _ in range(6)]
        sw = pack_stage(convs, c, KS, DIL, 0.1)
        cases.append((torch.randn(1, t, c, generator=gen, device=dev), imcol.imcol_fold(c),
                      {m: imcol.prepare_imcol_stage(sw, m) for m in imcol.MODES}))

    def run(mode):
        """(outputs, ms) of each stage."""
        outs, times = [], []
        for x, fold, st in cases:
            outs.append(imcol.imcol_stage(x, st[mode], fold))
            times.append(time_ms(lambda: imcol.imcol_stage(x, st[mode], fold)))
        return outs, times

    status = 0
    for name in ("one_block_per_sm", "no_resident_weights", *EDITS):
        for mode in imcol.MODES:
            base, variant = [], []
            for turn in ("base", "variant", "variant", "base"):
                with Variant(name if turn == "variant" else "base", libs):
                    outs, times = run(mode)
                (variant if turn == "variant" else base).append(times)
                if turn == "base" and len(base) == 1:
                    want = outs
                elif not all(torch.equal(a, b) for a, b in zip(outs, want)):
                    print(f"{name} {mode}: output differs from the chosen launch's")
                    status = 1
            b = [sum(v) / 2 for v in zip(*base)]
            v = [sum(v) / 2 for v in zip(*variant)]
            print(f"{name} {mode}: stage ms chosen {' '.join(f'{x:.3f}' for x in b)} "
                  f"(sum {sum(b):.3f}) variant {' '.join(f'{x:.3f}' for x in v)} "
                  f"(sum {sum(v):.3f})", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
