#!/usr/bin/env python3
"""Time K5 (csrc/alias_free_snake.cu) against variants of itself that undo
one design choice each, at BigVGAN's four stage shapes at 2048 mel frames
(B = 1), in turns on one card, and check every variant's output.

    python3 scripts/k5_variants.py [--parent DIR]   # from the repository root, one CUDA card

Variants (each against the launch the wrapper picks):

- ``scalar``: scalar loads and stores instead of float4;
- ``sinf``: the accurate ``sinf`` instead of the reduced ``__sinf``;
- ``smem_halos``: the halos passed through shared memory (a store, a warp
  barrier, a load) instead of ``__shfl_sync``;
- ``five_blocks_per_sm``: registers for 5 blocks of 4 warps an SM (96 a
  thread, a few values spilled) instead of 4 (128, none spilled);
- ``one_tile``: one chunk of 256 samples a warp, one warp a run, instead
  of runs sized to the card walked by persistent warps;
- ``parent`` (with ``--parent DIR``, another checkout such as the parent
  commit unpacked by ``git archive``): the K5 kernel of DIR, built from its
  source and called through its own C interface.

``sinf``, ``smem_halos`` and ``five_blocks_per_sm`` are rebuilt from the
source with one line changed.  Every variant but ``sinf`` and ``parent``
must give the chosen launch's output bit for bit; those two must stay
within TOL_K5 of the plain version.  Each time is the device time of one
launch: 20 launches captured in a CUDA graph and replayed, so the host's
enqueue rate does not enter it.  Prints one line per variant: the ms of
each stage, chosen and variant (each the mean of two turns: chosen,
variant, variant, chosen), and their sums.
"""

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from toucan_tpu_torch.kernels import aliasfree, build  # noqa: E402
from toucan_tpu_torch.nn.alias_free import resample_filter  # noqa: E402

STAGES = ((8 * 2048, 256), (48 * 2048, 128), (192 * 2048, 64), (384 * 2048, 32))
TOL_K5 = 2e-5
SOURCE = build.SRC_DIR / "alias_free_snake.cu"
# (text in the source, its replacement) of the rebuilt variants
EDITS = {
    "sinf": [("constexpr bool FAST_SINE = true;", "constexpr bool FAST_SINE = false;")],
    "smem_halos": [("constexpr bool SHUFFLE_HALOS = true;",
                    "constexpr bool SHUFFLE_HALOS = false;")],
    "five_blocks_per_sm": [("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 5;")],
}


def graph_ms(fn, iters=20):
    """Device ms of one fn(): iters calls captured in one CUDA graph, the
    graph replayed between two events (after a warm-up on a side stream)."""
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


def build_variants(out_dir, parent):
    """{variant: path of its library}, compiled in parallel with the
    source's own library; ``parent``: another checkout, whose K5 source is
    built as it is."""
    src = SOURCE.read_text()
    sources = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        sources[name] = os.path.join(out_dir, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(text)
    if parent:
        sources["parent"] = os.path.join(parent, "toucan_tpu_torch", "csrc", "alias_free_snake.cu")
    procs = {}
    for name, cu in sources.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    build.build(["alias_free_snake"])
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def parent_snake(lib):
    """The parent kernel's call: x (B, T, C) as the (B, C, T) view, its
    12 taps on the card, one launch over a grid it picks itself."""
    fn = lib.alias_free_snake_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    taps = {}

    def call(x, alpha, beta):
        b, t, c = x.shape
        xt = x.transpose(1, 2).contiguous()
        out = torch.empty_like(xt)
        if x.device not in taps:
            taps[x.device] = resample_filter(x.device)
        err = fn(xt.data_ptr(), alpha.data_ptr(), beta.data_ptr(), taps[x.device].data_ptr(),
                 out.data_ptr(), b, t, c, torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, "parent alias_free_snake")
        return out.transpose(1, 2)
    return call


def use_library(path):
    """Bind K5's wrapper to the library at ``path`` (None: the source's own)."""
    lib = ctypes.CDLL(str(path or build.library_path("alias_free_snake")))
    lib.toucan_error_string.restype = ctypes.c_char_p
    lib.toucan_error_string.argtypes = [ctypes.c_int]
    build._libs["alias_free_snake"] = lib
    aliasfree._slots_cache.clear()


class Variant:
    """A variant's library and geometry, set for the block of code it guards."""

    def __init__(self, name, libs):
        self.name, self.libs = name, libs

    def __enter__(self):
        self.saved = aliasfree.geometry_for
        chosen = aliasfree.geometry_for
        if self.name == "parent":
            return self
        if self.name == "scalar":
            aliasfree.geometry_for = lambda xt: dataclasses.replace(chosen(xt), vector=False)
        elif self.name == "one_tile":
            aliasfree.geometry_for = lambda xt: chosen(xt, persistent=False)
        use_library(self.libs.get(self.name))
        return self

    def __exit__(self, *exc):
        if self.name == "parent":
            return
        aliasfree.geometry_for = self.saved
        use_library(None)


def main():
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--parent", help="another checkout whose K5 to time in turns")
    opts = args.parse_args()
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_variants(str(out_dir), opts.parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for t, c in STAGES:
        alpha = 0.3 * torch.randn(c, generator=gen, device=dev)
        beta = 0.3 * torch.randn(c, generator=gen, device=dev)
        x = torch.randn(1, c, t, generator=gen, device=dev).transpose(1, 2)
        cases.append((x, alpha, beta))

    parent = parent_snake(ctypes.CDLL(libs["parent"])) if opts.parent else None

    def run(snake):
        """(outputs, ms) of each stage."""
        outs, times = [], []
        for x, alpha, beta in cases:
            outs.append(snake(x, alpha, beta))
            times.append(graph_ms(lambda: snake(x, alpha, beta)))
        return outs, times

    status = 0
    for name in ("scalar", *EDITS, "one_tile") + (("parent",) if parent else ()):
        base, variant = [], []
        for turn in ("base", "variant", "variant", "base"):
            with Variant(name if turn == "variant" else "base", libs):
                use = parent if (name, turn) == ("parent", "variant") else None
                outs, times = run(use or aliasfree.alias_free_snake)
            (variant if turn == "variant" else base).append(times)
            if turn == "base" and len(base) == 1:
                want = outs
            elif name in ("sinf", "parent") and turn == "variant":
                err = max((o - aliasfree.alias_free_snake_plain(*case)).abs().max().item()
                          for o, case in zip(outs, cases))
                if not err <= TOL_K5:
                    print(f"{name}: {err:.3e} from the plain version")
                    status = 1
            elif not all(torch.equal(a, b) for a, b in zip(outs, want)):
                print(f"{name}: output differs from the chosen launch's")
                status = 1
            del outs
        b = [sum(v) / 2 for v in zip(*base)]
        v = [sum(v) / 2 for v in zip(*variant)]
        print(f"{name}: stage ms chosen {' '.join(f'{x:.4f}' for x in b)} (sum {sum(b):.4f}) "
              f"variant {' '.join(f'{x:.4f}' for x in v)} (sum {sum(v):.4f})", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
