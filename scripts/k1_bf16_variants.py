#!/usr/bin/env python3
"""Time K1's bf16 kernel (csrc/flash_rel_attention.cu, namespace bf16) at
the shapes the main path gives it and at B = 2, T = 2048, against variants
of its launch and rings, the parent's kernel and SDPA, in turns on one card,
and check every variant's output.

    python3 scripts/k1_bf16_variants.py [--parent DIR]   # from the repository root, one CUDA card

Shapes (H = 4, d = 48, bf16 inputs made from a seed): B = 2, T = 2048,
lengths [2048, 1433]; the decoder, B = 1, T = 2048, every frame valid; the
encoder, B = 1, T = 128, 110 valid phones.

Variants (each against the launch ``bf16_geometry`` picks):

- ``splits=N``: the same kernel with N key splits per query tile (the
  combine kernel after it where N > 1);
- ``kv_stages=2``: a K/V ring of two stages instead of three;
- ``kv_stages=2, p_slots=4``: two K/V stages and four p chunks;
- ``parent`` (with ``--parent DIR``, another checkout such as the parent
  commit unpacked by ``git archive``): the bf16 kernel of DIR, built from
  its source and called through its own C interface;
- ``sdpa``: ``scaled_dot_product_attention`` on the same bf16 q_u, k, v with
  the rel-pos bias and the key mask as a bf16 float mask (built outside the
  timing), the yardstick of PERF.md; the port never calls it.

The ring variants are rebuilt from the source with one line changed.  Every
kernel variant must stay within TOL_K1 of the plain version.  Each time is
the device time of one call: 20 calls captured in a CUDA graph and
replayed, so the host's enqueue rate does not enter it; each variant is the
mean of two turns (chosen, variant, variant, chosen).
"""

import argparse
import ctypes
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from toucan_tpu_torch.kernels import build  # noqa: E402
from toucan_tpu_torch.kernels.flash_attention import (bf16_geometry,  # noqa: E402
                                                      flash_rel_attention,
                                                      flash_rel_attention_plain)

TOL_K1 = 2e-5
H, D = 4, 48
SHAPES = (("B=2 T=2048", 2, 2048, [2048, 1433]), ("decoder", 1, 2048, [2048]),
          ("encoder", 1, 128, [110]))
SPLITS = (1, 2, 3, 4, 8)
SOURCE = build.SRC_DIR / "flash_rel_attention.cu"
# (text in the source, its replacement) of the rebuilt variants
EDITS = {
    "kv_stages=2": [("constexpr int NKV = 3;", "constexpr int NKV = 2;")],
    "kv_stages=2, p_slots=4": [("constexpr int NKV = 3;", "constexpr int NKV = 2;"),
                               ("constexpr int NP = 3;", "constexpr int NP = 4;")],
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


def file_name(variant):
    return "".join(c if c.isalnum() else "_" for c in variant)


def build_variants(out_dir, parent):
    """{variant: path of its library}, compiled in parallel with the
    source's own library; ``parent``: another checkout, whose K1 source is
    built as it is."""
    src = SOURCE.read_text()
    sources = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        sources[name] = os.path.join(out_dir, f"{file_name(name)}.cu")
        with open(sources[name], "w") as f:
            f.write(text)
    if parent:
        sources["parent"] = os.path.join(parent, "toucan_tpu_torch", "csrc",
                                         "flash_rel_attention.cu")
    procs = {}
    for name, cu in sources.items():
        lib = os.path.join(out_dir, f"lib{file_name(name)}.so")
        procs[name] = (lib, subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    build.build(["flash_rel_attention"])
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def this_kernel(lib, splits=None):
    """A call of this source's bf16 entry in ``lib`` with ``splits`` key
    splits (None: ``bf16_geometry``'s), scratch allocated per call as the
    wrapper allocates it."""
    fn = lib.flash_rel_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]

    def call(q_u, q_v, k, v, p, lens):
        b, h, t, d = q_u.shape
        n_kt = -(-t // 64)
        want = bf16_geometry(b, h, t, d).splits if splits is None else splits
        per = -(-n_kt // want)
        count = -(-n_kt // per)
        out = torch.empty(q_u.shape, dtype=torch.float32, device=q_u.device)
        parts = [None, None]
        if count > 1:
            parts = [torch.empty((count, b, h, t, d), device=q_u.device),
                     torch.empty((count, b, h, t, 2), device=q_u.device)]
        err = fn(*(x.data_ptr() for x in (q_u, q_v, k, v, p, lens, out)),
                 *(x if x is None else x.data_ptr() for x in parts), b, h, t, d, count, per,
                 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, "flash_rel_attention_bf16")
        return out
    return call


def parent_kernel(lib):
    """The parent's bf16 entry: (q_u, q_v, k, v, p, lengths, out, B, H, T,
    D, scale, stream), one launch over a grid it picks itself."""
    fn = lib.flash_rel_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]

    def call(q_u, q_v, k, v, p, lens):
        b, h, t, d = q_u.shape
        out = torch.empty(q_u.shape, dtype=torch.float32, device=q_u.device)
        err = fn(*(x.data_ptr() for x in (q_u, q_v, k, v, p, lens, out)), b, h, t, d,
                 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, "parent flash_rel_attention_bf16")
        return out
    return call


def sdpa_call(q_u, q_v, k, v, p, lens):
    """SDPA on the same bf16 inputs, the bias and mask as one bf16 mask."""
    b, h, t, d = q_u.shape
    ar = torch.arange(t, device=q_u.device)
    rel = (t - 1 - ar[:, None] + ar[None, :]).expand(b, h, t, t)
    bias = torch.gather(q_v.float() @ p.float().transpose(-1, -2)[None], -1, rel) / math.sqrt(d)
    bias = bias.masked_fill(~(ar[None, :] < lens[:, None])[:, None, None, :],
                            float("-inf")).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda *_: sdpa(q_u, k, v, attn_mask=bias)


def main():
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--parent", help="another checkout whose K1 bf16 to time in turns")
    opts = args.parse_args()
    if not torch.cuda.is_available():
        print("k1_bf16_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_variants(str(out_dir), opts.parent)
    own = build.load("flash_rel_attention")
    variants = {f"splits={n}": this_kernel(own, n) for n in SPLITS}
    variants.update({name: this_kernel(libs[name]) for name in EDITS})
    if opts.parent:
        variants["parent"] = parent_kernel(libs["parent"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    status = 0
    for label, b, t, lengths in SHAPES:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        xs = [torch.randn(b, H, t, D, generator=gen, device=dev) for _ in range(4)]
        xs.append(torch.randn(H, 2 * t - 1, D, generator=gen, device=dev))
        args_ = (*(x.to(torch.bfloat16) for x in xs), lens)
        want = flash_rel_attention_plain(*args_)
        geo = bf16_geometry(b, H, t, D)
        chosen = lambda *a: flash_rel_attention(*a)  # noqa: E731
        rows = {"sdpa": sdpa_call(*args_), **variants}
        err = (chosen(*args_) - want).abs().max().item()
        print(f"[{label}] B={b} H={H} T={t} d={D} lengths={lengths}: chosen splits={geo.splits} "
              f"grid={geo.grid} max_abs_err={err:.3e}", flush=True)
        if not err <= TOL_K1:
            status = 1
        for name, fn in rows.items():
            if name != "sdpa":
                e = (fn(*args_) - want).abs().max().item()
                if not e <= TOL_K1:
                    status = 1
            else:
                e = (fn().float() - want).abs().max().item()
            a = graph_ms(lambda: chosen(*args_))
            v = graph_ms(lambda: fn(*args_))
            v2 = graph_ms(lambda: fn(*args_))
            a2 = graph_ms(lambda: chosen(*args_))
            print(f"[{label}] {name}: chosen {(a + a2) / 2:.4f} ms ({a:.4f}, {a2:.4f}), "
                  f"variant {(v + v2) / 2:.4f} ms ({v:.4f}, {v2:.4f}), max_abs_err {e:.3e}",
                  flush=True)
    print("k1_bf16_variants: " + ("every kernel variant within TOL_K1" if status == 0 else
                                  "a kernel variant disagrees with the plain version"))
    return status


if __name__ == "__main__":
    sys.exit(main())
