"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface.  It is compiled at
first use for Hopper (``sm_90a``) into ``toucan_tpu_torch/_build/``, under a
file name that carries a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is not.  ``build`` starts one nvcc per
source, all together, and keeps each compiler's ``-Xptxas -v`` report
(registers, shared memory, spills) in ``build_logs``.

Each wrapper counts its kernel's launches in its ``.launches`` through
``count_launch``: a launch made while the current stream captures a CUDA
graph runs only when the graph is replayed, so it goes to the open
``CaptureTally``, which adds it to the counts at each replay.  A cache whose
tensors a graph reads by address passes them through ``hold``, so that the
graph's tally keeps them alive after the cache drops them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_logs: dict = {}
_libs: dict = {}
_tally = None  # the CaptureTally open around the capture in progress


class CaptureTally:
    """What one CUDA graph's capture recorded: its kernel launches
    {wrapper: count}, and the cached tensors it reads by address
    (``hold``), kept alive as long as the tally.

    Open it (``with``) around the capture; ``replayed()`` after each replay
    adds the launches to the wrappers' ``.launches``.
    """

    def __init__(self):
        self.counts: dict = {}
        self.held: list = []

    def __enter__(self):
        global _tally
        if _tally is not None:
            raise RuntimeError("a capture tally is already open")
        _tally = self
        return self

    def __exit__(self, *exc):
        global _tally
        _tally = None

    def replayed(self):
        for wrapper, n in self.counts.items():
            wrapper.launches += n


def capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def count_launch(wrapper):
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``, or,
    while the current stream is capturing, in the open ``CaptureTally`` (a
    capture with none open, such as a timing loop's, counts nowhere)."""
    if not capturing():
        wrapper.launches += 1
    elif _tally is not None:
        _tally.counts[wrapper] = _tally.counts.get(wrapper, 0) + 1


class LaunchCount:
    """The launches of one instantiation of a kernel (such as K1's on bf16
    inputs), counted by ``count_launch`` beside its wrapper's count of all
    its launches."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self):
        return f"LaunchCount({self.name!r}, launches={self.launches})"


def hold(t: torch.Tensor) -> torch.Tensor:
    """Return ``t``, a tensor from a cache that may later drop it; while a
    capture is open, its graph reads ``t`` by address, so the capture's
    tally keeps ``t`` alive as long as the graph."""
    if _tally is not None and capturing():
        _tally.held.append(t)
    return t


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict:
    """Compile every named source that is not built yet, in parallel.

    Returns {name: ptxas report} for the sources compiled by this call;
    raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    build_logs.update(logs)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.toucan_error_string.restype = ctypes.c_char_p
        lib.toucan_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return _libs[name]


def check_aligned(what: str, **tensors):
    """Raise ValueError unless each tensor starts on a 16-byte boundary.

    The kernels move these with 16-byte accesses (``cp.async``, float4), which
    fault on a misaligned address and leave the CUDA context unusable; a
    contiguous view into a larger buffer can start anywhere.
    """
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary "
                             f"(storage offset {x.storage_offset()}); pass a copy")


def check_no_grad(what: str, **tensors):
    """Raise ValueError if grad is enabled and a tensor requires grad.

    The kernels write their outputs through raw pointers, so an output on
    the card has no autograd graph: a grad-enabled call would train only the
    layers after the kernel, and nothing would say so.  The plain versions,
    which CPU tensors take, stay differentiable.
    """
    if torch.is_grad_enabled():
        needs = [name for name, x in tensors.items() if x.requires_grad]
        if needs:
            raise ValueError(f"{what}: {', '.join(needs)} require grad, and the CUDA kernel "
                             "has no backward; call it under torch.no_grad() or "
                             "torch.inference_mode(), or detach the inputs")


def check(lib: ctypes.CDLL, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.toucan_error_string(err).decode()})")
