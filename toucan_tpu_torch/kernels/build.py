"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface.  It is compiled at
first use for Hopper (``sm_90a``) into ``toucan_tpu_torch/_build/``, under a
file name that carries a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is not.  ``build`` starts one nvcc per
source, all together, and keeps each compiler's ``-Xptxas -v`` report
(registers, shared memory, spills) in ``build_logs``.
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
