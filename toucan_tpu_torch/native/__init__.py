"""Native (C++) host-side F0 tracker and resampler, loaded through ctypes.

Counterpart of ``toucan_tpu/native/__init__.py``.  ``f0.cpp`` and
``resample.cpp`` are copies of the JAX package's: a Boersma
autocorrelation + Viterbi pitch tracker that matches
``frontend.pitch.estimate_f0`` frame for frame, up to floating-point
reordering, and is one to two orders of magnitude faster; and a threaded
polyphase windowed-sinc resampler that matches ``frontend.audio``'s numpy
resampler to float32 rounding (double accumulation).  They are host code,
not kernels.  Each is compiled on first use with the host's g++ (plain C
ABI, no pybind11) into the git-ignored ``toucan_tpu_torch/_build/native/``,
under a name that carries a hash of the source.  Without a compiler
``estimate_f0`` and ``resample`` take the numpy paths; ``f0_calls`` and
``resample_calls`` count which path each call took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_LOCK = threading.Lock()
_LIBS: dict = {}
f0_calls = {"native": 0, "numpy": 0}
resample_calls = {"native": 0, "numpy": 0}


def _lib_path(source: str) -> str:
    with open(os.path.join(_HERE, source), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libtoucan{stem}-{digest}.so")


def _compile(source: str, lib_path: str) -> bool:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
           os.path.join(_HERE, source), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, lib_path)
    return True


def _load(source: str, configure):
    """Compile (once, cached by source hash) and load a native library.
    Returns the ctypes library or None when no toolchain is available."""
    with _LOCK:
        if source in _LIBS:
            return _LIBS[source]
        lib = None
        lib_path = _lib_path(source)
        if os.path.exists(lib_path) or _compile(source, lib_path):
            lib = ctypes.CDLL(lib_path)
            configure(lib)
        _LIBS[source] = lib
        return lib


def _configure_f0(lib):
    lib.toucan_estimate_f0.restype = ctypes.c_int
    lib.toucan_estimate_f0.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]


def load_f0_library():
    return _load("f0.cpp", _configure_f0)


def native_f0_available() -> bool:
    return load_f0_library() is not None


def _numpy_f0(audio, sr, hop, fmin, fmax):
    from toucan_tpu_torch.frontend.pitch import estimate_f0 as py_f0

    f0_calls["numpy"] += 1
    return py_f0(audio, sr=sr, hop=hop, fmin=fmin, fmax=fmax)


def estimate_f0(audio, sr: int = 16000, hop: int = 256, fmin: float = 40.0,
                fmax: float = 600.0) -> np.ndarray:
    """Native-path F0 per frame (0 for unvoiced); numpy fallback when the
    toolchain is unavailable.  Same contract as frontend.pitch.estimate_f0."""
    lib = load_f0_library()
    if lib is None:
        return _numpy_f0(audio, sr, hop, fmin, fmax)
    audio = np.ascontiguousarray(audio, dtype=np.float64)
    capacity = max(1, len(audio) // hop + 2)
    out = np.zeros(capacity, dtype=np.float64)
    n = lib.toucan_estimate_f0(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(audio)), ctypes.c_double(sr), ctypes.c_int(hop),
        ctypes.c_double(fmin), ctypes.c_double(fmax),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(capacity))
    if n <= 0:
        return _numpy_f0(audio, sr, hop, fmin, fmax)
    f0_calls["native"] += 1
    return out[:n]


# ------------------------------------------------------------- resample

def _configure_resample(lib):
    lib.toucan_resample_out_len.restype = ctypes.c_int64
    lib.toucan_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.toucan_resample.restype = ctypes.c_int64
    lib.toucan_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
    ]


def load_resample_library():
    return _load("resample.cpp", _configure_resample)


def native_resample_available() -> bool:
    return load_resample_library() is not None


def _numpy_resample(audio, orig_sr, new_sr):
    from toucan_tpu_torch.frontend.audio import resample_numpy

    resample_calls["numpy"] += 1
    return resample_numpy(np.asarray(audio, np.float32), orig_sr, new_sr)


def resample(audio, orig_sr: int, new_sr: int, n_threads: int = 0) -> np.ndarray:
    """Native polyphase sinc resampling of a mono float32 signal (the numpy
    path without g++).  Matches ``frontend.audio.resample_numpy`` to float32
    rounding.  ``n_threads``: 0 lets the library choose."""
    lib = load_resample_library()
    if lib is None:
        return _numpy_resample(audio, orig_sr, new_sr)
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    cap = int(lib.toucan_resample_out_len(len(audio), orig_sr, new_sr)) + 1
    out = np.empty(cap, dtype=np.float32)
    n = lib.toucan_resample(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(len(audio)),
        ctypes.c_int64(orig_sr), ctypes.c_int64(new_sr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(cap),
        ctypes.c_int32(n_threads))
    if n < 0:
        return _numpy_resample(audio, orig_sr, new_sr)
    resample_calls["native"] += 1
    return out[:n]
