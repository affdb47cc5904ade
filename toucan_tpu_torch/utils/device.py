"""Device resolution and the f32 contract of the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def _precision_flags():
    """(object, attribute, f32 value) of the cuDNN and matmul precision
    switches, in the API the caller set them with.  ``allow_tf32`` exists on
    every version this port runs on; once a caller has set the newer
    ``fp32_precision`` switches, PyTorch refuses to read ``allow_tf32``,
    and then those switches (cuDNN conv and RNN, matmul) are used."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    try:
        cudnn.allow_tf32, matmul.allow_tf32
    except RuntimeError:
        return [(obj, "fp32_precision", "ieee") for obj in (cudnn.conv, cudnn.rnn, matmul)]
    return [(cudnn, "allow_tf32", False), (matmul, "allow_tf32", False)]


@contextlib.contextmanager
def f32_precision():
    """Run convs and matmuls in full f32 (no TF32), then restore the
    caller's settings.  PyTorch's default runs f32 convs in TF32 on the
    card; the port's paths, and the kernels held to them, are f32."""
    flags = _precision_flags()
    saved = [getattr(obj, name) for obj, name, _ in flags]
    try:
        for obj, name, value in flags:
            setattr(obj, name, value)
        yield
    finally:
        for (obj, name, _), value in zip(flags, saved):
            setattr(obj, name, value)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU is used only when asked for.

    Raises when no CUDA device is visible and the caller did not pass
    ``device="cpu"``: the port never falls back to the CPU quietly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
