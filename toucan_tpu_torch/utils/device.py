"""Device resolution and the precision policy of the port's entry points."""

from __future__ import annotations

import contextlib

import torch

# the JAX interface's names for its matmul precision
# (``toucan_tpu/infer/interface.py``, ``matmul_precision``): "float32" runs
# convs and matmuls in IEEE f32; "default" is what JAX's default precision
# is on an NVIDIA card, TF32 in cuDNN's convs and cuBLAS's matmuls
POLICIES = ("float32", "default")


def _precision_flags():
    """(object, attribute, {policy: value}) of the cuDNN and matmul
    precision switches, in the API the caller set them with.  ``allow_tf32``
    exists on every version this port runs on; once a caller has set the
    newer ``fp32_precision`` switches, PyTorch refuses to read
    ``allow_tf32``, and then those switches (cuDNN conv and RNN, matmul)
    are used."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    try:
        cudnn.allow_tf32, matmul.allow_tf32
    except RuntimeError:
        return [(obj, "fp32_precision", {"float32": "ieee", "default": "tf32"})
                for obj in (cudnn.conv, cudnn.rnn, matmul)]
    return [(obj, "allow_tf32", {"float32": False, "default": True}) for obj in (cudnn, matmul)]


def check_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(f"matmul_precision must be one of {POLICIES}, got {policy!r}")
    return policy


@contextlib.contextmanager
def matmul_precision(policy: str = "float32"):
    """Run cuDNN's convs and cuBLAS's matmuls under ``policy`` ("float32":
    no TF32; "default": TF32 allowed), then restore the caller's settings.
    PyTorch's own default runs f32 convs in TF32 on the card.  The port's
    kernels keep their own arithmetic under either policy: they are not
    library calls."""
    check_policy(policy)
    flags = _precision_flags()
    saved = [getattr(obj, name) for obj, name, _ in flags]
    try:
        for obj, name, values in flags:
            setattr(obj, name, values[policy])
        yield
    finally:
        for (obj, name, _), value in zip(flags, saved):
            setattr(obj, name, value)


def f32_precision():
    """``matmul_precision("float32")``: convs and matmuls in full f32."""
    return matmul_precision("float32")


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
