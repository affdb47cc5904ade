"""Alias-free SnakeBeta (K5): the CUDA kernel's wrapper and its plain version.

Counterpart of ``toucan_tpu/kernels/pallas_aliasfree.py``.  The kernel is
``csrc/alias_free_snake.cu``; the plain version is
``nn/alias_free.py::alias_free_snake``.  ``alias_free_snake`` launches the
kernel for CUDA tensors and runs the plain version for CPU tensors; any
other device raises.  Unlike the Pallas kernel, which covers the interior
and leaves the edges to its caller, one launch computes every sample,
replicate-padded edges included.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.nn.alias_free import alias_free_snake as alias_free_snake_plain
from toucan_tpu_torch.nn.alias_free import resample_filter

__all__ = ["alias_free_snake", "alias_free_snake_plain"]


@lru_cache(maxsize=None)
def _device_filter(device: torch.device) -> torch.Tensor:
    """The 12 filter taps, copied to each device once."""
    return resample_filter(device)


def _check(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor):
    """What the kernel needs of its inputs; raises ValueError before a launch."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be a (B, T, C) float32 tensor, got {tuple(x.shape)} {x.dtype}")
    b, t, c = x.shape
    for name, p in (("alpha", alpha), ("beta", beta)):
        if p.shape != (c,) or p.dtype != torch.float32 or p.device != x.device \
                or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor on {x.device}")
    if b > 65535 or t < 1:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    build.check_no_grad("alias_free_snake", x=x, alpha=alpha, beta=beta)


def alias_free_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; plain version on a CPU tensor.

    x (B, T, C) f32; alpha, beta (C,) f32 log-scale SnakeBeta parameters.
    The kernel walks time innermost: the (B, T, C) view of a contiguous
    (B, C, T) tensor, as the BigVGAN convs leave it, goes in without a copy;
    any other strides are copied to that layout first.  Returns the (B, T, C)
    view of a contiguous (B, C, T) tensor.  The kernel has no backward: on
    the card a call with grad enabled on an input that requires grad raises
    ValueError.
    """
    if x.device.type == "cpu":
        return alias_free_snake_plain(x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"alias_free_snake takes cuda or cpu tensors, got {x.device}")
    _check(x, alpha, beta)
    b, t, c = x.shape
    xt = x.transpose(1, 2).contiguous()
    taps = _device_filter(x.device)
    out = torch.empty_like(xt)
    lib = build.load("alias_free_snake")
    fn = lib.alias_free_snake_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xt.data_ptr(), alpha.data_ptr(), beta.data_ptr(), taps.data_ptr(),
                 out.data_ptr(), b, t, c, stream)
    build.check(lib, err, "alias_free_snake")
    alias_free_snake.launches += 1
    return out.transpose(1, 2)


alias_free_snake.launches = 0
