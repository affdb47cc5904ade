"""Weight-norm and spectral-norm convolutions of the vocoder critics.

Counterpart of ``toucan_tpu/nn/param_norm.py`` (the reference applies
``torch.nn.utils.weight_norm`` to every discriminator conv and
``spectral_norm`` to the first multi-scale discriminator,
``HiFiGAN_Discriminators.py:365-372``).  Weights are in torch's (out,
in/groups, *k) layout:

* ``norm="weight"``: ``weight_v`` and ``weight_g`` (out, 1, ...) as torch's
  weight norm names them; the kernel is ``v * g / max(||v||, 1e-12)`` with
  the norm per output channel, and ``g`` starts at ``||v||``;
* ``norm="spectral"``: ``weight`` divided by its largest singular value,
  estimated as the JAX package does: 30 steps of power iteration on the
  weight with its gradient stopped, from a fixed start vector ``u0``, then
  ``sigma = u . (W v)`` with the gradient.  JAX draws ``u0`` from
  ``PRNGKey(7)``, which a ``torch.Generator`` cannot reproduce: here it is a
  buffer drawn from the generator given at construction (or set by the
  converter), so that two implementations agree only when given the same
  start.  ``torch.nn.utils.spectral_norm`` keeps a persistent ``u`` and runs
  one step a call, which gives another sigma;
* ``norm="none"``: ``weight`` as it is.

``padding="SAME"`` is XLA's: ``out = ceil(T / stride)`` and the total
padding split with ``total // 2`` before and the rest after, which is
asymmetric for strided convs; explicit ``((lo, hi), ...)`` pairs are taken
as they are.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

POWER_STEPS = 30
NORMS = ("weight", "spectral", "none")


def _l2normalize(x, eps: float = 1e-12):
    return x / (torch.linalg.vector_norm(x) + eps)


def same_padding(length: int, kernel: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """XLA's "SAME" (lo, hi) padding of one axis."""
    out = -(-length // stride)
    total = max((out - 1) * stride + dilation * (kernel - 1) + 1 - length, 0)
    return total // 2, total - total // 2


class NormedConv(nn.Module):
    """1-D or 2-D conv with weight norm, spectral norm or none, on (B, C, *spatial)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Sequence[int],
                 stride: Optional[Sequence[int]] = None,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME", groups: int = 1,
                 dilation: Optional[Sequence[int]] = None, norm: str = "weight",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
        self.kernel_size = tuple(kernel_size)
        n = len(self.kernel_size)
        self.stride = tuple(stride or (1,) * n)
        self.dilation = tuple(dilation or (1,) * n)
        self.padding = padding
        self.groups = groups
        self.norm = norm
        shape = (out_channels, in_channels // groups) + self.kernel_size
        w = torch.empty(shape)
        nn.init.normal_(w, 0.0, 1.0 / math.sqrt(math.prod(shape[1:])), generator=generator)
        if norm == "weight":
            self.weight_v = nn.Parameter(w)
            self.weight_g = nn.Parameter(
                torch.linalg.vector_norm(w.reshape(out_channels, -1), dim=1).reshape(
                    (out_channels,) + (1,) * (n + 1)))
        else:
            self.weight = nn.Parameter(w)
        if norm == "spectral":
            self.register_buffer("u0", _l2normalize(torch.randn(out_channels, generator=generator)))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def sigma(self) -> torch.Tensor:
        """The spectral norm's estimate of the largest singular value."""
        w = self.weight.reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            u = _l2normalize(self.u0.to(w.dtype))
            for _ in range(POWER_STEPS):
                v = _l2normalize(w.T @ u)
                u = _l2normalize(w @ v)
        return u @ (w @ v)

    def kernel(self) -> torch.Tensor:
        if self.norm == "weight":
            v = self.weight_v
            norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
            return v * (self.weight_g.reshape(-1) / norm.clamp(min=1e-12)).reshape(
                (-1,) + (1,) * (v.dim() - 1))
        if self.norm == "spectral":
            return self.weight / self.sigma()
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            pads = [same_padding(x.shape[2 + i], k, s, d) for i, (k, s, d) in
                    enumerate(zip(self.kernel_size, self.stride, self.dilation))]
        else:
            pads = self.padding
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(x, self.kernel(), self.bias, self.stride, 0, self.dilation, self.groups)
