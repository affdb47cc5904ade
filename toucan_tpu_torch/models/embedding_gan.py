"""Artificial-speaker embedding generator and its slider control.

Counterpart of the serving part of ``toucan_tpu/models/embedding_gan.py``
(reference ``InferenceInterfaces/Controllability/``):

* ``ResNetG``, the WGAN's ResNet generator, renders a speaker embedding
  from a latent through a small square "image" (``wgan/resnet_1.py``), in
  NCHW with the reference's state-dict keys: ``fc``, ``bn1d``,
  ``resnet.{i}`` (an ``Upsample`` after each of the first blocks, at the odd
  indices), ``conv_img`` and ``fc_out``;
* ``GanWrapper``: a bank of latents, and six PCA sliders fitted by least
  squares from the generator's first hidden layer back to the latent
  (``GAN.py:20-77``).  The latents come from a ``torch.Generator`` on the
  device, the generator runs there in batches of 5 000, and the SVD and the
  least squares run in numpy on the host as JAX's do, so that the sliders'
  basis takes the same signs.

The critic and the WGAN-QC trainer are training code and not ported here.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from toucan_tpu_torch.utils.device import f32_precision, resolve_device

PCA_BATCH = 5000
SLIDERS = 6


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResNetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, res_ratio: float = 0.1):
        super().__init__()
        fhidden = min(fin, fout)
        self.res_ratio = res_ratio
        self.conv_0 = nn.Conv2d(fin, fhidden, 3, padding=1, bias=False)
        self.bn2d_0 = nn.BatchNorm2d(fhidden, eps=1e-5)
        self.conv_1 = nn.Conv2d(fhidden, fout, 3, padding=1, bias=False)
        self.bn2d_1 = nn.BatchNorm2d(fout, eps=1e-5)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
            self.bn2d_s = nn.BatchNorm2d(fout, eps=1e-5)

    def forward(self, x):
        x_s = self.bn2d_s(self.conv_s(x)) if self.learned_shortcut else x
        dx = _lrelu(self.bn2d_0(self.conv_0(x)))
        dx = self.bn2d_1(self.conv_1(dx))
        return _lrelu(x_s + self.res_ratio * dx)


class ResNetG(nn.Module):
    def __init__(self, data_dim: int = 64, z_dim: int = 32, size: int = 4, nfilter: int = 64,
                 nfilter_max: int = 512):
        super().__init__()
        s0, nf = 4, nfilter
        self.data_dim, self.z_dim, self.size = data_dim, z_dim, size
        self.nfilter, self.nfilter_max = nfilter, nfilter_max
        nlayers = int(math.log2(size / s0))
        self.s0 = s0
        self.nf0 = min(nfilter_max, nf * 2 ** (nlayers + 1))
        self.fc = nn.Linear(z_dim, self.nf0 * s0 * s0)
        self.bn1d = nn.BatchNorm1d(self.nf0 * s0 * s0, eps=1e-5)
        blocks, fin = [], self.nf0
        for i in range(nlayers, 0, -1):
            nf1 = min(nf * 2 ** i, nfilter_max)
            blocks += [ResNetBlock(fin, nf1), nn.Upsample(scale_factor=2, mode="nearest")]
            fin = nf1
        fout = min(nf, nfilter_max)
        blocks += [ResNetBlock(fin, fout), ResNetBlock(fout, fout)]
        self.resnet = nn.Sequential(*blocks)
        self.conv_img = nn.Conv2d(fout, 3, 3, padding=1)
        self.fc_out = nn.Linear(3 * size * size, data_dim)

    def forward(self, z, return_intermediate: bool = False):
        """z (B, z_dim) -> (B, data_dim); with ``return_intermediate`` also
        the first hidden layer (B, nf0 * 16), which the sliders are fitted on."""
        out = _lrelu(self.bn1d(self.fc(z)))
        intermediate = out
        out = self.resnet(out.view(z.shape[0], self.nf0, self.s0, self.s0))
        out = _lrelu(self.conv_img(out))
        out = self.fc_out(out.reshape(z.shape[0], -1))
        if return_intermediate:
            return out, intermediate.detach()
        return out


def pca_basis(intermediate: np.ndarray, zs: np.ndarray) -> np.ndarray:
    """(6, z_dim): the least-squares map from the top six principal
    components of the hidden layer to the latents (the reference's
    ``torch.pca_lowrank`` default q = 6), in numpy as JAX computes it."""
    mu = intermediate.mean()
    centered = intermediate - mu
    _, _, vt = np.linalg.svd(centered - centered.mean(0), full_matrices=False)
    basis = vt[:SLIDERS].T  # (D, 6)
    x_proj = centered @ basis  # (N, 6)
    u, *_ = np.linalg.lstsq(x_proj, zs, rcond=None)  # (6, z_dim)
    return u


class GanWrapper:
    """Sampler and PCA slider control over a trained embedding generator."""

    def __init__(self, g_state_dict, generator: Optional[ResNetG] = None,
                 num_latents: int = 1100, num_pca_samples: int = 50000, seed: int = 0,
                 device=None, state=None):
        """``g_state_dict`` goes into ``generator`` (default ``ResNetG()``)
        on ``device`` (the card unless "cpu").  ``seed`` seeds the
        ``torch.Generator`` that draws the latent bank and the PCA's
        samples.  ``state``: (z_list, z, U) of another wrapper (arrays, e.g.
        a JAX wrapper's), taken instead of drawing and fitting them, so two
        wrappers can be compared on equal latents."""
        self.device = resolve_device(device)
        self.generator = generator or ResNetG()
        self.generator.load_state_dict(g_state_dict)
        self.generator.to(self.device).eval()
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        if state is not None:
            self.z_list, self.z, self.U = (torch.tensor(np.asarray(a), dtype=torch.float32,
                                                        device=self.device) for a in state)
            return
        self.z_list = torch.randn((num_latents, self.generator.z_dim), generator=self.rng,
                                  device=self.device)
        self.z = self.z_list[0]
        self.U = self._compute_controllability(num_pca_samples)

    def state(self):
        """(z_list, z, U) as numpy, another wrapper's ``state``."""
        return tuple(t.cpu().numpy() for t in (self.z_list, self.z, self.U))

    @f32_precision()
    @torch.no_grad()
    def intermediate(self, z: torch.Tensor) -> torch.Tensor:
        """The generator's first hidden layer for latents z, in batches."""
        return torch.cat([self.generator(z[i:i + PCA_BATCH], return_intermediate=True)[1]
                          for i in range(0, len(z), PCA_BATCH)])

    def _compute_controllability(self, n_samples: int) -> torch.Tensor:
        z = torch.randn((n_samples, self.generator.z_dim), generator=self.rng,
                        device=self.device)
        u = pca_basis(self.intermediate(z).cpu().numpy(), z.cpu().numpy())
        return torch.as_tensor(u, device=self.device)

    def set_latent(self, seed: int):
        self.z = self.z_list[seed % len(self.z_list)]

    def reset_default_latent(self, rng: Optional[torch.Generator] = None):
        """A fresh latent from ``rng`` (default: the wrapper's generator)."""
        self.z = torch.randn((self.generator.z_dim,), generator=rng or self.rng,
                             device=self.device)

    @f32_precision()
    @torch.no_grad()
    def modify_embed(self, slider_vector) -> np.ndarray:
        """z + U^T x -> G(z): a 6-dim slider vector edits the voice."""
        x = torch.as_tensor(np.asarray(slider_vector, np.float32), device=self.device)
        z_new = self.z + self.U.T @ x
        return self.generator(z_new[None])[0].cpu().numpy()
