"""Barlow Twins, triplet and SSIM losses (the reference's ``Utility/diverse_losses.py``).

Counterpart of ``toucan_tpu/train/diverse_losses.py``.  As JAX's
``jnp.std``, the Barlow Twins standardisation takes the population
standard deviation (``torch.std`` defaults to ``correction=1``).
"""

import torch
import torch.nn.functional as F


def _standardize(z):
    """(z - mean) / (population std + 1e-6) over the batch, the std taken
    from the centred values as ``jnp.std`` computes it: its gradient then
    passes through the centring, and sums to 0 over the batch as it does in
    exact arithmetic (``torch.std``'s own backward leaves a sum of ~1e-3 of
    the largest gradient on a batch of near-equal rows)."""
    centred = z - z.mean(0)
    return centred / (centred.square().mean(0).sqrt() + 1e-6)


def barlow_twins_loss(z_a, z_b, lambda_offdiag: float = 5e-3):
    """Cross-correlation identity objective of two views (B, D): the
    on-diagonal term plus ``lambda_offdiag`` x the off-diagonal one."""
    b = z_a.shape[0]
    z_a, z_b = _standardize(z_a), _standardize(z_b)
    c = (z_a.T @ z_b) / b
    diag = torch.diagonal(c)
    return ((diag - 1.0) ** 2).sum() + lambda_offdiag * ((c ** 2).sum() - (diag ** 2).sum())


def triplet_loss(anchor, positive, negative, margin: float = 1.0):
    """Euclidean triplet margin loss (B, D) -> scalar."""
    d_pos = torch.sqrt(((anchor - positive) ** 2).sum(-1) + 1e-12)
    d_neg = torch.sqrt(((anchor - negative) ** 2).sum(-1) + 1e-12)
    return torch.clamp(d_pos - d_neg + margin, min=0.0).mean()


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1, img2, window_size: int = 11, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """Structural similarity of (B, H, W) images, gaussian-windowed, with
    the zero "SAME" padding of the JAX function."""
    window = _gaussian_window(window_size, device=img1.device).to(img1.dtype)[None, None]
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x[:, None], window, padding=pad)[:, 0]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1 = filt(img1 ** 2) - mu1_sq
    sigma2 = filt(img2 ** 2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / \
               ((mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))
    return ssim_map.mean()
