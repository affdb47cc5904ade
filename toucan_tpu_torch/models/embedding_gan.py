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

and the WGAN-QC trainer (``wgan/wgan_qc.py``): the critic ``ResNetD``
regresses to the potentials of an exact per-batch optimal transport plan,
whose LP scipy's HiGHS solves on the host, as in JAX.  ``train=True`` runs
the generator's BatchNorms as flax's training call does (batch statistics,
running ones updated), whatever the module's mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from toucan_tpu_torch.nn.convolution import batch_norm
from toucan_tpu_torch.utils.device import f32_precision, resolve_device

PCA_BATCH = 5000
SLIDERS = 6


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResNetBlock(nn.Module):
    """The reference's ResNet block; ``use_bn=False`` (the critic's) gives
    the two 3x3 convs biases and no norms."""

    def __init__(self, fin: int, fout: int, res_ratio: float = 0.1, use_bn: bool = True):
        super().__init__()
        fhidden = min(fin, fout)
        self.res_ratio, self.use_bn = res_ratio, use_bn
        self.conv_0 = nn.Conv2d(fin, fhidden, 3, padding=1, bias=not use_bn)
        self.conv_1 = nn.Conv2d(fhidden, fout, 3, padding=1, bias=not use_bn)
        if use_bn:
            self.bn2d_0 = nn.BatchNorm2d(fhidden, eps=1e-5)
            self.bn2d_1 = nn.BatchNorm2d(fout, eps=1e-5)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
            if use_bn:
                self.bn2d_s = nn.BatchNorm2d(fout, eps=1e-5)

    def _norm(self, name, x, train):
        return batch_norm(getattr(self, name), x, train) if self.use_bn else x

    def forward(self, x, train: bool = False):
        x_s = self._norm("bn2d_s", self.conv_s(x), train) if self.learned_shortcut else x
        dx = _lrelu(self._norm("bn2d_0", self.conv_0(x), train))
        dx = self._norm("bn2d_1", self.conv_1(dx), train)
        return _lrelu(x_s + self.res_ratio * dx)


def _run_blocks(blocks: nn.Sequential, x, train: bool = False):
    for m in blocks:
        x = m(x, train) if isinstance(m, ResNetBlock) else m(x)
    return x


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

    def forward(self, z, return_intermediate: bool = False, train: bool = False):
        """z (B, z_dim) -> (B, data_dim); with ``return_intermediate`` also
        the first hidden layer (B, nf0 * 16), which the sliders are fitted on."""
        out = _lrelu(batch_norm(self.bn1d, self.fc(z), train))
        intermediate = out
        out = _run_blocks(self.resnet, out.view(z.shape[0], self.nf0, self.s0, self.s0), train)
        out = _lrelu(self.conv_img(out))
        out = self.fc_out(out.reshape(z.shape[0], -1))
        if return_intermediate:
            return out, intermediate.detach()
        return out


class ResNetD(nn.Module):
    """The WGAN-QC critic (JAX ``ResNetD``, reference ``ResNet_D``): a
    speaker embedding rendered as a (3, size, size) image, ResNet blocks
    without norms (average pooling between the later ones), one score.
    Keys: ``fc_input``, ``conv_img``, ``resnet.{i}`` (a pool at the odd
    indices after the first two blocks) and ``fc``."""

    def __init__(self, data_dim: int = 64, size: int = 4, nfilter: int = 64,
                 nfilter_max: int = 512):
        super().__init__()
        nf, self.size = nfilter, size
        nlayers = int(math.log2(size / 4))
        self.fc_input = nn.Linear(data_dim, 3 * size * size)
        self.conv_img = nn.Conv2d(3, nf, 3, padding=1)
        fin = min(nf, nfilter_max)
        blocks = [ResNetBlock(fin, fin, use_bn=False)]
        fout = min(nf * 2, nfilter_max)
        blocks.append(ResNetBlock(fin, fout, use_bn=False))
        for i in range(1, nlayers + 1):
            fin, fout = fout, min(nf * 2 ** (i + 1), nfilter_max)
            blocks += [nn.AvgPool2d(3, stride=2, padding=1), ResNetBlock(fin, fout, use_bn=False)]
        self.resnet = nn.Sequential(*blocks)
        self.fc = nn.Linear(fout * 16, 1)

    def forward(self, x):
        """x (B, data_dim) -> (B, 1)."""
        out = _lrelu(self.fc_input(x)).view(x.shape[0], 3, self.size, self.size)
        out = _run_blocks(self.resnet, _lrelu(self.conv_img(out)))
        return self.fc(out.reshape(x.shape[0], -1))


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


# ----------------------------------------------------------------- trainer

@dataclass
class WganQCState:
    generator: ResNetG
    critic: ResNetD
    g_optimizer: torch.optim.Adam
    d_optimizer: torch.optim.Adam
    step: int = 0


def create_wgan_qc_state(generator: Optional[ResNetG] = None, critic: Optional[ResNetD] = None,
                         lr: float = 1e-4, betas=(0.5, 0.999), device=None,
                         seed: int = 0) -> WganQCState:
    """The generator and the critic (new ones drawn from ``seed`` where not
    given) on ``device`` (None: the card), each with optax's Adam (PyTorch's
    Adam computes the same update)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = generator if generator is not None else ResNetG()
        critic = critic if critic is not None else ResNetD()
    generator.to(device).train()
    critic.to(device).train()
    return WganQCState(generator, critic,
                       torch.optim.Adam(generator.parameters(), lr=lr, betas=betas, eps=1e-8),
                       torch.optim.Adam(critic.parameters(), lr=lr, betas=betas, eps=1e-8))


def solve_ot_lp(distance: np.ndarray):
    """Solve the reference's OT dual LP exactly (scipy HiGHS instead of
    cvxopt/GLPK, as the JAX package does): min c^T x s.t. x_r[i] - x_f[j]
    <= d[i, j], with the same zero-mean offset.  Returns (potentials x,
    plan duals z (b, b))."""
    from scipy.optimize import linprog

    b = distance.shape[0]
    c = np.concatenate([-np.ones(b) / b, np.ones(b) / b])
    a_ub = np.zeros((b * b, 2 * b))
    rows = np.arange(b * b)
    a_ub[rows, np.tile(np.arange(b), b)] = 1.0       # constraint rows: for column j, all i
    a_ub[rows, b + np.repeat(np.arange(b), b)] = -1.0
    res = linprog(c, A_ub=a_ub, b_ub=np.asarray(distance).T.reshape(-1), bounds=(None, None),
                  method="highs")
    x = res.x - 0.5 * res.x.sum() / b
    return x, (-res.ineqlin.marginals).reshape(b, b)


def _adam_step(params, grads, optimizer):
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    optimizer.step()


def make_wgan_qc_train_step(gamma: float = 0.1):
    """-> step(state, real_batch, z=None, generator=None, ot=None) -> {D, WD, G}.

    The JAX step's parts in its order: the generator's train-mode sample of
    ``z`` (drawn from ``generator`` where not given; the BatchNorm running
    statistics update), the distance matrix and the LP on the host (or
    ``ot`` = (potentials, real_ordered) given), the critic's step (its
    loss differentiates the critic's input gradient), and the generator's
    step, which runs the train-mode forward again (a second update of the
    statistics, as in JAX).  The losses come back as floats."""

    def train_step(state: WganQCState, real_batch, z=None, generator=None, ot=None):
        gen, critic = state.generator, state.critic
        data_dim = gen.data_dim
        k_const = 1.0 / data_dim
        kr = float(np.sqrt(k_const))
        lam = 2 * kr * gamma * 2
        like = next(gen.parameters())
        real = torch.as_tensor(real_batch, dtype=like.dtype, device=like.device)
        b = real.shape[0]
        if z is None:
            z = torch.randn((b, gen.z_dim), generator=generator, device=real.device,
                            dtype=real.dtype)
        with torch.no_grad():
            fake = gen(z, train=True)
        if ot is None:
            dist = k_const * 0.5 * (real[:, None, :] - fake[None, :, :]).square().sum(-1)
            potentials, plan = solve_ot_lp(dist.double().cpu().numpy())
            ot = (potentials, real.cpu().numpy()[np.argmax(plan, axis=0)])
        target = torch.as_tensor(np.asarray(ot[0]), dtype=real.dtype, device=real.device)
        real_ordered = torch.as_tensor(np.asarray(ot[1]), dtype=real.dtype, device=real.device)

        # the critic
        d_params = list(critic.parameters())
        fake_x = fake.detach().requires_grad_()
        out_real = critic(real)[:, 0]
        out_fake = critic(fake_x)[:, 0]
        l2 = (0.5 * (out_real.mean() - target[:b].mean()) ** 2
              + 0.5 * ((out_fake - target[b:]) ** 2).mean())
        # the critic's samples are independent (no norms), so the gradient
        # of the sum is each sample's input gradient
        grads_x, = torch.autograd.grad(out_fake.sum(), fake_x, create_graph=True)
        gnorm = torch.linalg.vector_norm(grads_x.reshape(b, -1), dim=1)
        diff_norm = torch.linalg.vector_norm((real_ordered - fake).reshape(b, -1), dim=1)
        reg = 0.5 * ((gnorm / (2 * kr) - kr / 2 * diff_norm) ** 2).mean()
        d_loss = l2 + lam * reg
        wd = (out_real.mean() - out_fake.mean()).detach()
        _adam_step(d_params, torch.autograd.grad(d_loss, d_params, allow_unused=True),
                   state.d_optimizer)

        # the generator, against the updated critic
        g_params = list(gen.parameters())
        g_loss = -critic(gen(z, train=True))[:, 0].mean()
        _adam_step(g_params, torch.autograd.grad(g_loss, g_params, allow_unused=True),
                   state.g_optimizer)
        state.step += 1
        return {"D": d_loss.item(), "WD": wd.item(), "G": g_loss.item()}

    return train_step
