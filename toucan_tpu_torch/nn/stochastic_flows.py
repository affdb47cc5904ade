"""VITS-style stochastic variance predictor (spline flows).

Counterpart of ``toucan_tpu/nn/stochastic_flows.py``; reference
``StochasticToucanTTS/StochasticVariancePredictor.py``: a conditional
normalizing flow over (value, auxiliary) pairs built from dilated
depth-separable convs and piecewise rational-quadratic spline couplings
with linear tails at +-5, and a posterior flow giving the variational bound
in training.  Layout is (B, T, C); the spline is vectorized (where-masked,
as JAX's).  Parameter names are the reference's state-dict keys: the flow
lists hold ``ElementwiseAffine`` at 0, then ``ConvFlow`` and ``Flip`` in
turns (``flows.{2i+1}`` the i-th ConvFlow), and the DDSConv norms keep the
reference's ``gamma``/``beta``.  Noise comes from a ``torch.Generator`` or
is given as a tensor (the standard-normal draw, before any scale), so a
test can inject the draws of the JAX package.  The DDSConvs carry no
dropout: the JAX predictor never enables theirs.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from toucan_tpu_torch.nn.convolution import conv_btc

MIN_BIN_WIDTH = 1e-3
MIN_BIN_HEIGHT = 1e-3
MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations, inputs, eps=1e-6):
    """The bin of each input; the last edge is moved up by ``eps`` so an
    input on the right edge falls in the last bin."""
    last = bin_locations[..., -1:] + eps
    bin_locations = torch.cat([bin_locations[..., :-1], last], dim=-1)
    return (inputs[..., None] >= bin_locations).sum(-1) - 1


def _knots(unnormalized, low, high, minimum):
    """Bin sizes from logits: softmax, floored at ``minimum``, cumulated
    over [low, high] with the end knots pinned."""
    n = unnormalized.shape[-1]
    sizes = minimum + (1 - minimum * n) * torch.softmax(unnormalized, dim=-1)
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (high - low) * cum + low
    cum = torch.cat([torch.full_like(cum[..., :1], low), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], high)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(inputs, widths_u, heights_u, derivs_u, inverse=False,
                              left=0.0, right=1.0, bottom=0.0, top=1.0):
    """-> (outputs, log|det|); ``derivs_u`` has num_bins + 1 entries."""
    num_bins = widths_u.shape[-1]
    cumwidths, widths = _knots(widths_u, left, right, MIN_BIN_WIDTH)
    cumheights, heights = _knots(heights_u, bottom, top, MIN_BIN_HEIGHT)
    derivatives = MIN_DERIVATIVE + F.softplus(derivs_u)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = bin_idx.clamp(0, num_bins - 1)[..., None]

    def take(arr):
        return torch.gather(arr, -1, bin_idx)[..., 0]

    in_cumwidths = take(cumwidths[..., :-1])
    in_widths = take(widths)
    in_cumheights = take(cumheights[..., :-1])
    in_delta = take(heights / widths)
    in_der = take(derivatives[..., :-1])
    in_der_plus = take(derivatives[..., 1:])
    in_heights = take(heights)
    slope_sum = in_der + in_der_plus - 2 * in_delta

    if inverse:
        shifted = inputs - in_cumheights
        a = shifted * slope_sum + in_heights * (in_delta - in_der)
        b = in_heights * in_der - shifted * slope_sum
        c = -in_delta * shifted
        discriminant = b ** 2 - 4 * a * c
        theta = (2 * c) / (-b - torch.sqrt(discriminant.clamp(min=0.0)))
        outputs = theta * in_widths + in_cumwidths
    else:
        theta = (inputs - in_cumwidths) / in_widths
    theta_1m = theta * (1 - theta)
    denom = in_delta + slope_sum * theta_1m
    der_num = in_delta ** 2 * (in_der_plus * theta ** 2 + 2 * in_delta * theta_1m
                               + in_der * (1 - theta) ** 2)
    logabsdet = torch.log(der_num.clamp(min=1e-12)) - 2 * torch.log(denom.clamp(min=1e-12))
    if inverse:
        return outputs, -logabsdet
    numerator = in_heights * (in_delta * theta ** 2 + in_der * theta_1m)
    return in_cumheights + numerator / denom, logabsdet


def unconstrained_rational_quadratic_spline(inputs, widths_u, heights_u, derivs_u,
                                            inverse=False, tail_bound=5.0):
    """The spline inside [-tail_bound, tail_bound], identity outside."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - MIN_DERIVATIVE) - 1)
    derivs_u = F.pad(derivs_u, (1, 1), value=constant)
    safe_inputs = torch.where(inside, inputs, torch.zeros_like(inputs))
    out_in, lad_in = rational_quadratic_spline(
        safe_inputs, widths_u, heights_u, derivs_u, inverse,
        left=-tail_bound, right=tail_bound, bottom=-tail_bound, top=tail_bound)
    return (torch.where(inside, out_in, inputs),
            torch.where(inside, lad_in, torch.zeros_like(lad_in)))


class FlowLayerNorm(nn.Module):
    """LayerNorm over channels, eps 1e-5, with the reference's names."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.gamma, self.beta, 1e-5)


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack with GELU and LayerNorm."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int):
        super().__init__()
        self.convs_sep = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, groups=channels,
                      dilation=kernel_size ** i, padding=(kernel_size ** i * (kernel_size - 1)) // 2)
            for i in range(n_layers))
        self.convs_1x1 = nn.ModuleList(nn.Conv1d(channels, channels, 1) for _ in range(n_layers))
        self.norms_1 = nn.ModuleList(FlowLayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(FlowLayerNorm(channels) for _ in range(n_layers))

    def forward(self, x, mask, g=None):
        if g is not None:
            x = x + g
        for sep, pw, n1, n2 in zip(self.convs_sep, self.convs_1x1, self.norms_1, self.norms_2):
            y = F.gelu(n1(conv_btc(sep, x * mask)))
            x = x + F.gelu(n2(conv_btc(pw, y)))
        return x * mask


class ConvFlow(nn.Module):
    def __init__(self, filter_channels: int, kernel_size: int, n_layers: int = 3,
                 num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.filter_channels, self.num_bins, self.tail_bound = filter_channels, num_bins, tail_bound
        self.pre = nn.Conv1d(1, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = nn.Conv1d(filter_channels, num_bins * 3 - 1, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, mask, g=None, reverse: bool = False):
        """x (B, T, 2); mask (B, T, 1) -> x, or (x, log-det (B,)) forward."""
        x0, x1 = x[..., :1], x[..., 1:]
        h = self.convs(conv_btc(self.pre, x0), mask, g=g)
        h = conv_btc(self.proj, h) * mask
        scale = math.sqrt(self.filter_channels)
        nb = self.num_bins
        x1_out, logabsdet = unconstrained_rational_quadratic_spline(
            x1[..., 0], h[..., :nb] / scale, h[..., nb:2 * nb] / scale, h[..., 2 * nb:],
            inverse=reverse, tail_bound=self.tail_bound)
        x_out = torch.cat([x0, x1_out[..., None]], dim=-1) * mask
        if reverse:
            return x_out
        return x_out, (logabsdet[..., None] * mask).sum(dim=(1, 2))


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, mask, reverse: bool = False):
        m, logs = self.m.view(-1), self.logs.view(-1)
        if reverse:
            return (x - m) * torch.exp(-logs) * mask
        return (m + torch.exp(logs) * x) * mask, (logs * mask).sum(dim=(1, 2))


class Flip(nn.Module):
    def forward(self, x):
        return x.flip(-1)


def _flow_list(channels: int, kernel_size: int, n_flows: int) -> nn.ModuleList:
    flows = nn.ModuleList([ElementwiseAffine(2)])
    for _ in range(n_flows):
        flows.append(ConvFlow(channels, kernel_size))
        flows.append(Flip())
    return flows


def _normal(shape, like, noise, generator):
    if noise is not None:
        return noise.to(like.dtype)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


class StochasticVariancePredictor(nn.Module):
    """``nll``: per-sample NLL of targets w (B, T, 1); ``sample``: a draw."""

    def __init__(self, in_channels: int, kernel_size: int, n_flows: int = 4,
                 cond_channels: Optional[int] = None):
        super().__init__()
        c = in_channels
        self.pre = nn.Conv1d(c, c, 1)
        self.proj = nn.Conv1d(c, c, 1)
        self.convs = DDSConv(c, kernel_size, 3)
        if cond_channels:
            self.cond = nn.Conv1d(cond_channels, c, 1)
        self.flows = _flow_list(c, kernel_size, n_flows)
        self.post_pre = nn.Conv1d(1, c, 1)
        self.post_proj = nn.Conv1d(c, c, 1)
        self.post_convs = DDSConv(c, kernel_size, 3)
        self.post_flows = _flow_list(c, kernel_size, 4)

    def _condition(self, x, mask, g):
        x = conv_btc(self.pre, x)
        if g is not None and hasattr(self, "cond"):
            x = x + conv_btc(self.cond, g.detach())
        return conv_btc(self.proj, self.convs(x, mask)) * mask

    def nll(self, x, mask, w, g=None, noise=None, generator=None):
        """x (B, T, C) encodings; mask (B, T, 1); w (B, T, 1) targets; g
        (B, 1, E) or None; ``noise`` (B, T, 2) the posterior's N(0, 1) draw,
        else drawn from ``generator``.  -> (B,)."""
        x = self._condition(x, mask, g)
        h_w = conv_btc(self.post_proj, self.post_convs(conv_btc(self.post_pre, w), mask)) * mask
        e_q = _normal(w.shape[:2] + (2,), w, noise, generator) * mask
        z_q, logdet_q = self.post_flows[0](e_q, mask)
        for flow in self.post_flows[1::2]:
            z_q, ld = flow(z_q, mask, g=x + h_w)
            logdet_q = logdet_q + ld
            z_q = z_q.flip(-1)
        z_u, z1 = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * mask
        z0 = (w - u) * mask
        logdet_q = logdet_q + ((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * mask).sum(dim=(1, 2))
        logq = (-0.5 * (math.log(2 * math.pi) + e_q ** 2) * mask).sum(dim=(1, 2)) - logdet_q

        y0 = torch.log(z0.clamp(min=1e-6)) * mask
        z, ld = self.flows[0](torch.cat([y0, z1], dim=-1), mask)
        logdet = -y0.sum(dim=(1, 2)) + ld
        for flow in self.flows[1::2]:
            z, ld = flow(z, mask, g=x)
            logdet = logdet + ld
            z = z.flip(-1)
        nll = (0.5 * (math.log(2 * math.pi) + z ** 2) * mask).sum(dim=(1, 2)) - logdet
        return nll + logq

    def sample(self, x, mask, g=None, noise=None, generator=None, noise_scale: float = 0.3):
        """-> (B, T, 1); ``noise`` (B, T, 2) the N(0, 1) draw before
        ``noise_scale``.  The reversed flow list drops the first-trained
        ConvFlow ("remove a useless vflow") and keeps the flip in front of
        the affine (``toucan_tpu/nn/stochastic_flows.py:286-296``)."""
        x = self._condition(x, mask, g)
        z = _normal(x.shape[:2] + (2,), x, noise, generator) * noise_scale
        for flow in list(self.flows[1::2])[:0:-1]:
            z = flow(z.flip(-1), mask, g=x, reverse=True)
        return self.flows[0](z.flip(-1), mask, reverse=True)[..., :1]
