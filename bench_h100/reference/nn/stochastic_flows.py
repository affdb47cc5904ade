"""VITS-style stochastic variance predictor (spline flows), sampling only.

Reference: IMS-Toucan ``StochasticToucanTTS/StochasticVariancePredictor.py:39-116``
and the piecewise rational-quadratic spline it imports: a conditional
normalizing flow over (value, auxiliary) pairs of dilated depth-separable
convs and spline couplings of ``num_bins`` bins with linear tails at
+-``tail_bound``.  (Frozen copy of ``toucan_tpu_torch/nn/stochastic_flows.py``,
cut to ``sample``.)  Layout is (B, T, C); the spline is vectorized
(where-masked).  The module keeps every parameter of the port's, the
posterior flow's too, so that the two load one state dict, though
sampling never runs the posterior.

Departures from IMS-Toucan, all the port's: the reversed flow list drops
the first-trained ConvFlow and keeps the flip in front of the affine, as
IMS-Toucan's ``reverse`` does ("remove a useless vflow"); the DDSConvs
carry no dropout (inference); the noise is given as the N(0, 1) draw
before ``noise_scale``, never drawn here.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference.nn.convolution import conv_btc

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


def inverse_spline(inputs, widths_u, heights_u, derivs_u, tail_bound=5.0):
    """The inverse of the rational-quadratic spline inside [-tail_bound,
    tail_bound], identity outside; ``derivs_u`` has num_bins - 1 entries
    (the end derivatives are pinned at 1)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - MIN_DERIVATIVE) - 1)
    derivs_u = F.pad(derivs_u, (1, 1), value=constant)
    x = torch.where(inside, inputs, torch.zeros_like(inputs))
    num_bins = widths_u.shape[-1]
    cumwidths, widths = _knots(widths_u, -tail_bound, tail_bound, MIN_BIN_WIDTH)
    cumheights, heights = _knots(heights_u, -tail_bound, tail_bound, MIN_BIN_HEIGHT)
    derivatives = MIN_DERIVATIVE + F.softplus(derivs_u)
    bin_idx = _searchsorted(cumheights, x).clamp(0, num_bins - 1)[..., None]

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
    shifted = x - in_cumheights
    a = shifted * slope_sum + in_heights * (in_delta - in_der)
    b = in_heights * in_der - shifted * slope_sum
    c = -in_delta * shifted
    discriminant = b ** 2 - 4 * a * c
    theta = (2 * c) / (-b - torch.sqrt(discriminant.clamp(min=0.0)))
    return torch.where(inside, theta * in_widths + in_cumwidths, inputs)


class FlowLayerNorm(nn.Module):
    """LayerNorm over channels, eps 1e-5, with IMS-Toucan's names."""

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

    def reverse(self, x, mask, g):
        """x (B, T, 2); mask (B, T, 1): the coupling's inverse."""
        x0, x1 = x[..., :1], x[..., 1:]
        h = self.convs(conv_btc(self.pre, x0), mask, g=g)
        h = conv_btc(self.proj, h) * mask
        scale = math.sqrt(self.filter_channels)
        nb = self.num_bins
        x1_out = inverse_spline(x1[..., 0], h[..., :nb] / scale, h[..., nb:2 * nb] / scale,
                                h[..., 2 * nb:], tail_bound=self.tail_bound)
        return torch.cat([x0, x1_out[..., None]], dim=-1) * mask


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def reverse(self, x, mask):
        return (x - self.m.view(-1)) * torch.exp(-self.logs.view(-1)) * mask


class Flip(nn.Module):
    def forward(self, x):
        return x.flip(-1)


def _flow_list(channels: int, kernel_size: int, n_flows: int, num_bins: int,
               tail_bound: float) -> nn.ModuleList:
    flows = nn.ModuleList([ElementwiseAffine(2)])
    for _ in range(n_flows):
        flows.append(ConvFlow(channels, kernel_size, num_bins=num_bins, tail_bound=tail_bound))
        flows.append(Flip())
    return flows


class StochasticVariancePredictor(nn.Module):
    """``sample``: a draw of one value a position."""

    def __init__(self, in_channels: int, kernel_size: int, n_flows: int = 4,
                 cond_channels: Optional[int] = None, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        c = in_channels
        self.pre = nn.Conv1d(c, c, 1)
        self.proj = nn.Conv1d(c, c, 1)
        self.convs = DDSConv(c, kernel_size, 3)
        if cond_channels:
            self.cond = nn.Conv1d(cond_channels, c, 1)
        self.flows = _flow_list(c, kernel_size, n_flows, num_bins, tail_bound)
        # the posterior (training only): kept so that the state dict is the port's
        self.post_pre = nn.Conv1d(1, c, 1)
        self.post_proj = nn.Conv1d(c, c, 1)
        self.post_convs = DDSConv(c, kernel_size, 3)
        self.post_flows = _flow_list(c, kernel_size, 4, num_bins, tail_bound)

    def sample(self, x, mask, g, noise, noise_scale: float):
        """x (B, T, C) encodings; mask (B, T, 1); g (B, 1, E) or None;
        ``noise`` (B, T, 2) the N(0, 1) draw -> (B, T, 1)."""
        x = conv_btc(self.pre, x)
        if g is not None and hasattr(self, "cond"):
            x = x + conv_btc(self.cond, g)
        x = conv_btc(self.proj, self.convs(x, mask)) * mask
        z = noise * noise_scale
        for flow in list(self.flows[1::2])[:0:-1]:
            z = flow.reverse(z.flip(-1), mask, g=x)
        return self.flows[0].reverse(z.flip(-1), mask)[..., :1]
