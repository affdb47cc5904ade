"""PortaSpeech-style normalizing-flow PostNet (Glow).

Reference: ``TrainingInterfaces/Text_to_Spectrogram/ToucanTTS/Glow.py``.
Time is squeezed by 2 into channels, then 18 blocks of [ActNorm,
InvConvNear (LU, n_split=4), affine coupling with a WaveNet core] run in
reverse, conditioned on a projection of [mel, text].  The WaveNet cores'
``in_layers`` and ``res_skip_layers`` are shared by every 4 consecutive
blocks (the same module objects, so a state dict lists them under each
block, as the reference's does); ``cond_layer``, ``start`` and ``end`` are
per block.  Everything is (B, T, C), with the JAX package's channel order.
"""

import torch
from torch import nn

from bench_h100.reference.nn.convolution import conv_btc, same_conv


def squeeze(x, mask, n_sqz=2):
    """(B, T, C) -> (B, T//n, n*C); a trailing odd frame is dropped."""
    b, t, c = x.shape
    t = (t // n_sqz) * n_sqz
    x = x[:, :t].reshape(b, t // n_sqz, n_sqz * c)
    mask = mask[:, n_sqz - 1::n_sqz]
    return x * mask, mask


def unsqueeze(x, mask, n_sqz=2):
    b, t, c = x.shape
    x = x.reshape(b, t * n_sqz, c // n_sqz)
    mask = torch.repeat_interleave(mask, n_sqz, dim=1)
    return x * mask, mask


class ActNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x, mask):
        """-> (z, log-det (B,))."""
        logs = self.logs.view(-1)
        z = (self.bias.view(-1) + torch.exp(logs) * x) * mask
        return z, logs.sum() * mask.sum(dim=(1, 2))

    def reverse(self, x, mask):
        return (x - self.bias.view(-1)) * torch.exp(-self.logs.view(-1)) * mask


class InvConvNear(nn.Module):
    """Invertible 1x1 conv over interleaved channel groups, LU-parameterized."""

    def __init__(self, channels: int, n_split: int = 4, n_sqz: int = 2):
        super().__init__()
        self.n_split, self.n_sqz = n_split, n_sqz
        w0, _ = torch.linalg.qr(torch.randn(n_split, n_split))
        if torch.det(w0) < 0:
            w0[:, 0] = -w0[:, 0]
        p, lower, upper = torch.linalg.lu(w0)
        s = torch.diagonal(upper)
        self.register_buffer("p", p)
        self.register_buffer("sign_s", torch.sign(s))
        self.l = nn.Parameter(torch.tril(lower, -1))
        self.log_s = nn.Parameter(torch.log(torch.abs(s)))
        self.u = nn.Parameter(torch.triu(upper, 1))

    def weight(self):
        ns = self.n_split
        l_mask = torch.tril(torch.ones(ns, ns, dtype=self.l.dtype, device=self.l.device), -1)
        eye = torch.eye(ns, dtype=self.l.dtype, device=self.l.device)
        lower = self.l * l_mask + eye
        upper = self.u * l_mask.T + torch.diag(self.sign_s * torch.exp(self.log_s))
        return self.p @ lower @ upper

    def _mix(self, x, weight, mask):
        b, t, c = x.shape
        ns, nq = self.n_split, self.n_sqz
        x = x.reshape(b, t, nq, c // ns, ns // nq).permute(0, 1, 2, 4, 3).reshape(b, t, ns, c // ns)
        z = torch.einsum("btgk,hg->bthk", x, weight)
        z = z.reshape(b, t, nq, ns // nq, c // ns).permute(0, 1, 2, 4, 3).reshape(b, t, c)
        return z * mask

    def forward(self, x, mask):
        """-> (z, log-det (B,)): sum(log_s) (c / n_split) per real frame."""
        c = x.shape[-1]
        logdet = self.log_s.sum() * (c / self.n_split) * mask.sum(dim=(1, 2))
        return self._mix(x, self.weight(), mask), logdet

    def reverse(self, x, mask):
        # inv_ex: no singularity check, so no device sync on the hot path;
        # in f32 whatever the model's dtype, as JAX inverts it
        # (toucan_tpu/nn/glow.py:119), and torch.linalg has no bf16 inverse
        weight = torch.linalg.inv_ex(self.weight().float()).inverse.to(x.dtype)
        return self._mix(x, weight, mask)


class WN(nn.Module):
    """Gated dilated-conv stack; ``in_layers``/``res_skip_layers`` may be shared."""

    def __init__(self, hidden: int, kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int, shared=None):
        super().__init__()
        self.hidden, self.n_layers = hidden, n_layers
        self.cond_layer = nn.Conv1d(gin_channels, 2 * hidden * n_layers, 1)
        if shared is None:
            self.in_layers = nn.ModuleList(
                same_conv(hidden, 2 * hidden, kernel_size, dilation=dilation_rate ** i)
                for i in range(n_layers))
            self.res_skip_layers = nn.ModuleList(
                nn.Conv1d(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1)
                for i in range(n_layers))
        else:
            self.in_layers = shared.in_layers
            self.res_skip_layers = shared.res_skip_layers

    def forward(self, x, mask, g):
        h = self.hidden
        cond = conv_btc(self.cond_layer, g)
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            acts = conv_btc(self.in_layers[i], x) + cond[..., 2 * h * i:2 * h * (i + 1)]
            acts = torch.tanh(acts[..., :h]) * torch.sigmoid(acts[..., h:])
            res_skip = conv_btc(self.res_skip_layers[i], acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * mask


class CouplingBlock(nn.Module):
    def __init__(self, in_channels: int, hidden: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int, shared_wn=None):
        super().__init__()
        self.half = in_channels // 2
        self.start = nn.Conv1d(self.half, hidden, 1)
        self.end = nn.Conv1d(hidden, in_channels, 1)
        nn.init.zeros_(self.end.weight)
        nn.init.zeros_(self.end.bias)
        self.wn = WN(hidden, kernel_size, dilation_rate, n_layers, gin_channels, shared_wn)

    def _scale_shift(self, x_0, mask, g):
        h = conv_btc(self.start, x_0) * mask
        out = conv_btc(self.end, self.wn(h, mask, g))
        return out[..., :self.half], out[..., self.half:]

    def forward(self, x, mask, g):
        """-> (z, log-det (B,))."""
        x_0, x_1 = x[..., :self.half], x[..., self.half:]
        m, logs = self._scale_shift(x_0, mask, g)
        z_1 = (m + torch.exp(logs) * x_1) * mask
        return torch.cat([x_0, z_1], dim=-1), (logs * mask).sum(dim=(1, 2))

    def reverse(self, x, mask, g):
        x_0, x_1 = x[..., :self.half], x[..., self.half:]
        m, logs = self._scale_shift(x_0, mask, g)
        return torch.cat([x_0, (x_1 - m) * torch.exp(-logs) * mask], dim=-1)


class Glow(nn.Module):
    def __init__(self, in_channels: int = 80, hidden_channels: int = 192,
                 kernel_size: int = 5, dilation_rate: int = 1, n_blocks: int = 18,
                 n_layers: int = 4, n_split: int = 4, n_sqz: int = 2,
                 text_condition_channels: int = 192, share_wn_layers: int = 4):
        super().__init__()
        self.n_sqz = n_sqz
        self.in_channels = in_channels
        self.g_proj = same_conv(in_channels + text_condition_channels,
                                text_condition_channels, 5)
        sq_ch = in_channels * n_sqz
        self.flows = nn.ModuleList()
        for b in range(n_blocks):
            shared = None if b % share_wn_layers == 0 else self.flows[-1].wn
            self.flows.append(ActNorm(sq_ch))
            self.flows.append(InvConvNear(sq_ch, n_split, n_sqz))
            self.flows.append(CouplingBlock(sq_ch, hidden_channels, kernel_size,
                                            dilation_rate, n_layers,
                                            text_condition_channels * n_sqz, shared))

    def sample(self, z, mel_out, encoded_texts, nonpadding):
        """Reverse pass: noise z (B, T, 80) -> refined mel (B, T, 80).

        nonpadding (B, T, 1) float zeroes padded frames of the condition.
        """
        g = conv_btc(self.g_proj, torch.cat([mel_out, encoded_texts], dim=-1) * nonpadding)
        x, mask_sq = squeeze(z, nonpadding, self.n_sqz)
        g, _ = squeeze(g, nonpadding, self.n_sqz)
        for i in range(len(self.flows) - 1, -1, -3):
            x = self.flows[i].reverse(x, mask_sq, g)        # coupling
            x = self.flows[i - 1].reverse(x, mask_sq)       # invconv
            x = self.flows[i - 2].reverse(x, mask_sq)       # actnorm
        x, _ = unsqueeze(x, mask_sq, self.n_sqz)
        return x
