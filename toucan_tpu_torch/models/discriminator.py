"""Spectrogram discriminator (an LSGAN critic over random mel windows).

Counterpart of ``toucan_tpu/models/discriminator.py``; reference
``TrainingInterfaces/Text_to_Spectrogram/ToucanTTS/SpectrogramDiscriminator.py``:
a 2-D conv stack that strides over frequency, on 100-frame windows, with
MSE adversarial losses and feature matching for the generator.  Windows
are (B, 1, T, F) here, as the reference takes them.  ``random_windows``
gathers cyclic windows of the unpadded spectrograms, as the JAX package
does in place of the reference's repeat-doubling loop, with starts drawn
from a ``torch.Generator`` (or given).
"""

import torch
import torch.nn.functional as F
from torch import nn

WINDOW_FRAMES = 100
# (kernel (T, F), stride (T, F)) of the five filters; each pads to keep T
_FILTERS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
            ((3, 3), (1, 1)))


class DiscriminatorNet(nn.Module):
    def __init__(self, window: int = WINDOW_FRAMES, mels: int = 80):
        super().__init__()
        self.filters = nn.ModuleList()
        c_in, freq = 1, mels
        for k, s in _FILTERS:
            self.filters.append(nn.Conv2d(c_in, 32, k, stride=s, padding=(k[0] // 2, k[1] // 2)))
            c_in, freq = 32, (freq + 2 * (k[1] // 2) - k[1]) // s[1] + 1
        self.out = nn.Conv2d(32, 1, 3, padding=1)
        self.fc = nn.Linear(window * freq, 1)

    def forward(self, y):
        """y (B, 1, T, F) -> (score (B, 1), feature maps)."""
        fmaps = [y]
        for conv in self.filters:
            y = conv(y)
            fmaps.append(y)
            y = F.leaky_relu(y, 0.1)
        y = self.out(y)
        fmaps.append(y)
        return self.fc(y.flatten(1)), fmaps


class SpectrogramDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.D = DiscriminatorNet()

    def forward(self, windows):
        return self.D(windows)

    def generator_feedback(self, fake, real):
        """Feature matching plus the LSGAN generator loss.  The critic is
        frozen here, as the reference freezes it: its parameters take no
        gradient from this loss, the fake windows do."""
        self.requires_grad_(False)
        try:
            score_fake, fmap_fake = self.D(fake)
            _, fmap_real = self.D(real)
        finally:
            self.requires_grad_(True)
        fm = sum((f - r.detach()).abs().mean() for f, r in zip(fmap_fake, fmap_real))
        return fm + ((score_fake - 1.0) ** 2).mean()

    def discriminator_loss(self, fake, real):
        """The critic's LSGAN loss on a detached fake."""
        score_fake, _ = self.D(fake.detach())
        score_real, _ = self.D(real)
        return (score_fake ** 2).mean() + ((score_real - 1.0) ** 2).mean()


def random_windows(fake, real, lengths, window: int = WINDOW_FRAMES, generator=None,
                   starts=None):
    """Cyclic ``window``-frame windows of the unpadded spectrograms.

    fake, real (B, L, 80); lengths (B,) -> (B, 1, window, 80) each.  Each
    row starts at ``starts`` (B,) or at a draw uniform in [0, length) from
    ``generator``, and wraps around its true length.
    """
    lengths = lengths.to(torch.int64).clamp(min=1)
    if starts is None:
        u = torch.rand(lengths.shape, generator=generator, device=lengths.device)
        starts = (u * lengths).to(torch.int64).clamp(max=lengths - 1)
    idx = (starts.to(lengths.device)[:, None] + torch.arange(window, device=lengths.device)) \
        % lengths[:, None]
    gather = idx[..., None].expand(-1, -1, fake.shape[-1])
    return (torch.gather(fake, 1, gather)[:, None], torch.gather(real, 1, gather)[:, None])
