"""Speaker-embedding VAE (reference ``Spectrogram_to_Embedding/EmbeddingVAE``).

Counterpart of ``toucan_tpu/models/embedding_vae.py``: a small MLP VAE over
64-dim speaker embeddings for sampling artificial voices.  Same widths and
loss mix: KL + 0.1 L1 + (1 - cosine) + 0.1 MSE; the variance head predicts
in log space.  The noise comes from a ``torch.Generator`` or is given
(``noise``), so a test can inject the JAX package's draws.
"""

import torch
from torch import nn

ENCODER = (64, 32, 32, 32, 32, 16)   # then the bottleneck
DECODER = (16, 32, 32, 64) + (64,) * 10


class EmbeddingVAE(nn.Module):
    def __init__(self, bottleneck_size: int = 16, embedding_dim: int = 64):
        super().__init__()
        self.bottleneck_size = bottleneck_size
        widths = (embedding_dim,) + ENCODER + (bottleneck_size,)
        self.encoder = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.mean = nn.ModuleList(nn.Linear(bottleneck_size, bottleneck_size) for _ in range(2))
        self.log_var = nn.ModuleList(nn.Linear(bottleneck_size, bottleneck_size)
                                     for _ in range(2))
        widths = (bottleneck_size,) + DECODER
        self.decoder = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))

    def encode(self, x):
        """-> (means, log-variances), each (B, bottleneck)."""
        for layer in self.encoder:
            x = torch.tanh(layer(x))
        heads = []
        for head in (self.mean, self.log_var):
            h = torch.tanh(head[0](x))
            heads.append(torch.relu(head[1](h)))
        return tuple(heads)

    def decode(self, z):
        for i, layer in enumerate(self.decoder):
            z = layer(z)
            if i < len(self.decoder) - 1:
                z = torch.tanh(z)
        return z

    def forward(self, target_data=None, noise=None, generator=None,
                noise_scale_during_inference: float = 1.4):
        """With ``target_data`` (B, 64): (reconstruction, KL, reconstruction
        loss), z = mean + exp(log_var) * noise.  Without: one decoded sample
        of z = noise * 1.4 (``noise`` (1, bottleneck), else drawn)."""
        if target_data is not None:
            means, log_var = self.encode(target_data)
            sigma = torch.exp(log_var)
            eps = noise if noise is not None else torch.randn(
                means.shape, generator=generator, device=means.device, dtype=means.dtype)
            recon = self.decode(means + sigma * eps)
            kl = (-torch.log(sigma.clamp(min=1e-8)) + (sigma ** 2 + means ** 2) / 2 - 0.5).mean()
            cos = (recon * target_data).sum(-1) / (
                recon.norm(dim=-1) * target_data.norm(dim=-1)).clamp(min=1e-8)
            rec_loss = (0.1 * (recon - target_data).abs().mean() + 1.0 - cos.mean()
                        + 0.1 * ((recon - target_data) ** 2).mean())
            return recon, kl, rec_loss
        device = next(self.parameters()).device
        z = noise if noise is not None else torch.randn(
            (1, self.bottleneck_size), generator=generator, device=device)
        return self.decode(z * noise_scale_during_inference)
