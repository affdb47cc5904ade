"""Length regulator: phone-level features -> frame-level features.

Reference: ``Layers/LengthRegulator.py:37-61``.  Frame j of sample b copies
token i with cumsum(ds)[i-1] <= j < cumsum(ds)[i], found by searchsorted;
the output is zero-padded to a fixed ``max_frames``.
"""

import torch


def regulate_durations(ds: torch.Tensor) -> torch.Tensor:
    """The reference's all-zero fallback."""
    # rows whose durations are all zero get 1 everywhere (reference edge case)
    all_zero = ds.sum(1, keepdim=True) == 0
    return torch.where(all_zero, torch.ones_like(ds), ds)


def length_regulate(xs: torch.Tensor, ds: torch.Tensor, max_frames: int) -> torch.Tensor:
    """Expand (B, T, D) by durations (B, T) into (B, max_frames, D); frames
    past the total duration are zero."""
    ends = torch.cumsum(ds.to(torch.int64), dim=1)                      # (B, T)
    frames = torch.arange(max_frames, device=xs.device)
    idx = torch.searchsorted(ends, frames.expand(ends.shape[0], -1).contiguous(), right=True)
    idx = idx.clamp(max=ds.shape[1] - 1)
    out = torch.gather(xs, 1, idx[..., None].expand(-1, -1, xs.shape[-1]))
    valid = frames[None, :] < ends[:, -1:]
    return torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
