"""Padding-mask helpers (reference ``Utility/utils.py:369-434``)."""

import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask, True on real positions."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]
