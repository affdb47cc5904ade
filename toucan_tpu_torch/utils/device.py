"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU is used only when asked for.

    Raises when no CUDA device is visible and the caller did not pass
    ``device="cpu"``: the port never falls back to the CPU quietly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
