"""Learning-rate schedules.

Counterpart of ``toucan_tpu/train/schedules.py``.  Each schedule maps the
number of updates done so far to the rate of the next one, counting from
step + 1 as the reference's torch schedulers do (``Utility/WarmupScheduler.py``),
so the first update runs at the value of step 1.  ``WarmupScheduler`` drives
an optimizer by one of them and saves in a torch scheduler's state dict.
"""

from __future__ import annotations

import torch


def toucan_warmup_schedule(peak_lr: float = 1e-3, warmup_steps: int = 8000,
                           max_steps: int = 80000, floor: float = 1e-7):
    """Linear warmup, then the reference's (very slow) linear decay
    (``Utility/WarmupScheduler.py:23-30``)."""

    def schedule(step):
        step = step + 1
        if step <= warmup_steps:
            return peak_lr * min(step / warmup_steps, 1.0)
        scale = 1.0 - ((step - warmup_steps) / max_steps) / (max_steps / 10)
        return max(peak_lr * scale, floor)

    return schedule


def noam_warmup_schedule(peak_lr: float, warmup_steps: int = 25000):
    """ESPnet WarmupLR (``Utility/WarmupScheduler.py:33-60``)."""

    def schedule(step):
        step = step + 1
        return peak_lr * warmup_steps ** 0.5 * min(step ** -0.5, step * warmup_steps ** -1.5)

    return schedule


class _ScheduleLR(torch.optim.lr_scheduler.LRScheduler):
    """Every group's rate is ``self.rate(updates done)`` (``last_epoch``).
    Subclasses keep only numbers in their state, so a checkpoint loads
    with ``weights_only=True`` (a stored function would not)."""

    def rate(self, step: int) -> float:
        raise NotImplementedError

    def get_lr(self):
        return [self.rate(self.last_epoch) for _ in self.optimizer.param_groups]

    def jump_to(self, step: int):
        """Set the count of updates done to ``step`` (a resumed run)."""
        self.last_epoch = int(step)
        self._last_lr = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, self._last_lr):
            group["lr"] = lr


class WarmupScheduler(_ScheduleLR):
    """``toucan_warmup_schedule(peak_lr, warmup_steps, max_steps)``."""

    def __init__(self, optimizer, peak_lr: float = 1e-3, warmup_steps: int = 8000,
                 max_steps: int = 80000):
        self.peak_lr, self.warmup_steps, self.max_steps = peak_lr, warmup_steps, max_steps
        super().__init__(optimizer)

    def rate(self, step):
        return toucan_warmup_schedule(self.peak_lr, self.warmup_steps, self.max_steps)(step)


class NoamScheduler(_ScheduleLR):
    """``noam_warmup_schedule(peak_lr, warmup_steps)``."""

    def __init__(self, optimizer, peak_lr: float = 1e-3, warmup_steps: int = 25000):
        self.peak_lr, self.warmup_steps = peak_lr, warmup_steps
        super().__init__(optimizer)

    def rate(self, step):
        return noam_warmup_schedule(self.peak_lr, self.warmup_steps)(step)


MILESTONES = (500_000, 1_000_000, 1_200_000, 1_400_000)


def vocoder_schedule(base_lr: float):
    """The vocoders' MultiStepLR: gamma 0.5 at MILESTONES updates."""
    return lambda step: base_lr * 0.5 ** sum(step >= m for m in MILESTONES)


class VocoderScheduler(_ScheduleLR):
    """``vocoder_schedule(lr)`` (``MultiStepLR``'s state would hold a
    ``Counter``, which a weights-only load refuses)."""

    def __init__(self, optimizer, lr: float):
        self.lr = lr
        super().__init__(optimizer)

    def rate(self, step):
        return vocoder_schedule(self.lr)(step)
