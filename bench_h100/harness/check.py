"""How ``correct`` is decided: the plain reference judges a sample of what
the timed path served.

For each sampled sentence the reference (``bench_h100/reference``, plain
f32 with TF32 off) makes its own text features, which have to equal the
program frontend's (``features_differ``, exact; limit 0), and then its
family's ``Reference`` (``families/<family>.py``) judges the served
sentence at the shapes the program ran it at, on the noise the program
drew (drawn again from the interface's seed, at the shapes and in the order
the interface drew it), with the inputs the client gave the program where
it gave any.  Each number is the largest over the sample; the cell's
limits (``limits/<cell>.json``) hold each.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from bench_h100.reference.frontend.text import TextFrontend

SAMPLE = 8          # sentences judged a run, the longest among them
FIRST = 64
LANG_EN = 12
CEILING = 1e9       # a number past this (an infinite gap) reads as this


def set_tf32(on: bool):
    """TF32 in cuDNN's convs and cuBLAS's matmuls on or off, in whichever
    API the running PyTorch accepts."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    try:
        cudnn.allow_tf32, matmul.allow_tf32
    except RuntimeError:
        for obj in (cudnn.conv, cudnn.rnn, matmul):
            obj.fp32_precision = "tf32" if on else "ieee"
        return
    cudnn.allow_tf32 = matmul.allow_tf32 = on


def relative_gap(got, want) -> float:
    """Max abs gap of ``got`` from ``want`` over max abs ``want`` (1 where
    their shapes differ)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return 1.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


class ReferenceBase:
    """What every family's ``Reference`` has: the device and the
    reference's frontend.  A family adds ``noise(seed, shapes, wanted)``
    (the program's noise draws in ``wanted``, drawn again), ``synthesize``
    and ``judge(rec, feats, z, given)`` -> (numbers, near-tie)."""

    def __init__(self, device):
        self.device = device
        self.fe = TextFrontend(language="en", use_g2p=True)


class Sample:
    """The requests the check judges: ``SAMPLE - 1`` drawn from the seed
    among the first ``FIRST`` (every window serves those), and the longest
    served (most phones, the first of equals).  A client keeps the waves
    of these alone, so that the window holds no more host memory than a
    user's loop would."""

    def __init__(self, seed: int):
        self.drawn = set(random.Random(seed).sample(range(FIRST), SAMPLE - 1))
        self.longest = None   # (phones, index)

    def offer(self, i: int, phones: int):
        """(keep, drop): whether to keep served request ``i``'s wave, and
        the earlier request whose wave is no longer wanted, or None."""
        if self.longest is None or phones > self.longest[0]:
            drop = self.longest[1] if self.longest and self.longest[1] not in self.drawn else None
            self.longest = (phones, i)
            return True, drop
        return i in self.drawn, None

    def picks(self, records: list) -> list:
        served = {i for i, r in enumerate(records) if "frames" in r}
        out = sorted(i for i in self.drawn if i in served)
        if self.longest is not None and self.longest[1] not in out:
            out.insert(0, self.longest[1])
        return out


def judge(ref, records: list, picks: list, schedule: list, program_features: dict,
          noise_seed: int, noise_shapes: list, given=lambda item: None) -> tuple:
    """(numbers, near-ties): the numbers compared, each the largest over
    the sampled records ``picks``; ``given(item)`` the inputs the client
    gave the program for schedule item ``item``, or None."""
    draws = ref.noise(noise_seed, noise_shapes, {records[i]["noise_index"] for i in picks})
    out = dict(features_differ=0)
    ties = 0
    for i in picks:
        r = records[i]
        feats = ref.fe.string_to_features(schedule[r["item"]][0])
        if not np.array_equal(feats, program_features[i]):
            out["features_differ"] += 1
        numbers, tie = ref.judge(r, feats, draws[r["noise_index"]], given(r["item"]))
        ties += int(tie)
        for k, v in numbers.items():
            out[k] = max(out.get(k, 0.0), v)
    return {k: min(v, CEILING) for k, v in out.items()}, ties
