"""``override``: one ``__call__`` at a time, as ``call``, each with the
sentence's per-phone durations, pitch and energy given (prosody cloning,
``run_prosody_override.py``: a reference reading's prosody put on a
voice, one sentence at a time).

The inputs are drawn from the run's seed in set-up, for every sentence of
the schedule, with the mix's parameters (``traffic/override.json``,
``durations`` and ``assumed``):

- durations: log(d + 1) ~ N(mu, ``log_spread``), rounded, at most
  ``longest_phone`` frames and 0 on word boundaries, with mu solved so that
  the whole schedule takes the corpus's frames a written word
  (``generator.frames_per_word``), the rate the weights recipe gives the
  predicted durations: every seed then asks for the same frames in all;
- pitch and energy: log-normal around 1, as the model's normalised inputs
  are, with the log spreads under ``assumed``; 0 on word boundaries.

With durations given the interface decodes ``round_up(sum + 2, 64)``
frames (``shapes``), and the vocoder's cut runs them all; the warm-up makes
exactly the buckets of the schedule's (phone bucket, frames) pairs, the
largest first.
"""

from __future__ import annotations

import math

import numpy as np

from bench_h100.clients.call import CallClient
from bench_h100.harness.serve import phone_buckets
from bench_h100.reference.frontend.inventory import feature_index
from bench_h100.traffic import generator

STREAM = 0x6f76   # the inputs' own stream of the seed, apart from the speaker's


def decoded_frames(durations) -> int:
    """The frames the interface decodes for these given durations."""
    return 64 * max(1, math.ceil((int(np.sum(durations)) + 2) / 64))


def draw(st) -> list:
    """[{durations (n,), pitch (n, 1), energy (n, 1)}] of every schedule
    sentence, from the seed."""
    p = {**st.mix["durations"], **st.mix["assumed"]}
    rng = np.random.default_rng([st.seed, STREAM])
    boundary = feature_index()["word-boundary"]
    out = []
    for text, _ in st.schedule:
        free = st.features[text][:, boundary] != 1
        n = len(free)
        z, pitch, energy = (rng.standard_normal(n) for _ in range(3))
        out.append(dict(z=z, free=free,
                        pitch=np.where(free, np.exp(p["pitch_log_spread"] * pitch), 0.0),
                        energy=np.where(free, np.exp(p["energy_log_spread"] * energy), 0.0)))

    def durations(x, mu):
        d = np.clip(np.rint(np.exp(mu + p["log_spread"] * x["z"]) - 1.0), 0, p["longest_phone"])
        return np.where(x["free"], d, 0).astype(np.int64)

    words = sum(len(t.split()) for t, _ in st.schedule)
    target = generator.frames_per_word(st.mix["corpus"]) * words
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = (lo + hi) / 2
        frames = sum(int(durations(x, mid).sum()) for x in out)
        lo, hi = (mid, hi) if frames < target else (lo, mid)
    mu = (lo + hi) / 2
    return [dict(durations=durations(x, mu), pitch=x["pitch"][:, None].astype(np.float32),
                 energy=x["energy"][:, None].astype(np.float32)) for x in out]


class OverrideClient(CallClient):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.inputs = draw(self.st)

    def given(self, item: int):
        return self.inputs[item]

    def shapes(self, item: int) -> tuple:
        pad = phone_buckets([self.schedule[item][1]])[0]
        return pad, decoded_frames(self.inputs[item]["durations"])

    def precompile(self):
        """Nothing: the buckets of given durations are the warm-up's."""

    def warm_items(self) -> list:
        """One sentence of each (phone bucket, frames) pair, the largest
        first, so that the smaller graphs capture into the memory the larger
        left free."""
        seen = {}
        for i in range(len(self.schedule)):
            seen.setdefault(self.shapes(i)[::-1], i)
        return [seen[k] for k in sorted(seen, reverse=True)]


CLIENT = OverrideClient
