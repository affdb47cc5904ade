"""The closed-loop clients that drive the program's entry points: what
every client shares.

A mix names its client (``"client"`` in ``traffic/<mix>.json``), found
as ``clients/<client>.py``, whose ``CLIENT`` is a subclass of ``Client``.
Each client makes the program's buckets, warms up, then runs the window,
and records every request: its sentence, the shapes the program ran it at
(the family's ``record_shapes``), delivered frames, send and done times
and what it returned.  It also tells the control (``harness/control.py``),
which serves the reference in the program's place, at which shapes the
program would have run a sentence, what it gives the program and what it
keeps of the answer.
"""

from __future__ import annotations

import contextlib
import time

SAMPLES_PER_FRAME = 384   # 24 kHz audio, 384 samples a mel frame
SAMPLE_RATE = 24000


def phone_buckets(phone_counts) -> list:
    """The interface's phone buckets of these phone counts, by its own rule."""
    from toucan_tpu_torch.infer.interface import PHONE_BUCKET, _round_up

    return sorted({_round_up(p, PHONE_BUCKET) for p in phone_counts})


class Client:
    """What every client shares: the schedule, the buckets, the warm-up,
    the shapes the program ran and the window loop.  ``st`` is the run's
    ``harness.run.Setup``; without ``iface`` (the control) the client only
    answers ``shapes``, ``given`` and ``served``."""

    # each record's send-to-done time is that sentence's own wait
    sentence_latency = True

    def __init__(self, st, sample, iface=None, span=None):
        self.st, self.schedule, self.mix, self.sample = st, st.schedule, st.mix, sample
        self.iface = iface
        self.span = span or (lambda name: contextlib.nullcontext())
        self.draws, self.steps = [], []
        if iface is not None:
            st.family.record_shapes(iface, self.draws, self.steps)
        self.records = []

    def buckets(self) -> list:
        return phone_buckets(p for _, p in self.schedule)

    def precompile(self):
        """Make the program's buckets of the schedule before any request."""
        self.iface.precompile(phone_buckets=tuple(self.buckets()), batch_sizes=(1,))

    def warm_items(self) -> list:
        """One sentence of each phone bucket the schedule holds."""
        seen = {}
        for i, (_, p) in enumerate(self.schedule):
            seen.setdefault(phone_buckets([p])[0], i)
        return [seen[b] for b in sorted(seen)]

    def shapes(self, item: int) -> tuple:
        """(phone bucket, decoded frames) at which the interface runs
        schedule item ``item`` with predicted durations, by its own rule."""
        from toucan_tpu_torch.infer.interface import FRAMES_PER_PHONE

        pad = phone_buckets([self.schedule[item][1]])[0]
        return pad, pad * FRAMES_PER_PHONE

    def given(self, item: int):
        """What the client gives the program besides the text of schedule
        item ``item`` (durations, pitch, energy), or None."""
        return None

    def served(self, synthesis: dict) -> dict:
        """What a request of this client keeps of a synthesis (the
        reference's, in the control)."""
        return dict(wave=synthesis["wave"], frames=synthesis["frames"])

    def finish(self):
        """Work on the records that waits until the window has closed."""

    def run(self, seconds: float) -> float:
        """Requests until ``seconds`` have passed; returns the window's
        length, from its start to the end of its last request."""
        t0 = time.perf_counter()
        end = t0 + seconds
        i = 0
        while time.perf_counter() < end:
            i = self.request(i)
        return time.perf_counter() - t0

    def _item(self, i):
        return self.schedule[i % len(self.schedule)]

    def _ran(self, rec: dict, draw: int, step: int):
        """Note in ``rec`` the noise draw and the step that served it."""
        rec["noise_index"] = draw
        if draw < len(self.draws):
            rec["noise_shape"] = self.draws[draw]
        if step < len(self.steps):
            rec.update(self.steps[step])
