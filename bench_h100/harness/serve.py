"""The system under test: ``toucan_tpu_torch``'s ``ToucanTTSInterface``, and
the closed-loop clients that drive its entry points.

A mix names its client (``"client"`` in ``traffic/<mix>.json``):
``call`` sends one sentence to ``__call__`` and the next when the wave is
on the host; ``read_to_file`` sends pages of ``page`` consecutive
sentences to ``read_to_file``, back to back, each written to one WAV file
under the temporary directory.  Each client warms up, then runs the window,
and records every request: its sentence, the shapes the program ran it at
(``record_shapes``), delivered frames, send and done times and what it
returned.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time

import numpy as np

SAMPLES_PER_FRAME = 384   # 24 kHz audio, 384 samples a mel frame
SAMPLE_RATE = 24000
JOIN_SILENCE = 10600    # read_to_file's silence between sentences, in samples


def build_interface(config: dict, tts_sd, voc_sd, embedding, seed: int, device):
    """The program, from the reference's state dicts."""
    from toucan_tpu_torch.infer.interface import VOCODERS, ToucanTTSInterface
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig

    vocoder = VOCODERS[config["vocoder"]](**config["vocoder_config"])
    return ToucanTTSInterface(tts_sd, voc_sd, config=ToucanTTSConfig(**config["acoustic"]),
                              vocoder=vocoder, default_embedding=embedding, language="en",
                              use_g2p=True, seed=seed, device=device,
                              matmul_precision=config["matmul_precision"])


def record_shapes(iface, draws: list, steps: list):
    """Log on the host, in order, the shape of every glow-noise buffer the
    interface fills (``draws``) and the shapes of every step it runs
    (``steps``): the rows and phone bucket of its text, the frames its
    acoustic model decoded and the frames its vocoder ran, read from the
    outputs it hands back.  Nothing waits for the device."""
    draw, step = iface._draw_noise, iface._run_e2e

    def logged_draw(buf):
        draws.append(tuple(buf.shape))
        return draw(buf)

    def logged_step(max_frames, noise=None, **inputs):
        outs = step(max_frames, noise, **inputs)
        wave, after = outs[0], outs[1]
        steps.append(dict(rows=wave.shape[0], phone_bucket=inputs["text"].shape[1],
                          decoder_frames=after.shape[1],
                          vocoder_frames=wave.shape[-1] // SAMPLES_PER_FRAME))
        return outs

    iface._draw_noise, iface._run_e2e = logged_draw, logged_step


def phone_buckets(phone_counts) -> list:
    """The interface's phone buckets of these phone counts, by its own rule."""
    from toucan_tpu_torch.infer.interface import PHONE_BUCKET, _round_up

    return sorted({_round_up(p, PHONE_BUCKET) for p in phone_counts})


class Client:
    """What every client shares: the schedule, the warm-up, the shapes the
    program ran (``record_shapes``) and the window loop."""

    def __init__(self, iface, schedule: list, mix: dict, sample, span=None):
        self.iface, self.schedule, self.mix, self.sample = iface, schedule, mix, sample
        self.span = span or (lambda name: contextlib.nullcontext())
        self.draws, self.steps = [], []
        record_shapes(iface, self.draws, self.steps)
        self.records = []

    def buckets(self) -> list:
        return phone_buckets(p for _, p in self.schedule)

    def warm_items(self) -> list:
        """One sentence of each phone bucket the schedule holds."""
        seen = {}
        for i, (_, p) in enumerate(self.schedule):
            seen.setdefault(phone_buckets([p])[0], i)
        return [seen[b] for b in sorted(seen)]

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


class CallClient(Client):
    """One ``__call__`` at a time (the interactive demo, a screen reader)."""

    def warm(self):
        for i in self.warm_items():
            self._call(i)

    def _call(self, i):
        return self.iface(self._item(i)[0], return_duration_pitch_energy=True)

    def request(self, i):
        text, phones = self._item(i)
        draw, step = len(self.draws), len(self.steps)
        rec = dict(item=i % len(self.schedule), phones=phones, t_send=time.perf_counter())
        try:
            with self.span("bench.request"):
                wave, dur, pitch, energy = self._call(i)
        except Exception as exc:  # a failed request counts, the loop goes on
            rec.update(error=repr(exc))
        else:
            rec.update(durations=dur, pitch=pitch, energy=energy,
                       frames=len(wave) // SAMPLES_PER_FRAME)
            keep, drop = self.sample.offer(len(self.records), phones)
            if keep:
                rec["wave"] = wave
            if drop is not None:
                del self.records[drop]["wave"]
        rec["t_done"] = time.perf_counter()
        self._ran(rec, draw, step)
        self.records.append(rec)
        return i + 1


class ReadToFileClient(Client):
    """Pages of consecutive sentences through ``read_to_file`` (an
    audiobook or a synthetic corpus)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.path = os.path.join(tempfile.gettempdir(), "bench_h100_read_aloud.wav")
        self.page = self.mix["page"]
        self.pages = []

    def warm(self):
        items = self.warm_items()
        self._read(items)

    def _read(self, items):
        return self.iface.read_to_file([self._item(i)[0] for i in items], self.path)

    def request(self, i):
        items = list(range(i, i + self.page))
        page = dict(items=items, first_draw=len(self.draws), first_step=len(self.steps),
                    t_send=time.perf_counter())
        try:
            with self.span("bench.request"):
                page["wav"] = self._read(items)
        except Exception as exc:  # a failed page counts, the loop goes on
            page["error"] = repr(exc)
        page["t_done"] = time.perf_counter()
        self.pages.append(page)
        return i + self.page

    def finish(self):
        """Split each page's WAV samples into its sentences' records (after
        the window: the split is the benchmark's work, not the program's)."""
        for n, page in enumerate(self.pages):
            pieces = (split_pages(page["wav"], len(page["items"])) if "wav" in page
                      else [None] * len(page["items"]))
            for k, (j, piece) in enumerate(zip(page["items"], pieces)):
                text, phones = self._item(j)
                rec = dict(item=j % len(self.schedule), phones=phones, t_send=page["t_send"],
                           t_done=page["t_done"], page=n)
                self._ran(rec, page["first_draw"] + k, page["first_step"] + k)
                if piece is not None:
                    rec.update(wave=piece, frames=len(piece) // SAMPLES_PER_FRAME)
                    self.sample.offer(len(self.records), phones)
                self.records.append(rec)
            page.pop("wav", None)


def split_pages(wav: np.ndarray, count: int) -> list:
    """The ``count`` sentences of a ``read_to_file`` result: each piece
    follows ``JOIN_SILENCE`` zero samples and is a whole number of frame
    pairs (the glow keeps an even mel length); a piece ends where the next
    run of ``JOIN_SILENCE`` zeros begins, rounded up to whole frame pairs,
    since its own last samples may be zero."""
    pair = 2 * SAMPLES_PER_FRAME
    nz = np.flatnonzero(wav != 0.0)
    pieces, pos = [], JOIN_SILENCE
    for _ in range(count):
        later = nz[nz >= pos]
        if len(later) == 0:
            pieces.append(wav[pos:pos])
            continue
        # the last nonzero sample before a gap of JOIN_SILENCE zeros
        gaps = np.flatnonzero(np.diff(later) > JOIN_SILENCE)
        last = later[gaps[0]] if len(gaps) else later[-1]
        length = math.ceil((last + 1 - pos) / pair) * pair
        pieces.append(wav[pos:pos + length])
        pos += length + JOIN_SILENCE
    return pieces


CLIENTS = {"call": CallClient, "read_to_file": ReadToFileClient}
