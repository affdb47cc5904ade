"""``read_to_file``: pages of ``page`` consecutive sentences through
``read_to_file``, back to back, each written to one WAV file under the
temporary directory (an audiobook or a synthetic corpus)."""

from __future__ import annotations

import math
import os
import tempfile
import time

import numpy as np

from bench_h100.harness.serve import SAMPLES_PER_FRAME, Client

JOIN_SILENCE = 10600    # read_to_file's silence between sentences, in samples


class ReadToFileClient(Client):
    # a sentence is done when its page is
    sentence_latency = False

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


CLIENT = ReadToFileClient
