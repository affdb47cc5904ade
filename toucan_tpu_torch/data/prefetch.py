"""Host-to-device input pipeline for training.

Counterpart of ``toucan_tpu/data/prefetch.py``.  The reference keeps its
card fed with DataLoader workers
(``toucantts_train_loop.py:68-76``); here one host thread takes the next
host batch (a dict of numpy arrays, padded by ``data/batching.py``), puts
it in pinned memory and copies it to the card with ``non_blocking`` on a
side stream, up to ``depth`` batches ahead of the step that consumes them.
The consumer's stream waits for the copy's event before it reads a batch.
An exception of the source or of the copy re-raises at the consumer's
``next()``.  On the CPU the batches are only wrapped as tensors.

With a ``mesh`` (JAX's branch, ``make_global_batch``), each rank of the
mesh runs its own prefetcher over a source of global batches, and keeps
its data rank's rows of each.  (``train_loop(mesh=...)`` samples each
rank's share itself and passes no mesh.)
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

_DONE = object()


def to_tensors(batch, device, non_blocking: bool = False):
    """Host batch -> dict of tensors on ``device`` (int32 stays int32,
    ``lang_ids`` becomes int64 for the embedding lookup)."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if key == "lang_ids":
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=non_blocking)
        out[key] = t
    return out


class DevicePrefetcher:
    """Iterate device-resident batches, prepared up to ``depth`` ahead."""

    def __init__(self, source, device, depth: int = 2, mesh=None):
        self.device = torch.device(device)
        if mesh is not None:
            from toucan_tpu_torch.dist.mesh import local_rows
            source = (local_rows(b, mesh) for b in source)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._thread = threading.Thread(target=self._run, args=(iter(source),), daemon=True,
                                        name="toucan-prefetch")
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, source):
        try:
            for batch in source:
                if self._stream is None:
                    item = (to_tensors(batch, self.device), None)
                else:
                    with torch.cuda.stream(self._stream):
                        tensors = to_tensors(batch, self.device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    item = (tensors, event)
                if not self._put(item):
                    return
            self._put(_DONE)
        except BaseException as exc:  # surfaced at the consumer's next()
            self._put(exc)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _DONE:
            self._queue.put(_DONE)
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors.values():  # made on the side stream, freed after this one's use
                t.record_stream(stream)
        return tensors

    def close(self):
        """Stop early: the thread ends at its next batch."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)
