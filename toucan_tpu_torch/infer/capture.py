"""One step at fixed shapes, captured once as a CUDA graph and replayed.

Counterpart of the entries of the JAX interface's jit caches
(``toucan_tpu/infer/interface.py``: ``_e2e_cache``, ``_vocoder_cache``).  A
``Bucket`` holds static input buffers, the step (a function of those
buffers that returns a tuple of tensors) and the step's outputs.

On the card the step runs once eagerly on a side stream (the warm-up: it
builds the kernels and fills every host-side cache, such as tilings,
occupancy queries, prepared weights and position tables), is then captured
into a ``torch.cuda.CUDAGraph`` inside ``matmul_precision(policy)``, so
that the captured library kernels follow the bucket's policy (the
interface's: "float32" unless it was asked for "default") whatever the
caller set, and is replayed at every call.  A capture that fails raises;
nothing falls back to eager.
On the CPU the step runs eagerly over the same buffers at every call.

A call copies its inputs into the static buffers and hands back copies of
the outputs, made on the stream right after the replay: the next call of
the same bucket overwrites the static outputs.  So buckets that replay on
one stream can capture into one memory pool (``pool``, from
``torch.cuda.graph_pool_handle()``): a replay of another bucket may
overwrite this one's intermediates and static outputs, never a copy handed
back.  Nothing waits for the device, so a caller can queue several calls
before it reads the first.  A call runs in a ``toucan.replay`` span, a
capture in a ``toucan.capture`` span (``utils.profiling.span``).
"""

from __future__ import annotations

import time

import torch

from toucan_tpu_torch.kernels import build
from toucan_tpu_torch.utils.device import matmul_precision
from toucan_tpu_torch.utils.profiling import span


class Bucket:
    def __init__(self, step, inputs: dict, device, pool=None, policy: str = "float32"):
        """``inputs``: {name: (shape, dtype) or None}, the step's keyword
        arguments (None is passed as None).  The buffers, on ``device``,
        start at zero; on the card the step is warmed up and captured on
        them here, into the memory pool ``pool`` (None: a pool of its own),
        under the precision ``policy`` (``utils.device.matmul_precision``)."""
        self.step = step
        self.device = torch.device(device)
        self.policy = policy
        self.graph = self.tally = self.outputs = None
        self.capture_s = None          # warm-up and capture, host clock (card only)
        self.reserved_bytes = None     # memory its capture added to the pool (card only)
        with torch.inference_mode():
            self.inputs = {name: None if spec is None
                           else torch.zeros(spec[0], dtype=spec[1], device=self.device)
                           for name, spec in inputs.items()}
        if self.device.type == "cuda":
            self._capture(pool)

    def _capture(self, pool):
        with span("toucan.capture"):
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()   # so that the reserved bytes below are the capture's own
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            with torch.inference_mode(), matmul_precision(self.policy), \
                    torch.cuda.device(self.device):
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    self.step(**self.inputs)
                torch.cuda.current_stream(self.device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with build.CaptureTally() as tally:
                    with torch.cuda.graph(graph, pool=pool):
                        self.outputs = self.step(**self.inputs)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()   # the warm-up's blocks
            self.graph, self.tally = graph, tally
            self.capture_s = time.perf_counter() - t0
            self.reserved_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def __call__(self, **inputs) -> tuple:
        """Fill the named buffers, in the order given, and run the step;
        returns copies of its outputs.  A value is a tensor to copy in (of
        the buffer's shape) or a function that fills the buffer it is given
        in place (so functions that draw from one generator draw in the
        order of the arguments)."""
        fixed = {name for name, buf in self.inputs.items() if buf is not None}
        if set(inputs) != fixed:
            raise ValueError(f"the bucket takes exactly {sorted(fixed)}, got {sorted(inputs)}")
        with torch.inference_mode(), span("toucan.replay"):
            for name, value in inputs.items():
                buf = self.inputs[name]
                if callable(value):
                    value(buf)
                else:
                    buf.copy_(value, non_blocking=True)
            if self.graph is not None:
                self.graph.replay()
                self.tally.replayed()
            else:
                outs = self.step(**self.inputs)
                if self.outputs is None:
                    self.outputs = tuple(torch.empty_like(o) for o in outs)
                for buf, o in zip(self.outputs, outs):
                    buf.copy_(o)
            return tuple(o.clone() for o in self.outputs)
