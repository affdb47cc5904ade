"""Two-stage pipelined serving: acoustic (text -> masked mel) and vocoder
(mel -> wave) stages over a stream of batches.

Counterpart of ``toucan_tpu/infer/pipelined.py`` (one process, a list of
devices, no process group).  ``make_stage_fns`` splits the interface's
fused text -> wave step (``infer/interface.py::_e2e``) into its two halves,
bit-identical to it: the acoustic stage runs K1 on the card, the vocoder
stage K2 (or the vocoder's kernels).  ``PipelinedSynthesizer`` keeps up to
``depth`` batches in flight:

* with two devices the acoustic model lives on the first and the vocoder
  on the second, each stage on its device's current stream; the mel hops
  with a ``non_blocking`` copy on the second device after an event on the
  first's stream, so the first computes batch N+1's mel while the second
  vocodes batch N;
* with one device both stages run there, one after the other on its
  stream, and the stream still dispatches batch N+1 before it fetches batch
  N's wave, hiding the host's work behind the device's (``two_stage`` is
  False).  Two entries naming one device (``["cpu", "cpu"]``) make two
  stages with a copy of the vocoder each, in turn.

Reference behaviour: ``InferenceInterfaces/ToucanTTSInterface.py:93-135``
(both stages in turn on one device).
"""

from __future__ import annotations

import copy
from collections import deque

import torch

from toucan_tpu_torch.utils.device import matmul_precision as precision_policy


def make_stage_fns(model, vocoder, max_frames: int, matmul_precision: str = "float32"):
    """(acoustic, vocode): ``acoustic(text, text_lengths, utt, lang, noise,
    knobs) -> (mel, mel_lengths)`` with frames past each length zeroed (f32),
    and ``vocode(mel) -> wave (B, 384 * max_frames)``; the tensors on the
    stage's module's device, ``knobs`` the (4,) duration, pitch variance,
    energy variance and pause scales."""

    @torch.inference_mode()
    def acoustic(text, text_lengths, utt, lang, noise, knobs):
        with precision_policy(matmul_precision):
            _, after, _, _, _, lens = model.infer(
                text, text_lengths, max_frames, utterance_embedding=utt, lang_ids=lang,
                duration_scaling_factor=knobs[0], pitch_variance_scale=knobs[1],
                energy_variance_scale=knobs[2], pause_duration_scaling_factor=knobs[3],
                glow_noise=noise)
        after = after.float()
        mask = (torch.arange(max_frames, device=after.device)[None, :] < lens[:, None])[..., None]
        return torch.where(mask, after, torch.zeros((), device=after.device)), lens

    @torch.inference_mode()
    def vocode(mel):
        with precision_policy(matmul_precision):
            return vocoder(mel)[..., 0]

    return acoustic, vocode


def _devices(devices):
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass devices=['cpu'] (or two) "
                               "to run the pipeline on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


class PipelinedSynthesizer:
    """Double-buffered two-stage synthesis over a stream of batches.

    ``model``/``vocoder``: a ``ToucanTTS`` and a vocoder module, loaded from
    ``tts_state``/``vocoder_state`` (state dicts; None keeps their weights)
    and moved, in eval mode, to their stage's device.  ``devices`` defaults
    to every visible card; with two or more the acoustic stage runs on the
    first and the vocoder on the second (``two_stage``), with one both run
    there.  ``depth`` bounds the batches in flight.
    """

    def __init__(self, model, tts_state, vocoder, vocoder_state, max_frames: int,
                 devices=None, depth: int = 2, matmul_precision: str = "float32"):
        devices = _devices(devices)
        self.dev_acoustic = devices[0]
        self.dev_vocoder = devices[1] if len(devices) > 1 else devices[0]
        self.two_stage = len(devices) > 1
        self.depth = depth
        self.max_frames = max_frames
        if tts_state is not None:
            model.load_state_dict(tts_state)
        if vocoder_state is not None:
            vocoder.load_state_dict(vocoder_state)
        self.model = model.to(self.dev_acoustic).eval()
        if self.two_stage and self.dev_vocoder == self.dev_acoustic:
            vocoder = copy.deepcopy(vocoder)  # a stage's own copy (two CPU "devices")
        self.vocoder = vocoder.to(self.dev_vocoder).eval()
        self.acoustic_fn, self.vocode_fn = make_stage_fns(self.model, self.vocoder, max_frames,
                                                          matmul_precision)

    def _put(self, x):
        if x is None:
            return None
        x = torch.as_tensor(x)
        if self.dev_acoustic.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(self.dev_acoustic, non_blocking=True)

    def _dispatch(self, batch):
        """Enqueue both stages of one batch ``(text, text_lengths, utt, lang,
        noise, knobs)``; returns (wave, mel_lengths, the wave's event) without
        waiting for the device."""
        mel, lens = self.acoustic_fn(*[self._put(x) for x in batch])
        if self.dev_acoustic.type != "cuda":  # the CPU: in turn
            return self.vocode_fn(mel.to(self.dev_vocoder)), lens, None
        if self.dev_vocoder != self.dev_acoustic:
            # each device works on its own current stream; the hop waits for
            # the mel's event and runs on the vocoder's device
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.dev_acoustic))
            stream_v = torch.cuda.current_stream(self.dev_vocoder)
            stream_v.wait_event(done)
            with torch.cuda.stream(stream_v):
                mel = mel.to(self.dev_vocoder, non_blocking=True)
        wave = self.vocode_fn(mel)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.dev_vocoder))
        return wave, lens, ready

    def synthesize_stream(self, batches, as_numpy: bool = True):
        """Yield ``(wave, mel_lengths)`` per input batch, keeping up to
        ``depth`` batches in flight (batch N+1 is dispatched before batch
        N's wave is fetched).  ``as_numpy`` fetches each to the host;
        otherwise the device tensors come after their event.  The caller
        trims each wave to ``mel_lengths * 384``."""
        def out(item):
            wave, lens, ready = item
            if ready is not None:
                ready.synchronize()
            if as_numpy:
                return wave.cpu().numpy(), lens.cpu().numpy()
            return wave, lens

        inflight = deque()
        for batch in batches:
            inflight.append(self._dispatch(batch))
            if len(inflight) > self.depth:
                yield out(inflight.popleft())
        while inflight:
            yield out(inflight.popleft())


# ------------------------------------------------------------------ bench

def _elapsed_ms(fn) -> float:
    """Wall time of ``fn`` on the card, by CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bench_pipelined_vs_sequential(device="cuda", dtype=torch.float32, n_batches: int = 8,
                                  seed: int = 0):
    """The pipelined stream against the fused sequential path (both stages
    of one batch in turn, then the next) on the same synthetic batches, at
    the full-width ToucanTTS and HiFiGAN, seeded random weights: B = 8, 128
    phones, 1024 frames.  Times by CUDA events; returns a dict of audio
    seconds per second, ``two_stage``, and a single sentence's latency (32
    phones, 256 frames, best of 5).  With one card ``two_stage`` is False
    and the stream's gain is only the host's work hidden behind the card's.
    """
    from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
    from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator

    device = torch.device(device)
    b, tmax, frames = 8, 128, 1024
    audio_s = b * frames * 384 / 24000.0
    torch.manual_seed(seed)
    model = ToucanTTS(ToucanTTSConfig(dtype=dtype)).to(device).eval()
    vocoder = HiFiGANGenerator(dtype=dtype).to(device).eval()
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def batch(b, tmax, frames, n):
        return ((torch.rand(b, tmax, 62, generator=gen) > 0.5).float(),
                torch.full((b,), n, dtype=torch.int64), torch.randn(b, 64, generator=gen),
                torch.zeros(b, 1, dtype=torch.int64),
                torch.randn(b, frames, 80, generator=gen) * 0.8, torch.ones(4))

    work = [tuple(x.to(device) for x in batch(b, tmax, frames, tmax))] * n_batches
    acoustic, vocode = make_stage_fns(model, vocoder, frames)

    def fused():
        for x in work:
            vocode(acoustic(*x)[0])

    fused()  # warm
    fused_ms = _elapsed_ms(fused)
    devices = [device] + ([torch.device("cuda:1")] if torch.cuda.device_count() > 1 else [])
    pipe = PipelinedSynthesizer(model, None, vocoder, None, frames, devices=devices, depth=2)
    list(pipe.synthesize_stream(work[:2], as_numpy=False))  # warm both stages
    pipe_ms = _elapsed_ms(lambda: list(pipe.synthesize_stream(work, as_numpy=False)))
    one = tuple(x.to(device) for x in batch(1, 32, 256, 16))
    acoustic1, vocode1 = make_stage_fns(model, vocoder, 256)
    vocode1(acoustic1(*one)[0])
    latency = min(_elapsed_ms(lambda: vocode1(acoustic1(*one)[0])) for _ in range(5))
    return {"fused_ms": fused_ms, "pipelined_ms": pipe_ms,
            "e2e_fused_audio_s_per_s": n_batches * audio_s / (fused_ms / 1e3),
            "e2e_pipelined_audio_s_per_s": n_batches * audio_s / (pipe_ms / 1e3),
            "two_stage": pipe.two_stage, "single_utterance_latency_ms": latency}

