"""End-to-end TTS interface: text -> articulatory features -> mel -> wave.

Counterpart of ``toucan_tpu/infer/interface.py`` (reference
``InferenceInterfaces/ToucanTTSInterface.py``): language/accent setters,
the utterance embedding (given, or from reference audio through the GST),
the prosody-control knobs, per-phone prosody overrides, batched synthesis,
``read_to_file``, ``read_aloud``, ``plot_synthesis``, the HiFiGAN or
BigVGAN vocoder and ``quantize_vocoder`` (int8 HiFiGAN stages).  The
acoustic model is ``ToucanTTS`` or, with ``acoustic="stochastic"``,
``StochasticToucanTTS``, whose spline flows sample pitch, energy and
durations from the flows' noise; ``acoustic_step`` alone calls either.

Every entry point takes text to wave by one path.  ``_stage`` pads the
phones to the same buckets as the JAX interface (32 phones, 16 frames per
phone), so the acoustic model computes on the same shapes, and copies the
step's inputs to the device.  ``_run_e2e`` runs the acoustic step at 16
frames a padded phone, which gives the mel zeroed past each length; the
host reads the lengths (one round trip a step); and the vocoder runs over
the first F frames of the mel alone, F the smallest frame bucket (64-frame
steps to 1024, 512-frame steps above: ``_frame_bucket``) that holds the
longest length plus the vocoder's ``receptive_frames``.  The delivered
samples read no frame past that, so they are those of the whole padded
mel.  A vocoder that gives no receptive frames (a module without the
property, or a HiFiGAN whose int8 K4 stages take their scales from every
row) runs over every decoded frame, without the round trip.  ``_noise``
says which noise a step draws from the interface's generator, of what
shape and in what order (the stochastic model's flows', then the glow's);
``_fetch`` cuts each wave at its mel length and copies it to the host.
Every entry point runs its convs and matmuls under the interface's
``matmul_precision`` (``utils.device.matmul_precision``: "float32" by
default, IEEE f32; "default" lets cuDNN and cuBLAS use TF32, as JAX's
default precision does on an NVIDIA card) whatever the caller's TF32
settings, and leaves those settings as it found them.  ``dtype``
(``torch.bfloat16``) is the acoustic model's and a vocoder named by
string's compute dtype, as the JAX interface's ``dtype``; the GST, a
vocoder module passed in and the returned waves, mels and prosody stay
f32.

As the JAX interface jits one function per bucket, the port keeps one
``infer.capture.Bucket`` per (batch size, phone bucket, frames decoded,
which of durations/pitch/energy were given) in ``_e2e_cache``, the
acoustic step, and one per (batch size, vocoder frame bucket) in
``_vocoder_cache``: on the card a CUDA graph, captured at the bucket's
first use or by ``precompile`` and replayed after that; on the CPU the
same buckets run eagerly.  All graphs of an interface capture into one
memory pool, so a new bucket adds only what its graph needs beyond what
the pool already holds.  The knobs are a (4,) tensor that only the device
reads, so they never make a new bucket.  ``_dispatch_call`` waits for a
sentence's acoustic step only, and ``read_to_file`` enqueues every
sentence's vocoder before it fetches the first wave.  A graph fixes the
vocoder's mode and the precision policy at its capture:
``quantize_vocoder`` and setting ``matmul_precision`` clear the caches.

Each layer of a request runs in a span (``utils.profiling.span``), free
while nothing traces: ``toucan.call``, ``toucan.read_to_file`` or
``toucan.batch`` with the request's id, then ``toucan.dispatch`` (a
sentence), ``toucan.frontend``, ``toucan.stage`` (host padding and the
copies to the device), ``toucan.replay`` and ``toucan.capture``
(``infer.capture.Bucket``), ``toucan.fetch`` (each read of the device's
outputs, the mel lengths of a step too, and its wait) and
``toucan.write`` (the page's WAV).  ``counters``
holds the operator's counts (``COUNTERS``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import wave as wave_mod
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from toucan_tpu_torch.frontend.audio import AudioPreprocessor, read_wav
from toucan_tpu_torch.frontend.text import TextFrontend, language_id
from toucan_tpu_torch.infer.capture import Bucket
from toucan_tpu_torch.models.gst import StyleEmbedding
from toucan_tpu_torch.models.stochastic_toucan_tts import FLOWS, StochasticToucanTTS
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator, calibrate_act_scales
from toucan_tpu_torch.utils.device import check_policy, matmul_precision, resolve_device
from toucan_tpu_torch.utils.profiling import span

VOCODERS = {"hifigan": HiFiGANGenerator, "bigvgan": BigVGAN}
ACOUSTIC = {"toucan": ToucanTTS, "stochastic": StochasticToucanTTS}
# the operator's counters (``ToucanTTSInterface.counters``): requests on the
# entry points, sentences, vocoder frames run (rows included) and delivered,
# buckets made and those made outside ``precompile`` (a capture on a live
# request on the card), steps whose vocoder ran every decoded frame (it
# gives no receptive frames, or the cut reached them), and frames of mel
# lengths past the frames their step decoded (durations that sum past the
# bucket; the lengths delivered are clamped to it)
COUNTERS = ("requests", "sentences", "frames_run", "frames_delivered", "buckets_built",
            "buckets_built_live", "steps_uncut", "frames_truncated")
PHONE_BUCKET = 32
FRAMES_PER_PHONE = 16       # static upper bound for the upsampled length
FINE_FRAMES = 1024          # the vocoder's frame buckets: 64-frame steps to here, 512 above
SAMPLES_PER_FRAME = 384     # 24 kHz out / 16 kHz-rate mel frames (hop 256)
SENTENCE_JOIN_SILENCE = 10600
CALIBRATION_PANGRAM = "~ðə kwˈɪk bɹˈaʊn fˈɑks dʒˈʌmps ˈoʊvəɹ ðə lˈeɪzi dˈɔɡ~#"


def _round_up(n, m):
    return max(m, int(math.ceil(n / m)) * m)


def _frame_bucket(frames: int) -> int:
    """The vocoder's frame bucket of ``frames``: a multiple of 64 up to
    ``FINE_FRAMES`` (the ladder of ``_vocode`` and of the JAX interface's),
    of 512 above (a multiple of 512 holds every phone bucket's 16 frames a
    phone), so the rare long sentence costs ``precompile`` few graphs."""
    return _round_up(frames, 64 if frames <= FINE_FRAMES else 512)


@torch.inference_mode()
def acoustic_step(model, text, text_lengths, max_frames: int, utt, lang, noise,
                  knobs=(1.0,) * 4, durations=None, pitch=None, energy=None, flow_noise=None):
    """Text -> (mel, after, durations, pitch, energy, mel_lengths) of
    ``max_frames`` decoded frames: the acoustic half of a step, the step of
    an ``_e2e_cache`` bucket and ``infer.pipelined``'s acoustic stage.
    ``mel`` is ``after`` zeroed past each length; both are f32 whatever
    the model's dtype, as in JAX (``interface.py:239``).  Tensors on the
    model's device.  A ``ToucanTTS`` takes ``knobs``, the (duration, pitch
    variance, energy variance, pause) scales as a (4,) tensor or floats,
    and the given ``durations``, ``pitch`` and ``energy``; a
    ``StochasticToucanTTS`` samples its prosody from ``flow_noise``, the
    (3, B, T, 2) draws of its flows."""
    if isinstance(model, StochasticToucanTTS):
        _, after, dur, pit, ene, lens = model.infer(
            text, text_lengths, max_frames, utterance_embedding=utt, lang_ids=lang,
            glow_noise=noise, flow_noise=tuple(flow_noise))
    else:
        _, after, dur, pit, ene, lens = model.infer(
            text, text_lengths, max_frames, utterance_embedding=utt, lang_ids=lang,
            gold_durations=durations, gold_pitch=pitch, gold_energy=energy,
            duration_scaling_factor=knobs[0], pitch_variance_scale=knobs[1],
            energy_variance_scale=knobs[2], pause_duration_scaling_factor=knobs[3],
            glow_noise=noise)
    after = after.float()
    mask = (torch.arange(max_frames, device=after.device)[None, :] < lens[:, None])[..., None]
    mel = torch.where(mask, after, torch.zeros((), device=after.device))
    return mel, after, dur, pit, ene, lens


def _under_policy(method):
    """Run an entry point under its interface's ``matmul_precision``."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with matmul_precision(self.matmul_precision):
            return method(self, *args, **kwargs)
    return wrapper


class ToucanTTSInterface:
    def __init__(self, tts_state_dict, vocoder_state_dict,
                 config: Optional[ToucanTTSConfig] = None,
                 vocoder: Union[str, nn.Module] = "hifigan", default_embedding=None,
                 language: str = "en", use_g2p: bool = True, seed: int = 0, device=None,
                 gst_state_dict=None, dtype: Optional[torch.dtype] = None,
                 matmul_precision: str = "float32", mesh=None, longform_frames: int = 1024,
                 acoustic: str = "toucan"):
        """``vocoder`` is "hifigan" (``HiFiGANGenerator()``), "bigvgan"
        (``BigVGAN()``) or a vocoder module of the checkpoint's widths; the
        state dicts are loaded into the models.  ``gst_state_dict``: the
        StyleEmbedding's, needed by ``set_utterance_embedding`` from audio.
        ``device`` defaults to the card; pass "cpu" for the CPU.
        ``dtype`` (e.g. ``torch.bfloat16``) overrides the compute dtype of
        the acoustic model and of a vocoder named by string, as the JAX
        interface's ``dtype`` does.  ``matmul_precision``: "float32" (the
        port's default, unlike JAX's "default": f32 is the port's contract,
        which its card-against-CPU checks rest on) or "default" (TF32 in
        cuDNN and cuBLAS); the kernels keep their own arithmetic under
        either.

        ``mesh``: a ``dist.make_mesh`` mesh with a 'data' dim, every rank
        of which builds the interface alike and makes the same calls.  A
        call whose frame budget reaches ``longform_frames`` then runs the
        acoustic model on every rank and vocodes the mel time-sharded over
        'data' (``dist/longform.py``'s halo exchange), and returns the whole
        wave on every rank, as the JAX interface's ``mesh`` does.  That path
        runs eagerly, outside the per-bucket CUDA graphs: its exchange is a
        collective, which a graph cannot hold under gloo.

        ``acoustic``: "toucan" (``ToucanTTS``) or "stochastic"
        (``StochasticToucanTTS`` of the same config, f32 only).  A
        stochastic interface samples prosody at the model's ``noise_scale``
        and serves ``__call__``, ``synthesize_batch`` and ``read_to_file``
        through the same buckets, graphs and vocoder cut; each step draws
        the pitch, energy and duration flows' N(0, 1) noise, (B, phones, 2)
        each, then the glow noise.  Its model takes no knobs and no given
        durations, pitch or energy, so those (a knob other than 1, an
        override, ``precompile(with_overrides=True)``), ``mesh`` and a
        ``dtype`` other than f32 raise ValueError."""
        if acoustic not in ACOUSTIC:
            raise ValueError(f"acoustic must be one of {sorted(ACOUSTIC)}, got {acoustic!r}")
        self.stochastic = acoustic == "stochastic"
        if self.stochastic and mesh is not None:
            raise ValueError("a stochastic interface has no long-form mesh path")
        self.device = resolve_device(device)
        self.config = config or ToucanTTSConfig()
        if dtype is not None and self.config.dtype != dtype:
            self.config = dataclasses.replace(self.config, dtype=dtype)
        if self.stochastic and self.config.dtype != torch.float32:
            raise ValueError("a stochastic interface computes in f32 only")
        self.model = ACOUSTIC[acoustic](self.config)
        self.model.load_state_dict(tts_state_dict)
        self.model.to(self.device).eval()
        if isinstance(vocoder, str):
            if vocoder not in VOCODERS:
                raise ValueError(f"vocoder must be one of {sorted(VOCODERS)} or a module, "
                                 f"got {vocoder!r}")
            vocoder = VOCODERS[vocoder](dtype=dtype or torch.float32)
        self.vocoder = vocoder
        self.vocoder.load_state_dict(vocoder_state_dict)
        self.vocoder.to(self.device).eval()
        self.gst = None
        if gst_state_dict is not None:
            self.gst = StyleEmbedding()
            self.gst.load_state_dict(gst_state_dict)
            self.gst.to(self.device).eval()
        self.use_g2p = use_g2p
        self._frontends = {}
        self.set_language(language)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._voc_act_scales = None  # set by quantize_vocoder (int8 stages)
        self._e2e_cache = {}         # text -> mel buckets (the acoustic step)
        self._vocoder_cache = {}     # mel -> wave buckets, by (rows, frames)
        self._clear_caches()
        self._eager = False          # run every call eagerly, no bucket (comparisons)
        self.counters = dict.fromkeys(COUNTERS, 0)
        self._matmul_precision = check_policy(matmul_precision)
        self.mesh = mesh
        self.longform_frames = longform_frames
        if default_embedding is None and self.config.utt_embed_dim is not None:
            default_embedding = np.zeros(self.config.utt_embed_dim, np.float32)
        self.default_utterance_embedding = (
            None if default_embedding is None
            else np.asarray(default_embedding, np.float32).reshape(-1))

    # ------------------------------------------------------------- setters

    @property
    def matmul_precision(self) -> str:
        """The precision policy of every entry point and captured bucket."""
        return self._matmul_precision

    @matmul_precision.setter
    def matmul_precision(self, policy: str):
        if check_policy(policy) != self._matmul_precision:
            self._matmul_precision = policy
            self._clear_caches()  # a graph keeps the policy of its capture

    def set_language(self, lang: str):
        self.set_phonemizer_language(lang)
        self.set_accent_language(lang)

    def set_phonemizer_language(self, lang: str):
        self.text2phone = self._frontend(lang)

    def set_accent_language(self, lang: str):
        self.lang_id = language_id(lang) if self.config.lang_embs is not None else None

    @_under_policy
    def set_utterance_embedding(self, path_to_reference_audio: str = "", embedding=None,
                                wave=None, sr: int = 16000):
        """Set the speaker: an ``embedding`` as given, or the GST embedding of
        reference audio, a ``wave`` at ``sr`` or a PCM WAV file at
        ``path_to_reference_audio``.  The audio is loudness-normalized,
        resampled to 16 kHz and trimmed on the host; its mel and the GST run
        on the interface's device."""
        if embedding is not None:
            self.default_utterance_embedding = np.asarray(embedding, np.float32).reshape(-1)
            return
        if self.gst is None:
            raise ValueError("an embedding from audio needs the interface's gst_state_dict")
        if wave is None:
            wave, sr = read_wav(path_to_reference_audio)
        pre = AudioPreprocessor(input_sr=sr, output_sr=16000, cut_silence=True)
        spec = pre.audio_to_mel_spec_tensor(wave, device=self.device).T
        emb = self.gst(spec[None], [len(spec)])
        self.default_utterance_embedding = emb[0].cpu().numpy()

    @_under_policy
    def quantize_vocoder(self, calibration_mel=None, calibration_text=None, act_scales=None):
        """Switch the HiFiGAN vocoder to int8 stages (K3) with activation
        scales calibrated on a representative mel.

        ``calibration_mel``: (B, T, 80) log-mel; default: one synthesized
        from ``calibration_text`` (IPA; default a built-in pangram) through
        the acoustic model, with glow noise from the interface's generator,
        so the scales follow serving statistics.  ``act_scales``: scales of
        an earlier calibration ({stage: (18,)}) to use instead of
        calibrating.  Returns the scales, kept on the device.
        """
        if not isinstance(self.vocoder, HiFiGANGenerator):
            raise ValueError("int8 serving mode supports the HiFiGAN/Avocodo generator")
        if act_scales is not None:
            scales = {i: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                      for i, v in act_scales.items()}
        else:
            if calibration_mel is None:
                mel = self._calibration_mel(calibration_text or CALIBRATION_PANGRAM)
            else:
                mel = torch.as_tensor(calibration_mel, dtype=torch.float32, device=self.device)
            scales = calibrate_act_scales(self.vocoder, mel)
        self._voc_act_scales = scales
        self.vocoder.stage_mode = "int8"
        self._clear_caches()
        return scales

    def _clear_caches(self):
        """Drop every captured bucket: a graph keeps the vocoder's mode and
        scales of its capture; and read the vocoder's ``receptive_frames``
        anew, which decide whether a step is cut."""
        self._e2e_cache.clear()
        self._vocoder_cache.clear()
        self._graph_pool = None      # the memory pool all buckets' graphs capture into
        # the vocoder's receptive frames, None where it gives none: every
        # step then vocodes all the frames it decoded
        self._reach = getattr(self.vocoder, "receptive_frames", None)

    def _bucket(self, step, inputs: dict, live: bool = True) -> Bucket:
        """A ``Bucket`` on the interface's device; on the card its graph
        captures into the pool that the interface's other graphs share.
        ``live``: made for a request, not by ``precompile``."""
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        self.counters["buckets_built"] += 1
        self.counters["buckets_built_live"] += live
        return Bucket(step, inputs, self.device, self._graph_pool, self.matmul_precision)

    @torch.inference_mode()
    def _calibration_mel(self, text: str) -> torch.Tensor:
        phones = self.text2phone.string_to_features(text, input_phonemes=True)
        inputs, n_pad = self._stage([phones], self._refuse_prosody((1.0,) * 4))
        max_frames = n_pad * FRAMES_PER_PHONE
        _, after, *_, lens = acoustic_step(self.model, max_frames=max_frames,
                                           **self._draws(1, n_pad, max_frames), **inputs)
        return after[:, :int(lens[0])]

    def _vocoder_call(self, mel):
        if self._voc_act_scales is None:
            return self.vocoder(mel)
        return self.vocoder(mel, act_scales=self._voc_act_scales)

    def _cut_frames(self, longest: int, max_frames: int) -> int:
        """The frames the vocoder runs for a step of ``max_frames`` decoded
        frames whose longest mel is ``longest``: the frame bucket of
        ``longest`` plus the receptive frames, at most ``max_frames``."""
        if self._reach is None:
            return max_frames
        return min(_frame_bucket(longest + self._reach), max_frames)

    def _frontend(self, lang: str) -> TextFrontend:
        if lang not in self._frontends:
            self._frontends[lang] = TextFrontend(language=lang, use_g2p=self.use_g2p)
        return self._frontends[lang]

    # ----------------------------------------------------------- synthesis

    def _tensor(self, x, dtype=torch.float32):
        """A host array on the interface's device.  To the card it goes
        through pinned memory without waiting for the device, so a caller
        can enqueue a call while earlier ones still run."""
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, phones, knobs, utt=None, lang_ids=None, durations=None, pitch=None,
               energy=None):
        """A step's inputs on the device, named as ``acoustic_step``'s
        arguments, and its phone bucket: the (n, features) arrays of
        ``phones`` padded to the phone bucket of the longest, and their
        lengths; ``utt`` (B, E), default the interface's embedding;
        ``lang_ids``, one a row, default the interface's language (None
        where the model has no language embedding); ``knobs`` as
        ``_refuse_prosody`` returns them; and the given ``durations``,
        ``pitch`` and ``energy``, one array a row over its phones, or
        None."""
        b = len(phones)
        lengths = np.asarray([len(p) for p in phones], np.int64)
        n_pad = _round_up(int(lengths.max()), PHONE_BUCKET)

        def padded(rows, dtype=torch.float32):
            if rows is None:
                return None
            rows = [np.asarray(row, np.float32) for row in rows]
            out = np.zeros((b, n_pad) + rows[0].shape[1:], np.float32)
            for i, (row, n) in enumerate(zip(rows, lengths)):
                out[i, :n] = row
            return self._tensor(out, dtype)

        if utt is None and self.default_utterance_embedding is not None:
            utt = np.tile(self.default_utterance_embedding[None], (b, 1))
        if utt is not None:
            utt = self._tensor(np.asarray(utt, np.float32).reshape(b, -1))
        if lang_ids is None:
            lang_ids = [self.lang_id] * b
        lang = None if self.lang_id is None else self._tensor([[i] for i in lang_ids], torch.int64)
        inputs = dict(text=padded(phones), text_lengths=self._tensor(lengths, torch.int64),
                      utt=utt, lang=lang, knobs=None if knobs is None else self._tensor(knobs),
                      durations=padded(durations, torch.int32), pitch=padded(pitch),
                      energy=padded(energy))
        return inputs, n_pad

    def _draw_noise(self, buf: torch.Tensor):
        """Fill buf with glow noise, N(0, 0.8^2), from the interface's generator."""
        torch.randn(buf.shape, generator=self.generator, out=buf)
        buf.mul_(0.8)

    def _draw_flow_noise(self, buf: torch.Tensor):
        """Fill buf (3, B, T, 2) with the pitch, energy and duration flows'
        N(0, 1) draws from the interface's generator, in that order."""
        for part in buf:
            torch.randn(part.shape, generator=self.generator, out=part)

    def _noise(self, b: int, phones: int, max_frames: int) -> dict:
        """The noise a step of ``b`` rows, ``phones`` padded phones and
        ``max_frames`` decoded frames takes, in the order the generator
        fills it: {argument: (shape, drawer)}, the stochastic model's
        flows' (3, B, phones, 2), then the glow's (B, frames, 80).  The
        drawers are looked up on the interface at each step."""
        noise = {}
        if self.stochastic:
            noise["flow_noise"] = ((len(FLOWS), b, phones, 2), self._draw_flow_noise)
        noise["noise"] = ((b, max_frames, self.config.mel_channels), self._draw_noise)
        return noise

    def _draws(self, b: int, phones: int, max_frames: int, eager: bool = True, **given) -> dict:
        """A step's noise arguments (``_noise``): each as ``given`` where
        that is a tensor, else drawn now into a new buffer or, not
        ``eager``, the drawer with which a bucket fills its own."""
        draws = {}
        for name, (shape, draw) in self._noise(b, phones, max_frames).items():
            if given.get(name) is not None:
                draws[name] = given[name]
            elif eager:
                draws[name] = torch.empty(shape, device=self.device)
                draw(draws[name])
            else:
                draws[name] = draw
        return draws

    def _refuse_prosody(self, knobs, durations=None, pitch=None, energy=None):
        """The knobs a step takes: ``knobs``, or None on a stochastic
        interface, whose model samples its prosody: there a knob other than
        1 or given durations, pitch or energy raise ValueError."""
        if not self.stochastic:
            return knobs
        if any(k != 1.0 for k in knobs) or any(x is not None for x in (durations, pitch, energy)):
            raise ValueError("a stochastic interface takes no prosody knobs other than 1 "
                             "and no given durations, pitch or energy")
        return None

    @torch.inference_mode()
    def _longform(self, max_frames: int, noise=None, flow_noise=None, **inputs):
        """The acoustic step, then its mel vocoded time-sharded over the
        mesh (JAX ``interface.py:459-473``): eager, every rank alike.
        Returns ``_run_e2e``'s outputs, the wave (1, 384 * mel_length)."""
        from toucan_tpu_torch.dist.longform import synthesize_longform

        draws = self._draws(1, inputs["text"].shape[1], max_frames, noise=noise,
                            flow_noise=flow_noise)
        _, after, dur, pit, ene, lens = acoustic_step(self.model, max_frames=max_frames,
                                                      **draws, **inputs)
        wave = synthesize_longform(self._vocoder_call, after[0, :int(lens[0])], self.mesh)
        return torch.from_numpy(wave)[None], after, dur, pit, ene, lens

    def _e2e_bucket(self, max_frames: int, inputs: dict, live: bool = True) -> Bucket:
        """The acoustic step's bucket of these inputs (device tensors or
        None, named as ``acoustic_step``'s arguments) and of the noise they
        take (``_noise``), made and, on the card, captured on first use.
        Its key holds all that a graph fixes: batch size, phone bucket,
        ``max_frames`` and which overrides were given."""
        b, phones = inputs["text"].shape[:2]
        key = (b, phones, max_frames,
               *(inputs.get(k) is not None for k in ("durations", "pitch", "energy")))
        if key not in self._e2e_cache:
            specs = {k: None if v is None else (tuple(v.shape), v.dtype) for k, v in inputs.items()}
            specs.update((k, (shape, torch.float32))
                         for k, (shape, _) in self._noise(b, phones, max_frames).items())
            self._e2e_cache[key] = self._bucket(
                functools.partial(acoustic_step, self.model, max_frames=max_frames), specs, live)
        return self._e2e_cache[key]

    def _vocoder_bucket(self, rows: int, frames: int, live: bool = True) -> Bucket:
        """The mel -> wave bucket of (rows, frames), made and, on the card,
        captured on first use."""
        if (rows, frames) not in self._vocoder_cache:
            self._vocoder_cache[rows, frames] = self._bucket(
                lambda mel: (self._vocoder_call(mel),),
                {"mel": ((rows, frames, self.config.mel_channels), torch.float32)}, live)
        return self._vocoder_cache[rows, frames]

    def _run_vocoder(self, mel):
        """(B, F, 80) device mel -> (B, 384 F) wave through the bucket of
        (B, F) (eagerly where ``_eager`` is set), without waiting."""
        if self._eager:
            return self._vocoder_call(mel.contiguous())[..., 0]
        wave, = self._vocoder_bucket(*mel.shape[:2])(mel=mel)
        return wave[..., 0]

    def _run_e2e(self, max_frames: int, noise=None, flow_noise=None, **inputs):
        """Text -> wave: the acoustic step through its bucket at
        ``max_frames`` decoded frames, then the vocoder through the bucket
        of its ``_cut_frames``, once the host has read the mel lengths (the
        step's one wait for the device; none where the vocoder gives no
        receptive frames and runs every decoded frame); eagerly where
        ``_eager`` is set.  ``inputs``: device tensors or None; ``noise``
        and ``flow_noise`` (``_noise``): device tensors, or None to draw
        them from the generator.  Returns (wave over the frames the vocoder
        ran, after, durations, pitch, energy, mel_lengths) on the device."""
        b, phones = inputs["text"].shape[:2]
        draws = self._draws(b, phones, max_frames, self._eager, noise=noise,
                            flow_noise=flow_noise)
        if self._eager:
            mel, *outs = acoustic_step(self.model, max_frames=max_frames, **draws, **inputs)
        else:
            given = {k: v for k, v in inputs.items() if v is not None}
            mel, *outs = self._e2e_bucket(max_frames, inputs)(**draws, **given)
        frames = max_frames
        if self._reach is not None:
            with span("toucan.fetch"):
                frames = self._cut_frames(int(outs[-1].cpu().max()), max_frames)
        self.counters["steps_uncut"] += frames == max_frames
        return (self._run_vocoder(mel[:, :frames]), *outs)

    def precompile(self, phone_buckets=(PHONE_BUCKET, 4 * PHONE_BUCKET), batch_sizes=(1,),
                   with_overrides=False):
        """Make the buckets of these phone buckets and batch sizes (with
        ``with_overrides``: of calls that give durations, pitch and energy)
        before any request, so that serving never pays a warm-up and a
        capture on a live request: every vocoder frame bucket a step of
        theirs can reach (``_cut_frames`` of each length up to its decoded
        frames), then their text -> mel buckets.  Each kind goes largest
        first: the smaller graphs then capture into the memory the larger
        captures left free in the interface's pool."""
        if with_overrides and self.stochastic:
            raise ValueError("a stochastic interface takes no given durations, pitch or energy")
        cuts = {(b, self._cut_frames(length, n_pad * FRAMES_PER_PHONE))
                for b in batch_sizes for n_pad in phone_buckets
                for length in range(n_pad * FRAMES_PER_PHONE + 1)}
        for b, frames in sorted(cuts, key=lambda bf: -bf[0] * bf[1]):
            self._vocoder_bucket(b, frames, live=False)
        for b, n_pad in sorted(itertools.product(batch_sizes, phone_buckets),
                               key=lambda bn: -bn[0] * bn[1]):
            given = {}
            if with_overrides:
                given = dict(durations=[np.ones(n_pad)] * b, pitch=[np.zeros((n_pad, 1))] * b,
                             energy=[np.zeros((n_pad, 1))] * b)
            inputs, _ = self._stage([np.zeros((n_pad, self.config.input_features))] * b,
                                    self._refuse_prosody((1.0,) * 4), **given)
            self._e2e_bucket(n_pad * FRAMES_PER_PHONE, inputs, live=False)

    @_under_policy
    @torch.inference_mode()
    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        """(L, 80) -> (L*384,) 24 kHz wave, through a bucket of 64 frames."""
        frames = _round_up(len(mel), 64)
        mel_p = np.zeros((1, frames, mel.shape[1]), np.float32)
        mel_p[0, :len(mel)] = mel
        wave = self._run_vocoder(self._tensor(mel_p))
        return wave[0, :len(mel) * SAMPLES_PER_FRAME].cpu().numpy()

    @_under_policy
    def _dispatch_call(self, text: str, duration_scaling_factor=1.0, pitch_variance_scale=1.0,
                       energy_variance_scale=1.0, pause_duration_scaling_factor=1.0,
                       durations=None, pitch=None, energy=None, input_is_phones=False,
                       glow_noise=None, flow_noise=None, index=None):
        """Enqueue one sentence's text -> wave and return its device outputs
        (wave, after, durations, pitch, energy, mel_lengths) and its phone
        count, having waited for its acoustic step only (``_run_e2e``), so
        that a caller can enqueue several sentences before it fetches the
        first wave (``read_to_file``, which gives the sentence's ``index``
        to its span)."""
        knobs = self._refuse_prosody((duration_scaling_factor, pitch_variance_scale,
                                      energy_variance_scale, pause_duration_scaling_factor),
                                     durations, pitch, energy)
        if flow_noise is not None and not self.stochastic:
            raise ValueError("flow noise is the stochastic model's")
        with span("toucan.dispatch", index=index):
            with span("toucan.frontend"):
                phones = self.text2phone.string_to_features(text, input_phonemes=input_is_phones)
            with span("toucan.stage"):
                given = {k: [v] for k, v in dict(durations=durations, pitch=pitch,
                                                 energy=energy).items() if v is not None}
                inputs, n_pad = self._stage([phones], knobs, **given)
                n = len(phones)
                if durations is not None:
                    max_frames = _round_up(int(np.sum(durations)
                                               * max(duration_scaling_factor, 1.0)) + 2, 64)
                else:
                    max_frames = n_pad * FRAMES_PER_PHONE
                noise = None
                if glow_noise is not None:  # injected z (deterministic synthesis, parity tests)
                    glow_noise = np.asarray(glow_noise, np.float32)
                    z = np.zeros((1, max_frames, self.config.mel_channels), np.float32)
                    z[0, :len(glow_noise)] = glow_noise[:max_frames]
                    noise = self._tensor(z)
                if flow_noise is not None:  # injected (3, n, 2): the draws of the sentence's phones
                    flow_noise = self._tensor(
                        np.pad(np.asarray(flow_noise, np.float32)[:, None],
                               ((0, 0), (0, 0), (0, n_pad - n), (0, 0))))
            run = self._run_e2e
            if self.mesh is not None and max_frames >= self.longform_frames:
                run = self._longform
            outs = run(max_frames, noise, flow_noise=flow_noise, **inputs)
        self.counters["sentences"] += 1
        self._count_run(outs[0])
        return outs, n

    def _request(self) -> int:
        """Count a request on an entry point; returns its id."""
        self.counters["requests"] += 1
        return self.counters["requests"]

    def _count_run(self, waves):
        """Count the vocoder frames of a step's (rows, samples) waves."""
        self.counters["frames_run"] += waves.shape[0] * (waves.shape[-1] // SAMPLES_PER_FRAME)

    def _delivered(self, mel_len: int, decoded: int) -> int:
        """A mel length read to the host, clamped to the ``decoded`` frames
        of its step; the frames past them count as truncated."""
        if mel_len <= decoded:
            return mel_len
        self.counters["frames_truncated"] += mel_len - decoded
        return decoded

    def _fetch(self, waves, lens, decoded: int, whole: bool = False) -> list:
        """Each row of a step's (B, samples) device ``waves`` cut at its mel
        length (``lens``, clamped to the ``decoded`` frames by
        ``_delivered``), on the host; counts the frames delivered.  Each
        length is read, then its row copied cut; ``whole``: the waves and
        lengths are copied whole, then cut on the host."""
        if whole:
            waves, lens = waves.cpu().numpy(), lens.cpu().numpy()
        out = []
        for wave, mel_len in zip(waves, lens):
            mel_len = self._delivered(int(mel_len), decoded)
            self.counters["frames_delivered"] += mel_len
            out.append(wave[:mel_len * SAMPLES_PER_FRAME])
        return out if whole else [wave.cpu().numpy() for wave in out]

    @_under_policy
    def __call__(self, text: str, duration_scaling_factor=1.0, pitch_variance_scale=1.0,
                 energy_variance_scale=1.0, pause_duration_scaling_factor=1.0,
                 durations=None, pitch=None, energy=None, input_is_phones=False,
                 return_duration_pitch_energy=False, return_plot_as_filepath=False,
                 glow_noise=None, flow_noise=None):
        """The 24 kHz wave; with ``return_duration_pitch_energy`` also the
        per-phone durations, pitch and energy, with ``return_plot_as_filepath``
        (and not the former) the path of a PNG of ``plot_synthesis``.
        ``glow_noise`` (frames, 80) and, on a stochastic interface,
        ``flow_noise`` (3, phones, 2) replace the generator's draws."""
        with span("toucan.call", self._request()):
            (wave, after, dur, pit, ene, lens), n = self._dispatch_call(
                text, duration_scaling_factor, pitch_variance_scale, energy_variance_scale,
                pause_duration_scaling_factor, durations, pitch, energy, input_is_phones,
                glow_noise, flow_noise)
            with span("toucan.fetch"):
                wave, = self._fetch(wave, lens, after.shape[1])
                if return_duration_pitch_energy:
                    out = (wave, dur[0, :n].cpu().numpy(), pit[0, :n, 0].cpu().numpy(),
                           ene[0, :n, 0].cpu().numpy())
                elif return_plot_as_filepath:
                    mel = after[0, :len(wave) // SAMPLES_PER_FRAME].cpu().numpy()
                    dur, pit = dur[0, :n].cpu().numpy(), pit[0, :n, 0].cpu().numpy()
            if return_duration_pitch_energy:
                return out
            if return_plot_as_filepath:
                if input_is_phones:
                    labels = self.text2phone.postprocess_phoneme_string(
                        text, for_feature_extraction=False, for_plot_labels=True)
                else:
                    labels = self.text2phone.get_phone_string(text, for_plot_labels=True)
                return wave, self.plot_synthesis(mel, dur, pit, labels)
            return wave

    def plot_synthesis(self, mel, durations, pitch, labels, path=None):
        """Spectrogram + prosody overview plot (reference:
        ``ToucanTTSInterface.py:171-228``): mel image, per-phone duration
        boundaries with phone labels on the x axis, pitch curve overlay.
        Returns the saved filepath.  Needs matplotlib, imported here."""
        import tempfile

        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        mel = np.asarray(mel)
        durations = np.asarray(durations, np.int64)
        pitch = np.asarray(pitch).reshape(-1)
        fig, ax = plt.subplots(figsize=(9, 4))
        ax.imshow(mel.T, origin="lower", aspect="auto", cmap="GnBu",
                  interpolation="nearest")
        bounds = np.cumsum(durations)
        ax.vlines(bounds - 0.5, 0, mel.shape[1] - 1, colors="black",
                  linewidth=0.4, alpha=0.4)
        centers = bounds - durations / 2.0
        n = min(len(centers), len(labels))
        ax.set_xticks(centers[:n])
        ax.set_xticklabels(list(labels)[:n], fontsize=7)
        # per-frame pitch curve (phone-level values expanded by duration),
        # scaled into the lower 40% of the mel axis like the reference plot
        pitch_frames = np.repeat(pitch[:len(durations)], durations)
        if len(pitch_frames) and pitch_frames.max() > 0:
            scaled = pitch_frames / pitch_frames.max() * (mel.shape[1] * 0.4)
            ax.plot(np.arange(len(scaled)), scaled, color="crimson",
                    linewidth=1.2, label="pitch")
            ax.legend(loc="upper right", fontsize=7)
        ax.set_xlim(-0.5, mel.shape[0] - 0.5)
        ax.set_ylabel("mel bin")
        fig.tight_layout()
        if path is None:
            path = tempfile.NamedTemporaryFile(suffix=".png", delete=False).name
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    @_under_policy
    def synthesize_batch(self, texts, input_is_phones=False, languages=None,
                         utterance_embeddings=None, duration_scaling_factor=1.0,
                         pitch_variance_scale=1.0, energy_variance_scale=1.0,
                         pause_duration_scaling_factor=1.0, return_pcm16=False):
        """One device run over a batch of texts; returns a list of 24 kHz
        waves.  ``languages``: optional per-text language codes;
        ``utterance_embeddings``: optional (B, E).  Conv masking makes each
        row equal its exact-length single run.  ``return_pcm16``: int16
        waves, converted on the device (a quarter of the bytes to fetch)."""
        b = len(texts)
        langs = languages if languages is not None else [None] * b
        knobs = self._refuse_prosody((duration_scaling_factor, pitch_variance_scale,
                                      energy_variance_scale, pause_duration_scaling_factor))
        with span("toucan.batch", self._request()):
            with span("toucan.frontend"):
                frontends = [self.text2phone if lg is None else self._frontend(lg)
                             for lg in langs]
                phones = [fe.string_to_features(tx, input_phonemes=input_is_phones)
                          for fe, tx in zip(frontends, texts)]
            with span("toucan.stage"):
                inputs, n_pad = self._stage(
                    phones, knobs, utt=utterance_embeddings,
                    lang_ids=[self.lang_id if lg is None else language_id(lg) for lg in langs])
            waves, after, _, _, _, lens = self._run_e2e(n_pad * FRAMES_PER_PHONE, **inputs)
            self.counters["sentences"] += b
            self._count_run(waves)
            if return_pcm16:
                waves = torch.round(waves.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
            with span("toucan.fetch"):
                return self._fetch(waves, lens, after.shape[1], whole=True)

    # ----------------------------------------------------------- file I/O

    @_under_policy
    def read_to_file(self, text_list, file_location, duration_scaling_factor=1.0,
                     pitch_variance_scale=1.0, energy_variance_scale=1.0, silent=True,
                     dur_list=None, pitch_list=None, energy_list=None,
                     increased_compatibility_mode=False, input_is_phones=False):
        """Synthesize each text, join them with silence, write a 24 kHz PCM16
        wav (``increased_compatibility_mode``: each sample twice, 48 kHz).
        Every sentence is enqueued before the first wave is fetched: the
        host waits for a sentence's acoustic half, enqueues its vocoder and
        then works on the next sentence while the device vocodes, so the
        device idles one wake-up and one launch a sentence.
        Returns the samples (int16 in the compatibility mode)."""
        with span("toucan.read_to_file", self._request()):
            inflight = []
            for text, durations, pitch, energy in itertools.zip_longest(
                    text_list, dur_list or [], pitch_list or [], energy_list or []):
                if not text or not text.strip():
                    continue
                if not silent:
                    print(f"Now synthesizing: {text}")
                outs, _ = self._dispatch_call(
                    text, duration_scaling_factor=duration_scaling_factor,
                    pitch_variance_scale=pitch_variance_scale,
                    energy_variance_scale=energy_variance_scale, durations=durations,
                    pitch=pitch, energy=energy, input_is_phones=input_is_phones,
                    index=len(inflight))
                inflight.append((outs[0], outs[5], outs[1].shape[1]))
            silence = np.zeros(SENTENCE_JOIN_SILENCE, np.float32)
            pieces = [silence]
            for wave, lens, decoded in inflight:
                with span("toucan.fetch"):
                    pieces += [*self._fetch(wave, lens, decoded), silence]
            with span("toucan.write"):
                wav, sr = _compatible(np.concatenate(pieces), increased_compatibility_mode)
                write_wav(file_location, wav, sr)
            return wav

    def read_aloud(self, text, duration_scaling_factor=1.0, pitch_variance_scale=1.0,
                   energy_variance_scale=1.0, blocking=False, increased_compatibility_mode=False,
                   input_is_phones=False, _player=None):
        """Synthesize and play through the host's audio device (reference
        ``ToucanTTSInterface.py:287-296``) with half a second of trailing
        silence; ``blocking`` waits for the end.  ``_player`` stands in for
        the ``sounddevice`` module (tests, hosts without audio)."""
        if not text or text.strip() == "":
            return None
        player = _player
        if player is None:
            import sounddevice as player  # host audio is optional
        wav = self(text, duration_scaling_factor=duration_scaling_factor,
                   pitch_variance_scale=pitch_variance_scale,
                   energy_variance_scale=energy_variance_scale, input_is_phones=input_is_phones)
        wav, sr = _compatible(np.concatenate([wav, np.zeros(12000, np.float32)]),
                              increased_compatibility_mode)
        player.play(wav, samplerate=sr)
        if blocking:
            player.wait()
        return wav


def _compatible(wav, increased_compatibility_mode):
    """(samples, rate): 24 kHz as they are, or every sample twice at 48 kHz
    as PCM16 for devices that want it."""
    if not increased_compatibility_mode:
        return wav, 24000
    return (np.clip(np.repeat(wav, 2), -1, 1) * 32767).astype(np.int16), 48000


def write_wav(path, data, sr):
    """PCM16 mono WAV with the standard library."""
    if data.dtype != np.int16:
        data = (np.clip(data, -1, 1) * 32767).astype(np.int16)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(data.tobytes())
