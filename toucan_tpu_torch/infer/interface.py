"""End-to-end TTS interface: text -> articulatory features -> mel -> wave.

Counterpart of ``toucan_tpu/infer/interface.py`` (reference
``InferenceInterfaces/ToucanTTSInterface.py``): language/accent setters,
the utterance embedding (given, or from reference audio through the GST),
the prosody-control knobs, per-phone prosody overrides, batched synthesis,
``read_to_file``, ``read_aloud``, ``plot_synthesis``, the HiFiGAN or
BigVGAN vocoder and ``quantize_vocoder`` (int8 HiFiGAN stages).  Inputs are
padded to the same buckets as the JAX interface (32 phones, 16 frames per
phone, 64 vocoder frames), so both compute on the same shapes.  Text to wave runs
on the device without a host round trip; frames past each mel length are
zeroed before vocoding.  Every entry point runs its convs and matmuls
under the interface's ``matmul_precision`` (``utils.device.matmul_precision``:
"float32" by default, IEEE f32; "default" lets cuDNN and cuBLAS use TF32,
as JAX's default precision does on an NVIDIA card) whatever the caller's
TF32 settings, and leaves those settings as it found them.  ``dtype``
(``torch.bfloat16``) is the acoustic model's and a vocoder named by string's
compute dtype, as the JAX interface's ``dtype``; the GST, a vocoder module
passed in and the returned waves, mels and prosody stay f32.

As the JAX interface jits one function per bucket, the port keeps one
``infer.capture.Bucket`` per (batch size, phone bucket, frame bucket,
which of durations/pitch/energy were given) in ``_e2e_cache``, and one per
64-frame bucket in ``_vocoder_cache``: on the card a CUDA graph, captured at
the bucket's first use or by ``precompile`` and replayed after that; on the
CPU the same buckets run eagerly.  All graphs of an interface capture into
one memory pool, so a new bucket adds only what its graph needs beyond
what the pool already holds.  The knobs are a (4,) tensor that only
the device reads, so they never make a new bucket.  ``_dispatch_call``
enqueues a sentence without waiting for the device, and ``read_to_file``
enqueues every sentence before it fetches the first.  A graph fixes the
vocoder's mode and the precision policy at its capture:
``quantize_vocoder`` and setting ``matmul_precision`` clear the caches.
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
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator, calibrate_act_scales
from toucan_tpu_torch.utils.device import check_policy, matmul_precision, resolve_device

VOCODERS = {"hifigan": HiFiGANGenerator, "bigvgan": BigVGAN}
PHONE_BUCKET = 32
FRAMES_PER_PHONE = 16       # static upper bound for the upsampled length
SAMPLES_PER_FRAME = 384     # 24 kHz out / 16 kHz-rate mel frames (hop 256)
SENTENCE_JOIN_SILENCE = 10600
CALIBRATION_PANGRAM = "~ðə kwˈɪk bɹˈaʊn fˈɑks dʒˈʌmps ˈoʊvəɹ ðə lˈeɪzi dˈɔɡ~#"


def _round_up(n, m):
    return max(m, int(math.ceil(n / m)) * m)


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
                 matmul_precision: str = "float32", mesh=None, longform_frames: int = 1024):
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
        collective, which a graph cannot hold under gloo."""
        self.device = resolve_device(device)
        self.config = config or ToucanTTSConfig()
        if dtype is not None and self.config.dtype != dtype:
            self.config = dataclasses.replace(self.config, dtype=dtype)
        self.model = ToucanTTS(self.config)
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
        self._e2e_cache = {}         # fused text -> wave buckets
        self._vocoder_cache = {}     # mel -> wave buckets of _vocode
        self._graph_pool = None      # the memory pool all buckets' graphs capture into
        self._eager = False          # run every call eagerly, no bucket (comparisons)
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
        scales of its capture."""
        self._e2e_cache.clear()
        self._vocoder_cache.clear()
        self._graph_pool = None

    def _bucket(self, step, inputs: dict) -> Bucket:
        """A ``Bucket`` on the interface's device; on the card its graph
        captures into the pool that the interface's other graphs share."""
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return Bucket(step, inputs, self.device, self._graph_pool, self.matmul_precision)

    @torch.inference_mode()
    def _calibration_mel(self, text: str) -> torch.Tensor:
        phones = self.text2phone.string_to_features(text, input_phonemes=True)
        n = len(phones)
        n_pad = _round_up(n, PHONE_BUCKET)
        text_arr = np.zeros((1, n_pad, phones.shape[1]), np.float32)
        text_arr[0, :n] = phones
        max_frames = n_pad * FRAMES_PER_PHONE
        _, after, *_, lens = self.model.infer(
            self._tensor(text_arr), self._tensor([n], torch.int64), max_frames,
            utterance_embedding=self._utt(1), lang_ids=self._lang([self.lang_id]),
            glow_noise=self._noise(1, max_frames))
        return after[:, :int(lens[0])].float()

    def _vocoder_call(self, mel):
        if self._voc_act_scales is None:
            return self.vocoder(mel)
        return self.vocoder(mel, act_scales=self._voc_act_scales)

    def _frontend(self, lang: str) -> TextFrontend:
        if lang not in self._frontends:
            self._frontends[lang] = TextFrontend(language=lang, use_g2p=self.use_g2p)
        return self._frontends[lang]

    # ----------------------------------------------------------- synthesis

    def _tensor(self, x, dtype=torch.float32):
        """A host array on the interface's device.  To the card it goes
        through pinned memory without waiting for the device, so a caller
        can enqueue a call while earlier ones still run."""
        if x is None:
            return None
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _lang(self, ids):
        """(B, 1) language ids, or None where the model has no language
        embedding."""
        return None if self.lang_id is None else self._tensor([[i] for i in ids], torch.int64)

    def _draw_noise(self, buf: torch.Tensor):
        """Fill buf with glow noise, N(0, 0.8^2), from the interface's generator."""
        torch.randn(buf.shape, generator=self.generator, out=buf)
        buf.mul_(0.8)

    def _noise(self, b: int, max_frames: int) -> torch.Tensor:
        buf = torch.empty((b, max_frames, self.config.mel_channels), device=self.device)
        self._draw_noise(buf)
        return buf

    @torch.inference_mode()
    def _e2e(self, text, text_lengths, max_frames: int, utt, lang, noise, knobs=(1.0,) * 4,
             durations=None, pitch=None, energy=None):
        """Text -> mel -> wave on the device, the step of an ``_e2e_cache``
        bucket.  Tensors on ``self.device``; ``knobs`` the (duration, pitch
        variance, energy variance, pause) scales, a (4,) tensor or floats.
        Returns (wave (B, 384*max_frames), after, durations, pitch, energy,
        mel_lengths); the mel handed to the vocoder and the one returned are
        f32 whatever the model's dtype, as in JAX (``interface.py:239``)."""
        after, dur, pit, ene, lens = self._acoustic(
            text, text_lengths, max_frames, utt, lang, noise, knobs, durations, pitch, energy)
        mask = (torch.arange(max_frames, device=after.device)[None, :] < lens[:, None])[..., None]
        mel = torch.where(mask, after, torch.zeros((), device=after.device))
        wave = self._vocoder_call(mel)[..., 0]
        return wave, after, dur, pit, ene, lens

    def _acoustic(self, text, text_lengths, max_frames: int, utt, lang, noise, knobs,
                  durations=None, pitch=None, energy=None):
        """Text -> (after (f32), durations, pitch, energy, mel_lengths)."""
        _, after, dur, pit, ene, lens = self.model.infer(
            text, text_lengths, max_frames, utterance_embedding=utt, lang_ids=lang,
            gold_durations=durations, gold_pitch=pitch, gold_energy=energy,
            duration_scaling_factor=knobs[0], pitch_variance_scale=knobs[1],
            energy_variance_scale=knobs[2], pause_duration_scaling_factor=knobs[3],
            glow_noise=noise)
        return after.float(), dur, pit, ene, lens

    @torch.inference_mode()
    def _longform(self, max_frames: int, noise=None, **inputs):
        """The acoustic model, then its mel vocoded time-sharded over the
        mesh (JAX ``interface.py:459-473``): eager, every rank alike.
        Returns ``_e2e``'s outputs, the wave (1, 384 * mel_length) only."""
        from toucan_tpu_torch.dist.longform import synthesize_longform

        if noise is None:
            noise = self._noise(1, max_frames)
        after, dur, pit, ene, lens = self._acoustic(max_frames=max_frames, noise=noise,
                                                    **inputs)
        wave = synthesize_longform(self._vocoder_call, after[0, :int(lens[0])], self.mesh)
        return torch.from_numpy(wave)[None], after, dur, pit, ene, lens

    def _e2e_bucket(self, max_frames: int, inputs: dict) -> Bucket:
        """The bucket of these inputs (device tensors or None, named as
        ``_e2e``'s arguments), made and, on the card, captured on first use.
        Its key holds all that a graph fixes: batch size, phone bucket,
        ``max_frames`` and which overrides were given."""
        text = inputs["text"]
        key = (text.shape[0], text.shape[1], max_frames,
               *(inputs.get(k) is not None for k in ("durations", "pitch", "energy")))
        if key not in self._e2e_cache:
            specs = {k: None if v is None else (tuple(v.shape), v.dtype) for k, v in inputs.items()}
            specs["noise"] = ((text.shape[0], max_frames, self.config.mel_channels), torch.float32)
            self._e2e_cache[key] = self._bucket(
                functools.partial(self._e2e, max_frames=max_frames), specs)
        return self._e2e_cache[key]

    def _run_e2e(self, max_frames: int, noise=None, **inputs):
        """``_e2e`` through its bucket (eagerly where ``_eager`` is set).
        ``inputs``: device tensors or None; ``noise`` a device tensor, or
        None to draw it from the generator into the bucket's buffer.
        Returns the device outputs without waiting for the device."""
        if self._eager:
            if noise is None:
                noise = self._noise(inputs["text"].shape[0], max_frames)
            return self._e2e(max_frames=max_frames, noise=noise, **inputs)
        bucket = self._e2e_bucket(max_frames, inputs)
        given = {k: v for k, v in inputs.items() if v is not None}
        return bucket(noise=self._draw_noise if noise is None else noise, **given)

    def precompile(self, phone_buckets=(PHONE_BUCKET, 4 * PHONE_BUCKET), batch_sizes=(1,),
                   with_overrides=False):
        """Make the text -> wave buckets of these phone buckets and batch
        sizes (with ``with_overrides``: of calls that give durations, pitch
        and energy) before any request, so that serving never pays a
        warm-up and a capture on a live request.  The largest bucket comes
        first: the smaller graphs then capture into the memory its capture
        left free in the interface's pool."""
        feats = self.config.input_features
        for b, n_pad in sorted(itertools.product(batch_sizes, phone_buckets),
                               key=lambda bn: -bn[0] * bn[1]):
            inputs = dict(text=self._tensor(np.zeros((b, n_pad, feats))),
                          text_lengths=self._tensor(np.full(b, n_pad), torch.int64),
                          utt=self._utt(b), lang=self._lang([self.lang_id] * b),
                          knobs=self._tensor(np.ones(4)))
            if with_overrides:
                inputs.update(durations=self._tensor(np.ones((b, n_pad)), torch.int32),
                              pitch=self._tensor(np.zeros((b, n_pad, 1))),
                              energy=self._tensor(np.zeros((b, n_pad, 1))))
            self._e2e_bucket(n_pad * FRAMES_PER_PHONE, inputs)

    @_under_policy
    @torch.inference_mode()
    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        """(L, 80) -> (L*384,) 24 kHz wave, through a bucket of 64 frames."""
        frames = _round_up(len(mel), 64)
        mel_p = np.zeros((1, frames, mel.shape[1]), np.float32)
        mel_p[0, :len(mel)] = mel
        mel_t = self._tensor(mel_p)
        if self._eager:
            wave = self._vocoder_call(mel_t)
        else:
            if frames not in self._vocoder_cache:
                self._vocoder_cache[frames] = self._bucket(
                    lambda mel: (self._vocoder_call(mel),), {"mel": (mel_p.shape, torch.float32)})
            wave, = self._vocoder_cache[frames](mel=mel_t)
        return wave[0, :len(mel) * SAMPLES_PER_FRAME, 0].cpu().numpy()

    def _utt(self, b: int):
        if self.default_utterance_embedding is None:
            return None
        return self._tensor(np.tile(self.default_utterance_embedding[None], (b, 1)))

    @_under_policy
    def _dispatch_call(self, text: str, duration_scaling_factor=1.0, pitch_variance_scale=1.0,
                       energy_variance_scale=1.0, pause_duration_scaling_factor=1.0,
                       durations=None, pitch=None, energy=None, input_is_phones=False,
                       glow_noise=None):
        """Enqueue one sentence's text -> wave and return its device outputs
        (wave, after, durations, pitch, energy, mel_lengths) and its phone
        count, without waiting for the device, so that a caller can enqueue
        several sentences before it fetches the first (``read_to_file``)."""
        phones = self.text2phone.string_to_features(text, input_phonemes=input_is_phones)
        n = len(phones)
        n_pad = _round_up(n, PHONE_BUCKET)
        text_arr = np.zeros((1, n_pad, phones.shape[1]), np.float32)
        text_arr[0, :n] = phones
        if durations is not None:
            max_frames = _round_up(int(np.sum(durations)
                                       * max(duration_scaling_factor, 1.0)) + 2, 64)
        else:
            max_frames = n_pad * FRAMES_PER_PHONE

        def pad_override(x, dtype=torch.float32):
            if x is None:
                return None
            x = np.asarray(x, np.float32)
            out = np.zeros((1, n_pad) + x.shape[1:], np.float32)
            out[0, :n] = x
            return self._tensor(out, dtype)

        noise = None
        if glow_noise is not None:  # injected z (deterministic synthesis, parity tests)
            glow_noise = np.asarray(glow_noise, np.float32)
            z = np.zeros((1, max_frames, self.config.mel_channels), np.float32)
            z[0, :len(glow_noise)] = glow_noise[:max_frames]
            noise = self._tensor(z)
        knobs = (duration_scaling_factor, pitch_variance_scale, energy_variance_scale,
                 pause_duration_scaling_factor)
        run = self._run_e2e
        if self.mesh is not None and max_frames >= self.longform_frames:
            run = self._longform
        outs = run(max_frames, noise, text=self._tensor(text_arr),
                   text_lengths=self._tensor([n], torch.int64), utt=self._utt(1),
                   lang=self._lang([self.lang_id]), knobs=self._tensor(knobs),
                   durations=pad_override(durations, torch.int32),
                   pitch=pad_override(pitch), energy=pad_override(energy))
        return outs, n

    @_under_policy
    def __call__(self, text: str, duration_scaling_factor=1.0, pitch_variance_scale=1.0,
                 energy_variance_scale=1.0, pause_duration_scaling_factor=1.0,
                 durations=None, pitch=None, energy=None, input_is_phones=False,
                 return_duration_pitch_energy=False, return_plot_as_filepath=False,
                 glow_noise=None):
        """The 24 kHz wave; with ``return_duration_pitch_energy`` also the
        per-phone durations, pitch and energy, with ``return_plot_as_filepath``
        (and not the former) the path of a PNG of ``plot_synthesis``."""
        (wave, after, dur, pit, ene, lens), n = self._dispatch_call(
            text, duration_scaling_factor, pitch_variance_scale, energy_variance_scale,
            pause_duration_scaling_factor, durations, pitch, energy, input_is_phones,
            glow_noise)
        mel_len = int(lens[0])
        wave = wave[0, :mel_len * SAMPLES_PER_FRAME].cpu().numpy()
        if return_duration_pitch_energy:
            return (wave, dur[0, :n].cpu().numpy(), pit[0, :n, 0].cpu().numpy(),
                    ene[0, :n, 0].cpu().numpy())
        if return_plot_as_filepath:
            if input_is_phones:
                labels = self.text2phone.postprocess_phoneme_string(
                    text, for_feature_extraction=False, for_plot_labels=True)
            else:
                labels = self.text2phone.get_phone_string(text, for_plot_labels=True)
            path = self.plot_synthesis(after[0, :mel_len].cpu().numpy(),
                                       dur[0, :n].cpu().numpy(), pit[0, :n, 0].cpu().numpy(),
                                       labels)
            return wave, path
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
        frontends = [self.text2phone if lg is None else self._frontend(lg) for lg in langs]
        phones = [fe.string_to_features(tx, input_phonemes=input_is_phones)
                  for fe, tx in zip(frontends, texts)]
        lengths = np.asarray([len(p) for p in phones], np.int64)
        n_pad = _round_up(int(lengths.max()), PHONE_BUCKET)
        text_arr = np.zeros((b, n_pad, phones[0].shape[1]), np.float32)
        for i, p in enumerate(phones):
            text_arr[i, :len(p)] = p
        max_frames = n_pad * FRAMES_PER_PHONE
        if utterance_embeddings is None:
            utt = self._utt(b)
        else:
            utt = self._tensor(np.asarray(utterance_embeddings, np.float32).reshape(b, -1))
        knobs = (duration_scaling_factor, pitch_variance_scale, energy_variance_scale,
                 pause_duration_scaling_factor)
        waves, _, _, _, _, lens = self._run_e2e(
            max_frames, text=self._tensor(text_arr), text_lengths=self._tensor(lengths, torch.int64),
            utt=utt, lang=self._lang([self.lang_id if lg is None else language_id(lg)
                                      for lg in langs]),
            knobs=self._tensor(knobs))
        if return_pcm16:
            waves = torch.round(waves.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        waves, lens = waves.cpu().numpy(), lens.cpu().numpy()
        return [waves[i, :int(lens[i]) * SAMPLES_PER_FRAME] for i in range(b)]

    # ----------------------------------------------------------- file I/O

    @_under_policy
    def read_to_file(self, text_list, file_location, duration_scaling_factor=1.0,
                     pitch_variance_scale=1.0, energy_variance_scale=1.0, silent=True,
                     dur_list=None, pitch_list=None, energy_list=None,
                     increased_compatibility_mode=False, input_is_phones=False):
        """Synthesize each text, join them with silence, write a 24 kHz PCM16
        wav (``increased_compatibility_mode``: each sample twice, 48 kHz).
        Every sentence is enqueued before the first is fetched, so the
        host's work on one overlaps the device's on the ones before it.
        Returns the samples (int16 in the compatibility mode)."""
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
                energy_variance_scale=energy_variance_scale, durations=durations, pitch=pitch,
                energy=energy, input_is_phones=input_is_phones)
            inflight.append((outs[0], outs[5]))
        silence = np.zeros(SENTENCE_JOIN_SILENCE, np.float32)
        pieces = [silence]
        for wave, lens in inflight:
            pieces += [wave[0, :int(lens[0]) * SAMPLES_PER_FRAME].cpu().numpy(), silence]
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
