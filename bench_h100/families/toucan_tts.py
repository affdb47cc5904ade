"""The ToucanTTS family: the conformer acoustic model with its duration,
pitch and energy predictors, PostNet and glow, then a HiFiGAN or BigVGAN
vocoder (``configs/*.json`` with ``"family": "toucan_tts"``).

What the harness asks of this model, and of no other:

- ``build``, ``embedding_dim``, ``shape_weights``: the reference's modules
  and the model steps of the weights recipe (``harness/weights.py``): the
  glow's zero-init coupling ``end`` layers drawn from N(0, ``GLOW_END_STD``)
  in flow order, so that the flow reads the acoustic model's mel, and the
  duration predictor's output layer rescaled so that log(d + 1) has spread
  ``DURATION_SPREAD`` over the calibration sentences' phones (word
  boundaries aside, which the model zeroes), narrowed so that none passes
  ``LONGEST_PHONE`` frames, and shifted so that they take the corpus's
  frames a written word;
- ``build_interface`` and ``record_shapes``: the program, built from the
  reference's state dicts, and the shapes it ran each step at;
- ``noise``, ``noise_shape`` and ``Reference``: the glow noise drawn again,
  and the reference's synthesis and the numbers it judges a served
  sentence by;
- ``acoustic_flops``: the model FLOPs of the acoustic model.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100.harness.check import LANG_EN, ReferenceBase, relative_gap
from bench_h100.harness.serve import SAMPLES_PER_FRAME
from bench_h100.reference.frontend.inventory import feature_index
from bench_h100.reference.models import VOCODERS
from bench_h100.reference.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from bench_h100.reference.nn.masks import make_non_pad_mask

GLOW_END_STD = 0.02
DURATION_SPREAD = 0.25
LONGEST_PHONE = 15


# ------------------------------------------------------------------ weights

def build(config: dict, device) -> tuple:
    """(acoustic model, vocoder) of the reference on ``device``, each module
    initialised there by its own rule from the current seed of torch's
    generator on that device."""
    with torch.device(device):
        tts = ToucanTTS(ToucanTTSConfig(**config["acoustic"])).eval()
        voc = VOCODERS[config["vocoder"]](**config["vocoder_config"]).eval()
    return tts, voc


def embedding_dim(config: dict) -> int:
    return config["acoustic"]["utt_embed_dim"]


@torch.no_grad()
def shape_weights(tts, config: dict, embedding: torch.Tensor, calibration: list, lang_id: int,
                  frames_per_word: float):
    """The glow's coupling ends drawn, then the durations calibrated on
    ``calibration``: [((T, 62) features, written words)]."""
    for flow in getattr(tts, "post_flow", torch.nn.Module()).modules():
        if hasattr(flow, "end"):
            torch.nn.init.normal_(flow.end.weight, 0.0, GLOW_END_STD)
    _calibrate_durations(tts, calibration, embedding, lang_id, frames_per_word)


def _calibrate_durations(tts, calibration, emb, lang_id, frames_per_word):
    dp = tts.duration_predictor
    boundary = feature_index()["word-boundary"]
    raw = []
    hook = dp.linear.register_forward_hook(lambda m, i, o: raw.append(o[0, :, 0] - m.bias))
    utt = torch.nn.functional.normalize(emb, dim=-1)
    for feats, _ in calibration:
        x = torch.as_tensor(feats, device=emb.device)[None]
        n = x.shape[1]
        mask = make_non_pad_mask(torch.tensor([n], device=emb.device), n)
        enc = tts.encoder(x, mask[:, None, :], utterance_embedding=utt,
                          lang_ids=torch.tensor([[lang_id]], device=emb.device),
                          conv_mask=mask[..., None].float())
        dp(enc, utt, mask[..., None].float())
        raw[-1] = raw[-1][x[0, :, boundary] != 1]   # the model zeroes word boundaries
    hook.remove()
    r = torch.cat(raw)
    words = sum(w for _, w in calibration)
    # mean(d + 1) over the phones that take frames
    center = 1.0 + frames_per_word * words / len(r)
    # the spread, narrowed where the calibration's longest phone would pass
    # LONGEST_PHONE frames
    top = (r.max() - r.mean()).item()
    scale = min(DURATION_SPREAD / r.std().item(),
                math.log((LONGEST_PHONE + 1) / center) / max(top, 1e-12))
    dp.linear.weight.mul_(scale)
    # the bias at which the calibration's rounded durations sum to
    # frames_per_word frames a word (they grow with it)
    x, lo, hi = scale * r.double(), -20.0, 20.0
    for _ in range(60):
        mid = (lo + hi) / 2
        frames = torch.clamp(torch.round(torch.exp(x + mid) - 1.0), min=0.0).sum().item()
        lo, hi = (mid, hi) if frames < frames_per_word * words else (lo, mid)
    dp.linear.bias.fill_((lo + hi) / 2)


# ------------------------------------------------------------------ program

def build_interface(config: dict, tts_sd, voc_sd, embedding, seed: int, device):
    """The program, ``ToucanTTSInterface``, from the reference's state
    dicts, in the configuration's ``dtype``."""
    from toucan_tpu_torch.infer.interface import VOCODERS as PROGRAM_VOCODERS
    from toucan_tpu_torch.infer.interface import ToucanTTSInterface
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig as ProgramConfig

    dtype = getattr(torch, config["dtype"])
    vocoder = PROGRAM_VOCODERS[config["vocoder"]](**config["vocoder_config"], dtype=dtype)
    return ToucanTTSInterface(tts_sd, voc_sd, config=ProgramConfig(**config["acoustic"]),
                              vocoder=vocoder, default_embedding=embedding, language="en",
                              use_g2p=True, seed=seed, device=device, dtype=dtype,
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


# ---------------------------------------------------------------- the check

def noise_shape(config: dict, frames: int) -> tuple:
    """The glow noise a request of ``frames`` decoded frames draws."""
    return (1, frames, config["acoustic"]["mel_channels"])


def noise(seed: int, shapes: list, wanted: set, device) -> dict:
    """The glow noise of the draws in ``wanted``: the interface draws
    N(0, 1) into a buffer of each shape in ``shapes`` from its generator and
    scales it by 0.8, in order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in enumerate(shapes):
        z = torch.randn(shape, generator=gen, device=device)
        if k in wanted:
            out[k] = z * 0.8
    return out


class Reference(ReferenceBase):
    """The reference's synthesis at the shapes the program ran, and the
    numbers a served sentence is judged by:

    - ``duration_gap``: with predicted durations, how far, in frames, the
      reference's unrounded durations would have to move to round to what
      was served (0 when they round alike; a near-tie rounds either way, so
      the limit is small but not 0).  Where only the wave was served
      (a read-aloud page), the served lengths are read from it and the
      cheapest near-ties that explain them are taken.  With given
      durations, the largest gap between those served and those given;
    - ``pitch_err``, ``energy_err`` (where served): max abs gap over max abs
      reference;
    - ``wave_err``: max abs gap of the served wave over max abs reference
      wave (1 where the lengths differ), the reference forced with the
      served (or given) durations on the same glow noise.
    """

    def __init__(self, tts, voc, embedding, device):
        super().__init__(device)
        self.tts, self.voc = tts, voc
        self.utt = torch.as_tensor(embedding, device=device)[None]
        self.f2i = feature_index()

    def noise(self, seed: int, shapes: list, wanted: set) -> dict:
        return noise(seed, shapes, wanted, self.device)

    def _padded(self, x, pad: int, dtype):
        n = len(x)
        out = np.zeros((1, pad) + np.shape(x)[1:], dtype)
        out[0, :n] = x
        return torch.as_tensor(out, device=self.device)

    @torch.no_grad()
    def synthesize(self, feats: np.ndarray, pad: int, z: torch.Tensor, durations=None,
                   pitch=None, energy=None) -> dict:
        """Free (``durations`` None) or with the given durations (n,) and,
        where given, pitch and energy (n, 1), the text padded to ``pad``
        phones and decoded into the frames of the noise ``z``: features,
        unrounded durations, durations, pitch, energy, wave."""
        n = len(feats)
        frames = z.shape[1]
        x = self._padded(feats, pad, np.float32)
        gold = {}
        if durations is not None:
            gold["gold_durations"] = self._padded(durations, pad, np.int32)
        if pitch is not None:
            gold["gold_pitch"] = self._padded(pitch, pad, np.float32)
        if energy is not None:
            gold["gold_energy"] = self._padded(energy, pad, np.float32)
        raw = []
        hook = self.tts.duration_predictor.linear.register_forward_hook(
            lambda m, i, o: raw.append(o[0, :n, 0].double().cpu().numpy()))
        try:
            _, after, dur, pit, ene, lens = self.tts.infer(
                x, torch.tensor([n], device=self.device), frames, utterance_embedding=self.utt,
                lang_ids=torch.tensor([[LANG_EN]], device=self.device), glow_noise=z, **gold)
        finally:
            hook.remove()
        length = int(lens[0])
        mask = (torch.arange(frames, device=self.device)[None, :] < lens[:, None])[..., None]
        mel = torch.where(mask, after.float(), torch.zeros((), device=self.device))
        wave = self.voc(mel)[0, :length * SAMPLES_PER_FRAME, 0]
        x0 = x[0, :n].cpu().numpy()
        fixed = (x0[:, self.f2i["word-boundary"]] == 1)
        return dict(unrounded=np.exp(raw[0]) - 1.0 if raw else None, fixed=fixed,
                    durations=dur[0, :n].cpu().numpy(), pitch=pit[0, :n, 0].cpu().numpy(),
                    energy=ene[0, :n, 0].cpu().numpy(), wave=wave.cpu().numpy(),
                    frames=length)

    def judge(self, rec: dict, feats: np.ndarray, z: torch.Tensor, given=None) -> tuple:
        """(numbers, near-tie) of one served sentence; ``given`` the
        durations, pitch and energy the client gave the program, or None."""
        if given is not None:
            return self._judge_given(rec, feats, z, given)
        out = {}
        free = self.synthesize(feats, rec["phone_bucket"], z)
        prosody = {}
        if "durations" in rec:
            served = np.asarray(rec["durations"])
            if len(served) != len(feats):
                gap = math.inf
            else:
                gap = duration_gap(free["unrounded"], free["fixed"], free["durations"], served)
            for key in ("pitch", "energy"):
                prosody[f"{key}_err"] = relative_gap(rec[key], free[key])
        else:
            served, gap = resolve_lengths(free["unrounded"], free["fixed"], free["durations"],
                                          rec["frames"])
        tie = served is not None and not np.array_equal(served, free["durations"])
        out["duration_gap"] = float(gap)
        if served is None or not math.isfinite(gap):
            out["wave_err"] = 1.0
        else:
            forced = self.synthesize(feats, rec["phone_bucket"], z, served)
            out["wave_err"] = relative_gap(rec["wave"], forced["wave"])
        return {**out, **prosody}, tie

    def _judge_given(self, rec, feats, z, given):
        forced = self.synthesize(feats, rec["phone_bucket"], z, **given)
        served, want = np.asarray(rec["durations"], np.int64), np.asarray(given["durations"])
        gap = (float(np.abs(served - want).max(initial=0)) if served.shape == want.shape
               else math.inf)
        out = dict(duration_gap=gap,
                   wave_err=relative_gap(rec["wave"], forced["wave"]) if gap == 0 else 1.0)
        for key in ("pitch", "energy"):
            out[f"{key}_err"] = relative_gap(rec[key], forced[key])
        return out, False


def duration_gap(unrounded, fixed, ref, served) -> float:
    """Frames the reference's unrounded durations would have to move to
    round to ``served`` (0 where they round alike); phones the model fixes
    (word boundaries) must match exactly."""
    gap = 0.0
    for d, f, r, k in zip(unrounded, fixed, ref, served):
        if f or k == r:
            gap = max(gap, float(abs(int(k) - int(r))))
            continue
        lo = -math.inf if k == 0 else k - 0.5
        gap = max(gap, lo - d, d - (k + 0.5))
    return gap


def resolve_lengths(unrounded, fixed, ref, frames: int) -> tuple:
    """(durations, gap): the reference's rounding with the fewest and
    cheapest near-ties flipped so that the glow's even length of their sum
    is ``frames``, and the largest move that took."""
    total = int(np.sum(ref))
    best = (None, math.inf)
    for target in (frames, frames + 1):
        delta = target - total
        step = 1 if delta > 0 else -1
        costs = []
        for i, (d, f, r) in enumerate(zip(unrounded, fixed, ref)):
            if f or (step < 0 and r == 0):
                continue
            costs.append(((r + 0.5) - d if step > 0 else d - (r - 0.5), i))
        costs.sort()
        if abs(delta) > len(costs):
            continue
        chosen = costs[:abs(delta)]
        gap = max([max(c, 0.0) for c, _ in chosen], default=0.0)
        if gap < best[1]:
            durs = np.array(ref, np.int64)
            for _, i in chosen:
                durs[i] += step
            best = (durs, gap)
    return best


# -------------------------------------------------------------------- FLOPs
#
# The count is of what the architecture needs, whoever implements it: 2
# flops per multiply-add of every linear layer, convolution and attention
# product (what ``torch.utils.flop_counter.FlopCounterMode`` counts on the
# reference at those exact shapes), except that the rel-pos term q_v . p is
# counted over the T x T offsets a row needs, not the 2T - 1 columns the
# plain version's rel-shift computes.

def _conformer_block(t: int, d: int, units: int, kernel: int) -> int:
    ffn = 2 * (4 * t * d * units)                # macaron and final feed-forward
    proj = 8 * t * d * d + 2 * (2 * t - 1) * d * d  # q, k, v, out; pos on 2T - 1 offsets
    scores = 6 * t * t * d                       # q_u.k, q_v.p (T x T), attn.v
    conv = 4 * t * d * d + 2 * t * d * kernel + 2 * t * d * d
    return ffn + proj + scores + conv


def _predictor(n: int, d: int, layers: int, chans: int, kernel: int, emb: int) -> int:
    convs = sum(2 * n * kernel * (d if i == 0 else chans) * chans for i in range(layers))
    norms = layers * 2 * 2 * (emb * emb + emb * chans + chans * chans) if emb else 0
    return convs + norms + 2 * n * chans


def acoustic_flops(config: dict, n: int, frames: int) -> int:
    """ToucanTTS ``infer`` at ``n`` phones and ``frames`` mel frames."""
    cfg = config["acoustic"]
    d, emb = cfg["adim"], cfg["utt_embed_dim"] or 0
    f = 2 * n * (cfg["input_features"] * 100 + 100 * d)
    f += cfg["enc_layers"] * _conformer_block(n, d, cfg["enc_units"], cfg["enc_kernel"])
    if emb:
        f += 2 * n * (d + emb) * d
    pred_emb = emb if cfg["conditional_predictors"] else 0
    for kind in ("duration", "pitch", "energy"):
        f += _predictor(n, d, cfg[f"{kind}_layers"], cfg[f"{kind}_chans"],
                        cfg[f"{kind}_kernel"], pred_emb)
    f += 2 * (2 * n * d)                          # pitch and energy embeddings
    f += cfg["dec_layers"] * _conformer_block(frames, d, cfg["dec_units"], cfg["dec_kernel"])
    mel = cfg["mel_channels"]
    f += 2 * frames * d * mel                     # feat_out
    f += 2 * frames * 5 * (mel * 256 + 3 * 256 * 256 + 256 * mel)  # PostNet
    if cfg["use_postflow"]:
        f += _glow(cfg, frames)
    return f


def _glow(cfg: dict, frames: int) -> int:
    d, mel, h = cfg["adim"], cfg["mel_channels"], cfg["glow_hidden"]
    k, layers, sqz = cfg["glow_kernel"], cfg["glow_layers"], cfg["glow_sqz"]
    f = 2 * frames * 5 * (mel + d) * d            # g_proj
    t, c, gin = frames // sqz, mel * sqz, d * sqz
    ns = 4
    per_block = (2 * 2 * ns ** 3                  # the LU product of the 4 x 4 mixing weight
                 + 2 * t * ns * c                 # its inverse applied to every frame
                 + 2 * t * (c // 2) * h           # start
                 + 2 * t * gin * 2 * h * layers   # cond_layer
                 + layers * 2 * t * k * h * 2 * h  # in_layers
                 + (layers - 1) * 2 * t * h * 2 * h + 2 * t * h * h  # res_skip
                 + 2 * t * h * c)                 # end
    return f + cfg["glow_blocks"] * per_block
