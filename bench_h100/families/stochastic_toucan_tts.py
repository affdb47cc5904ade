"""The StochasticToucanTTS family: ToucanTTS's conformers, PostNet and glow
with VITS-style spline flows in place of the duration, pitch and energy
predictors, then a HiFiGAN or BigVGAN vocoder (``configs/*.json`` with
``"family": "stochastic_toucan_tts"``; ``flows`` holds the flows' sizes).

What the harness asks of this model, and of no other:

- ``build``, ``embedding_dim``, ``shape_weights``: the reference's modules
  and the model steps of the weights recipe: every ConvFlow's zero-init
  ``proj`` drawn from N(0, ``FLOW_PROJ_STD``), so that the splines bend;
  the glow's coupling ``end`` layers as ToucanTTS's; and the duration
  flow's last affine solved so that the calibration sentences' sampled
  durations, on flow noise drawn from the run's seed, take the corpus's
  frames a written word, narrowed where a phone would pass
  ``LONGEST_PHONE`` frames;
- ``build_interface`` and ``record_shapes``: the program,
  ``ToucanTTSInterface(acoustic="stochastic")``, and the shapes it ran
  each step at, with one draw entry a step: the three flows' noise shapes
  and the glow's, in the order drawn;
- ``noise``, ``noise_shape`` and ``Reference``: those draws again, and the
  reference's synthesis and the numbers a served sentence is judged by,
  with a near-tie rule for ``ceil``;
- ``acoustic_flops``: the model FLOPs of the acoustic model, the flows'
  convs and projections included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100.families import toucan_tts as base
from bench_h100.harness.check import LANG_EN, relative_gap
from bench_h100.harness.serve import SAMPLES_PER_FRAME
from bench_h100.reference.frontend.inventory import feature_index
from bench_h100.reference.models import VOCODERS
from bench_h100.reference.models.stochastic_toucan_tts import (FLOWS, FlowConfig,
                                                               StochasticToucanTTS)
from bench_h100.reference.models.toucan_tts import ToucanTTSConfig
from bench_h100.reference.nn.stochastic_flows import ConvFlow

FLOW_PROJ_STD = 0.02
LONGEST_PHONE = 15
embedding_dim = base.embedding_dim


# ------------------------------------------------------------------ weights

def flow_config(config: dict) -> FlowConfig:
    return FlowConfig(**config["flows"])


def build(config: dict, device) -> tuple:
    """(acoustic model, vocoder) of the reference on ``device``, each module
    initialised there by its own rule from the current seed of torch's
    generator on that device."""
    with torch.device(device):
        tts = StochasticToucanTTS(ToucanTTSConfig(**config["acoustic"]),
                                  flow_config(config)).eval()
        voc = VOCODERS[config["vocoder"]](**config["vocoder_config"]).eval()
    return tts, voc


@torch.no_grad()
def shape_weights(tts, config: dict, embedding: torch.Tensor, calibration: list, lang_id: int,
                  frames_per_word: float):
    """The flows' projections and the glow's coupling ends drawn, then the
    durations calibrated on ``calibration``: [((T, 62) features, written
    words)]."""
    for m in tts.modules():
        if isinstance(m, ConvFlow):
            torch.nn.init.normal_(m.proj.weight, 0.0, FLOW_PROJ_STD)
            torch.nn.init.normal_(m.proj.bias, 0.0, FLOW_PROJ_STD)
    for flow in tts.post_flow.modules():
        if hasattr(flow, "end"):
            torch.nn.init.normal_(flow.end.weight, 0.0, base.GLOW_END_STD)
    calibrate_durations(tts, calibration, embedding, lang_id, frames_per_word)


def sampled_log_durations(tts, calibration, emb, lang_id) -> torch.Tensor:
    """The duration flow's log-durations of the calibration sentences'
    phones (word boundaries aside, which the model zeroes), each sentence
    alone on flow noise drawn from torch's generator on the device."""
    boundary = feature_index()["word-boundary"]
    out = []
    for feats, _ in calibration:
        x = torch.as_tensor(feats, device=emb.device)[None]
        n = x.shape[1]
        noise = [torch.randn((1, n, 2), device=emb.device) for _ in FLOWS]
        *_, log_d = tts.prosody(x, torch.tensor([n], device=emb.device), emb,
                                torch.tensor([[lang_id]], device=emb.device), noise)
        out.append(log_d[0][x[0, :, boundary] != 1])
    return torch.cat(out).double()


@torch.no_grad()
def calibrate_durations(tts, calibration, emb, lang_id, frames_per_word) -> dict:
    """Set the duration flow's last affine on the value channel, log-d =
    (z - m) * exp(-logs): m so that the calibration's ceil'd durations sum
    to ``frames_per_word`` frames a written word, and logs 0 unless a
    phone would then pass ``LONGEST_PHONE`` frames, else the least
    narrowing that keeps every phone within it.  Returns what was set and
    reached."""
    affine = tts.duration_flow.flows[0]
    affine.m[0].zero_()
    affine.logs[0].zero_()
    z = sampled_log_durations(tts, calibration, emb, lang_id)
    target = frames_per_word * sum(w for _, w in calibration)

    def frames(scale, shift):
        return torch.ceil(torch.exp(scale * z + shift))

    def solve(scale):
        lo, hi = -20.0, 20.0
        for _ in range(60):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if frames(scale, mid).sum().item() < target else (lo, mid)
        return hi

    scale = 1.0
    if frames(scale, solve(scale)).max().item() > LONGEST_PHONE:
        lo, hi = 0.0, 1.0
        for _ in range(40):
            mid = (lo + hi) / 2
            fits = frames(mid, solve(mid)).max().item() <= LONGEST_PHONE
            lo, hi = (mid, hi) if fits else (lo, mid)
        scale = lo
    shift = solve(scale)
    affine.m[0].fill_(-shift / scale)
    affine.logs[0].fill_(-math.log(scale))
    d = frames(scale, shift)
    return dict(scale=scale, frames=d.sum().item(), target=target, longest=d.max().item(),
                phones=len(d))


# ------------------------------------------------------------------ program

def build_interface(config: dict, tts_sd, voc_sd, embedding, seed: int, device):
    """The program, ``ToucanTTSInterface(acoustic="stochastic")``, from the
    reference's state dicts; its flows are the published ones."""
    from toucan_tpu_torch.infer.interface import VOCODERS as PROGRAM_VOCODERS
    from toucan_tpu_torch.infer.interface import ToucanTTSInterface
    from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig as ProgramConfig

    if flow_config(config) != FlowConfig():
        raise ValueError("the program's flows have the published sizes only")
    dtype = getattr(torch, config["dtype"])
    vocoder = PROGRAM_VOCODERS[config["vocoder"]](**config["vocoder_config"], dtype=dtype)
    return ToucanTTSInterface(tts_sd, voc_sd, config=ProgramConfig(**config["acoustic"]),
                              vocoder=vocoder, default_embedding=embedding, language="en",
                              use_g2p=True, seed=seed, device=device, dtype=dtype,
                              matmul_precision=config["matmul_precision"], acoustic="stochastic")


def record_shapes(iface, draws: list, steps: list):
    """Log on the host, in order, one entry a step of the noise buffers the
    interface fills (``draws``): the three flows' shapes, then the glow's;
    and the shapes of every step it runs (``steps``), as ToucanTTS's.
    Nothing waits for the device."""
    base.record_shapes(iface, [], steps)
    flow_draw, glow_draw = iface._draw_flow_noise, iface._draw_noise
    flows = []

    def logged_flow_draw(buf):
        flows[:] = [tuple(buf.shape[1:])] * buf.shape[0]
        return flow_draw(buf)

    def logged_glow_draw(buf):
        draws.append((*flows, tuple(buf.shape)))
        flows.clear()
        return glow_draw(buf)

    iface._draw_flow_noise, iface._draw_noise = logged_flow_draw, logged_glow_draw


# ---------------------------------------------------------------- the check

def noise_shape(config: dict, frames: int) -> tuple:
    """The draws of a request of ``frames`` decoded frames: the flows' at
    its phone bucket, then the glow's."""
    from toucan_tpu_torch.infer.interface import FRAMES_PER_PHONE

    flows = ((1, frames // FRAMES_PER_PHONE, 2),) * len(FLOWS)
    return (*flows, (1, frames, config["acoustic"]["mel_channels"]))


def noise(seed: int, shapes: list, wanted: set, device) -> dict:
    """{entry: (the three flows' N(0, 1) draws, the glow noise)} of the
    entries in ``wanted``: the interface draws N(0, 1) into a buffer of each
    shape of each entry from its generator, in order, and scales the last
    by 0.8."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, entry in enumerate(shapes):
        z = [torch.randn(shape, generator=gen, device=device) for shape in entry]
        if k in wanted:
            out[k] = (tuple(z[:-1]), z[-1] * 0.8)
    return out


class Reference(base.Reference):
    """The reference's synthesis at the shapes the program ran, on its
    draws, and the numbers a served sentence is judged by:

    - ``duration_gap``: how far, in frames, the reference's unrounded
      durations exp(log-d) would have to move to ceil to what was served (0
      where they agree; a near-tie ceils either way, so the limit is small
      but not 0); word boundaries must match exactly;
    - ``pitch_err``, ``energy_err``: max abs gap over max abs reference;
    - ``wave_err``: max abs gap of the served wave over max abs reference
      wave (1 where the lengths differ), the reference forced with the
      served durations on the same noise.

    The model takes no given prosody, so a client that gives some is not
    judged here.
    """

    def noise(self, seed: int, shapes: list, wanted: set) -> dict:
        return noise(seed, shapes, wanted, self.device)

    @torch.no_grad()
    def synthesize(self, feats: np.ndarray, pad: int, z: tuple, durations=None,
                   pitch=None, energy=None) -> dict:
        """Sampled (``durations`` None) or at the given durations (n,), the
        text padded to ``pad`` phones and decoded into the frames of the
        glow noise of ``z`` (the flows' draws, the glow's): features,
        log-durations, durations, pitch, energy, wave and the frames
        delivered (the mel length, at most the frames decoded)."""
        if pitch is not None or energy is not None:
            raise ValueError("the stochastic model takes no given pitch or energy")
        flow_noise, glow = z
        n, frames = len(feats), glow.shape[1]
        x = self._padded(feats, pad, np.float32)
        forced = None if durations is None else self._padded(durations, pad, np.int32)
        _, after, dur, pit, ene, lens, log_d = self.tts.infer(
            x, torch.tensor([n], device=self.device), frames, self.utt,
            torch.tensor([[LANG_EN]], device=self.device), glow, flow_noise, durations=forced)
        length = min(int(lens[0]), frames)
        mask = (torch.arange(frames, device=self.device)[None, :] < lens[:, None])[..., None]
        mel = torch.where(mask, after, torch.zeros((), device=self.device))
        wave = self.voc(mel)[0, :length * SAMPLES_PER_FRAME, 0]
        return dict(log_durations=log_d[0, :n].double().cpu().numpy(),
                    fixed=x[0, :n, self.f2i["word-boundary"]].cpu().numpy() == 1,
                    durations=dur[0, :n].cpu().numpy(), pitch=pit[0, :n, 0].cpu().numpy(),
                    energy=ene[0, :n, 0].cpu().numpy(), wave=wave.cpu().numpy(),
                    frames=length)

    def judge(self, rec: dict, feats: np.ndarray, z: tuple, given=None) -> tuple:
        """(numbers, near-tie) of one served sentence with its durations."""
        if given is not None:
            raise ValueError("the stochastic model takes no given prosody")
        free = self.synthesize(feats, rec["phone_bucket"], z)
        served = np.asarray(rec["durations"])
        gap = (ceil_gap(free["log_durations"], free["fixed"], free["durations"], served)
               if len(served) == len(feats) else math.inf)
        tie = not np.array_equal(served, free["durations"])
        out = dict(duration_gap=float(gap))
        if not math.isfinite(gap):
            out["wave_err"] = 1.0
        else:
            wave = self.synthesize(feats, rec["phone_bucket"], z, served)["wave"] if tie \
                else free["wave"]
            out["wave_err"] = relative_gap(rec["wave"], wave)
        for key in ("pitch", "energy"):
            out[f"{key}_err"] = relative_gap(rec[key], free[key])
        return out, tie


def ceil_gap(log_durations, fixed, ref, served) -> float:
    """Frames the reference's unrounded durations exp(log-d) would have to
    move to ceil to ``served`` (ceil(d) = k for k - 1 < d <= k; 0 where
    the reference's ceil agrees); phones the model fixes (word boundaries)
    must match exactly."""
    gap = 0.0
    for ld, f, r, k in zip(log_durations, fixed, ref, served):
        if f or k == r:
            gap = max(gap, float(abs(int(k) - int(r))))
            continue
        d = math.exp(ld)
        gap = max(gap, (int(k) - 1) - d, d - int(k))
    return gap


# -------------------------------------------------------------------- FLOPs

def _flow_predictor(n: int, c: int, emb: int, n_flows: int, kernel: int, bins: int) -> int:
    """One predictor's ``sample`` at ``n`` phones: the conditioning convs
    and the ConvFlows it runs in reverse (all but the first-trained)."""
    dds = 3 * (2 * n * c * kernel + 2 * n * c * c)     # depthwise and 1x1 convs
    f = 2 * n * c * c + 2 * emb * c + dds + 2 * n * c * c  # pre, cond (one position), convs, proj
    per_flow = 2 * n * c + dds + 2 * n * c * (3 * bins - 1)  # pre, convs, proj
    return f + (n_flows - 1) * per_flow


def acoustic_flops(config: dict, n: int, frames: int) -> int:
    """StochasticToucanTTS ``infer`` at ``n`` phones and ``frames`` mel
    frames."""
    cfg, fl = config["acoustic"], config["flows"]
    d, emb = cfg["adim"], cfg["utt_embed_dim"] or 0
    f = 2 * n * (cfg["input_features"] * 100 + 100 * d)
    f += cfg["enc_layers"] * base._conformer_block(n, d, cfg["enc_units"], cfg["enc_kernel"])
    if emb:
        f += 2 * n * (d + emb) * d
    for kind in ("pitch", "energy", "duration"):
        f += _flow_predictor(n, d, emb, fl[f"{kind}_flows"], fl[f"{kind}_kernel"], fl["num_bins"])
    f += 2 * (2 * n * d)                          # pitch and energy embeddings
    f += cfg["dec_layers"] * base._conformer_block(frames, d, cfg["dec_units"], cfg["dec_kernel"])
    mel = cfg["mel_channels"]
    f += 2 * frames * d * mel                     # feat_out
    f += 2 * frames * 5 * (mel * 256 + 3 * 256 * 256 + 256 * mel)  # PostNet
    return f + base._glow(cfg, frames)
