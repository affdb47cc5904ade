"""How ``correct`` is decided: the plain reference judges a sample of what
the timed path served.

For each sampled sentence the reference (``bench_h100/reference``, plain
f32 with TF32 off) makes its own text features, runs ``infer`` freely at
the shapes the program ran that sentence at (its phone bucket and decoded
frames, as ``serve.record_shapes`` logged them) on the same glow noise
(drawn again from the interface's seed, at the shapes and in the order the
interface drew it), and then again with the served durations, into its
vocoder.  It compares:

- ``features_differ``: sentences whose features differ from the program's
  frontend's (exact; limit 0);
- ``duration_gap``: how far, in frames, the reference's unrounded
  durations would have to move to round to what was served (0 when they
  round alike; a near-tie rounds either way, so the limit is small but not
  0).  A read-aloud page returns only its waves, so there the served
  lengths are read from them and the cheapest near-ties that explain them
  are taken;
- ``pitch_err``, ``energy_err`` (where served): max abs gap over max abs
  reference;
- ``wave_err``: max abs gap of the served wave over max abs reference
  wave (1 where the lengths differ).
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from bench_h100.harness.serve import SAMPLES_PER_FRAME
from bench_h100.reference.frontend.inventory import feature_index
from bench_h100.reference.frontend.text import TextFrontend

SAMPLE = 8          # sentences judged a run, the longest among them
FIRST = 64
LANG_EN = 12


def set_tf32(on: bool):
    """TF32 in cuDNN's convs and cuBLAS's matmuls on or off, in whichever
    API the running PyTorch accepts."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    try:
        cudnn.allow_tf32, matmul.allow_tf32
    except RuntimeError:
        for obj in (cudnn.conv, cudnn.rnn, matmul):
            obj.fp32_precision = "tf32" if on else "ieee"
        return
    cudnn.allow_tf32 = matmul.allow_tf32 = on


class Sample:
    """The requests the check judges: ``SAMPLE - 1`` drawn from the seed
    among the first ``FIRST`` (every window serves those), and the longest
    served (most phones, the first of equals).  A client keeps the waves
    of these alone, so that the window holds no more host memory than a
    user's loop would."""

    def __init__(self, seed: int):
        self.drawn = set(random.Random(seed).sample(range(FIRST), SAMPLE - 1))
        self.longest = None   # (phones, index)

    def offer(self, i: int, phones: int):
        """(keep, drop): whether to keep served request ``i``'s wave, and
        the earlier request whose wave is no longer wanted, or None."""
        if self.longest is None or phones > self.longest[0]:
            drop = self.longest[1] if self.longest and self.longest[1] not in self.drawn else None
            self.longest = (phones, i)
            return True, drop
        return i in self.drawn, None

    def picks(self, records: list) -> list:
        served = {i for i, r in enumerate(records) if "frames" in r}
        out = sorted(i for i in self.drawn if i in served)
        if self.longest is not None and self.longest[1] not in out:
            out.insert(0, self.longest[1])
        return out


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


class Reference:
    """The reference's synthesis at the shapes the program ran."""

    def __init__(self, tts, voc, embedding, device):
        self.tts, self.voc, self.device = tts, voc, device
        self.fe = TextFrontend(language="en", use_g2p=True)
        self.utt = torch.as_tensor(embedding, device=device)[None]
        self.f2i = feature_index()

    @torch.no_grad()
    def synthesize(self, feats: np.ndarray, pad: int, z: torch.Tensor, durations=None) -> dict:
        """Free (``durations`` None) or with the given durations (n,), the
        text padded to ``pad`` phones and decoded into the frames of the
        noise ``z``: features, unrounded durations, durations, pitch,
        energy, wave."""
        n = len(feats)
        frames = z.shape[1]
        x = np.zeros((1, pad, feats.shape[1]), np.float32)
        x[0, :n] = feats
        x = torch.as_tensor(x, device=self.device)
        gold = None
        if durations is not None:
            g = np.zeros((1, pad), np.int32)
            g[0, :n] = durations
            gold = torch.as_tensor(g, device=self.device)
        raw = []
        hook = self.tts.duration_predictor.linear.register_forward_hook(
            lambda m, i, o: raw.append(o[0, :n, 0].double().cpu().numpy()))
        try:
            _, after, dur, pit, ene, lens = self.tts.infer(
                x, torch.tensor([n], device=self.device), frames, utterance_embedding=self.utt,
                lang_ids=torch.tensor([[LANG_EN]], device=self.device), gold_durations=gold,
                glow_noise=z)
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


def judge(ref: Reference, records: list, picks: list, schedule: list, program_features: dict,
          noise_seed: int, noise_shapes: list) -> dict:
    """The numbers compared, over the sampled records ``picks``."""
    draws = noise(noise_seed, noise_shapes, {records[i]["noise_index"] for i in picks},
                  ref.device)
    out = dict(features_differ=0, duration_gap=0.0, wave_err=0.0)
    if any("durations" in records[i] for i in picks):
        out.update(pitch_err=0.0, energy_err=0.0)
    ties = 0
    for i in picks:
        r = records[i]
        text = schedule[r["item"]][0]
        feats = ref.fe.string_to_features(text)
        if not np.array_equal(feats, program_features[i]):
            out["features_differ"] += 1
        z = draws[r["noise_index"]]
        free = ref.synthesize(feats, r["phone_bucket"], z)
        if "durations" in r:
            served = np.asarray(r["durations"])
            if len(served) != len(feats):
                gap = math.inf
            else:
                gap = duration_gap(free["unrounded"], free["fixed"], free["durations"], served)
            for key in ("pitch", "energy"):
                got = np.asarray(r[key])
                err = (np.abs(got - free[key]).max() / max(np.abs(free[key]).max(), 1e-6)
                       if got.shape == free[key].shape else 1.0)
                out[f"{key}_err"] = max(out[f"{key}_err"], float(err))
        else:
            served, gap = resolve_lengths(free["unrounded"], free["fixed"], free["durations"],
                                          r["frames"])
        ties += int(served is not None and not np.array_equal(served, free["durations"]))
        out["duration_gap"] = max(out["duration_gap"], float(gap))
        if served is None or not math.isfinite(gap):
            out["wave_err"] = 1.0
            continue
        forced = ref.synthesize(feats, r["phone_bucket"], z, served)
        want, got = forced["wave"], np.asarray(r["wave"])
        err = (np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
               if got.shape == want.shape else 1.0)
        out["wave_err"] = max(out["wave_err"], float(err))
    out["duration_gap"] = min(out["duration_gap"], 1e9)
    return out, ties
