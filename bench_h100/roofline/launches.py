"""Which launches of K1, K2 and K5 one served sentence makes, and at which
shapes: what the yardstick expects of the port's path at batch 1, at the
shapes the program ran that sentence at (``serve.record_shapes``).

The acoustic model runs K1 once in each conformer block: the encoder at
the phone bucket with the sentence's phones as valid keys, the decoder at
the frames it decoded with the sum of the durations (or, where only the
wave was served, its frames) as valid keys.  The vocoder runs over the
frames it was handed: HiFiGAN one K2 a stage, BigVGAN one K5 for each of
the 6 activations of its 3 AMP blocks a stage and one after the last
stage.  A sentence whose shapes were not recorded, or that ran more than
one row, has no launches here, so that a roofline over it falls silent.
"""


def _recorded(rec) -> bool:
    return rec.get("rows") == 1 and "phone_bucket" in rec


def k1(config: dict, rec) -> list:
    """[(b, h, t, d, lengths)] of K1."""
    if not _recorded(rec):
        return []
    a = config["acoustic"]
    h, d = a["aheads"], a["adim"] // a["aheads"]
    keys = int(sum(rec["durations"])) if "durations" in rec else rec["frames"]
    return ([(1, h, rec["phone_bucket"], d, [rec["phones"]])] * a["enc_layers"]
            + [(1, h, rec["decoder_frames"], d, [keys])] * a["dec_layers"])


def _stages(config: dict, rec) -> list:
    v = config["vocoder_config"]
    scales = v.get("upsample_scales", v.get("upsample_rates"))
    t, c, out = rec["vocoder_frames"], v["channels"], []
    for s in scales:
        t, c = t * s, c // 2
        out.append((t, c))
    return out


def k2(config: dict, rec) -> list:
    """[(t, c, kernel_sizes, dilations)] of K2 (HiFiGAN only)."""
    if config["vocoder"] != "hifigan" or not _recorded(rec):
        return []
    v = config["vocoder_config"]
    ks, ds = tuple(v["resblock_kernel_sizes"]), tuple(v["resblock_dilations"])
    return [(t, c, ks, ds) for t, c in _stages(config, rec)]


def k5(config: dict, rec) -> list:
    """[(b, t, c)] of K5 (BigVGAN only)."""
    if config["vocoder"] != "bigvgan" or not _recorded(rec):
        return []
    v = config["vocoder_config"]
    per_stage = 2 * len(v["resblock_dilations"]) * len(v["resblock_kernel_sizes"])
    stages = _stages(config, rec)
    return [(1, t, c) for t, c in stages for _ in range(per_stage)] + [(1, *stages[-1])]
