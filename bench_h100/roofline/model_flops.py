"""Model FLOPs of one sentence: the acoustic model (its family's
``acoustic_flops``, ``families/<family>.py``) and the vocoder (here) at the
sentence's own phone count ``n`` and mel frame count ``frames``.

The count is of what the architecture needs, whoever implements it:
2 flops per multiply-add of every linear layer, convolution and attention
product (what ``torch.utils.flop_counter.FlopCounterMode`` counts on the
reference at those exact shapes), except that the rel-pos term q_v . p is
counted over the T x T offsets a row needs, not the 2T - 1 columns the
plain version's rel-shift computes.  Padding to a bucket is not counted:
it is not work the sentence needed.
"""


def vocoder(kind: str, vcfg: dict, frames: int) -> int:
    """HiFiGAN (Avocodo) or BigVGAN generator at ``frames`` mel frames."""
    mels = vcfg.get("in_channels", vcfg.get("num_mels"))
    ch = vcfg["channels"]
    scales = vcfg.get("upsample_scales", vcfg.get("upsample_rates"))
    f = 2 * frames * 7 * mels * ch                # input conv
    t, c_in = frames, ch
    taps = sum(2 * len(vcfg["resblock_dilations"]) * k for k in vcfg["resblock_kernel_sizes"])
    acts = 2 * len(vcfg["resblock_dilations"]) * len(vcfg["resblock_kernel_sizes"])
    for scale, up_k in zip(scales, vcfg["upsample_kernel_sizes"]):
        c = c_in // 2
        f += 2 * t * c_in * c * up_k              # transposed conv, over its input
        t *= scale
        f += 2 * taps * t * c * c                 # the stage's 18 convs
        if kind == "bigvgan":
            f += acts * _alias_free(t, c)
        c_in = c
    if kind == "bigvgan":
        f += _alias_free(t, c_in)                 # activation_post
    return f + 2 * t * 7 * c_in                   # output conv


def _alias_free(t: int, c: int) -> int:
    """One alias-free activation: the 2x upsampling FIR of 12 taps over the
    input with 5 replicated samples each side, and the 12-tap decimation
    to t samples."""
    return 2 * 12 * c * (t + 10) + 2 * 12 * c * t


def sentence(config: dict, n: int, frames: int) -> int:
    """The whole step of one sentence under a benchmark configuration."""
    from bench_h100.harness import spec

    return (spec.family(config).acoustic_flops(config, n, frames)
            + vocoder(config["vocoder"], config["vocoder_config"], frames))
