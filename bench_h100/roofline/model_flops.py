"""Model FLOPs of one sentence: the acoustic model and the vocoder at the
sentence's own phone count ``n`` and mel frame count ``frames``.

The count is of what the architecture needs, whoever implements it:
2 flops per multiply-add of every linear layer, convolution and attention
product (what ``torch.utils.flop_counter.FlopCounterMode`` counts on the
reference at those exact shapes), except that the rel-pos term q_v . p is
counted over the T x T offsets a row needs, not the 2T - 1 columns the
plain version's rel-shift computes.  Padding to a bucket is not counted:
it is not work the sentence needed.
"""


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


def acoustic(cfg: dict, n: int, frames: int) -> int:
    """ToucanTTS ``infer`` (``ToucanTTSConfig`` fields in ``cfg``)."""
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
    return (acoustic(config["acoustic"], n, frames)
            + vocoder(config["vocoder"], config["vocoder_config"], frames))
