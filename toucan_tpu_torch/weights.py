"""State dicts for the port from the JAX package's variables.

The JAX package keeps its weights as nested dicts (``params``,
``batch_stats``, ``buffers``); these functions take such dicts of numpy
arrays and return the port's ``state_dict``, whose keys are the reference
IMS-Toucan ones.  They invert ``toucan_tpu/compat/torch_toucan.py::
convert_toucan_tts``, ``compat/torch_vocoder.py::convert_hifigan`` /
``convert_bigvgan``, ``compat/torch_gst.py::convert_style_embedding``,
``compat/torch_aligner.py::convert_aligner``,
``compat/torch_gan.py::convert_resnet_g`` and
``compat/torch_stochastic.py::convert_stochastic_toucan_tts``, and give the
spectrogram discriminator, the embedding VAE, a JAX train state, the
vocoders' joint critic (both ways), a JAX vocoder train state, the
aligner's ``TinyTTS``, the WGAN-QC critic and the plain attention
theirs: only layouts change (flax (k, in, out) conv kernels and (in, out) dense
kernels become torch (out, in, k) and (out, in)), never values.  No JAX
is needed to call them.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Writer:
    def __init__(self):
        self.sd = {}

    def linear(self, key, p):
        self.sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.sd[f"{key}.bias"] = _t(p["bias"])

    def conv(self, key, p):
        self.sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
        if "bias" in p:
            self.sd[f"{key}.bias"] = _t(p["bias"])

    def norm(self, key, p):
        self.sd[f"{key}.weight"] = _t(p["scale"])
        self.sd[f"{key}.bias"] = _t(p["bias"])


def _count(tree, prefix) -> int:
    rx = re.compile(rf"{prefix}(\d+)$")
    return sum(1 for k in tree if rx.match(k))


def _batch_norm(w: _Writer, key, p, s):
    w.norm(key, p)
    w.sd[f"{key}.running_mean"] = _t(s["mean"])
    w.sd[f"{key}.running_var"] = _t(s["var"])
    w.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _conformer(w: _Writer, key, p, stats):
    if "embed" in p:
        w.linear(f"{key}.embed.0", p["embed"]["fc1"])
        w.linear(f"{key}.embed.2", p["embed"]["fc2"])
    if "language_embedding" in p:
        w.sd[f"{key}.language_embedding.weight"] = _t(p["language_embedding"]["embedding"])
    for i in range(_count(p, "block_")):
        bp, bs, bk = p[f"block_{i}"], stats[f"block_{i}"], f"{key}.encoders.{i}"
        for name in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv", "norm_final"):
            w.norm(f"{bk}.{name}", bp[name])
        for ff in ("feed_forward", "feed_forward_macaron"):
            w.conv(f"{bk}.{ff}.w_1", bp[ff]["w_1"])
            w.conv(f"{bk}.{ff}.w_2", bp[ff]["w_2"])
        att = bp["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            w.linear(f"{bk}.self_attn.{name}", att[name])
        w.sd[f"{bk}.self_attn.pos_bias_u"] = _t(att["pos_bias_u"])
        w.sd[f"{bk}.self_attn.pos_bias_v"] = _t(att["pos_bias_v"])
        cm = bp["conv_module"]
        for name in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"):
            w.conv(f"{bk}.conv_module.{name}", cm[name])
        _batch_norm(w, f"{bk}.conv_module.norm", cm["norm"], bs["conv_module"]["norm"])
    if "output_norm" in p:
        w.norm(f"{key}.output_norm", p["output_norm"])
    if "hs_emb_projection" in p:
        w.linear(f"{key}.hs_emb_projection", p["hs_emb_projection"])


def _predictor(w: _Writer, key, p):
    stack = p["stack"]
    for i in range(_count(stack, "conv_")):
        w.conv(f"{key}.conv.{i}.0", stack[f"conv_{i}"])
        if f"cln_{i}" in stack:
            cln = stack[f"cln_{i}"]
            for ours, theirs in (("scale", "W_scale"), ("bias", "W_bias")):
                for j, idx in enumerate((0, 2, 4)):
                    w.linear(f"{key}.norms.{i}.{theirs}.{idx}", cln[f"{ours}_{j}"])
        else:
            w.norm(f"{key}.norms.{i}", stack[f"ln_{i}"])
    w.linear(f"{key}.linear", stack["linear"])


def toucan_tts_from_jax(variables, share_wn_layers: int = 4) -> dict:
    """JAX ToucanTTS variables -> the port's ToucanTTS state dict.

    ``share_wn_layers`` is the Glow's block count per shared WaveNet core
    (``Glow.share_wn_layers``); the shared layers are listed under every
    block that uses them.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    buffers = variables.get("buffers", {})
    w = _Writer()
    _conformer(w, "encoder", params["encoder"], stats["encoder"])
    _conformer(w, "decoder", params["decoder"], stats["decoder"])
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _predictor(w, name, params[name])
    w.conv("pitch_embed.0", params["pitch_embed"])
    w.conv("energy_embed.0", params["energy_embed"])
    w.linear("feat_out", params["feat_out"])
    _postnet_and_glow(w, params, buffers, share_wn_layers)
    return w.sd


def _postnet_and_glow(w: _Writer, params, buffers, share_wn_layers: int):
    post = params["conv_postnet"]
    for i in range(_count(post, "conv_")):
        w.conv(f"conv_postnet.postnet.{i}.0", post[f"conv_{i}"])
        w.norm(f"conv_postnet.postnet.{i}.1", post[f"gn_{i}"])
    if "post_flow" not in params:
        return
    gp, gb = params["post_flow"], buffers["post_flow"]
    w.conv("post_flow.g_proj", gp["g_proj"])
    for b in range(_count(gp, "actnorm_")):
        an = gp[f"actnorm_{b}"]
        w.sd[f"post_flow.flows.{3 * b}.logs"] = _t(an["logs"]).reshape(1, -1, 1)
        w.sd[f"post_flow.flows.{3 * b}.bias"] = _t(an["bias"]).reshape(1, -1, 1)
        base = f"post_flow.flows.{3 * b + 1}"
        for name in ("p", "sign_s"):
            w.sd[f"{base}.{name}"] = _t(gb[f"invconv_{b}"][name])
        for name in ("l", "log_s", "u"):
            w.sd[f"{base}.{name}"] = _t(gp[f"invconv_{b}"][name])
        base = f"post_flow.flows.{3 * b + 2}"
        cp = gp[f"coupling_{b}"]
        w.conv(f"{base}.start", cp["start"])
        w.conv(f"{base}.end", cp["end"])
        w.conv(f"{base}.wn.cond_layer", cp["cond_layer"])
        core = gp[f"wn_core_{b // share_wn_layers}"]
        for i in range(_count(core, "in_")):
            w.conv(f"{base}.wn.in_layers.{i}", core[f"in_{i}"])
            w.conv(f"{base}.wn.res_skip_layers.{i}", core[f"res_skip_{i}"])


def _dds_conv(w: _Writer, key, p):
    for i in range(_count(p, "sep_")):
        w.conv(f"{key}.convs_sep.{i}", p[f"sep_{i}"])
        w.conv(f"{key}.convs_1x1.{i}", p[f"pw_{i}"])
        for n in (1, 2):
            ln = p[f"norm{n}_{i}"]["ln"]
            w.sd[f"{key}.norms_{n}.{i}.gamma"] = _t(ln["scale"])
            w.sd[f"{key}.norms_{n}.{i}.beta"] = _t(ln["bias"])


def _stochastic_predictor(w: _Writer, key, p):
    """Inverts ``compat/torch_stochastic.py::convert_stochastic_predictor``."""
    for name in ("pre", "proj", "post_pre", "post_proj", "cond"):
        if name in p:
            w.conv(f"{key}.{name}", p[name])
    _dds_conv(w, f"{key}.convs", p["convs"])
    _dds_conv(w, f"{key}.post_convs", p["post_convs"])
    for flows, affine, prefix in (("flows", "affine", "flow_"),
                                  ("post_flows", "post_affine", "post_flow_")):
        for name in ("m", "logs"):
            w.sd[f"{key}.{flows}.0.{name}"] = _t(p[affine][name]).reshape(-1, 1)
        for i in range(_count(p, prefix)):
            fp, fk = p[f"{prefix}{i}"], f"{key}.{flows}.{2 * i + 1}"
            w.conv(f"{fk}.pre", fp["pre"])
            _dds_conv(w, f"{fk}.convs", fp["convs"])
            w.conv(f"{fk}.proj", fp["proj"])


def stochastic_toucan_tts_from_jax(variables, share_wn_layers: int = 4) -> dict:
    """JAX StochasticToucanTTS variables -> the port's state dict.

    Inverts ``toucan_tpu/compat/torch_stochastic.py::
    convert_stochastic_toucan_tts`` (``:35,57``): the conformers, PostNet
    and glow as ``toucan_tts_from_jax`` writes them, the three flows at
    ``{duration,pitch,energy}_flow``.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    w = _Writer()
    _conformer(w, "encoder", params["encoder"], stats["encoder"])
    _conformer(w, "decoder", params["decoder"], stats["decoder"])
    for name in ("duration_flow", "pitch_flow", "energy_flow"):
        _stochastic_predictor(w, name, params[name])
    w.conv("pitch_embed.0", params["pitch_embed"])
    w.conv("energy_embed.0", params["energy_embed"])
    w.linear("feat_out", params["feat_out"])
    _postnet_and_glow(w, params, variables.get("buffers", {}), share_wn_layers)
    return w.sd


def _conv2d(w: _Writer, key, p):
    """flax (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    w.sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    w.sd[f"{key}.bias"] = _t(p["bias"])


def spectrogram_discriminator_from_jax(variables) -> dict:
    """JAX SpectrogramDiscriminator variables -> the port's state dict.

    The JAX package has no converter for the critic; the port keeps the
    reference's module layout (``D.filters.{i}``, ``D.out``, ``D.fc``) with
    weight norm folded.  The JAX net reads windows as (B, T, F, 1) and the
    port as (B, 1, T, F): the same (T, F) kernels, and the same flatten
    order into ``fc``.
    """
    p = variables["params"]["D"]
    w = _Writer()
    for i in range(_count(p, "conv_")):
        _conv2d(w, f"D.filters.{i}", p[f"conv_{i}"])
    _conv2d(w, "D.out", p["out"])
    w.linear("D.fc", p["fc"])
    return w.sd


def embedding_vae_from_jax(variables) -> dict:
    """JAX EmbeddingVAE variables -> the port's state dict: ``enc_{i}``,
    ``mean_{i}``, ``var_{i}`` and ``dec_{i}`` go to ``encoder.{i}``,
    ``mean.{i}``, ``log_var.{i}`` and ``decoder.{i}`` (the JAX package has
    no converter and loads no reference checkpoint of it)."""
    p = variables["params"]
    w = _Writer()
    for ours, theirs in (("encoder", "enc_"), ("mean", "mean_"), ("log_var", "var_"),
                         ("decoder", "dec_")):
        for i in range(_count(p, theirs)):
            w.linear(f"{ours}.{i}", p[f"{theirs}{i}"])
    return w.sd


def train_state_from_jax(state, params, batch_stats, buffers, mu, nu, count: int, step: int):
    """Carry a JAX ``TrainState`` (``toucan_tpu/train/toucan_train.py``)
    into the port's ``train.toucan_train.TrainState`` ``state``, in place.

    ``params``, ``mu`` and ``nu`` are the JAX trees ``{"tts": ...,
    "disc": ...}`` (the state's params and its Adam moments), ``batch_stats``
    and ``buffers`` the model's, all as numpy; ``count`` Adam's update
    count, ``step`` the state's step.  The moments go through the same
    layout changes as the parameters they belong to.
    """
    def tts_sd(tree):
        return toucan_tts_from_jax({"params": tree["tts"], "batch_stats": batch_stats,
                                    "buffers": buffers})

    def disc_sd(tree):
        return spectrogram_discriminator_from_jax({"params": tree["disc"]})

    state.model.load_state_dict(tts_sd(params))
    modules = [(state.model, tts_sd)]
    if state.disc is not None:
        state.disc.load_state_dict(disc_sd(params))
        modules.append((state.disc, disc_sd))
    state.optimizer.state.clear()
    for module, convert in modules:
        load_optimizer_state(state.optimizer, module, convert, mu, nu, count)
    state.scheduler.jump_to(count)
    state.step = int(step)
    return state


def hifigan_from_jax(variables) -> dict:
    """JAX HiFiGANGenerator variables -> the port's HiFiGANGenerator state dict.

    The Avocodo taps ``out_proj_x1``/``out_proj_x2`` exist in the JAX
    variables only when the generator was initialised with
    ``return_intermediates=True``; when absent they are set to zero (only
    training reads them).
    """
    p = variables["params"]
    w = _Writer()
    w.conv("input_conv", p["input_conv"])
    n_up = sum(1 for k in p if re.fullmatch(r"upsample_\d+_kernel", k))
    n_stacks = sum(1 for k in p if k.startswith("block_0_"))
    for i in range(n_up):
        # JAX (k, out, in) -> torch ConvTranspose1d (in, out, k)
        w.sd[f"upsamples.{i}.1.weight"] = _t(np.transpose(np.asarray(p[f"upsample_{i}_kernel"]),
                                                          (2, 1, 0)))
        w.sd[f"upsamples.{i}.1.bias"] = _t(p[f"upsample_{i}_bias"])
        for j in range(n_stacks):
            blk = p[f"block_{i}_{j}"]
            for d in range(_count(blk, "conv1_")):
                w.conv(f"blocks.{i * n_stacks + j}.convs1.{d}.1", blk[f"conv1_{d}"])
                w.conv(f"blocks.{i * n_stacks + j}.convs2.{d}.1", blk[f"conv2_{d}"])
    w.conv("output_conv.1", p["output_conv"])
    _avocodo_taps(w, p, "upsample_{}_bias")
    return w.sd


def _avocodo_taps(w: _Writer, p, bias_key: str):
    """The taps out_proj_x1/x2 after stages 1 and 2, zero when absent."""
    for name, stage in (("out_proj_x1", 1), ("out_proj_x2", 2)):
        if name in p:
            w.conv(name, p[name])
        else:
            ch = np.asarray(p[bias_key.format(stage)]).shape[0]
            w.sd[f"{name}.weight"] = torch.zeros(1, ch, 7)
            w.sd[f"{name}.bias"] = torch.zeros(1)


def bigvgan_from_jax(variables) -> dict:
    """JAX BigVGAN variables -> the port's BigVGAN state dict.

    Inverts ``compat/torch_vocoder.py::convert_bigvgan``.  As for HiFiGAN,
    the Avocodo taps are set to zero when the JAX variables lack them.
    """
    p = variables["params"]
    w = _Writer()
    w.conv("conv_pre", p["conv_pre"])
    n_up = sum(1 for k in p if re.fullmatch(r"up_\d+_kernel", k))
    n_blocks = sum(1 for k in p if k.startswith("amp_0_"))
    for i in range(n_up):
        # JAX (k, out, in) -> torch ConvTranspose1d (in, out, k)
        w.sd[f"ups.{i}.0.weight"] = _t(np.transpose(np.asarray(p[f"up_{i}_kernel"]), (2, 1, 0)))
        w.sd[f"ups.{i}.0.bias"] = _t(p[f"up_{i}_bias"])
        for j in range(n_blocks):
            blk, base = p[f"amp_{i}_{j}"], f"resblocks.{i * n_blocks + j}"
            for d in range(_count(blk, "conv1_")):
                w.conv(f"{base}.convs1.{d}", blk[f"conv1_{d}"])
                w.conv(f"{base}.convs2.{d}", blk[f"conv2_{d}"])
            for m in range(_count(blk, "alpha_")):
                w.sd[f"{base}.activations.{m}.act.alpha"] = _t(blk[f"alpha_{m}"])
                w.sd[f"{base}.activations.{m}.act.beta"] = _t(blk[f"beta_{m}"])
    w.sd["activation_post.act.alpha"] = _t(p["post_alpha"])
    w.sd["activation_post.act.beta"] = _t(p["post_beta"])
    w.conv("conv_post", p["conv_post"])
    _avocodo_taps(w, p, "up_{}_bias")
    return w.sd


def style_embedding_from_jax(variables) -> dict:
    """JAX StyleEmbedding variables -> the port's StyleEmbedding state dict.

    Inverts ``compat/torch_gst.py::convert_style_embedding``: flax (kh, kw,
    in, out) Conv2d kernels become torch (out, in, kh, kw), the GRU's (in,
    3H) kernels its (3H, in) weights, BatchNorm statistics its running
    buffers.
    """
    p, stats = variables["params"]["ref_enc"], variables["batch_stats"]["ref_enc"]
    w = _Writer()
    for i in range(_count(p, "conv_")):
        conv, bn = f"gst.ref_enc.convs.{3 * i}", f"gst.ref_enc.convs.{3 * i + 1}"
        w.sd[f"{conv}.weight"] = _t(np.transpose(np.asarray(p[f"conv_{i}"]["kernel"]), (3, 2, 0, 1)))
        _batch_norm(w, bn, p[f"bn_{i}"], stats[f"bn_{i}"])
    gru = p["gru"]
    for layer in range(_count(gru, "w_ih_")):
        base = "gst.ref_enc.gst"
        w.sd[f"{base}.weight_ih_l{layer}"] = _t(np.asarray(gru[f"w_ih_{layer}"]["kernel"]).T)
        w.sd[f"{base}.weight_hh_l{layer}"] = _t(np.asarray(gru[f"w_hh_{layer}_kernel"]).T)
        w.sd[f"{base}.bias_ih_l{layer}"] = _t(gru[f"w_ih_{layer}"]["bias"])
        w.sd[f"{base}.bias_hh_l{layer}"] = _t(gru[f"w_hh_{layer}_bias"])
    stl = variables["params"]["stl"]
    w.sd["gst.stl.gst_embs"] = _t(stl["gst_embs"])
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        w.linear(f"gst.stl.mha.{name}", stl[name])
    return w.sd


def multi_headed_attention_from_jax(variables) -> dict:
    """JAX ``nn/attention.py::MultiHeadedAttention`` variables -> the
    port's ``MultiHeadedAttention`` state dict (four dense layers)."""
    w = _Writer()
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        w.linear(name, variables["params"][name])
    return w.sd


def aligner_from_jax(variables) -> dict:
    """JAX Aligner variables -> the port's Aligner state dict.

    Inverts ``compat/torch_aligner.py::convert_aligner``: the conv layers at
    ``convs.{2i}`` (dropouts at the odd indices), the LSTM's two directions
    as ``rnn.*_l0`` and ``rnn.*_l0_reverse``, the projection ``proj``.
    """
    p, stats = variables["params"], variables["batch_stats"]
    w = _Writer()
    for i in range(_count(p, "conv_")):
        key = f"convs.{2 * i}"
        w.conv(f"{key}.conv", p[f"conv_{i}"]["conv"])
        _batch_norm(w, f"{key}.bnorm", p[f"conv_{i}"]["bn"], stats[f"conv_{i}"]["bn"])
    for name, suffix in (("lstm_fwd", ""), ("lstm_bwd", "_reverse")):
        d = p[name]
        w.sd[f"rnn.weight_ih_l0{suffix}"] = _t(np.asarray(d["w_ih"]["kernel"]).T)
        w.sd[f"rnn.weight_hh_l0{suffix}"] = _t(np.asarray(d["w_hh_kernel"]).T)
        w.sd[f"rnn.bias_ih_l0{suffix}"] = _t(d["w_ih"]["bias"])
        w.sd[f"rnn.bias_hh_l0{suffix}"] = _t(d["w_hh_bias"])
    w.linear("proj", p["proj"])
    return w.sd


def resnet_g_from_jax(variables, size: int = 4) -> dict:
    """JAX ResNetG variables -> the port's ResNetG state dict, for a
    generator of image side ``size``.

    Inverts ``compat/torch_gan.py::convert_resnet_g``: flax (kh, kw, in,
    out) Conv2d kernels become torch (out, in, kh, kw); ``block_{k}`` goes
    to ``resnet.{2k}`` for the first log2(size / 4) blocks, each followed by
    an Upsample, and the last two blocks follow them.
    """
    p, stats = variables["params"], variables.get("batch_stats", {})
    w = _Writer()
    w.linear("fc", p["fc"])
    _batch_norm(w, "bn1d", p["bn1d"], stats["bn1d"])
    nlayers = int(np.log2(size / 4))
    torch_indices = [2 * k for k in range(nlayers)] + [2 * nlayers, 2 * nlayers + 1]
    for ours, idx in enumerate(torch_indices):
        bp, bs, key = p[f"block_{ours}"], stats[f"block_{ours}"], f"resnet.{idx}"
        for conv, bn in (("conv_0", "bn_0"), ("conv_1", "bn_1"), ("conv_s", "bn_s")):
            if conv not in bp:
                continue
            w.sd[f"{key}.{conv}.weight"] = _t(np.transpose(np.asarray(bp[conv]["kernel"]),
                                                           (3, 2, 0, 1)))
            if "bias" in bp[conv]:
                w.sd[f"{key}.{conv}.bias"] = _t(bp[conv]["bias"])
            _batch_norm(w, f"{key}.bn2d_{bn[3:]}", bp[bn], bs[bn])
    w.sd["conv_img.weight"] = _t(np.transpose(np.asarray(p["conv_img"]["kernel"]), (3, 2, 0, 1)))
    w.sd["conv_img.bias"] = _t(p["conv_img"]["bias"])
    w.linear("fc_out", p["fc_out"])
    return w.sd


# ----------------------------------------------------------------- training

def _conv_to_torch(kernel) -> torch.Tensor:
    """flax (*k, in, out) -> torch (out, in, *k)."""
    a = np.asarray(kernel)
    n = a.ndim - 2
    return _t(np.transpose(a, (n + 1, n) + tuple(range(n))))


def _conv_to_jax(weight) -> np.ndarray:
    """torch (out, in, *k) -> flax (*k, in, out)."""
    a = np.asarray(weight)
    n = a.ndim - 2
    return np.transpose(a, tuple(range(2, n + 2)) + (1, 0))


def _normed_convs(module):
    """(path, NormedConv) of every normed conv of a critic, in module order."""
    from toucan_tpu_torch.nn.param_norm import NormedConv
    return [(name, m) for name, m in module.named_modules() if isinstance(m, NormedConv)]


def _node(tree, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def avocodo_discriminator_from_jax(variables, discriminator, start_vector=None) -> dict:
    """JAX ``AvocodoJointDiscriminator`` variables -> the state dict of the
    port's ``discriminator`` (built with the same ``channel_scale`` and
    segment).  Each conv is found by its path, which is the JAX module
    path: weight norm's ``v`` (*k, in/g, out) and ``g`` (out,) become
    ``weight_v`` (out, in/g, *k) and ``weight_g`` (out, 1, ...); the other
    kernels become ``weight`` unchanged in value.  ``start_vector(out)``
    gives a spectral conv's power-iteration start (JAX's is
    ``jax.random.normal(jax.random.PRNGKey(7), (out,))``, which the caller
    computes); without it each keeps the discriminator's own."""
    params = variables["params"]
    sd = {}
    for path, conv in _normed_convs(discriminator):
        p = _node(params, path)
        if conv.norm == "weight":
            v = _conv_to_torch(p["v"])
            sd[f"{path}.weight_v"] = v
            sd[f"{path}.weight_g"] = _t(p["g"]).reshape((-1,) + (1,) * (v.dim() - 1))
        else:
            sd[f"{path}.weight"] = _conv_to_torch(p["kernel"])
        sd[f"{path}.bias"] = _t(p["bias"])
        if conv.norm == "spectral":
            u0 = (conv.u0 if start_vector is None
                  else _t(start_vector(conv.weight.shape[0])))
            sd[f"{path}.u0"] = (u0 / (torch.linalg.vector_norm(u0) + 1e-12)).cpu()
    return sd


def avocodo_discriminator_to_jax(discriminator) -> dict:
    """The port's critic -> JAX ``{"params": ...}`` (numpy), the inverse of
    ``avocodo_discriminator_from_jax`` (the start vectors stay behind: JAX
    draws its own)."""
    params = {}
    for path, conv in _normed_convs(discriminator):
        node = params
        for key in path.split("."):
            node = node.setdefault(key, {})
        if conv.norm == "weight":
            node["v"] = _conv_to_jax(conv.weight_v.detach().cpu())
            node["g"] = conv.weight_g.detach().cpu().numpy().reshape(-1)
        else:
            node["kernel"] = _conv_to_jax(conv.weight.detach().cpu())
        node["bias"] = conv.bias.detach().cpu().numpy()
    return {"params": params}


def load_optimizer_state(optimizer, module, convert, mu, nu, count: int):
    """Put optax Adam-family moments ``mu``/``nu`` (JAX trees, numpy, of the
    layout ``convert`` turns into ``module``'s state dict) and their
    ``count`` into a torch optimizer over ``module``'s parameters (state
    keys ``step``, ``exp_avg``, ``exp_avg_sq``)."""
    m, v = convert(mu), convert(nu)
    for name, p in module.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": m[name].to(p.device).reshape(p.shape),
                              "exp_avg_sq": v[name].to(p.device).reshape(p.shape)}


def vocoder_train_state_from_jax(state, g_params, d_params, g_mu, g_nu, d_mu, d_nu,
                                 g_count: int, d_count: int, step: int,
                                 kind: str = "hifigan", start_vector=None):
    """Carry a JAX ``VocoderTrainState`` into the port's ``state``
    (``train/vocoder_train.py``), in place: both nets' parameters, RAdam's
    ``mu``/``nu``/``count`` of each (numpy trees of the states'
    ``ScaleByAdamState``) and the step, so that a JAX run resumes here.
    ``kind`` names the generator ("hifigan" or "bigvgan")."""
    gen_convert = {"hifigan": hifigan_from_jax, "bigvgan": bigvgan_from_jax}[kind]
    g_sd = lambda tree: gen_convert({"params": tree})  # noqa: E731
    d_sd = lambda tree: avocodo_discriminator_from_jax(  # noqa: E731
        {"params": tree}, state.discriminator, start_vector)
    state.generator.load_state_dict(g_sd(g_params))
    state.discriminator.load_state_dict(d_sd(d_params))
    for opt, sched, module, convert, mu, nu, count in (
            (state.g_optimizer, state.g_scheduler, state.generator, g_sd, g_mu, g_nu, g_count),
            (state.d_optimizer, state.d_scheduler, state.discriminator, d_sd, d_mu, d_nu,
             d_count)):
        opt.state.clear()
        load_optimizer_state(opt, module, convert, mu, nu, count)
        sched.jump_to(count)
    state.step = int(step)
    return state


def tiny_tts_from_jax(variables) -> dict:
    """JAX ``TinyTTS`` variables -> the port's ``train/aligner_train.py::
    TinyTTS`` state dict: each layer's directions as ``rnn{i}.*_l0`` and
    ``rnn{i}.*_l0_reverse``."""
    p = variables["params"]
    w = _Writer()
    w.linear("in_proj", p["in_proj"])
    for i in (1, 2):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            d = p[f"rnn{i}_{direction}"]
            w.sd[f"rnn{i}.weight_ih_l0{suffix}"] = _t(np.asarray(d["w_ih"]["kernel"]).T)
            w.sd[f"rnn{i}.weight_hh_l0{suffix}"] = _t(np.asarray(d["w_hh_kernel"]).T)
            w.sd[f"rnn{i}.bias_ih_l0{suffix}"] = _t(d["w_ih"]["bias"])
            w.sd[f"rnn{i}.bias_hh_l0{suffix}"] = _t(d["w_hh_bias"])
    w.linear("out_proj", p["out_proj"])
    return w.sd


def resnet_d_from_jax(variables, size: int = 4) -> dict:
    """JAX ``ResNetD`` variables -> the port's ``ResNetD`` state dict, for a
    critic of image side ``size``: ``block_{k}`` goes to ``resnet.{k}`` for
    the first two blocks and to ``resnet.{2k - 1}`` after them (each later
    block follows a pool)."""
    p = variables["params"]
    w = _Writer()
    w.linear("fc_input", p["fc_input"])
    w.sd["conv_img.weight"] = _conv_to_torch(p["conv_img"]["kernel"])
    w.sd["conv_img.bias"] = _t(p["conv_img"]["bias"])
    for k in range(2 + int(np.log2(size / 4))):
        bp, key = p[f"block_{k}"], f"resnet.{k if k < 2 else 2 * k - 1}"
        for conv in ("conv_0", "conv_1", "conv_s"):
            if conv in bp:
                w.sd[f"{key}.{conv}.weight"] = _conv_to_torch(bp[conv]["kernel"])
                if "bias" in bp[conv]:
                    w.sd[f"{key}.{conv}.bias"] = _t(bp[conv]["bias"])
    w.linear("fc", p["fc"])
    return w.sd


def shard_state_dict(sd: dict, rank: int, n: int, n_stacks: int = 3) -> dict:
    """'model' rank ``rank`` of ``n``'s share of a state dict by the
    tensor-parallel rules of ``dist/mesh.py`` (``param_sharding_rules``):
    each sharded key keeps its slice along the rule's dim, every other key
    stays whole.  ``n_stacks``: a HiFiGAN's residual stacks per stage."""
    from toucan_tpu_torch.dist.mesh import param_sharding_rules

    dims = param_sharding_rules(sd, n_stacks)
    return {k: v.chunk(n, dims[k])[rank].clone() if k in dims else v for k, v in sd.items()}


def gather_state_dicts(shards, n_stacks: int = 3) -> dict:
    """The inverse of ``shard_state_dict``: the ``n`` ranks' shares, in rank
    order, back to one whole state dict."""
    from toucan_tpu_torch.dist.mesh import param_sharding_rules

    dims = param_sharding_rules(shards[0], n_stacks)
    return {k: torch.cat([s[k] for s in shards], dims[k]) if k in dims else v
            for k, v in shards[0].items()}
