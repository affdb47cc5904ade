"""Load reference PyTorch checkpoint files into the port.

The port's twin of ``toucan_tpu/compat/load.py``, for the formats of the
reference release (``run_model_downloader.py``): ToucanTTS ``best.pt``
({"model": ..., "default_emb": ...}), vocoder ``best.pt`` ({"generator":
...}), the embedding function ``embedding_function.pt``
({"style_emb_func": ...}), the aligner ``aligner.pt`` ({"asr_model": ...})
and the embedding GAN ``embedding_gan.pt`` ({"model_parameters": ...,
"generator_state_dict": ...}).  The port's modules use the reference's
state-dict keys, so loading is: weight norm folded (``fold_weight_norm``),
then the reference's constant buffers that the port computes instead are
dropped by name:

- ``post_flow.flows.{n}.l_mask`` and ``.eye``: the Glow's InvConvNear LU
  masks (the port keeps only ``p`` and ``sign_s``);
- ``*.upsample.filter`` and ``*.downsample.lowpass.filter`` of BigVGAN's
  activations: the kaiser-sinc resampling filter, a constant in the port.

Everything else goes to ``load_state_dict`` as it is, so a key that is
missing or unknown raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig

# the layers the reference keeps weight-normed: the Glow's WaveNet convs; in
# the vocoders every conv
GLOW_WEIGHT_NORM = r"post_flow\.flows\.\d+\.(start|wn\.(cond_layer|in_layers\.\d+|res_skip_layers\.\d+))\."
DROPPED = re.compile(r"(post_flow\.flows\.\d+\.(l_mask|eye)"
                     r"|(.*\.)?activation(s\.\d+|_post)\.(upsample\.filter|downsample\.lowpass\.filter))$")


def _torch_load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def fold_weight_norm(sd) -> dict:
    """Every ``*.weight_g``/``*.weight_v`` pair becomes ``*.weight`` = g * v
    / ||v|| (the norm over every axis but the first), in numpy float32 with
    the arithmetic of ``compat/torch_toucan.py::_fold_weight_norm``."""
    out = {}
    for key, value in sd.items():
        if key.endswith(".weight_v"):
            continue
        if key.endswith(".weight_g"):
            base = key[:-len(".weight_g")]
            g = value.detach().cpu().numpy()
            v = sd[f"{base}.weight_v"].detach().cpu().numpy()
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out[f"{base}.weight"] = torch.from_numpy(g * v / norm)
        else:
            out[key] = value
    return out


def split_weight_norm(sd, pattern: str) -> dict:
    """The inverse of ``fold_weight_norm``, for writing checkpoints in the
    reference's format: every ``*.weight`` whose key matches ``pattern``
    becomes ``weight_g``, its norm over every axis but the first, and
    ``weight_v``, the weight itself."""
    rx, out = re.compile(pattern), {}
    for key, value in sd.items():
        if key.endswith(".weight") and rx.search(key):
            base = key[:-len(".weight")]
            out[f"{base}.weight_g"] = value.norm(dim=tuple(range(1, value.dim())), keepdim=True)
            out[f"{base}.weight_v"] = value.clone()
        else:
            out[key] = value
    return out


def reference_state_dict(sd) -> dict:
    """A reference state dict as the port's modules take it: weight norm
    folded, the buffers in ``DROPPED`` left out."""
    return {k: v for k, v in fold_weight_norm(sd).items() if not DROPPED.match(k)}


def _layer_count(sd, pattern) -> int:
    """Number of indexed sub-modules matching ``pattern`` (one ``(\\d+)``
    group), e.g. ``encoder.encoders.(\\d+).`` -> layer count."""
    rx = re.compile(pattern)
    best = -1
    for k in sd:
        m = rx.match(k)
        if m:
            best = max(best, int(m.group(1)))
    return best + 1


def sniff_toucan_config(sd) -> ToucanTTSConfig:
    """Detect the checkpoint architecture from its keys and shapes.

    Covers the reference's 3-way fallback (``ToucanTTSInterface.py:56-63``:
    multilingual-multispeaker -> multispeaker-only (``lang_embs=None``) ->
    single-speaker (``utt_embed_dim=None``, plain-LayerNorm predictors))
    plus the layer and width geometry (conformer depth, predictor stacks,
    glow depth).  ``use_postflow`` is whether there are ``post_flow.flows.*``
    keys (a FastSpeech2-style checkpoint has none).  ``conditional_predictors``
    is whether the duration predictor's norms are conditional layer norms,
    read from its own keys (``norms.{i}.W_scale.*``, the MLP that
    ``compat/torch_toucan.py::_t_cln`` reads), not from the encoder's: the
    JAX package's ``compat/load.py:94-99`` takes any checkpoint with
    ``encoder.hs_emb_projection`` as conditional, and so misreads the
    FastSpeech2 layout (an utterance embedding in the encoder, plain
    LayerNorm predictors).
    """
    kw = {}
    if "feat_out.weight" in sd:  # Linear(adim -> mel)
        kw["adim"] = int(sd["feat_out.weight"].shape[1])
        kw["mel_channels"] = int(sd["feat_out.weight"].shape[0])
    if "encoder.encoders.0.self_attn.pos_bias_u" in sd:
        kw["aheads"] = int(sd["encoder.encoders.0.self_attn.pos_bias_u"].shape[0])
    for side in ("enc", "dec"):
        prefix = "encoder" if side == "enc" else "decoder"
        n = _layer_count(sd, rf"{prefix}\.encoders\.(\d+)\.")
        if n:
            kw[f"{side}_layers"] = n
            w1 = sd[f"{prefix}.encoders.0.feed_forward.w_1.weight"]
            kw[f"{side}_units"] = int(w1.shape[0])
            dw = sd[f"{prefix}.encoders.0.conv_module.depthwise_conv.weight"]
            kw[f"{side}_kernel"] = int(dw.shape[-1])
    for pred in ("duration", "pitch", "energy"):
        n = _layer_count(sd, rf"{pred}_predictor\.conv\.(\d+)\.")
        if n:
            w = sd[f"{pred}_predictor.conv.0.0.weight"]
            kw[f"{pred}_layers"] = n
            kw[f"{pred}_chans"] = int(w.shape[0])
            kw[f"{pred}_kernel"] = int(w.shape[-1])
    n_flows = _layer_count(sd, r"post_flow\.flows\.(\d+)\.")
    kw["use_postflow"] = n_flows > 0
    if n_flows:
        kw["glow_blocks"] = n_flows // 3  # [ActNorm, InvConvNear, Coupling]
        kw["glow_layers"] = _layer_count(sd, r"post_flow\.flows\.2\.wn\.in_layers\.(\d+)\.")
        wv = sd.get("post_flow.flows.2.wn.in_layers.0.weight_v",
                    sd.get("post_flow.flows.2.wn.in_layers.0.weight"))
        if wv is not None:
            kw["glow_hidden"] = int(wv.shape[1])
            kw["glow_kernel"] = int(wv.shape[-1])
    kw["conditional_predictors"] = any(
        re.match(r"duration_predictor\.norms\.\d+\.W_scale\.", k) for k in sd)

    lang_embs = None
    if "encoder.language_embedding.weight" in sd:
        lang_embs = int(sd["encoder.language_embedding.weight"].shape[0])
    utt_embed_dim = None
    if "encoder.hs_emb_projection.weight" in sd:
        # Linear(adim + utt_embed_dim -> adim)  (Conformer.py:70)
        w = sd["encoder.hs_emb_projection.weight"]
        utt_embed_dim = int(w.shape[1] - w.shape[0])
    return ToucanTTSConfig(lang_embs=lang_embs, utt_embed_dim=utt_embed_dim, **kw)


def load_toucan_tts(path: str, return_config: bool = False):
    """-> (state dict, default embedding (numpy) or None[, config]).

    ``return_config=True`` also returns the :class:`ToucanTTSConfig`
    detected from the checkpoint's layout (``sniff_toucan_config``)."""
    ckpt = _torch_load(path)
    sd = reference_state_dict(ckpt["model"])
    config = sniff_toucan_config(sd)
    default_emb = ckpt.get("default_emb")
    if default_emb is not None:
        default_emb = default_emb.detach().cpu().numpy()
    if return_config:
        return sd, default_emb, config
    return sd, default_emb


def load_vocoder(path: str, kind: str = "hifigan") -> dict:
    """The generator's state dict of a HiFiGAN (``kind="hifigan"``) or
    BigVGAN (``"bigvgan"``) checkpoint.  ``kind`` is taken for parity with
    ``compat/load.py``, which picks a converter by it, and changes nothing
    here: both vocoders use the reference's keys.  An unknown kind raises."""
    if kind not in ("hifigan", "bigvgan"):
        raise ValueError(f"kind must be 'hifigan' or 'bigvgan', got {kind!r}")
    ckpt = _torch_load(path)
    return reference_state_dict(ckpt["generator"] if "generator" in ckpt else ckpt)


def load_style_embedding(path: str) -> dict:
    """The StyleEmbedding (GST) state dict of an embedding-function checkpoint."""
    ckpt = _torch_load(path)
    return reference_state_dict(ckpt["style_emb_func"] if "style_emb_func" in ckpt else ckpt)


def load_aligner(path: str) -> dict:
    """The Aligner state dict of an aligner checkpoint (``asr_model``);
    ``models.aligner.Aligner.for_state_dict`` builds its module."""
    ckpt = _torch_load(path)
    return reference_state_dict(ckpt["asr_model"] if "asr_model" in ckpt else ckpt)


def load_embedding_gan(path: str):
    """-> (generator state dict, ResNetG of the checkpoint's shape,
    dataset_mean, dataset_std (numpy or None)).

    Reads the reference ``embedding_gan.pt`` (``GAN.py:31-39``): the
    generator's shape from its ``model_parameters``, the weights from
    ``generator_state_dict``."""
    from toucan_tpu_torch.models.embedding_gan import ResNetG

    ckpt = _torch_load(path)
    mp = ckpt["model_parameters"]
    data_dim = mp["data_dim"][-1] if isinstance(mp["data_dim"], (list, tuple)) else mp["data_dim"]
    generator = ResNetG(data_dim=data_dim, z_dim=mp["z_dim"], size=mp["size"],
                        nfilter=mp["nfilter"], nfilter_max=mp["nfilter_max"])
    stats = [ckpt.get(k) for k in ("dataset_mean", "dataset_std")]
    mean, std = [v.detach().cpu().numpy() if hasattr(v, "detach") else v for v in stats]
    return dict(ckpt["generator_state_dict"]), generator, mean, std


def interface_from_torch(tts_path: str, vocoder_path: str, embedding_path: str,
                         vocoder_kind="hifigan", language: str = "en", use_g2p: bool = True,
                         **interface_kwargs):
    """A ready ToucanTTSInterface from reference checkpoints.

    ``vocoder_kind`` is "hifigan", "bigvgan" (the generator of that kind at
    the checkpoint's width, ``input_conv``'s or ``conv_pre``'s output
    channels, in the interface's ``dtype``), or a vocoder module of the
    checkpoint's widths to load the weights into (for example
    ``HiFiGANGenerator(imcol_mode="int8")``).  Extra keyword arguments
    (``device``, ``seed``, ``dtype``, ``matmul_precision``) pass through to
    the interface."""
    from toucan_tpu_torch.infer.interface import VOCODERS, ToucanTTSInterface

    tts_sd, default_emb, config = load_toucan_tts(tts_path, return_config=True)
    voc_sd = load_vocoder(vocoder_path, vocoder_kind if isinstance(vocoder_kind, str)
                          else "hifigan")
    if isinstance(vocoder_kind, str):
        first = "input_conv.weight" if vocoder_kind == "hifigan" else "conv_pre.weight"
        vocoder_kind = VOCODERS[vocoder_kind](
            channels=int(voc_sd[first].shape[0]),
            dtype=interface_kwargs.get("dtype") or torch.float32)
    return ToucanTTSInterface(tts_sd, voc_sd, config=config,
                              vocoder=vocoder_kind, default_embedding=default_emb,
                              gst_state_dict=load_style_embedding(embedding_path),
                              language=language, use_g2p=use_g2p, **interface_kwargs)
