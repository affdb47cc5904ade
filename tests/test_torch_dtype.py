"""The port's serving dtype (bf16) and precision policy against JAX's.

The kernels on bf16 inputs: K1's plain version (f32 arithmetic on the same
bf16 values, as the JAX kernel's body upcasts them) against the Pallas
kernel in interpret mode at atol 2e-5, and K5's (f32 arithmetic, e^alpha
and 1 / (e^beta + eps) rounded to bf16, one rounding of the output) within
one bf16 ulp of the Pallas kernel's interior.

The bf16 interface against the JAX interface's ``dtype=jnp.bfloat16`` on
the same weights (the variables cast to bf16, as bf16 serving holds them)
and glow noise, durations given: the wave, mel, pitch and energy within
twice JAX's own bf16-against-f32 distance on the same inputs, the rule
``test_torch_quantized_vocoder.py`` holds int8 to.  Predicted durations
may differ only by one frame at a phone where JAX's own f32 log-duration
lies, from a rounding boundary, within twice the largest distance of JAX's
bf16 log-durations from its f32 ones plus one bf16 rounding step of the
log-duration: the bf16 paths' errors there can fall on either side.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.kernels.folded_conv import fold_time, unfold_time
from toucan_tpu.kernels.pallas_aliasfree import fused_alias_free_snake_interior
from toucan_tpu.kernels.pallas_attention import flash_rel_attention as jax_flash
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu.nn.conformer import _l2_normalize
from toucan_tpu.nn.masks import make_non_pad_mask as jax_non_pad_mask
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.kernels import aliasfree
from toucan_tpu_torch.kernels import flash_attention
from toucan_tpu_torch.kernels.aliasfree import alias_free_snake
from toucan_tpu_torch.kernels.flash_attention import flash_rel_attention
from toucan_tpu_torch.kernels.stage import stage_tiling
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders import hifigan as hifigan_module
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator, calibrate_act_scales
from toucan_tpu_torch.nn.masks import make_non_pad_mask
from toucan_tpu_torch.nn.predictors import _ConvStack
from toucan_tpu_torch.utils.device import matmul_precision
from toucan_tpu_torch.weights import hifigan_from_jax, toucan_tts_from_jax

from test_torch_bigvgan import SMALL, _inference, _vocoder
from test_torch_interface import IPA, TINY, TEXTS, whole_step
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _bf16(tree):
    """JAX variables as bf16 serving holds them: every f32 leaf rounded."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if np.asarray(a).dtype == np.float32 else a, tree)


def _bf16_ulp(x):
    """One bf16 rounding step at |x|."""
    return np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float32))[1] - 8)


# ------------------------------------------------------------------ kernels

@pytest.mark.parametrize("t,lengths,d", [(23, (23, 17), 16), (40, (33, 40), 96)])
def test_k1_plain_bf16_matches_pallas_interpret(t, lengths, d):
    rng = np.random.RandomState(t)
    xs = [rng.randn(2, 4, t, d).astype(np.float32) for _ in range(4)]
    xs.append(rng.randn(4, 2 * t - 1, d).astype(np.float32))
    bf = [torch.from_numpy(x).to(BF16) for x in xs]
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in bf),
                                jnp.asarray(lens), interpret=True))
    got = flash_rel_attention(*bf, torch.from_numpy(lens))
    assert got.dtype == torch.float32
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :, :n].numpy(), want[b, :, :n], atol=2e-5)
    assert flash_rel_attention.launches == 0 and flash_rel_attention.bf16.launches == 0


@pytest.mark.parametrize("f", [1, 2])
def test_k5_plain_bf16_matches_pallas_interpret(f):
    """The Pallas kernel's interior (it zero-pads the edges its caller
    patches): every sample 8 or more from an edge within one bf16 ulp."""
    rng = np.random.RandomState(f)
    t, c = 96, 8
    x = torch.from_numpy(rng.randn(2, t, c).astype(np.float32)).to(BF16)
    alpha, beta = (torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32)).to(BF16)
                   for _ in range(2))
    jx, ja, jb = (jnp.asarray(v.float().numpy(), jnp.bfloat16) for v in (x, alpha, beta))
    want = unfold_time(fused_alias_free_snake_interior(fold_time(jx, f), ja, jb, f,
                                                       interpret=True), f)
    want = np.asarray(want, np.float32)[:, 8:-8]
    got = alias_free_snake(x, alpha, beta)
    assert got.dtype == BF16
    got = got.float().numpy()[:, 8:-8]
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    assert alias_free_snake.launches == 0 and alias_free_snake.bf16.launches == 0


def test_wrappers_take_float32_or_bfloat16():
    """K1 takes five f32 or five bf16 tensors, K5 x with parameters of its
    dtype; anything else raises ValueError before a launch."""
    args = [torch.zeros(1, 2, 8, 16) for _ in range(4)] + [torch.zeros(2, 15, 16)]
    lens = torch.tensor([8], dtype=torch.int32)
    for dt in (torch.float32, BF16):
        flash_attention._check(*(a.to(dt) for a in args), lens)
    for bad in ([a.half() for a in args], [args[0].to(BF16)] + args[1:]):
        with pytest.raises(ValueError):
            flash_attention._check(*bad, lens)
    x, p = torch.zeros(1, 16, 4), torch.zeros(4)
    for dt in (torch.float32, BF16):
        aliasfree._check(x.to(dt), p.to(dt), p.to(dt))
    for bad in ((x.half(), p.half(), p.half()), (x.to(BF16), p, p)):
        with pytest.raises(ValueError):
            aliasfree._check(*bad)


def test_k5_vectorizes_bf16_rows_of_16_bytes():
    """bf16 rows take 16-byte accesses only where T is a multiple of 8."""
    assert aliasfree.snake_geometry(1, 4096, 32, 132, per_vector=8).vector
    assert not aliasfree.snake_geometry(1, 4100, 32, 132, per_vector=8).vector
    assert aliasfree.snake_geometry(1, 4100, 32, 132).vector


def test_k3_bf16_stage_width_limit():
    """The bf16 generator's stages run K3, which takes bf16 up to C = 352."""
    stage_tiling("bf16", 1, 4096, 352, 132, (3, 7, 11), (1, 3, 5))
    with pytest.raises(ValueError):
        stage_tiling("bf16", 1, 4096, 384, 132, (3, 7, 11), (1, 3, 5))


# ------------------------------------------------------------------ policy

@pytest.mark.parametrize("policy,flag", [("float32", False), ("default", True)])
def test_matmul_precision_sets_and_restores_flags(policy, flag):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = not flag, not flag
        with matmul_precision(policy):
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (flag, flag)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (not flag, not flag)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before
    with pytest.raises(ValueError, match="matmul_precision"):
        matmul_precision("highest").__enter__()


# ------------------------------------------------------------- interfaces

@pytest.fixture(scope="module")
def trio():
    """JAX's f32 and bf16 interfaces and the port's bf16 one, on the same
    seeded weights."""
    tts_vars = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                                jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                utterance_embedding=jnp.zeros((1, 64)),
                                lang_ids=jnp.zeros((1, 1), jnp.int32),
                                method=JaxToucanTTS.infer)
    voc_vars = seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                jnp.zeros((1, 16, 80)))
    emb = np.random.RandomState(2).randn(64).astype(np.float32)
    kw = dict(default_embedding=emb, config=JaxConfig(**TINY), language="en", use_g2p=False)
    j32 = JaxInterface(tts_vars, voc_vars, None, vocoder=JaxHiFiGAN(channels=64), **kw)
    j16 = JaxInterface(_bf16(tts_vars), _bf16(voc_vars), None, dtype=jnp.bfloat16,
                       vocoder=JaxHiFiGAN(channels=64, dtype=jnp.bfloat16), **kw)
    port = ToucanTTSInterface(toucan_tts_from_jax(tts_vars), hifigan_from_jax(voc_vars),
                              config=ToucanTTSConfig(**TINY), default_embedding=emb,
                              vocoder=HiFiGANGenerator(channels=64, dtype=BF16),
                              language="en", use_g2p=False, device="cpu", dtype=BF16)
    return j32, j16, port, tts_vars


def _e2e_inputs(port):
    phones = [port.text2phone.string_to_features(t, input_phonemes=True) for t in TEXTS]
    lens = np.asarray([len(p) for p in phones], np.int32)
    text = np.zeros((len(TEXTS), 32, 62), np.float32)
    for i, p in enumerate(phones):
        text[i, :len(p)] = p
    rng = np.random.RandomState(4)
    utt = rng.randn(3, 64).astype(np.float32)
    lang = np.asarray([[12], [12], [3]], np.int32)
    noise = (0.8 * rng.randn(3, 512, 80)).astype(np.float32)
    durations = rng.randint(1, 6, size=(3, 32)).astype(np.int32)
    return text, lens, utt, lang, noise, durations


def test_interface_dtype_is_the_models(trio):
    *_, port, _ = trio
    assert port.config.dtype == BF16 and port.model.feat_out.weight.dtype == BF16
    assert port.vocoder.dtype == BF16
    named = ToucanTTSInterface(port.model.state_dict(), HiFiGANGenerator().state_dict(),
                               config=ToucanTTSConfig(**TINY), device="cpu", dtype=BF16,
                               use_g2p=False)
    assert named.vocoder.dtype == BF16            # a vocoder named by string follows dtype
    given = HiFiGANGenerator(channels=64)
    passed = ToucanTTSInterface(port.model.state_dict(), given.state_dict(),
                                config=ToucanTTSConfig(**TINY), vocoder=given, device="cpu",
                                dtype=BF16, use_g2p=False)
    assert passed.vocoder.dtype == torch.float32  # a module passed in keeps its own


def test_bf16_interface_matches_jax_bf16(trio):
    """With durations given: wave, mel, pitch and energy of the port's bf16
    step within twice JAX's own bf16-against-f32 distance; the outputs are
    f32."""
    j32, j16, port, _ = trio
    text, lens, utt, lang, noise, durations = _e2e_inputs(port)
    knobs = (1.0, 1.0, 1.0, 1.0)
    args = (jnp.asarray(text), jnp.asarray(lens), jnp.asarray(utt), jnp.asarray(lang),
            jnp.asarray(noise), jnp.asarray(knobs, jnp.float32))
    outs = {}
    for name, it in (("j32", j32), ("j16", j16)):
        res = it._e2e_fn(32, 512, True)(it.tts_variables, it.vocoder_variables, *args,
                                        durations=jnp.asarray(durations))
        outs[name] = [np.asarray(a, np.float32) for a in res]
    got = whole_step(port, torch.tensor(text), torch.tensor(lens, dtype=torch.long), 512,
                     torch.tensor(utt), torch.tensor(lang, dtype=torch.long),
                     torch.tensor(noise), knobs, durations=torch.tensor(durations))
    assert all(g.dtype in (torch.float32, torch.int32, torch.int64) for g in got)
    got = [g.numpy().astype(np.float32) for g in got]
    np.testing.assert_array_equal(got[2], outs["j16"][2])     # durations as given
    np.testing.assert_array_equal(got[5], outs["j16"][5])     # mel lengths
    for i, what in ((0, "wave"), (1, "mel"), (3, "pitch"), (4, "energy")):
        jax_spread = np.abs(outs["j16"][i] - outs["j32"][i]).max()
        err = np.abs(got[i] - outs["j16"][i]).max()
        assert 0 < jax_spread and err <= 2 * jax_spread, (what, err, jax_spread)


def _log_durations(module, text, text_lengths, utt, lang):
    """The duration predictor's log-durations before rounding, on the
    encoder of ``infer``."""
    utt = _l2_normalize(utt)
    mask = jax_non_pad_mask(text_lengths, text.shape[1])
    cmask = mask[..., None].astype(text.dtype)
    enc = module.encoder(text, mask[:, None, :], utterance_embedding=utt, lang_ids=lang,
                         conv_mask=cmask)
    return module.duration_predictor(enc, utt_embed=utt, is_inference=False,
                                     input_mask=cmask)


def _durations(module, text, text_lengths, utt, lang):
    """The duration predictor's rounded durations on the encoder of ``infer``."""
    utt = _l2_normalize(utt)
    mask = jax_non_pad_mask(text_lengths, text.shape[1])
    cmask = mask[..., None].astype(text.dtype)
    enc = module.encoder(text, mask[:, None, :], utterance_embedding=utt, lang_ids=lang,
                         conv_mask=cmask)
    return module.duration_predictor(enc, utt_embed=utt, is_inference=True, input_mask=cmask)


def test_bf16_predicted_durations_follow_the_rule(trio):
    j32, j16, port, tts_vars = trio
    text, lens, *_ = _e2e_inputs(port)
    # the interface's speaker and language: seeded weights keep these
    # log-durations in the range of speech (a random embedding can drive
    # one to e^20 frames)
    utt = np.tile(j32.default_utterance_embedding[None], (len(lens), 1))
    lang = np.full((len(lens), 1), j32.lang_id, np.int32)
    jargs = (jnp.asarray(text), jnp.asarray(lens), jnp.asarray(utt), jnp.asarray(lang))
    x32 = np.asarray(jax.jit(functools.partial(JaxToucanTTS(JaxConfig(**TINY)).apply,
                                               method=_log_durations))(tts_vars, *jargs))
    x16 = np.asarray(jax.jit(functools.partial(
        JaxToucanTTS(JaxConfig(**TINY, dtype=jnp.bfloat16)).apply,
        method=_log_durations))(_bf16(tts_vars), *jargs), np.float32)
    valid = np.arange(32)[None] < lens[:, None]
    spread = np.abs(x16 - x32)[valid].max()
    model = port.model
    with torch.inference_mode():
        tl = torch.tensor(lens, dtype=torch.long)
        mask = make_non_pad_mask(tl, 32)
        cmask = mask[..., None].to(BF16)
        u = torch.nn.functional.normalize(torch.tensor(utt), dim=-1)
        enc = model.encoder(torch.tensor(text).to(BF16), mask[:, None, :], utterance_embedding=u,
                            lang_ids=torch.tensor(lang, dtype=torch.long), conv_mask=cmask)
        got = model.duration_predictor(enc, u, cmask).numpy()
    want = np.asarray(jax.jit(functools.partial(
        JaxToucanTTS(JaxConfig(**TINY, dtype=jnp.bfloat16)).apply,
        method=_durations))(_bf16(tts_vars), *jargs))
    differ = (got != want) & valid
    k = np.minimum(got, want)[differ]
    boundary = np.log(k + 1.5)                       # round(e^x - 1) steps up at x = log(k + 1.5)
    x = x32[differ]
    assert np.all(np.abs(got - want)[differ] == 1)
    assert np.all(np.abs(x - boundary) <= 2 * spread + _bf16_ulp(x)), (x, boundary, spread)


@pytest.mark.parametrize("kind", ["hifigan", "bigvgan"])
def test_bf16_generators_match_jax_bf16(kind):
    """HiFiGAN (stages on K3's bf16 mode, its plain version here) and BigVGAN
    (K5's bf16 plain version; one AMP block of two rounds a stage) on one
    mel, each within twice JAX's own bf16-against-f32 distance."""
    mel = np.random.RandomState(9).randn(1, 8, 80).astype(np.float32)
    if kind == "hifigan":
        j32, j16 = JaxHiFiGAN(channels=64), JaxHiFiGAN(channels=64, dtype=jnp.bfloat16)
        variables = seeded_variables(j32, np.random.RandomState(1), jnp.zeros((1, 16, 80)))
        port = HiFiGANGenerator(channels=64, dtype=BF16)
        port.load_state_dict(hifigan_from_jax(variables))
    else:
        j32, variables, small = _vocoder(12, small=True)
        j16 = j32.clone(dtype=jnp.bfloat16)
        port = BigVGAN(**SMALL, resblock_dilations=(1, 3), dtype=BF16)
        port.load_state_dict(small.state_dict())
        variables = _inference(variables)
    w32 = np.asarray(jax.jit(j32.apply)(variables, mel), np.float32)
    w16 = np.asarray(jax.jit(j16.apply)(_bf16(variables), mel), np.float32)
    got = port.eval()(torch.from_numpy(mel)).numpy()
    spread = np.abs(w16 - w32).max()
    assert 0 < spread and np.abs(got - w16).max() <= 2 * spread, (np.abs(got - w16).max(),
                                                                    spread)


def test_bf16_hifigan_runs_every_stage_on_k3_bf16(monkeypatch):
    """Stages that neither ``stage_mode`` nor ``imcol_mode`` takes run K3's
    bf16 mode in a bf16 generator, with f32 inputs (bf16 values)."""
    seen = []
    real = hifigan_module.quantized_stage

    def spy(x, qs, *a, **k):
        seen.append((qs.mode, x.dtype))
        return real(x, qs, *a, **k)
    monkeypatch.setattr(hifigan_module, "quantized_stage", spy)
    gen = HiFiGANGenerator(channels=64, dtype=BF16).eval()
    wave = gen(torch.randn(1, 8, 80))
    assert wave.dtype == torch.float32 and seen == [("bf16", torch.float32)] * 4
    seen.clear()
    HiFiGANGenerator(channels=64).eval()(torch.randn(1, 8, 80))
    assert seen == []                                # f32 generators keep K2


def test_quantize_vocoder_on_bf16_calibrates_in_f32(trio):
    """A bf16 generator is calibrated on an f32 copy of its weights, as the
    JAX capture clones the model with dtype f32."""
    *_, port, _ = trio
    mel = torch.randn(1, 12, 80, generator=torch.Generator().manual_seed(3))
    f32 = HiFiGANGenerator(channels=64).eval()
    f32.load_state_dict({k: v.float() for k, v in port.vocoder.state_dict().items()})
    want = calibrate_act_scales(f32, mel)
    got = calibrate_act_scales(port.vocoder, mel)
    assert port.vocoder.dtype == BF16
    for i in want:
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)


def test_policy_change_clears_the_buckets(trio):
    *_, port, _ = trio
    port.precompile(phone_buckets=(32,))
    assert port._e2e_cache
    port.matmul_precision = "float32"                # unchanged: buckets stay
    assert port._e2e_cache
    try:
        port.matmul_precision = "default"
        assert not port._e2e_cache
        wave = port(IPA, input_is_phones=True)
        assert wave.dtype == np.float32 and np.isfinite(wave).all()
        assert port._e2e_cache[next(iter(port._e2e_cache))].policy == "default"
    finally:
        port.matmul_precision = "float32"
    with pytest.raises(ValueError, match="matmul_precision"):
        port.matmul_precision = "tf32"


def test_bf16_model_keeps_f32_where_jax_does():
    """The glow's InvConv is inverted in f32 (torch has no bf16 inverse);
    returned pitch and energy are f32; the mel is the model's dtype."""
    model = ToucanTTS(ToucanTTSConfig(**TINY, dtype=BF16)).eval()
    text = torch.zeros(1, 8, 62)
    out = model.infer(text, torch.tensor([8]), 64, utterance_embedding=torch.randn(1, 64),
                      lang_ids=torch.tensor([[3]]), glow_noise=torch.randn(1, 64, 80))
    assert [o.dtype for o in out] == [BF16, BF16, torch.int32, torch.float32, torch.float32,
                                      torch.int64]
    assert isinstance(model.duration_predictor, _ConvStack)
