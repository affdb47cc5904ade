"""The port's prosody cloning against the JAX package's, on the CPU.

A tiny aligner (conv 64, BiLSTM 32; the real one is 512/512) with seeded
weights in the JAX layout is carried to the port by
``weights.aligner_from_jax``; a tiny ToucanTTS and HiFiGAN likewise.  The
bars: the aligner's logits within 3e-4 and the CTC loss within rtol 1e-4
(``tests/test_aligner.py``); MAS and dijkstra bit for bit on the same
logits; after JAX's 5-step fine-tune, in float64 (see ``fine_tuned``),
parameters within 1e-7, the running statistics (flax's biased-variance
update) within 1e-5 and the logits within 1e-5; durations equal and the token-averaged pitch and energy
within 1e-4 (relative to their nonzero mean of 1); the native F0 within
rtol 1e-6 of the numpy F0 on voiced frames (``tests/test_native_f0.py``);
the synthesis with the cloned durations, pitch and energy and the same
glow noise within 2e-5 of the JAX interface's wave
(``tests/test_vocoder_parity.py``).  ``path_score`` and
``chip_smoke.check_alignments``, which tell a near-tie of two alignments
from a fault, are held to an exhaustive search on small grids.
"""

import contextlib
import copy
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.compat.torch_aligner import convert_aligner
from toucan_tpu.frontend import pitch as jax_pitch
from toucan_tpu.infer import cloner as jax_cloner_module
from toucan_tpu.infer.cloner import UtteranceCloner as JaxCloner
from toucan_tpu.infer.interface import ToucanTTSInterface as JaxInterface
from toucan_tpu.models.aligner import Aligner as JaxAligner
from toucan_tpu.models.aligner import alignment_from_logits as jax_alignment
from toucan_tpu.models.aligner import ctc_loss as jax_ctc_loss
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu_torch import native
from toucan_tpu_torch.data import extraction
from toucan_tpu_torch.frontend import pitch
from toucan_tpu_torch.frontend.audio import AudioPreprocessor
from toucan_tpu_torch.infer.cloner import UtteranceCloner
from toucan_tpu_torch.infer.interface import ToucanTTSInterface
from toucan_tpu_torch.load import load_aligner
from toucan_tpu_torch.models.aligner import (Aligner, alignment_from_logits, ctc_loss,
                                             path_score)
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.weights import aligner_from_jax, hifigan_from_jax, toucan_tts_from_jax

import chip_smoke
from test_torch_gst import seeded_gst, speech_like
from test_torch_interface import IPA, TINY
from test_torch_modules import seeded_variables

torch.set_num_threads(2)

WIDTHS = dict(conv_dim=64, lstm_dim=32)
SR = 16000
TOL_LOGITS = 3e-4
# the float64 fine-tune: the two agree to ~1e-9 after the first step, and
# BatchNorm over near-dead first-layer channels scales that up over five
TOL_F64_PARAMS = 1e-7
TOL_F64_STATS = 1e-5
TOL_F64_LOGITS = 1e-5
TOL_PROSODY = 1e-4
TOL_WAVE = 2e-5
jax_aligner = jax.jit(JaxAligner(**WIDTHS).apply)


def reference_wave(seed=0):
    """1.3 s at 16 kHz: a voiced stretch between silences."""
    wave = speech_like(SR, 1.1, seed=seed)
    return np.concatenate([np.zeros(1600, np.float32), wave, np.zeros(1600, np.float32)])


@pytest.fixture(scope="module")
def pair():
    """(JAX interface, JAX cloner, port interface, port cloner) on the same
    seeded weights; the JAX cloner's aligner is the tiny one."""
    aligner_vars = seeded_variables(JaxAligner(**WIDTHS), np.random.RandomState(3),
                                    jnp.zeros((1, 20, 80)), jnp.array([20]))
    tts_vars = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                                jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                utterance_embedding=jnp.zeros((1, 64)),
                                lang_ids=jnp.zeros((1, 1), jnp.int32), method=JaxToucanTTS.infer)
    voc_vars = seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                jnp.zeros((1, 16, 80)))
    emb = np.random.RandomState(2).randn(64).astype(np.float32)
    jax_iface = JaxInterface(tts_vars, voc_vars, None, default_embedding=emb,
                             config=JaxConfig(**TINY), vocoder=JaxHiFiGAN(channels=64),
                             language="en", use_g2p=False)
    port = ToucanTTSInterface(toucan_tts_from_jax(tts_vars), hifigan_from_jax(voc_vars),
                              config=ToucanTTSConfig(**TINY),
                              vocoder=HiFiGANGenerator(channels=64), default_embedding=emb,
                              language="en", use_g2p=False, device="cpu")
    return (jax_iface, JaxCloner(jax_iface, aligner_vars), port,
            UtteranceCloner(port, aligner_from_jax(aligner_vars)))


@contextlib.contextmanager
def jax_cloner_aligner(**kw):
    """The JAX cloner builds ``Aligner()`` for each call: make it the tiny
    one (with ``kw``) meanwhile."""
    orig = jax_cloner_module.Aligner
    jax_cloner_module.Aligner = lambda: orig(**WIDTHS, **kw)
    try:
        yield
    finally:
        jax_cloner_module.Aligner = orig


@pytest.fixture(scope="module")
def reference(pair):
    """The port's prepared reference: wave, mel (T, 80), phones, CTC ids."""
    return pair[3].prepare(IPA, reference_wave(), SR, "en", input_is_phones=True)


def test_aligner_forward_and_ctc_match_jax(pair):
    aligner_vars, port_aligner = pair[1].aligner_variables, pair[3].aligner
    rng = np.random.RandomState(4)
    mel = (rng.randn(2, 40, 80) - 4).astype(np.float32)
    lens = np.array([40, 30])
    want = np.asarray(jax_aligner(aligner_vars, jnp.asarray(mel), jnp.asarray(lens)))
    with torch.no_grad():
        got = port_aligner(torch.from_numpy(mel), lens).numpy()
    assert got.shape == want.shape == (2, 40, 145)
    np.testing.assert_allclose(got, want, atol=TOL_LOGITS)
    labels = rng.randint(0, 144, (2, 12))
    label_lens = np.array([12, 9])
    want_loss = float(jax_ctc_loss(jnp.asarray(want), jnp.asarray(lens), jnp.asarray(labels),
                                   jnp.asarray(label_lens)))
    got_loss = float(ctc_loss(torch.from_numpy(got), lens, labels, label_lens))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


def test_ctc_of_an_infeasible_sequence():
    """Fewer frames than labels: the port counts 0, as the reference's
    ``nn.CTCLoss(zero_infinity=True)``; JAX's optax loss, with its finite
    log-epsilon, gives a large finite value instead.  A limit of the
    comparison, not a port fault: in the port, as in the reference, such a
    sequence adds nothing to the fine-tune's gradient."""
    rng = np.random.RandomState(5)
    logits = rng.randn(1, 5, 145).astype(np.float32)
    labels = rng.randint(0, 144, (1, 12))
    want = float(jax_ctc_loss(jnp.asarray(logits), jnp.asarray([5]), jnp.asarray(labels),
                              jnp.asarray([12])))
    assert float(ctc_loss(torch.from_numpy(logits), [5], labels, [12])) == 0.0
    assert np.isfinite(want) and want > 1e3


@pytest.mark.parametrize("method", ["MAS", "dijkstra"])
def test_pathfinding_equals_jax_on_the_same_logits(pair, reference, method):
    logits = np.asarray(jax_aligner(pair[1].aligner_variables,
                                    jnp.asarray(reference.mel.numpy()[None])))[0]
    want = jax_alignment(logits, reference.token_ids, method=method)
    got = alignment_from_logits(logits, reference.token_ids, method=method)
    assert got.shape == (len(reference.mel), len(reference.token_ids))
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == 1).all()


def monotone_paths(frames, tokens, method):
    """Every path the pathfinding may return on a (frames, tokens) grid, as
    one token a frame: MAS starts at token 0 and moves on by at most one a
    frame, dijkstra starts anywhere in frame 0 and may skip; both end on the
    last token."""
    for cols in itertools.product(range(tokens), repeat=frames):
        steps = np.diff(cols)
        if cols[-1] != tokens - 1 or (steps < 0).any():
            continue
        if method == "MAS" and (cols[0] != 0 or (steps > 1).any()):
            continue
        yield np.eye(tokens, dtype=np.float32)[list(cols)]


@pytest.mark.parametrize("method", ["MAS", "dijkstra"])
def test_path_score_is_what_the_pathfinding_maximizes(method):
    """Over every path through a small grid, the pathfinding's own path
    scores highest."""
    rng = np.random.RandomState(11)
    for _ in range(4):
        logits = rng.randn(7, 3)
        found = alignment_from_logits(logits, np.arange(3), method)
        best = max(path_score(logits, p, method) for p in monotone_paths(7, 3, method))
        assert path_score(logits, found, method) == pytest.approx(best, abs=1e-12)


@pytest.mark.parametrize("method", ["MAS", "dijkstra"])
def test_near_tie_check_passes_a_flip_and_refuses_a_wrong_path(method):
    """``chip_smoke.check_alignments`` lets two close sets of logits part on
    a near-tie, and refuses a path that is not its side's optimum."""
    rng = np.random.RandomState(5)
    for _ in range(200):
        a = rng.randn(12, 4)
        b = a + 0.05 * rng.randn(*a.shape)
        aligns = [alignment_from_logits(x, np.arange(4), method) for x in (a, b)]
        if not np.array_equal(*aligns):
            break
    else:
        pytest.fail("no pair of close logits parted")
    assert "near-tie" in chip_smoke.check_alignments(method, [a, b], aligns)
    assert chip_smoke.check_alignments(method, [a, a], [aligns[0]] * 2) == "paths equal"
    with pytest.raises(AssertionError, match="more than a near-tie"):
        chip_smoke.check_alignments(method, [a, b], aligns[::-1])


@pytest.fixture(scope="module")
def fine_tuned(pair, reference):
    """(JAX variables after ``_fine_tune_aligner``, the port's aligner after
    its own), both in float64, on the same mel and CTC ids.

    In float32 the two fine-tunes part after the second of the five steps:
    BatchNorm over first-layer channels that are nearly all zero after the
    ReLU divides by sqrt(var + 1e-5) with var far below 1e-5, which scales
    each side's float32 rounding by ~300, and a ReLU input near zero in a
    later layer then takes opposite signs.  In float64 neither rounding
    reaches the kink, so the 5 steps are compared here, and the float32
    ``extract_prosody`` on the loaded aligner (``prosody``)."""
    jax_cl, port_cl = pair[1], pair[3]
    mel = reference.mel.double()
    saved = jax_cl.aligner_variables
    with jax.enable_x64(True), jax_cloner_aligner(dtype=jnp.float64):
        jax_cl.aligner_variables = jax.tree.map(lambda a: np.asarray(a, np.float64), saved)
        try:
            want = jax_cl._fine_tune_aligner(mel.numpy(), reference.token_ids)
        finally:
            jax_cl.aligner_variables = saved
        want_logits = np.asarray(JaxAligner(**WIDTHS, dtype=jnp.float64).apply(
            want, jnp.asarray(mel.numpy()[None])))[0]
    cl64 = copy.copy(port_cl)
    cl64.aligner = copy.deepcopy(port_cl.aligner).double()
    aligner = cl64._fine_tune_aligner(mel, reference.token_ids)
    return want, want_logits, aligner, cl64.logits(aligner, mel)


def test_fine_tune_matches_jax(pair, fine_tuned):
    """Parameters, running statistics (flax's 0.9/0.1 update with the biased
    batch variance) and the logits after 5 SGD steps."""
    want, want_logits, aligner, logits = fine_tuned
    got = convert_aligner({k: v.numpy() for k, v in aligner.state_dict().items()})
    before = pair[1].aligner_variables
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    for (path, g), (_, w), (_, b) in zip(flat(got), flat(want), flat(before)):
        tol = TOL_F64_STATS if path[0].key == "batch_stats" else TOL_F64_PARAMS
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, err_msg=str(path))
        assert not np.allclose(np.asarray(w), np.asarray(b), atol=1e-6), path  # trained
    assert logits.dtype == np.float64
    np.testing.assert_allclose(logits, want_logits, atol=TOL_F64_LOGITS)


def test_running_variance_is_the_biased_update():
    torch.manual_seed(0)
    conv = Aligner(conv_dim=8, lstm_dim=4).convs[0]
    x = torch.randn(2, 80, 30)
    before = conv.bnorm.running_var.clone()
    conv(x, train=True)
    h = torch.relu(conv.conv(x))
    want = 0.9 * before + 0.1 * h.var(dim=(0, 2), unbiased=False)
    torch.testing.assert_close(conv.bnorm.running_var, want)


def test_fine_tune_leaves_the_loaded_aligner(pair):
    """Two ``extract_prosody`` calls give equal results: the fine-tune
    trains a copy."""
    port_cl = pair[3]
    sd = {k: v.clone() for k, v in port_cl.aligner.state_dict().items()}
    first = port_cl.extract_prosody(IPA, reference_wave(), SR, input_is_phones=True)
    second = port_cl.extract_prosody(IPA, reference_wave(), SR, input_is_phones=True)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(v, port_cl.aligner.state_dict()[k]) for k, v in sd.items())
    assert not port_cl.aligner.training


@pytest.fixture(scope="module")
def prosody(pair):
    """{pathfinding: (JAX extract_prosody, port extract_prosody)} on the
    loaded aligner: the float32 fine-tune is left out, as the two sides'
    float32 fine-tunes part at a ReLU kink (see ``fine_tuned``)."""
    kw = dict(sr=SR, input_is_phones=True, on_line_fine_tune=False)
    with jax_cloner_aligner():
        return {method: tuple(cl.extract_prosody(IPA, reference_wave(), pathfinding=method, **kw)
                              for cl in (pair[1], pair[3]))
                for method in ("MAS", "dijkstra")}


@pytest.mark.parametrize("method", ["MAS", "dijkstra"])
def test_extract_prosody_matches_jax(prosody, method):
    want, got = prosody[method]
    np.testing.assert_array_equal(got[0], want[0])           # durations
    assert got[0].sum() > 0 and (got[0] > 0).sum() > 3
    for g, w in zip(got[1:3], want[1:3]):                    # pitch, energy
        assert g.shape == w.shape == (len(got[0]), 1)
        np.testing.assert_allclose(g, w, atol=TOL_PROSODY)
    assert got[3:] == want[3:]                                # silences


@pytest.mark.parametrize("base", [90.0, 150.0, 320.0])
def test_native_f0_matches_numpy(base):
    if not native.native_f0_available():
        pytest.skip("no host C++ toolchain")
    t = np.arange(2 * SR) / SR
    f = base + 30 * np.sin(2 * np.pi * 2 * t)
    sig = 0.5 * np.sin(np.cumsum(2 * np.pi * f / SR)) + 0.01 * np.random.RandomState(0).randn(len(t))
    sig[:4000] = 0.001 * np.random.RandomState(1).randn(4000)  # unvoiced head
    calls = dict(native.f0_calls)
    a = native.estimate_f0(sig)
    assert native.f0_calls["native"] == calls["native"] + 1
    b = pitch.estimate_f0(sig)
    np.testing.assert_array_equal(b, jax_pitch.estimate_f0(sig))   # the numpy copy
    assert len(a) == len(b)
    assert np.mean((a > 0) == (b > 0)) > 0.98
    both = (a > 0) & (b > 0)
    assert both.any()
    np.testing.assert_allclose(a[both], b[both], rtol=1e-6)


def test_frame_energy_matches_jax():
    from toucan_tpu.data.extraction import compute_frame_energy as jax_energy

    wave = reference_wave(1)
    np.testing.assert_allclose(extraction.compute_frame_energy(wave, device="cpu"),
                               jax_energy(wave), rtol=1e-5)


def test_audio_to_wave_tensor():
    wave = reference_wave(2) * 0.1
    ap = AudioPreprocessor(input_sr=SR, output_sr=SR)
    np.testing.assert_array_equal(ap.audio_to_wave_tensor(wave, normalize=False), wave)
    assert np.abs(ap.audio_to_wave_tensor(wave)).max() == pytest.approx(1.0)


def test_cloned_synthesis_matches_jax(pair, prosody):
    """The cloned durations, pitch and energy through both interfaces on
    the same glow noise."""
    jax_iface, _, port, _ = pair
    dur, pit, ene = prosody["MAS"][1][:3]
    z = (0.8 * np.random.RandomState(5).randn(int(dur.sum()) + 66, 80)).astype(np.float32)
    kw = dict(durations=dur, pitch=pit, energy=ene, input_is_phones=True, glow_noise=z,
              return_duration_pitch_energy=True)
    want, got = jax_iface(IPA, **kw), port(IPA, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], dur)
    assert got[0].shape == want[0].shape and len(got[0]) == int(dur.sum()) // 2 * 2 * 384
    np.testing.assert_allclose(got[0], want[0], atol=TOL_WAVE)


def test_clone_utterance_puts_the_silence_back(pair, tmp_path):
    """``clone_utterance`` is the override synthesis between the trimmed
    silences at 24 kHz (x 1.5), through the interface's buckets."""
    port, port_cl = pair[2], pair[3]
    ref = reference_wave(0)
    dur, pit, ene, start, end = port_cl.extract_prosody(IPA, ref, SR, input_is_phones=True)
    port.generator.manual_seed(7)
    path = tmp_path / "clone.wav"
    out = port_cl.clone_utterance(ref, IPA, sr=SR, input_is_phones=True,
                                  filename_of_result=str(path))
    port.generator.manual_seed(7)
    wave = port(IPA, durations=dur, pitch=pit, energy=ene, input_is_phones=True)
    assert start > 0 and end > 0 and path.stat().st_size > 44
    np.testing.assert_array_equal(out, np.concatenate([np.zeros(int(start * 1.5)), wave,
                                                       np.zeros(int(end * 1.5))]))
    key = (1, 32, -(-(int(dur.sum()) + 2) // 64) * 64, True, True, True)
    assert key in port._e2e_cache


def test_angel_mode_averages_voices_and_restores_the_speaker(pair, monkeypatch):
    """Each voice's GST embedding over the same cloned prosody, the waves
    averaged, the speaker restored after."""
    port, port_cl = pair[2], pair[3]
    monkeypatch.setattr(port, "gst", seeded_gst())
    text, ref, voices = "This is a test.", reference_wave(0), [reference_wave(1), reference_wave(2)]
    prev = port.default_utterance_embedding.copy()
    port.generator.manual_seed(8)
    out = port_cl.biblical_accurate_angel_mode(ref, text, voices, sr=SR)
    np.testing.assert_array_equal(port.default_utterance_embedding, prev)
    dur, pit, ene, start, end = port_cl.extract_prosody(text, ref, SR)
    port.generator.manual_seed(8)
    waves = []
    for voice in voices:
        port.set_utterance_embedding(wave=voice, sr=SR)
        waves.append(port(text, durations=dur, pitch=pit, energy=ene))
    port.set_utterance_embedding(embedding=prev)
    assert not np.array_equal(*waves)
    np.testing.assert_array_equal(out, np.concatenate([np.zeros(int(start * 1.5)),
                                                       (waves[0] + waves[1]) / 2,
                                                       np.zeros(int(end * 1.5))]))


def test_checkpoint_round_trip(pair, tmp_path):
    """The port's aligner state dict converts back to the JAX variables
    exactly, and ``load_aligner`` reads it from a reference-format file."""
    aligner = pair[3].aligner
    sd = aligner.state_dict()
    back = convert_aligner({k: v.numpy() for k, v in sd.items()})
    want = pair[1].aligner_variables
    leaves = lambda t: jax.tree_util.tree_leaves_with_path(t)
    assert [p for p, _ in leaves(back)] == [p for p, _ in leaves(want)]
    for (_, a), (_, b) in zip(leaves(back), leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    path = tmp_path / "aligner.pt"
    torch.save({"asr_model": sd, "optimizer": {}}, path)
    loaded = load_aligner(str(path))
    assert loaded.keys() == sd.keys() and all(torch.equal(loaded[k], v) for k, v in sd.items())
    assert Aligner.for_state_dict(loaded).rnn.hidden_size == WIDTHS["lstm_dim"]
