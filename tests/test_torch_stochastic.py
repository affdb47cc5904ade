"""The port's StochasticToucanTTS, spline flows and EmbeddingVAE against the
JAX package's, on the CPU.

Seeded variables in the JAX layout (``seeded_variables``: the flows'
zero-initialised ``proj`` convs and affines get random values, so every
spline is live) go to the port through ``weights.stochastic_toucan_tts_from_jax``
and ``weights.embedding_vae_from_jax``; the JAX package's normal draws are
injected as the port's noise tensors.  Tolerances: the spline in both
directions 1e-5 (the log-det also within 1e-5 of its size, a log of a
product of slopes); each flow's NLL rtol 1e-5 and its samples 1e-5; ``infer``'s
durations exact, mel, pitch and energy 3e-4 (``tests/test_toucan_parity.py``'s
bar); ``forward``'s losses rtol 1e-5; the VAE 1e-5.  The port's state dict
run back through ``compat/torch_stochastic.py`` gives the variables exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toucan_tpu.compat.torch_stochastic import convert_stochastic_toucan_tts
from toucan_tpu.models.embedding_vae import EmbeddingVAE as JaxVAE
from toucan_tpu.models.stochastic_toucan_tts import StochasticToucanTTS as JaxStochastic
from toucan_tpu.nn.stochastic_flows import \
    unconstrained_rational_quadratic_spline as jax_spline
from toucan_tpu_torch.models.embedding_vae import EmbeddingVAE
from toucan_tpu_torch.models.stochastic_toucan_tts import StochasticToucanTTS
from toucan_tpu_torch.nn.stochastic_flows import unconstrained_rational_quadratic_spline
from toucan_tpu_torch.weights import embedding_vae_from_jax, stochastic_toucan_tts_from_jax

from test_torch_modules import _flatten, seeded_variables
from test_torch_train import PORT_CFG, batch_args, port_batch
from test_train_dist import TINY as JAX_TINY, tiny_batch

torch.set_num_threads(2)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_matches_jax(inverse):
    rng = np.random.RandomState(0)
    shape = (3, 40)
    inputs = (rng.randn(*shape) * 3).astype(np.float32)      # some past the tails at +-5
    inputs[0, :3] = (-5.0, 5.0, 4.9999)
    widths, heights = rng.randn(2, *shape, 10).astype(np.float32)
    derivs = rng.randn(*shape, 9).astype(np.float32)
    want = jax_spline(*(jnp.asarray(a) for a in (inputs, widths, heights, derivs)),
                      inverse=inverse)
    got = unconstrained_rational_quadratic_spline(*(_t(a) for a in (inputs, widths, heights,
                                                                    derivs)), inverse=inverse)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    # the log-det is a log of a product of slopes: its rounding grows with it
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def model_pair():
    model = JaxStochastic(JAX_TINY)
    b = tiny_batch(b=2)
    variables = seeded_variables(model, np.random.RandomState(1),
                                 *[jnp.asarray(a) for a in batch_args(b)],
                                 utterance_embedding=jnp.zeros((2, 64)),
                                 lang_ids=jnp.zeros((2, 1), jnp.int32),
                                 flow_rng=jax.random.PRNGKey(0))
    port = StochasticToucanTTS(PORT_CFG)
    port.load_state_dict(stochastic_toucan_tts_from_jax(variables))
    return model, variables, port.eval()


def test_weights_round_trip_stochastic(model_pair):
    _, variables, port = model_pair
    back = convert_stochastic_toucan_tts({k: v.numpy() for k, v in port.state_dict().items()},
                                         enc_layers=JAX_TINY.enc_layers,
                                         dec_layers=JAX_TINY.dec_layers,
                                         glow_blocks=JAX_TINY.glow_blocks)
    want, got = _flatten(variables), _flatten(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("flow", ["pitch_flow", "energy_flow", "duration_flow"])
def test_flow_nll_and_sample_with_injected_noise(model_pair, flow):
    model, variables, port = model_pair
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 32).astype(np.float32)
    w = np.abs(rng.randn(2, 9, 1)).astype(np.float32) + 0.5
    g = rng.randn(2, 1, 64).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([[9], [6]]))[..., None].astype(np.float32)
    key = jax.random.PRNGKey(3)

    def run(m, x, mask, w, g):
        f = getattr(m, flow)
        return f.nll(x, mask, w, g=g, rng=key), f.sample(x, mask, g=g, rng=key)

    want_nll, want_sample = model.apply(variables, x, mask, w, g, method=run)
    noise = np.asarray(jax.random.normal(key, (2, 9, 2)))
    f = getattr(port, flow)
    with torch.no_grad():
        nll = f.nll(_t(x), _t(mask), _t(w), g=_t(g), noise=_t(noise))
        sample = f.sample(_t(x), _t(mask), g=_t(g), noise=_t(noise))
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), rtol=1e-5)
    np.testing.assert_allclose(sample.numpy(), np.asarray(want_sample), atol=1e-5)


def _flow_noise(key, shape):
    return tuple(_t(jax.random.normal(k, shape)) for k in jax.random.split(key, 3))


def test_infer_matches_jax(model_pair):
    model, variables, port = model_pair
    rng = np.random.RandomState(4)
    text = (rng.rand(2, 12, 62) > 0.5).astype(np.float32)
    lens = np.array([12, 9], np.int32)
    utt = rng.randn(2, 64).astype(np.float32)
    lang = np.array([[3], [41]], np.int32)
    glow_noise = (0.8 * rng.randn(2, 96, 80)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda v, *a: model.apply(v, *a, 96, utterance_embedding=utt, lang_ids=lang,
                                             glow_noise=glow_noise, flow_rng=key,
                                             method=JaxStochastic.infer))(variables, text, lens)
    got = port.infer(_t(text), _t(lens, torch.long), 96, utterance_embedding=_t(utt),
                     lang_ids=_t(lang, torch.long), glow_noise=_t(glow_noise),
                     flow_noise=_flow_noise(key, (2, 12, 2)))
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[2], want[2])            # durations
    np.testing.assert_array_equal(got[5], want[5])            # mel lengths
    assert want[2].max() > 1                                   # not the all-ones fallback
    for i in (0, 1, 3, 4):                                    # before, after, pitch, energy
        np.testing.assert_allclose(got[i], want[i], atol=3e-4)


@pytest.fixture(scope="module")
def forward_case(model_pair):
    """JAX's training forward, once (with the glow; its other outputs are
    those of a run without it)."""
    model, variables, _ = model_pair
    batch = tiny_batch(b=3, seed=6)
    batch["gold_pitch"][0, :2] = 0.0      # unvoiced phones leave the pitch flow's mask
    utt = np.random.RandomState(7).randn(3, 64).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want, _ = jax.jit(lambda v, b: model.apply(
        v, *batch_args(b), utterance_embedding=utt, lang_ids=b["lang_ids"], train=True,
        flow_rng=key, mutable=["batch_stats"]))(variables, batch)
    return batch, utt, key, want


@pytest.mark.parametrize("run_glow", [True, False])
def test_forward_losses_match_jax(model_pair, forward_case, run_glow):
    _, _, port = model_pair
    batch, utt, key, want = forward_case
    pb = port_batch(batch)
    port.train()
    try:
        got = port(*batch_args(pb), utterance_embedding=_t(utt), lang_ids=pb["lang_ids"],
                   run_glow=run_glow, deterministic=True,
                   flow_noise=_flow_noise(key, pb["text"].shape[:2] + (2,)))
    finally:
        port.eval()
    for i in (0, 1):
        np.testing.assert_allclose(got[i].detach().numpy(), np.asarray(want[i]), atol=3e-4)
    for i in (2, 3, 4) + ((5,) if run_glow else ()):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=1e-5)
    assert (got[5] is None) == (not run_glow)
    sum(v for v in got[2:] if v is not None).backward()
    assert all(p.grad is not None for n, p in port.named_parameters()
               if n.startswith(("pitch_flow", "duration_flow")) and not n.endswith(".cond.weight"))


@pytest.fixture(scope="module")
def vae_pair():
    model = JaxVAE()
    variables = seeded_variables(model, np.random.RandomState(9), jnp.zeros((2, 64)),
                                 jax.random.PRNGKey(0))
    port = EmbeddingVAE()
    port.load_state_dict(embedding_vae_from_jax(variables))
    return model, variables, port


def test_embedding_vae_matches_jax(vae_pair):
    model, variables, port = vae_pair
    target = np.random.RandomState(10).randn(4, 64).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = model.apply(variables, jnp.asarray(target), rng=key)
    noise = jax.random.normal(key, (4, 16))
    with torch.no_grad():
        got = port(_t(target), noise=_t(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    want_sample = model.apply(variables, rng=key)
    with torch.no_grad():
        got_sample = port(noise=_t(jax.random.normal(key, (1, 16))))
    np.testing.assert_allclose(got_sample.numpy(), np.asarray(want_sample), atol=1e-5)


def test_embedding_vae_weights_round_trip(vae_pair):
    """The JAX package has no converter for the VAE: the port's state dict,
    run back through the inverse names and layout, gives the variables."""
    _, variables, port = vae_pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = {}
    for ours, theirs in (("encoder", "enc_"), ("mean", "mean_"), ("log_var", "var_"),
                         ("decoder", "dec_")):
        for i in range(len(getattr(port, ours))):
            back[f"{theirs}{i}"] = {"kernel": sd[f"{ours}.{i}.weight"].T,
                                    "bias": sd[f"{ours}.{i}.bias"]}
    want, got = _flatten(variables["params"]), _flatten(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
