"""The port's GST embedding training against the JAX package's, on the CPU.

The tiny FastSpeech2 of ``tests/test_embedding_train.py`` (``TINY_FS2``,
dropout 0; the JAX PostNet's fixed 0.5, which no config field reaches, set
to 0 by a test-time patch as ``tests/test_torch_train.py`` does) and a GST
with seeded weights and statistics (``test_torch_gst.seeded_gst``) start
both sides from the same variables.  Held against JAX:

- the co-training step (the GST in training mode, one Adam with the noam
  schedule after a clip at 1.0): losses within rtol 1e-5; the updates by
  the rule of ``tests/test_torch_train.py`` (Adam makes them about +-lr:
  within 2 lr everywhere, within 1e-3 lr where |g| > 1e-6 and above 1e-3
  of its tensor's peak), beyond one f32 ulp of the parameter; both nets'
  BatchNorm statistics within 1e-6;
- the token-spread step after it: its loss within rtol 1e-5, the updates
  likewise; it advances Adam's count and moves parameters that carry
  momentum while their gradient is 0;
- the fine-tune step (triplets of batch 8; triplet + 0.1 x Barlow Twins,
  JAX's Adam): metrics within rtol 1e-5, the updates likewise, the
  gradients that are 0 in exact arithmetic (``FINETUNE_ZERO``) below 1e-5
  of the largest (JAX's own reach 5.2e-6) (the seeded GST's 8 embeddings differ by 0.7 % of their
  size: ``diverse_losses._standardize`` keeps the cancellation exact), the
  running statistics untouched;
- ``barlow_twins_loss``, ``triplet_loss``, ``ssim`` and the spread
  regulariser within 1e-6.
"""

import functools
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import toucan_tpu.models.toucan_tts as jax_toucan_tts_module
from toucan_tpu.compat.torch_gst import convert_style_embedding
from toucan_tpu.models.gst import StyleEmbedding as JaxStyleEmbedding
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.nn.postnet import PostNet as JaxPostNet
from toucan_tpu.train import diverse_losses as jax_losses
from toucan_tpu.train.embedding_train import EmbeddingTrainState as JaxEmbeddingState
from toucan_tpu.train.embedding_train import (make_embedding_train_step as jax_cotrain_step,
                                              make_finetune_step as jax_finetune_step,
                                              make_spread_regularization_step as jax_spread_step)
from toucan_tpu.train.schedules import noam_warmup_schedule as jax_noam
from toucan_tpu_torch.models.gst import StyleEmbedding
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, fastspeech2_config
from toucan_tpu_torch.train import diverse_losses
from toucan_tpu_torch.train.embedding_train import (create_embedding_train_state,
                                                    make_embedding_train_step,
                                                    make_finetune_step,
                                                    make_spread_regularization_step)
from toucan_tpu_torch.weights import style_embedding_from_jax, toucan_tts_from_jax

from test_embedding_train import TINY_FS2 as JAX_TINY_FS2
from test_torch_gst import seeded_gst
from test_torch_modules import seeded_variables
from test_train_dist import tiny_batch

torch.set_num_threads(2)

LR, WARMUP = 1e-3, 4
NO_DROPOUT = dict(dropout=0.0, duration_dropout=0.0, pitch_dropout=0.0, energy_dropout=0.0)
FIELDS = ("adim", "aheads", "enc_layers", "enc_units", "dec_layers", "dec_units",
          "duration_layers", "pitch_layers", "energy_layers", "duration_chans", "pitch_chans",
          "energy_chans", "utt_embed_dim", "lang_embs")
PORT_FS2 = fastspeech2_config(**{k: getattr(JAX_TINY_FS2, k) for k in FIELDS}, **NO_DROPOUT)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def cotrain_batch(seed=0):
    b = tiny_batch(b=3, seed=seed)
    b["lang_ids"] = np.random.RandomState(seed).randint(0, 40, size=(3, 1))
    return b


def port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)).long() if k == "lang_ids"
            else torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def triplet_batch(seed=1):
    rng = np.random.RandomState(seed)
    out = {k: rng.randn(8, 30, 80).astype(np.float32) for k in ("anchor", "positive", "negative")}
    out.update({f"{k}_lengths": rng.randint(18, 31, size=8).astype(np.int32)
                for k in ("anchor", "positive", "negative")})
    return out


@pytest.fixture(scope="module")
def run():
    """The JAX side: a co-training step, the spread step after it, and a
    fine-tune step of the seeded GST (the PostNet's dropout patched to 0)."""
    b = cotrain_batch()
    cfg = JAX_TINY_FS2.__class__(**{**JAX_TINY_FS2.__dict__, **NO_DROPOUT})
    tts = JaxToucanTTS(cfg)
    args = [jnp.asarray(b[k]) for k in ("text", "text_lengths", "gold_speech",
                                         "speech_lengths", "gold_durations", "gold_pitch",
                                         "gold_energy")]
    tts_vars = seeded_variables(tts, np.random.RandomState(0), *args,
                                utterance_embedding=jnp.zeros((3, 64)),
                                lang_ids=jnp.zeros((3, 1), jnp.int32), run_glow=False)
    gst = seeded_gst()
    gst_vars = convert_style_embedding({k: v.numpy() for k, v in gst.state_dict().items()})
    params = {"tts": tts_vars["params"], "gst": gst_vars["params"]}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(jax_noam(LR, WARMUP)))
    state0 = JaxEmbeddingState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats={"tts": tts_vars["batch_stats"],
                                            "gst": gst_vars["batch_stats"]},
                               opt_state=opt.init(params))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_toucan_tts_module, "PostNet", functools.partial(JaxPostNet, dropout_rate=0.0))
    try:
        step = jax.jit(jax_cotrain_step(cfg, opt))
        state1, metrics = step(state0, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(1))
        state2, reg_loss = jax_spread_step(opt)(state1)
    finally:
        mp.undo()
    ft_opt = optax.adam(1e-4)
    t = triplet_batch()
    ft_params, _, ft_metrics = jax_finetune_step(ft_opt)(
        gst_vars["params"], gst_vars["batch_stats"], ft_opt.init(gst_vars["params"]),
        jax.tree.map(jnp.asarray, t))
    return dict(tts_vars=tts_vars, gst_vars=gst_vars, states=[state0, state1, state2],
                metrics=_np(metrics), reg_loss=float(reg_loss), batch=b, triplets=t,
                ft_params=_np(ft_params), ft_metrics=_np(ft_metrics))


# the fine-tune's losses do not see a shift common to every embedding (the
# triplet distances and the Barlow standardisation remove it), nor the
# attention's key and value biases (a softmax ignores a shift of a query's
# scores, and its weights sum to 1): these gradients are 0 in exact
# arithmetic, float noise on both sides
FINETUNE_ZERO = ("gst.stl.mha.linear_k.bias", "gst.stl.mha.linear_v.bias",
                 "gst.stl.mha.linear_out.bias")


def port_state(r):
    state = create_embedding_train_state(PORT_FS2, lr=LR, warmup_steps=WARMUP, device="cpu")
    state.model.load_state_dict(toucan_tts_from_jax(r["tts_vars"]))
    state.model.conv_postnet.dropout_rate = 0.0   # as the JAX side's (see ``run``)
    state.gst.load_state_dict(style_embedding_from_jax(r["gst_vars"]))
    return state


def _sds(state):
    return [{k: v.clone() for k, v in m.state_dict().items()} for m in (state.model, state.gst)]


def _jax_sds(state):
    return [toucan_tts_from_jax({"params": _np(state.params["tts"]),
                                 "batch_stats": _np(state.batch_stats["tts"])}),
            style_embedding_from_jax({"params": _np(state.params["gst"]),
                                      "batch_stats": _np(state.batch_stats["gst"])})]


def _adam_updates_match(modules, want, lr, grads=None, zero=()):
    """The Adam rule of ``tests/test_torch_train.py``, beyond one f32 ulp of
    the parameter: within 2 lr everywhere, within 1e-3 lr where the gradient
    is live (``grads``, default each parameter's ``.grad``): above 1e-6 and
    above 1e-3 of its tensor's peak, where its sign is certain;
    the parameters named in ``zero`` (gradient 0 in exact arithmetic) are
    held below 1e-5 of the largest gradient instead (JAX's own come to
    5.2e-6 in the fine-tune); the statistics within 1e-6."""
    def grad(i, name, p):
        return p.grad if grads is None else grads[i][name]

    largest = max(grad(i, n, p).abs().max().item() for i, m in enumerate(modules)
                  for n, p in m.named_parameters())
    for i, (module, w) in enumerate(zip(modules, want)):
        for name, p in module.named_parameters():
            # each side rounds its own parameters
            diff = np.abs(p.detach().numpy() - w[name].numpy()) - np.spacing(
                np.abs(w[name].numpy()))
            assert diff.max() <= 2 * lr, name
            if name in zero:
                assert p.grad.abs().max().item() <= 1e-5 * largest, name
                continue
            g = np.abs(grad(i, name, p).numpy())
            live = g > max(1e-6, 1e-3 * g.max())
            assert not live.any() or diff[live].max() <= 1e-3 * lr, (name, diff[live].max() / lr)
        for name, buf in module.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), w[name].numpy(), atol=1e-6,
                                           err_msg=name)


@pytest.fixture(scope="module")
def port_run(run):
    state = port_state(run)
    before = _sds(state)
    metrics = make_embedding_train_step()(state, port_batch(run["batch"]))
    after_cotrain = _sds(state)
    grads_cotrain = [{n: p.grad.clone() for n, p in m.named_parameters()}
                     for m in (state.model, state.gst)]
    reg_loss = make_spread_regularization_step()(state)
    return dict(state=state, before=before, metrics=metrics, after_cotrain=after_cotrain,
                grads_cotrain=grads_cotrain, reg_loss=reg_loss)


def test_cotrain_step_matches_jax(run, port_run):
    got = port_run["metrics"]
    assert set(got) == set(run["metrics"]) == {"total_loss", "l1_loss"}
    for k, want in run["metrics"].items():
        np.testing.assert_allclose(got[k].item(), float(want), rtol=1e-5, err_msg=k)
    lr = float(jax_noam(LR, WARMUP)(0))
    want = _jax_sds(run["states"][1])
    state = port_state(run)  # the modules as the co-train step left them
    for m, sd in zip((state.model, state.gst), port_run["after_cotrain"]):
        m.load_state_dict(sd)
    _adam_updates_match((state.model, state.gst), want, lr, port_run["grads_cotrain"])


def test_spread_step_matches_jax_and_moves_every_moment(run, port_run):
    state = port_run["state"]
    np.testing.assert_allclose(port_run["reg_loss"].item(), run["reg_loss"], rtol=1e-5)
    assert state.step == 1                       # the spread step is not a train step
    assert state.scheduler.last_epoch == 2       # Adam's count advanced
    assert all(int(state.optimizer.state[p]["step"]) == 2 for p in state.parameters())
    before = port_run["after_cotrain"][0]
    moved = [n for n, p in state.model.named_parameters()
             if p.grad.abs().max() == 0 and not torch.equal(p.detach(), before[n])]
    assert len(moved) > len(list(state.model.parameters())) // 2, moved
    # the updates, live where the co-train step's gradient was (the moments)
    # or the spread's is (the token bank)
    live = [{n: torch.maximum(g.abs(), p.grad.abs()) for (n, g), p in
             zip(grads.items(), m.parameters())}
            for grads, m in zip(port_run["grads_cotrain"], (state.model, state.gst))]
    _adam_updates_match((state.model, state.gst), _jax_sds(run["states"][2]),
                        float(jax_noam(LR, WARMUP)(1)), live)


def test_finetune_step_matches_jax_and_keeps_the_statistics(run):
    gst = StyleEmbedding()
    gst.load_state_dict(style_embedding_from_jax(run["gst_vars"]))
    stats = {k: v.clone() for k, v in gst.state_dict().items() if "running" in k}
    opt = torch.optim.Adam(gst.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    t = {k: torch.from_numpy(v) for k, v in run["triplets"].items()}
    got = make_finetune_step()(gst, opt, t)
    for k, want in run["ft_metrics"].items():
        np.testing.assert_allclose(got[k].item(), float(want), rtol=1e-5, err_msg=k)
    for k, v in stats.items():
        torch.testing.assert_close(gst.state_dict()[k], v, rtol=0, atol=0)
    want = style_embedding_from_jax({"params": run["ft_params"],
                                     "batch_stats": run["gst_vars"]["batch_stats"]})
    _adam_updates_match((gst,), [want], 1e-4, zero=FINETUNE_ZERO)


def test_diverse_losses_and_the_spread_regulariser_match_jax():
    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(8, 16).astype(np.float32) for _ in range(3))
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    np.testing.assert_allclose(diverse_losses.barlow_twins_loss(ta, tb).item(),
                               float(jax_losses.barlow_twins_loss(ja, jb)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(diverse_losses.triplet_loss(ta, tb, tc).item(),
                               float(jax_losses.triplet_loss(ja, jb, jc)), atol=1e-6)
    i1, i2 = rng.rand(2, 2, 24, 24).astype(np.float32)
    np.testing.assert_allclose(diverse_losses.ssim(torch.from_numpy(i1),
                                                   torch.from_numpy(i2)).item(),
                               float(jax_losses.ssim(jnp.asarray(i1), jnp.asarray(i2))),
                               atol=1e-6)
    gst = seeded_gst(3)
    params = convert_style_embedding({k: v.numpy() for k, v in gst.state_dict().items()})
    np.testing.assert_allclose(gst.token_spread_regularizer().item(),
                               float(JaxStyleEmbedding.token_spread_regularizer(
                                   params["params"])), rtol=1e-5)


def test_progress_plot_and_callbacks(tmp_path, capsys):
    from toucan_tpu_torch.frontend.text import TextFrontend
    from toucan_tpu_torch.train.visualization import (console_callback, plot_progress_spec,
                                                      wandb_callback)
    model = ToucanTTS(PORT_FS2).eval()
    paths = plot_progress_spec(model, str(tmp_path), 7, TextFrontend(language="en"),
                               sentence="~hɛlˈoʊ wˈɜːld~#", input_is_phones=True,
                               default_embedding=np.zeros(64, np.float32), lang_id=12,
                               max_frames=128)
    assert [os.path.basename(p) for p in paths] == ["progress_before_7.png",
                                                   "progress_after_7.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    console_callback(7, {"l1_loss": torch.tensor(0.25), "total_loss": 1.5})
    assert capsys.readouterr().out == "[step 7] l1_loss=0.2500  total_loss=1.5000\n"
    wandb_callback(7, {"l1_loss": 0.25})  # wandb is not installed: nothing happens


def test_gst_mode_is_the_train_flag_not_the_module_mode():
    """A GST left in PyTorch's training mode embeds on its running
    statistics unless called with ``train=True``, as JAX's ``train=False``
    default; ``train=True`` updates them, ``update_stats=False`` keeps them."""
    gst = seeded_gst(2)
    specs, lens = torch.randn(3, 40, 80), torch.tensor([40, 33, 27])
    want = gst(specs, lens)
    stats = {k: v.clone() for k, v in gst.state_dict().items() if "running" in k}
    gst.train()
    torch.testing.assert_close(gst(specs, lens), want, rtol=0, atol=0)
    assert not gst(specs, lens).requires_grad
    kept = gst(specs, lens, train=True, update_stats=False)
    assert kept.requires_grad
    assert all(torch.equal(gst.state_dict()[k], v) for k, v in stats.items())
    gst(specs, lens, train=True)
    assert not any(torch.equal(gst.state_dict()[k], v) for k, v in stats.items()
                   if not k.endswith("num_batches_tracked"))
