"""The port's data- and tensor-parallel train steps against its single-process
step on the global batch and against JAX's single-device step, on the CPU.

The ranks are gloo processes (``tests/torch_dist_worker.py``, torch and the
port only), started once per mesh for the whole module, each with its own
clock.  The JAX side runs here.  A tiny ToucanTTS with seeded variables
(``tests/test_torch_modules.py::seeded_variables``) and the critic take one
step on a ragged global batch of four utterances, whose two halves have
very different lengths: every rank pads to the global batch's shapes.

- meshes (2, 1), (1, 2) and (2, 2): parameters, gradients, Adam's moments,
  BatchNorm statistics and metrics within 1e-6 of each tensor's peak of the
  port's single-process step, both in float64 (in float32 the two orders of
  summation part by about 1.4e-6 of a gradient's peak); the gradients that
  are 0 in exact arithmetic (``ZERO_GRADIENTS``) below 1e-12 on both sides;
- in float32, the moments within 1e-4 of their peak of JAX's jitted step
  (the bar of ``tests/test_torch_train.py``), the metrics within rtol 1e-5;
- the DDP trap: the same batch with local losses, local BatchNorm moments,
  each rank padded to its own rows and the gradients averaged misses the
  global step by far more than that.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import toucan_tpu.models.toucan_tts as jax_toucan_tts_module
from toucan_tpu.models.discriminator import SpectrogramDiscriminator as JaxDisc
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.nn.postnet import PostNet as JaxPostNet
from toucan_tpu.train.toucan_train import make_train_step as jax_make_step
from toucan_tpu.compat.torch_gst import convert_style_embedding
from toucan_tpu_torch.data.batching import _ceil_to, pad_batch
from toucan_tpu_torch.train.toucan_train import ZERO_GRADIENTS
from toucan_tpu_torch.weights import spectrogram_discriminator_from_jax, toucan_tts_from_jax

import torch_dist_worker as worker
from test_torch_gst import seeded_gst
from test_torch_modules import seeded_variables
from test_torch_train import (LR, MAX_STEPS, NO_DROPOUT, TINY, WARMUP, _jax_state,
                              batch_args)
from test_train_dist import TINY as JAX_TINY, tiny_batch
from test_torch_train import tiny_dataset
from test_torch_vocoder_train import write_ljspeech

MESHES = [(2, 1), (1, 2), (2, 2)]


def ragged_points(seed=3):
    """Four utterances: two short (rank 0 of a 2-way 'data' split), two
    long (rank 1), so a rank padded to its own rows differs from the
    global padding."""
    rng = np.random.RandomState(seed)
    points = []
    for t, lo, hi in ((5, 1, 3), (8, 1, 3), (28, 2, 5), (21, 3, 5)):
        durations = rng.randint(lo, hi, size=t)
        points.append(dict(text=(rng.rand(t, 62) > 0.5).astype(np.float32),
                           mel=rng.randn(int(durations.sum()), 80).astype(np.float32),
                           durations=durations, pitch=rng.randn(t, 1).astype(np.float32),
                           energy=rng.randn(t, 1).astype(np.float32), lang_id=7 + t))
    return points


def aligner_points():
    from toucan_tpu_torch.frontend.text import TextFrontend

    text = TextFrontend(language="en").string_to_features("~hɛlˈoʊ wˈɜːld~#",
                                                          input_phonemes=True)
    rng = np.random.RandomState(2)
    return [dict(text=text, mel=rng.randn(frames, 80).astype(np.float32))
            for frames in (30, 40, 22)]


def global_pad(points):
    """JAX's dataset-wide padding (``toucan_tpu/train/loop.py:101-103``)."""
    return (_ceil_to(max(len(p["text"]) for p in points), 32),
            _ceil_to(max(len(p["mel"]) for p in points), 64))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    b2 = tiny_batch(b=2)
    variables = seeded_variables(JaxToucanTTS(JAX_TINY), np.random.RandomState(0),
                                 *[jnp.asarray(a) for a in batch_args(b2)],
                                 utterance_embedding=jnp.zeros((2, 64)),
                                 lang_ids=jnp.zeros((2, 1), jnp.int32))
    disc_vars = seeded_variables(JaxDisc(), np.random.RandomState(9), jnp.zeros((2, 100, 80, 1)))
    gst = seeded_gst()
    points = ragged_points()
    batch = pad_batch(points, pad_to=global_pad(points))
    rng = jax.random.PRNGKey(1)
    _, win_rng = jax.random.split(jax.random.fold_in(rng, 0))
    starts = np.asarray(jax.random.randint(win_rng, (4,), 0,
                                           jnp.maximum(jnp.asarray(batch["speech_lengths"]), 1)))
    inp = dict(config={**TINY, **NO_DROPOUT}, dropout_config=TINY,
               opt=dict(lr=LR, warmup_steps=WARMUP, max_steps=MAX_STEPS),
               tts=toucan_tts_from_jax(variables),
               disc=spectrogram_discriminator_from_jax(disc_vars),
               gst=gst.state_dict(), batch=batch, starts=torch.tensor(starts),
               datapoints=np.array(points, dtype=object), ckpt_dir=str(d / "ckpt"),
               loop_dir=str(d / "loop"), dataset=tiny_dataset(8), corpora=str(d / "corpora"),
               aligner_data=aligner_points())
    write_ljspeech(d / "corpora")
    inp_path = str(d / "in.pt")
    torch.save(inp, inp_path)
    outs = {shape: str(d / f"out_{shape[0]}x{shape[1]}.pt") for shape in MESHES}
    jobs = {(2, 1): "acoustic_and_loops", (1, 2): "acoustic_and_checkpoints",
            (2, 2): "acoustic"}
    procs = {shape: worker.start(jobs[shape], *shape, inp_path, outs[shape]) for shape in MESHES}
    try:
        single = worker.acoustic_step(dict(inp, dtype=torch.float64), None)
        mp = pytest.MonkeyPatch()  # the JAX PostNet's dropout, which no config field reaches
        mp.setattr(jax_toucan_tts_module, "PostNet",
                   functools.partial(JaxPostNet, dropout_rate=0.0))
        try:
            cfg = JAX_TINY.__class__(**{**JAX_TINY.__dict__, **NO_DROPOUT})
            gst_vars = convert_style_embedding({k: v.numpy() for k, v in gst.state_dict().items()})
            state0, optimizer = _jax_state(variables, disc_vars, gst_vars)
            step = jax.jit(jax_make_step(cfg, optimizer, run_glow=True, use_discriminator=True))
            state1, metrics = step(state0, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        finally:
            mp.undo()
    finally:
        for shape, ps in procs.items():
            worker.wait(ps)
    adam = state1.opt_state[1][0]
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want_mu = {**{f"tts.{k}": v for k, v in toucan_tts_from_jax(
        {"params": tree(adam.mu["tts"]), "batch_stats": tree(state1.batch_stats),
         "buffers": tree(state1.buffers)}).items()},
        **{f"disc.{k}": v for k, v in spectrogram_discriminator_from_jax(
            {"params": tree(adam.mu["disc"])}).items()}}
    jax_out = dict(mu=want_mu, metrics={k: float(v) for k, v in metrics.items()})
    return single, {shape: torch.load(outs[shape], weights_only=False) for shape in MESHES}, \
        jax_out


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * peak, (what, np.abs(got - want).max(), peak)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_equals_the_single_process_step(runs, shape):
    single, meshes, _ = runs
    got = meshes[shape]["step64"]
    for net in ("tts", "disc"):
        assert got[net].keys() == single[net].keys()
        for name, tensors in single[net].items():
            for what, a, b in zip(("param", "grad", "exp_avg", "exp_avg_sq"),
                                  got[net][name], tensors):
                if what != "param" and name.endswith(ZERO_GRADIENTS):  # 0 but for float noise
                    assert max(a.abs().max(), b.abs().max()) < 1e-12, (name, what)
                    continue
                _close(a, b, 1e-6, f"{net}.{name} {what}")
    for name, buf in single["stats"].items():
        _close(got["stats"][name], buf, 1e-6, name)
    assert got["metrics"].keys() == single["metrics"].keys()
    for k, v in single["metrics"].items():
        _close(got["metrics"][k], v, 1e-6, k)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_matches_jax(runs, shape):
    _, meshes, jax_out = runs
    got = meshes[shape]["step32"]
    for k, v in jax_out["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].item(), v, rtol=1e-5, err_msg=k)
    for net in ("tts", "disc"):
        for name, (_, _, mu, _) in got[net].items():
            if name.endswith(ZERO_GRADIENTS):  # float noise on both sides
                continue
            _close(mu, jax_out["mu"][f"{net}.{name}"], 1e-4, f"{net}.{name}")


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_naive_ddp_mean_misses_the_global_step(runs, shape):
    """The trap the mesh step avoids: this comparison must fail by far."""
    single, meshes, _ = runs
    naive = meshes[shape]["naive"]
    worst = max(np.abs((naive[name] - tensors[1]).numpy()).max()
                / max(np.abs(tensors[1].numpy()).max(), 1e-30)
                for name, tensors in single["tts"].items())
    assert worst > 1e-2, worst


# ------------------------------------------------------- sharded checkpoints

def _same(got, want, what):
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), (what, k)
        else:
            assert got[k] == v, (what, k)


@pytest.mark.parametrize("layout", ["1xn", "nx1"])
def test_sharded_checkpoint_restores_onto_either_layout(runs, layout):
    """Saved by two ranks with the feed-forward convs split over 'model',
    read back onto that layout and onto a replicated one: every parameter,
    moment, statistic, the schedule and the step equal the saved state."""
    ck = runs[1][(1, 2)]["checkpoints"]
    assert ck["steps"] == [1, 2] and ck["latest"] == 2
    _same(ck[f"restored_{layout}"], ck["saved"][1], layout)


def test_sharded_checkpoint_restores_a_given_step_and_keeps_five(runs):
    ck = runs[1][(1, 2)]["checkpoints"]
    _same(ck["restored_first"], ck["saved"][0], "step 1")
    assert ck["kept"] == [2, 3, 4, 5, 6]


def test_sharded_swa_averages_parameters_only(runs):
    """JAX's ``swa_average``: the floating-point parameters are the mean of
    the two newest (oldest first, each over n); the rest is the newest's."""
    ck = runs[1][(1, 2)]["checkpoints"]
    older, newest = ck["saved"]
    params = {k for k in newest if k.startswith(("model.", "disc."))
              and not k.endswith(("exp_avg", "exp_avg_sq", ".step", "running_mean",
                                  "running_var", "num_batches_tracked"))}
    assert params
    for k, v in newest.items():
        got = ck["swa"][k]
        if k in params:
            assert torch.equal(got, older[k] / 2 + v / 2), k
        elif torch.is_tensor(v):
            assert torch.equal(got, v), k
        else:
            assert got == v, k


# ------------------------------------------------------------------- loops

def test_train_loop_and_pipelines_on_the_mesh(runs):
    """``train_loop(mesh=)`` over two data ranks: an epoch of four steps of
    2 + 2 utterances, a sharded checkpoint per epoch, SWA past 3 x
    ``postnet_start_steps``, resume from the highest; the aligner's and the
    vocoder's loops with their sharded steps."""
    lp = runs[1][(2, 1)]["loops"]
    assert lp["steps"] == [4, 8]
    assert lp["saved"] == [4] and lp["saved_after_resume"] == [4, 8]
    seeds = lp["dropout_seeds"]
    assert seeds[1] - seeds[0] == 7919, "each data rank's dropout from seed + 7919 * rank"
    assert len(lp["history"]) == 8
    assert all(np.isfinite(h["total_loss"]) for h in lp["history"])
    assert "glow_loss" in lp["history"][2] and "generator_loss" in lp["history"][0]
    assert lp["aligner_step"] == 2
    assert lp["vocoder"] == (4, [0, 2])


def test_mesh_dropout_keeps_the_replicas_equal(runs):
    """``train_loop`` on a (1, 2) mesh with dropout on, each rank seeded
    apart by its caller first: before each step's replicated gradients are
    made to agree over 'model' they are already equal, and so are the
    losses; the column-split feed-forwards' hidden channels draw from a
    stream per 'model' rank."""
    run = runs[1][(1, 2)]["dropout_loop"]
    assert len(run["apart"]) == 2 and run["apart"] == [0.0, 0.0], run["apart"]
    assert run["params_apart"] == 0.0, "the replicated parameters parted over 'model'"
    losses, seeds = run["losses"], run["seeds"]
    assert torch.equal(losses[0], losses[1]) and torch.isfinite(losses).all()
    assert seeds[0, 0] == seeds[1, 0], "the replicated region's stream"
    assert seeds[0, 1] != seeds[1, 1], "the sharded hidden channels' streams"

