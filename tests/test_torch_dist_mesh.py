"""The port's mesh layer without process groups, on the CPU: the
tensor-parallel rules against JAX's, the sharded state dicts, the set-up's
environment, a state put on a mesh, and sharded checkpoints in one process.

- every JAX parameter path that ``toucan_tpu/dist/mesh.py``'s rules shard
  maps, through ``weights.py``'s converter, to a port key sharded on the
  matching dim (flax (k, in, out) -> torch (out, in, k)), and no other key
  is sharded: checked on a tiny ToucanTTS and a HiFiGAN by giving each JAX
  leaf its own constant;
- ``shard_state_dict`` then ``gather_state_dicts`` then the JAX package's
  converters give the JAX variables exactly;
- a JAX ``TrainState`` and a JAX vocoder train state with live moments,
  carried over by ``weights.py`` and put on a stand-in (1, 2) mesh by
  ``shard_train_state`` / ``shard_vocoder_train_state``: each sharded
  weight keeps its slice, its moments the same slice of JAX's;
- global batches split by data rank (``make_global_batch`` and the
  prefetcher's mesh branch), a rank's own sample taken whole;
- ``make_mesh``'s assertion, ``initialize_distributed``'s resolution order
  and its refusal of an unnamed backend;
- a sharded checkpoint in one process: save, latest, restore, keep-5, SWA
  and FileNotFoundError;
- the scaling harness on two virtual ranks (``--virtual 2``), and its
  refusal to report a mesh whose ranks it did not start.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toucan_tpu.compat.torch_toucan import convert_toucan_tts
from toucan_tpu.compat.torch_vocoder import convert_hifigan
from toucan_tpu.dist.mesh import _spec_for
from toucan_tpu.models.toucan_tts import ToucanTTS as JaxToucanTTS
from toucan_tpu.models.toucan_tts import ToucanTTSConfig as JaxConfig
from toucan_tpu.models.vocoders.hifigan import HiFiGANGenerator as JaxHiFiGAN
from toucan_tpu_torch.dist import mesh as port_mesh
from toucan_tpu_torch.dist.mesh import make_mesh, param_sharding_rules, resolve_environment
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.train import sharded_checkpointing as sc
from toucan_tpu_torch.train import toucan_train as tt
from toucan_tpu_torch.train import vocoder_train as vt
from toucan_tpu_torch.dist import scaling_bench
from toucan_tpu_torch.models.vocoders.discriminators import AvocodoJointDiscriminator
from toucan_tpu_torch.weights import (gather_state_dicts, hifigan_from_jax, shard_state_dict,
                                      toucan_tts_from_jax, train_state_from_jax,
                                      vocoder_train_state_from_jax)

from toucan_tpu.models.discriminator import SpectrogramDiscriminator as JaxDisc

from test_torch_discriminators import jax_start_vector
from test_torch_gst import seeded_gst
from test_torch_modules import TINY, _flatten, seeded_variables
from test_torch_train import TINY as TRAIN_TINY, batch_args
from test_torch_vocoder_train import SCALE, SEGMENT, TINY_HIFIGAN, tiny_critic
from test_train_dist import TINY as JAX_TRAIN_TINY, tiny_batch


def _jax_tts():
    variables = seeded_variables(JaxToucanTTS(JaxConfig(**TINY)), np.random.RandomState(0),
                                 jnp.zeros((1, 8, 62)), jnp.array([8]), 32,
                                 utterance_embedding=jnp.zeros((1, 64)),
                                 lang_ids=jnp.zeros((1, 1), jnp.int32),
                                 method=JaxToucanTTS.infer)
    back = lambda sd: convert_toucan_tts(  # noqa: E731
        sd, **{k: TINY[k] for k in ("enc_layers", "dec_layers", "duration_layers",
                                    "pitch_layers", "energy_layers", "glow_blocks")})
    return variables, toucan_tts_from_jax, back


def _jax_hifigan():
    variables = seeded_variables(JaxHiFiGAN(channels=64), np.random.RandomState(1),
                                 jnp.zeros((1, 16, 80)), return_intermediates=True)
    return variables, hifigan_from_jax, convert_hifigan


MODELS = {"toucan_tts": _jax_tts, "hifigan": _jax_hifigan}


def _marked(tree, counter):
    if isinstance(tree, dict):
        return {k: _marked(v, counter) for k, v in tree.items()}
    counter.append(None)
    return np.full(np.shape(tree), float(len(counter)), np.float32)


@pytest.mark.parametrize("model", MODELS)
def test_rules_shard_what_jax_shards_on_the_matching_dim(model):
    variables, to_port, _ = MODELS[model]()
    marked = {"params": _marked(variables["params"], [])}
    for k in variables:
        if k != "params":
            marked[k] = variables[k]
    paths = {float(v.flat[0]): p for p, v in _flatten(marked["params"]).items() if v.size}
    sd = to_port(marked)
    want = {}
    for key, t in sd.items():
        values = torch.unique(t) if t.is_floating_point() else None
        if values is None or len(values) != 1 or float(values[0]) not in paths:
            continue
        spec = _spec_for(paths[float(values[0])])
        axis = [i for i, a in enumerate(spec) if a == "model"]
        if axis:  # flax (k, in, out) axis a is the port's (out, in, k) axis 2 - a
            want[key] = 2 - axis[0]
    assert want, "no rule matched"
    assert param_sharding_rules(sd) == want


@pytest.mark.parametrize("model", MODELS)
def test_sharded_state_dicts_gather_back_to_the_jax_variables(model):
    variables, to_port, back = MODELS[model]()
    sd = to_port(variables)
    dims = param_sharding_rules(sd)
    shards = [shard_state_dict(sd, r, 2) for r in range(2)]
    for k, d in dims.items():
        assert shards[0][k].shape[d] * 2 == sd[k].shape[d]
        assert not torch.equal(shards[0][k], shards[1][k])
    got = _flatten(back({k: v.numpy() for k, v in gather_state_dicts(shards).items()}))
    want = _flatten(variables)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


class StandInMesh:
    """What sharding a state reads of a (1, n) mesh, on rank ``rank``."""

    def __init__(self, rank, n=2):
        self.rank, self.n = rank, n

    def size(self, dim):
        return (1, self.n)[dim]

    def get_local_rank(self, dim):
        return self.rank if dim == "model" else 0

    def get_group(self, dim):
        return None


@functools.lru_cache(maxsize=None)
def _jax_trees():
    """Seeded JAX-layout trees of the tiny ToucanTTS and the critic: the
    variables, then two more as Adam's ``mu`` and ``nu`` (no JAX compile)."""
    tts = [seeded_variables(JaxToucanTTS(JAX_TRAIN_TINY), np.random.RandomState(s),
                            *[jnp.asarray(a) for a in batch_args(tiny_batch(b=2))],
                            utterance_embedding=jnp.zeros((2, 64)),
                            lang_ids=jnp.zeros((2, 1), jnp.int32)) for s in (0, 1, 2)]
    disc = [seeded_variables(JaxDisc(), np.random.RandomState(s), jnp.zeros((2, 100, 80, 1)))
            for s in (9, 10, 11)]
    return tts, disc


def _jax_tts_state():
    """A port ``TrainState`` carried from a JAX-layout one with live Adam
    moments, and the JAX moments in the port's layout."""
    tts, disc = _jax_trees()
    jax_vars = tts[0]
    mu, nu = ({"tts": tts[i]["params"], "disc": disc[i]["params"]} for i in (1, 2))
    state = tt.create_train_state(ToucanTTSConfig(**TRAIN_TINY), seeded_gst().state_dict(),
                                  use_discriminator=True, device="cpu")
    train_state_from_jax(state, {"tts": jax_vars["params"], "disc": disc[0]["params"]},
                         jax_vars["batch_stats"], jax_vars["buffers"], mu, nu, count=3, step=3)
    convert = lambda t: toucan_tts_from_jax(  # noqa: E731
        {"params": t["tts"], "batch_stats": jax_vars["batch_stats"], "buffers": jax_vars["buffers"]})
    return state, state.model, state.optimizer, convert(mu), convert(nu)


@functools.lru_cache(maxsize=None)
def _jax_vocoder_trees():
    jax_gen = JaxHiFiGAN(resblock_dilations=((1, 3),), **TINY_HIFIGAN)
    g = [seeded_variables(jax_gen, np.random.RandomState(s), jnp.zeros((1, 8, 80)),
                          return_intermediates=True)["params"] for s in (0, 1, 2)]
    return g, tiny_critic(np.random.RandomState(3))[1]["params"]


def _jax_vocoder_state():
    """A port ``VocoderTrainState`` carried from JAX-layout trees with live
    RAdam moments, and the generator's JAX moments."""
    g, d = _jax_vocoder_trees()
    state = vt.create_vocoder_train_state(
        HiFiGANGenerator(resblock_dilations=(1, 3), **TINY_HIFIGAN),
        AvocodoJointDiscriminator(channel_scale=SCALE, segment=SEGMENT), device="cpu")
    vocoder_train_state_from_jax(state, g[0], d, g[1], g[2], d, d, 2, 2, 2,
                                 start_vector=jax_start_vector)
    convert = lambda t: hifigan_from_jax({"params": t})  # noqa: E731
    return state, state.generator, state.g_optimizer, convert(g[1]), convert(g[2])


@pytest.mark.parametrize("kind", ["acoustic", "vocoder"])
def test_a_jax_state_loads_onto_the_mesh_with_moments_on_their_shards(kind):
    """A JAX train state carried over by ``weights.py``, then put on a (1, 2)
    mesh: each sharded weight keeps its slice, and its Adam moments the
    same slice of JAX's ``mu`` and ``nu`` (``shard_state_dict`` of them)."""
    make, shard, n_stacks = {
        "acoustic": (_jax_tts_state, port_mesh.shard_train_state, 3),
        "vocoder": (_jax_vocoder_state, port_mesh.shard_vocoder_train_state, 1)}[kind]
    state, module, opt, mu, nu = make()
    full = {n: p.detach().clone() for n, p in module.named_parameters()}
    dims = param_sharding_rules(full, n_stacks)
    assert dims
    for rank in range(2):
        state, module, opt, _, _ = make()
        shard(state, StandInMesh(rank))
        want = shard_state_dict(full, rank, 2, n_stacks)
        moments = {k: shard_state_dict({n: m[n].reshape(full[n].shape) for n in full}, rank, 2,
                                       n_stacks) for k, m in (("exp_avg", mu), ("exp_avg_sq", nu))}
        params = dict(module.named_parameters())
        assert params.keys() == full.keys()
        assert {id(p) for g in opt.param_groups for p in g["params"]} >= \
            {id(p) for p in params.values()}
        for n, p in params.items():
            assert torch.equal(p.detach(), want[n]), n
            assert (p.shape != full[n].shape) == (n in dims), n
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][k], moments[k][n]), (n, k)


def test_scaling_harness_on_two_virtual_ranks():
    """``main(["--virtual", "2"])``: two gloo CPU ranks, their first step's
    losses against one process on the global batch, finite rates."""
    out = scaling_bench.main(["--virtual", "2"])
    assert out["mesh"] == "2x1" and out["card"] == "cpu"
    assert "total_loss" in out["checked_against_one_process"]
    for k in ("utterances_per_second", "mel_frames_per_second",
              "per_device_utterances_per_second"):
        assert np.isfinite(out[k]) and out[k] > 0, k


@pytest.mark.parametrize("argv", [["--n_model", "2"], ["--n_data", "2"]])
def test_scaling_harness_claims_no_mesh_it_did_not_run(argv):
    """A mesh of two devices needs two ranks: with fewer cards ``main``
    refuses rather than report one process's rates as the mesh's, and so
    does ``measure`` without the rank's mesh."""
    with pytest.raises(ValueError, match="2 cards"):
        scaling_bench.main(argv)
    with pytest.raises(ValueError, match="one rank per device"):
        scaling_bench.measure(n_data=2, n_model=1, device="cpu")


class DataMesh(StandInMesh):
    """What splitting a batch reads of an (n, 1) mesh, on data rank ``rank``."""

    def size(self, dim):
        return (self.n, 1)[dim]

    def get_local_rank(self, dim):
        return self.rank if dim == "data" else 0


def test_global_batches_split_by_data_rank_in_the_prefetcher():
    from toucan_tpu_torch.data.prefetch import DevicePrefetcher

    batches = [{"x": np.arange(8).reshape(4, 2) + 10 * i, "lang_ids": np.arange(4)[:, None]}
               for i in range(3)]
    for rank in range(2):
        mesh = DataMesh(rank)
        got = list(DevicePrefetcher(iter(batches), "cpu", mesh=mesh))
        assert len(got) == 3
        for g, b in zip(got, batches):
            assert torch.equal(g["x"], torch.from_numpy(b["x"][2 * rank:2 * rank + 2]))
            assert g["lang_ids"].dtype == torch.int64
            assert torch.equal(port_mesh.make_global_batch(b, mesh, "cpu")["x"], g["x"])
        own = port_mesh.make_global_batch(batches[0], mesh, "cpu", local=True)
        assert torch.equal(own["x"], torch.from_numpy(batches[0]["x"]))
    with pytest.raises(AssertionError, match="must divide over 3 data ranks"):
        port_mesh.make_global_batch(batches[0], DataMesh(0, n=3), "cpu")


def test_make_mesh_asserts_the_world_size():
    with pytest.raises(AssertionError, match="3x2 mesh cannot use 4 devices"):
        make_mesh(3, 2, world_size=4)


def test_initialize_distributed_resolution_order(monkeypatch):
    for k in ("TOUCAN_COORDINATOR", "TOUCAN_NUM_PROCESSES", "TOUCAN_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator_address, num_processes, process_id"):
        resolve_environment()
    monkeypatch.setenv("MASTER_ADDR", "h0")
    monkeypatch.setenv("MASTER_PORT", "7")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert resolve_environment() == ("h0:7", 4, 3)
    monkeypatch.setenv("TOUCAN_COORDINATOR", "h1:9")
    monkeypatch.setenv("TOUCAN_NUM_PROCESSES", "2")
    monkeypatch.setenv("TOUCAN_PROCESS_ID", "1")
    assert resolve_environment() == ("h1:9", 2, 1)
    assert resolve_environment("h2:5", 8, 0) == ("h2:5", 8, 0)
    with pytest.raises(ValueError, match="backend"):
        port_mesh.initialize_distributed(backend="mpi")


def test_sharded_checkpoints_in_one_process(tmp_path):
    with pytest.raises(FileNotFoundError):
        sc.restore_sharded_checkpoint(str(tmp_path / "none"), None)
    assert sc.list_sharded_steps(str(tmp_path / "none")) == []
    states = []
    for step in range(1, 8):
        state = tt.create_train_state(ToucanTTSConfig(**TRAIN_TINY), seeded_gst().state_dict(),
                                      device="cpu", seed=step)
        state.step = step
        sc.save_sharded_checkpoint(str(tmp_path), state, step)
        states.append(snapshot_single(state))
    assert sc.list_sharded_steps(str(tmp_path)) == [3, 4, 5, 6, 7]
    assert sc.latest_sharded_step(str(tmp_path)) == 7
    target = tt.create_train_state(ToucanTTSConfig(**TRAIN_TINY), seeded_gst().state_dict(),
                                   device="cpu", seed=99)
    got = snapshot_single(sc.restore_sharded_checkpoint(str(tmp_path), target, step=5))
    for k, v in states[4].items():
        assert torch.equal(got[k], v) if torch.is_tensor(v) else got[k] == v, k
    avg = snapshot_single(sc.swa_average(str(tmp_path), target, n=2))
    params = {f"model.{n}" for n, _ in target.model.named_parameters(remove_duplicate=False)}
    for k, v in states[6].items():
        if k in params:  # buffers (statistics, the glow's permutations) are the newest's
            assert torch.equal(avg[k], states[5][k] / 2 + v / 2), k
        else:
            assert torch.equal(avg[k], v) if torch.is_tensor(v) else avg[k] == v, k


def snapshot_single(state):
    out = {"step": state.step}
    for n, t in state.model.state_dict().items():
        out[f"model.{n}"] = t.clone()
    return out
