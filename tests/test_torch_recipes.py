"""The port's recipes, training CLI and script twins, on the CPU.

- ``cli.build_pipeline_dict`` has JAX's ten names; each named TTS recipe
  hands ``_tts_pipeline`` what JAX's hands its own (``meta_pipeline``'s 14
  language groups included), captured by monkeypatching both packages'
  ``_tts_pipeline``; ``cli.main`` maps its flags to the pipeline's keyword
  arguments (``--device`` included), and joins a one-rank gloo group with
  ``--device cpu``.
- ``tt_it``, ``fs_it`` and ``aligner`` end to end on a NancyKrebs layout of
  IPA transcripts (``use_g2p=False``) with tiny models: each writes a
  ``.pt`` that ``load.py`` reads.  ``embedding_pipeline`` refuses a corpus
  that makes no batch of 16 instead of looping.
- ``run.weight_averaging`` against the root ``run_weight_averaging.py`` on
  hand-made checkpoints (the same trees as ``.pt`` and as msgpack), and
  its ``best.pt`` of the ``tt_it`` run read by ``load_toucan_tts``;
  ``run.scorer`` on the run's cache.
"""

import os
import socket
import wave as wave_mod

import numpy as np
import pytest
import torch

import run_weight_averaging as jax_weight_averaging
from toucan_tpu import cli as jax_cli
from toucan_tpu.recipes import pipelines as jax_pipelines
from toucan_tpu_torch import cli, load
from toucan_tpu_torch.data.corpus import load_cache
from toucan_tpu_torch.models.aligner import Aligner
from toucan_tpu_torch.models.gst import StyleEmbedding
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.recipes import pipelines
from toucan_tpu_torch.run import scorer as run_scorer
from toucan_tpu_torch.run import weight_averaging
from toucan_tpu_torch.train.checkpointing import list_checkpoints

from test_torch_interface import TINY

torch.set_num_threads(2)

IPA = ["~ðɪs ɪz ə tˈɛst~#", "~hɛlˈoʊ wˈɜːld~#", "~ə ʃˈɔːt sˈɛntəns~#"]
NAMED = ["nancy", "nancystoch", "meta", "fine_ex", "tt_it"]


def write_nancy(root, texts=IPA, sr=16000):
    """A NancyKrebs layout (``metadata.csv`` + ``wav/``) of tones."""
    corpus = os.path.join(root, "NancyKrebs")
    os.makedirs(os.path.join(corpus, "wav"))
    lines = []
    for i, text in enumerate(texts):
        t = np.arange(int(sr * (1.3 + 0.2 * i))) / sr
        pcm = (0.5 * np.sin(2 * np.pi * (150 + 30 * i) * t) * 32767).astype(np.int16)
        with wave_mod.open(os.path.join(corpus, "wav", f"utt{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes(pcm.tobytes())
        lines.append(f"utt{i}|{text}")
    with open(os.path.join(corpus, "metadata.csv"), "w", encoding="utf8") as f:
        f.write("\n".join(lines))


def test_pipeline_dict_has_jax_s_names():
    got, want = cli.build_pipeline_dict(), jax_cli.build_pipeline_dict()
    assert set(got) == set(want) and len(got) == 10
    assert all(f.__name__ == want[k].__name__ for k, f in got.items())


def _captured(module, monkeypatch, name):
    calls = []
    monkeypatch.setattr(module, "_tts_pipeline",
                        lambda recipes, save_name, **kw: calls.append((recipes, save_name, kw)))
    return calls


@pytest.mark.parametrize("name", NAMED)
def test_named_tts_recipes_hand_over_what_jax_s_do(name, monkeypatch):
    port_calls = _captured(pipelines, monkeypatch, name)
    jax_calls = _captured(jax_pipelines, monkeypatch, name)
    cli.build_pipeline_dict()[name](seed=5)
    jax_cli.build_pipeline_dict()[name](seed=5)
    assert port_calls == jax_calls and len(port_calls) == 1
    if name == "meta":
        groups = port_calls[0][0]
        assert len(groups) == 14 and sum(len(g) for g in groups) == 33


def test_cli_maps_its_flags_to_the_pipeline(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(cli, "build_pipeline_dict",
                        lambda: {"tt_it": lambda **kw: calls.append(kw) or "done"})
    monkeypatch.setenv("TOUCAN_CORPORA_ROOT", "unset")
    out = cli.main(["tt_it", "--device", "cpu", "--corpora_root", str(tmp_path), "--resume",
                    "--model_save_dir", "m", "--n_model", "1"])
    assert out == "done" and os.environ["TOUCAN_CORPORA_ROOT"] == str(tmp_path)
    assert calls == [dict(resume_checkpoint=None, resume=True, finetune=False, model_dir="m",
                          use_wandb=False, n_data=None, n_model=1, seed=cli.SEED,
                          device="cpu")]
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["tt_it", "--help"])
    assert exit_info.value.code == 0


def test_cli_joins_a_gloo_group_with_device_cpu(monkeypatch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(cli, "build_pipeline_dict",
                        lambda: {"aligner": lambda **kw: torch.distributed.get_backend()})
    try:
        assert cli.main(["aligner", "--device", "cpu", "--coordinator", f"localhost:{port}",
                         "--num_processes", "1", "--process_id", "0"]) == "gloo"
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory with a corpus root and an empty models dir; the
    recipes run from it (their caches go under ``Corpora/``)."""
    root = tmp_path_factory.mktemp("recipes")
    write_nancy(str(root / "corpora"))
    os.makedirs(root / "Models")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOUCAN_CORPORA_ROOT", str(root / "corpora"))
        mp.setenv("TOUCAN_MODELS_DIR", str(root / "Models"))
        mp.chdir(root)
        yield root


@pytest.fixture(scope="module")
def tt_it(workdir):
    state, history = pipelines.integration_test_pipeline(
        steps=2, batch_size=2, warmup_steps=1, postnet_start_steps=0, use_discriminator=False,
        use_g2p=False, config=ToucanTTSConfig(**TINY), device="cpu", log_every=1,
        model_dir=str(workdir / "Models" / "ToucanTTS_IntegrationTest"))
    return state, history


def test_tt_it_writes_checkpoints_that_load_py_reads(tt_it, workdir):
    state, history = tt_it
    assert len(history) >= 2 and all(np.isfinite(h["total_loss"]) for h in history)
    directory = workdir / "Models" / "ToucanTTS_IntegrationTest"
    paths = list_checkpoints(str(directory))
    assert len(paths) == 3 and "best.pt" in os.listdir(directory)   # SWA past 3 x 0 steps
    sd, emb = load.load_toucan_tts(paths[-1])
    ToucanTTS(ToucanTTSConfig(**TINY)).load_state_dict(sd)
    assert emb.shape == (64,)
    cache = load_cache(str(workdir / "Corpora" / "integration_test" / "fast_train_cache.npz"))
    assert len(cache) == 3 and all(d["durations"].sum() == len(d["mel"]) for d in cache)


def test_fs_it_writes_an_embedding_function(tt_it, workdir):
    model_dir = workdir / "Models" / "FastSpeech2_IntegrationTest"
    marks = []
    gst_sd = pipelines.fs_embedding_integration_test_pipeline(
        steps=2, batch_size=2, warmup_steps=1, use_g2p=False, config=ToucanTTSConfig(**TINY),
        device="cpu", model_dir=str(model_dir), callbacks=[lambda s, m: marks.append(s)])
    assert marks == [0, 1]
    got = load.load_style_embedding(str(model_dir / "embedding_function.pt"))
    StyleEmbedding().load_state_dict(got)
    assert all(torch.equal(got[k], v) for k, v in gst_sd.items())


def test_aligner_pipeline_writes_aligner_pt(workdir):
    sd = pipelines.aligner_pipeline(steps=2, use_g2p=False, device="cpu")
    got = load.load_aligner(str(workdir / "Models" / "Aligner" / "aligner.pt"))
    Aligner.for_state_dict(got).load_state_dict(got)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    assert len(load_cache(str(workdir / "Corpora" / "nancy" / "aligner_train_cache.npz"))) == 3


def test_embedding_pipeline_refuses_a_corpus_without_a_batch(workdir):
    with pytest.raises(ValueError, match="no batch of 16"):
        pipelines.embedding_pipeline(steps=1, use_g2p=False, device="cpu")


def test_gst_for_training_reads_the_embedding_function(workdir, capsys):
    path = workdir / "Models" / "Embedding" / "embedding_function.pt"
    assert not path.exists()
    drawn = pipelines._load_gst_state_dict()
    assert "no embedding function" in capsys.readouterr().out
    assert all(torch.equal(drawn[k], v) for k, v in pipelines._load_gst_state_dict().items())
    os.makedirs(path.parent)
    sd = {k: v + 1.0 if v.is_floating_point() else v for k, v in drawn.items()}
    torch.save({"style_emb_func": sd}, path)
    try:
        got = pipelines._load_gst_state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items())
    finally:
        os.remove(path)


def _trees(seed):
    rng = np.random.RandomState(seed)
    return {"model": {"w": rng.randn(3, 4).astype(np.float32),
                      "n": np.arange(3, dtype=np.int32) + seed},
            "step_counter": 10 * seed, "lr": 0.5 * seed,
            "default_emb": rng.randn(8).astype(np.float32)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def test_weight_averaging_follows_jax_s_rule(tmp_path):
    from flax import serialization

    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub / "M")
    for seed in (1, 2, 3):
        tree = _trees(seed)
        torch.save(_to_torch(tree), tmp_path / "port" / "M" / f"checkpoint_{seed}.pt")
        with open(tmp_path / "jax" / "M" / f"checkpoint_{seed}.msgpack", "wb") as f:
            f.write(serialization.msgpack_serialize(tree))
    weight_averaging.main(["--models_dir", str(tmp_path / "port"), "--n", "2"])
    jax_weight_averaging.make_best_in_all(str(tmp_path / "jax"), n=2)
    got = torch.load(tmp_path / "port" / "M" / "best.pt", weights_only=True)
    with open(tmp_path / "jax" / "M" / "best.msgpack", "rb") as f:
        want = serialization.msgpack_restore(f.read())
    np.testing.assert_allclose(got["model"]["w"].numpy(), want["model"]["w"], atol=1e-7)
    np.testing.assert_array_equal(got["model"]["n"].numpy(), want["model"]["n"])
    np.testing.assert_allclose(got["default_emb"].numpy(), want["default_emb"], atol=1e-7)
    assert got["step_counter"] == want["step_counter"] == 30 and got["lr"] == want["lr"]


def test_best_of_a_tt_it_run_serves(tt_it, workdir):
    directory = workdir / "Models" / "ToucanTTS_IntegrationTest"
    paths = list_checkpoints(str(directory))[-2:]
    weight_averaging.make_best_in_all(str(workdir / "Models"), n=2)
    sd, emb = load.load_toucan_tts(str(directory / "best.pt"))
    ckpts = [torch.load(p, weights_only=True)["model"] for p in paths]
    key = "encoder.embed.0.weight"
    assert torch.allclose(sd[key], (ckpts[0][key] + ckpts[1][key]) / 2)
    ToucanTTS(ToucanTTSConfig(**TINY)).load_state_dict(sd)


def test_scorer_twin_prints_the_worst(tt_it, workdir, capsys):
    torch.manual_seed(0)
    aligner = Aligner(conv_dim=64, lstm_dim=32)
    path = workdir / "aligner_small.pt"
    torch.save({"asr_model": aligner.state_dict()}, path)
    cache = str(workdir / "Corpora" / "integration_test" / "fast_train_cache.npz")
    scores = run_scorer.main([cache, "--aligner", str(path), "--worst", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert scores.shape == (3,) and np.isfinite(scores).all()
    assert out.count("ctc=") == 2 and "utt" in out
