"""The serving-script twins (``toucan_tpu_torch/run/``) on the CPU.

Tiny seeded checkpoints in the reference release's layout go into a
temporary ``TOUCAN_MODELS_DIR``; each twin then runs as its command line
would, with ``--device cpu``: a wav is written, the GUI's
``build_interface()`` is built, and the demo plays through an injected
player (``sounddevice``, the host-audio module the root demo uses, is not
installed here).
"""

import os
import wave as wave_mod

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from toucan_tpu_torch.infer.controllable import ControllableInterface
from toucan_tpu_torch.models.aligner import Aligner
from toucan_tpu_torch.models.embedding_gan import ResNetG
from toucan_tpu_torch.models.toucan_tts import ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.run import controllable_gui, interactive_demo, prosody_override
from toucan_tpu_torch.run import text_to_file_reader

from test_torch_gst import speech_like
from test_torch_interface import TINY
from test_torch_load import _randomized, write_gst, write_tts, write_vocoder

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("Models")
    for sub in ("ToucanTTS_Meta", "Avocodo", "BigVGAN", "Embedding", "Aligner"):
        (root / sub).mkdir()
    write_tts(str(root / "ToucanTTS_Meta" / "best.pt"), ToucanTTSConfig(**TINY))
    write_vocoder(str(root / "Avocodo" / "best.pt"), HiFiGANGenerator(channels=64))
    write_vocoder(str(root / "BigVGAN" / "best.pt"), BigVGAN(channels=64))
    write_gst(str(root / "Embedding" / "embedding_function.pt"))
    aligner = _randomized(Aligner(conv_dim=64, lstm_dim=32), 5)
    torch.save({"asr_model": aligner.state_dict(), "optimizer": {}},
               root / "Aligner" / "aligner.pt")
    params = dict(data_dim=[64], z_dim=32, size=4, nfilter=8, nfilter_max=16)
    torch.manual_seed(6)
    generator = ResNetG(**{k: v[-1] if k == "data_dim" else v for k, v in params.items()})
    torch.save({"model_parameters": params, "generator_state_dict": generator.state_dict(),
                "critic_state_dict": {}, "dataset_mean": torch.zeros(64),
                "dataset_std": torch.ones(64)}, root / "Embedding" / "embedding_gan.pt")
    return root


@pytest.fixture
def models_dir(models, monkeypatch):
    monkeypatch.setenv("TOUCAN_MODELS_DIR", str(models))
    return models


def _read(path):
    with wave_mod.open(str(path), "rb") as f:
        return f.getframerate(), f.getnframes()


@pytest.mark.parametrize("extra", [[], ["--dtype", "bfloat16", "--matmul_precision", "default"]])
def test_text_to_file_reader(models_dir, tmp_path, extra):
    out = tmp_path / "out.wav"
    text_to_file_reader.main(CPU + extra + ["--out", str(out), "Hello world.", "A second one."])
    sr, n = _read(out)
    assert sr == 24000 and n > 2 * 10600


def test_text_to_file_reader_with_bigvgan(models_dir, tmp_path):
    out = tmp_path / "big.wav"
    text_to_file_reader.read_texts("Meta", "Hello world.", str(out), faster_vocoder=False,
                                   device="cpu")
    assert _read(out)[0] == 24000


def test_prosody_override(models_dir, tmp_path, capsys):
    """A float WAV reference (read by ``read_wave``) and a voice recording."""
    ref, voice, out = tmp_path / "ref.wav", tmp_path / "voice.wav", tmp_path / "cloned.wav"
    wavfile.write(str(ref), 16000, speech_like(16000, 1.2, seed=7))
    wavfile.write(str(voice), 16000, speech_like(16000, 0.8, seed=8))
    prosody_override.main([str(ref), "Hello world.", "--voice_audio", str(voice),
                           "--out", str(out)] + CPU)
    assert _read(out)[0] == 24000 and _read(out)[1] > 0
    assert f"wrote {out}" in capsys.readouterr().out


class Player:
    def __init__(self):
        self.played = []

    def play(self, data, samplerate):
        self.played.append((np.asarray(data), samplerate))

    def wait(self):
        pass


def test_interactive_demo_plays_through_read_aloud(models_dir):
    lines = iter(["en", "Hello world.", ""])
    player = Player()
    interactive_demo.main(CPU, ask=lambda _: next(lines), player=player)
    (data, sr), = player.played
    assert sr == 24000 and data.dtype == np.float32 and len(data) > 12000


def test_interactive_demo_writes_files_without_host_audio(models_dir, tmp_path, monkeypatch):
    assert interactive_demo.host_player() is None    # no sounddevice on this host
    monkeypatch.chdir(tmp_path)
    lines = iter(["", "Hello world.", "Again.", ""])
    interactive_demo.main(CPU, ask=lambda _: next(lines))
    assert all(os.path.exists(tmp_path / f"demo_output_{i}.wav") for i in (0, 1))


def test_controllable_gui(models_dir, capsys):
    controllable = controllable_gui.build_interface(device="cpu")
    assert isinstance(controllable, ControllableInterface)
    sr, wav = controllable.read("Hello world.")
    assert sr == 48000 and len(wav) > 0
    controllable_gui.main(CPU)
    assert "gradio not installed; use build_interface() programmatically" in \
        capsys.readouterr().out


def test_gui_needs_the_gan_checkpoint(models_dir, tmp_path, monkeypatch):
    """Every checkpoint but the embedding GAN's: the GUI refuses to start."""
    for sub in ("ToucanTTS_Meta", "Avocodo"):
        (tmp_path / sub).symlink_to(models_dir / sub)
    (tmp_path / "Embedding").mkdir()
    (tmp_path / "Embedding" / "embedding_function.pt").symlink_to(
        models_dir / "Embedding" / "embedding_function.pt")
    monkeypatch.setenv("TOUCAN_MODELS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="embedding GAN checkpoint"):
        controllable_gui.build_interface(device="cpu")
