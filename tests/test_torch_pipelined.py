"""The port's two-stage pipelined serving (``infer/pipelined.py``) on the CPU.

A tiny ToucanTTS and HiFiGAN with seeded weights:

- ``make_stage_fns``: the acoustic stage gives the interface's acoustic
  step's mel (through its bucket, and eagerly) bit for bit, frames past
  each length zeroed, and the vocoder stage the wave of the interface's
  text -> wave step (``ToucanTTSInterface._run_e2e``), lengths equal;
- ``PipelinedSynthesizer`` on ``["cpu", "cpu"]`` (two stages, ``two_stage``)
  and on ``["cpu"]`` (one): a stream of six batches, each wave within 1e-6
  of its standalone dispatch through the stage functions (JAX's
  ``tests/test_pipelined_longform.py`` bar), lengths equal, in order;
- without ``devices`` and with no card it raises instead of running on
  the CPU.
"""

import numpy as np
import pytest
import torch

from toucan_tpu_torch.infer.interface import ToucanTTSInterface, acoustic_step
from toucan_tpu_torch.infer.pipelined import PipelinedSynthesizer, make_stage_fns
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator

from test_torch_train import TINY

FRAMES = 64
VOCODER = dict(channels=32, resblock_kernel_sizes=(3,), resblock_dilations=(1, 3))


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    model = ToucanTTS(ToucanTTSConfig(**TINY)).eval()
    vocoder = HiFiGANGenerator(**VOCODER).eval()
    with torch.no_grad():  # live biases
        for name, p in vocoder.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    return model, vocoder


def batch(seed, b=2, tmax=8):
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor([tmax, tmax - 3 - seed % 3][:b])
    return ((torch.rand(b, tmax, 62, generator=g) > 0.5).float(), lens,
            torch.randn(b, 64, generator=g), torch.randint(0, 90, (b, 1), generator=g),
            torch.randn(b, FRAMES, 80, generator=g) * 0.8,
            torch.tensor([1.0 + 0.1 * (seed % 2), 1.0, 1.0, 1.0]))


def test_stage_functions_equal_the_fused_step(models):
    model, vocoder = models
    iface = ToucanTTSInterface(model.state_dict(), vocoder.state_dict(),
                               config=ToucanTTSConfig(**TINY), vocoder=HiFiGANGenerator(**VOCODER),
                               device="cpu")
    text, lens, utt, lang, noise, knobs = batch(1)
    inputs = dict(text=text, text_lengths=lens, utt=utt, lang=lang, knobs=knobs)
    wave, after, _, _, _, mel_lens = iface._run_e2e(FRAMES, noise, **inputs)
    bucket_mel = iface._e2e_bucket(FRAMES, inputs)(noise=noise, **inputs)[0]
    eager_mel = acoustic_step(iface.model, max_frames=FRAMES, noise=noise, **inputs)[0]
    acoustic, vocode = make_stage_fns(iface.model, iface.vocoder, FRAMES)
    mel, got_lens = acoustic(text, lens, utt, lang, noise, knobs)
    assert torch.equal(got_lens, mel_lens)
    assert torch.equal(mel, bucket_mel) and torch.equal(mel, eager_mel)
    assert wave.shape == (2, FRAMES * 384)
    for i, n in enumerate(mel_lens.tolist()):
        assert torch.equal(mel[i, :n], after[i, :n]) and not mel[i, n:].any()
    assert torch.equal(vocode(mel), wave)


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu"]], ids=["two_stage", "one"])
def test_stream_matches_standalone_dispatch(models, devices):
    model, vocoder = models
    pipe = PipelinedSynthesizer(model, model.state_dict(), vocoder, vocoder.state_dict(),
                                FRAMES, devices=devices, depth=2)
    assert pipe.two_stage == (len(devices) == 2)
    batches = [batch(s) for s in range(6)]
    results = list(pipe.synthesize_stream(batches))
    assert len(results) == 6
    for (wave, lens), b in zip(results, batches):
        mel, want_lens = pipe.acoustic_fn(*b)
        want = pipe.vocode_fn(mel).numpy()
        assert wave.shape == want.shape == (2, FRAMES * 384)
        np.testing.assert_array_equal(lens, want_lens.numpy())
        np.testing.assert_allclose(wave, want, atol=1e-6, rtol=0)


def test_default_devices_ask_for_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    model, vocoder = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedSynthesizer(model, None, vocoder, None, FRAMES)
