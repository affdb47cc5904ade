"""The port's native resampler and its WAV readers.

``native/resample.cpp`` (a copy of the JAX package's) against the numpy
path of ``frontend/audio.py`` at the rates of ``tests/test_native_resample.py``
and its bar (float32 rounding: the numpy path sums in float32 sgemm, the
native one in double); skipped only where the host has no g++.  IEEE-float
WAV files (32 and 64 bit, plain and WAVE_FORMAT_EXTENSIBLE) read back
within 1e-7; PCM is read as before (``tests/test_torch_gst.py``).
"""

import shutil
import struct

import numpy as np
import pytest
from scipy.io import wavfile

from toucan_tpu_torch import native
from toucan_tpu_torch.frontend import audio


@pytest.fixture
def native_resampler():
    if shutil.which("g++") is None or not native.native_resample_available():
        pytest.skip("no C++ toolchain on this host")
    return native.resample


@pytest.mark.parametrize("orig_sr,new_sr", [(48000, 16000), (24000, 16000), (22050, 16000),
                                            (16000, 24000), (44100, 16000)])
def test_native_matches_numpy(native_resampler, orig_sr, new_sr):
    wave = np.random.RandomState(0).randn(orig_sr * 2 + 317).astype(np.float32)
    want = audio.resample_numpy(wave, orig_sr, new_sr)
    got = native_resampler(wave, orig_sr, new_sr)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_threads_do_not_change_the_result(native_resampler):
    wave = np.random.RandomState(1).randn(48000 * 2).astype(np.float32)
    np.testing.assert_array_equal(native_resampler(wave, 48000, 16000, n_threads=1),
                                  native_resampler(wave, 48000, 16000, n_threads=8))


def test_resample_prefers_native(native_resampler, monkeypatch):
    """``frontend.audio.resample`` takes the native path, as the JAX
    package's does, unless ``TOUCAN_NATIVE_RESAMPLE=0``."""
    wave = np.random.RandomState(2).randn(24000).astype(np.float32)
    before = dict(native.resample_calls)
    np.testing.assert_array_equal(audio.resample(wave, 24000, 16000),
                                  native_resampler(wave, 24000, 16000))
    assert native.resample_calls["native"] == before["native"] + 2
    monkeypatch.setenv("TOUCAN_NATIVE_RESAMPLE", "0")
    np.testing.assert_array_equal(audio.resample(wave, 24000, 16000),
                                  audio.resample_numpy(wave, 24000, 16000))
    assert audio.resample(wave, 16000, 16000) is wave


def test_numpy_path_without_a_compiler(monkeypatch):
    """Without g++ the native module falls back to the numpy path."""
    monkeypatch.setattr(native, "load_resample_library", lambda: None)
    wave = np.random.RandomState(3).randn(4800).astype(np.float32)
    before = native.resample_calls["numpy"]
    np.testing.assert_array_equal(native.resample(wave, 48000, 16000),
                                  audio.resample_numpy(wave, 48000, 16000))
    assert native.resample_calls["numpy"] == before + 1


def _extensible_float_wav(path, data, sr):
    """A WAVE_FORMAT_EXTENSIBLE file whose subformat is IEEE float, as
    audio editors write it (scipy writes the plain float tag)."""
    bits = data.dtype.itemsize * 8
    channels = 1 if data.ndim == 1 else data.shape[1]
    block = channels * data.dtype.itemsize
    guid = struct.pack("<IHH8s", 3, 0x0000, 0x0010, b"\x80\x00\x00\xaa\x00\x38\x9b\x71")
    fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr, sr * block, block, bits, 22, bits,
                      0) + guid
    payload = data.astype(data.dtype.newbyteorder("<")).tobytes()
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt \
        + b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("extensible", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_float_wav_reads_back(tmp_path, dtype, extensible, channels):
    rng = np.random.RandomState(4)
    want = rng.uniform(-1, 1, (1000, channels) if channels > 1 else 1000)
    path = str(tmp_path / "float.wav")
    if extensible:
        _extensible_float_wav(path, want.astype(dtype), 24000)
    else:
        wavfile.write(path, 24000, want.astype(dtype))
    for read in (audio.read_wav, audio.read_wave):
        got, sr = read(path)
        assert sr == 24000 and got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-7


def test_read_wave_reads_pcm_as_read_wav(tmp_path):
    path = str(tmp_path / "pcm.wav")
    wavfile.write(path, 16000, (np.arange(-100, 100) * 100).astype(np.int16))
    got, sr = audio.read_wave(path)
    want, _ = audio.read_wav(path)
    assert sr == 16000
    np.testing.assert_array_equal(got, want)
