"""The port's mel front end, audio loading and windowing against the JAX ones.

Bars are the reference's own: 2e-3 for the rfft path (test_audio.py:42) and
5e-3 for the fused mel (test_audio.py:80). The fused-mel kernel itself is
held against its plain version in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.audio.io import load_audio_file as jax_load_audio_file
from mapperatorinator_tpu.audio.mel import MelSpectrogram as JaxMelSpectrogram
from mapperatorinator_tpu.audio.mel import _dft_matrices
from mapperatorinator_tpu.infer.preprocessor import Preprocessor as JaxPreprocessor
from mapperatorinator_tpu.ops.mel_kernel import fused_mel as jax_fused_mel
from mapperatorinator_tpu_torch.audio import MelSpectrogram, load_audio_file
from mapperatorinator_tpu_torch.audio.mel import dft_matrices
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.infer import Preprocessor
from tests.fixtures.tiny_checkpoint import make_wav

KW = dict(sample_rate=16000, n_fft=1024, hop_length=128, n_mels=128, f_min=20, f_max=8000)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    t = np.arange(16000 * 2) / 16000
    x = 0.5 * np.sin(2 * np.pi * 440 * t)[None] + 0.1 * rng.standard_normal((2, len(t)))
    return x.astype(np.float32)


@pytest.mark.parametrize("pad_mode,log_scale", [("constant", False), ("reflect", True)])
def test_rfft_path_matches_jax(audio, pad_mode, log_scale):
    want = np.asarray(JaxMelSpectrogram("xla", log_scale, pad_mode=pad_mode, **KW)(jnp.asarray(audio)))
    got = MelSpectrogram("torchaudio", log_scale, pad_mode=pad_mode, **KW)(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 2 * 16000 // 128 + 1, 128)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_fused_mel_plain_matches_jax_interpret(audio):
    """The port's fused-mel front end (on the CPU the kernel's plain version)
    against the Pallas kernel run in interpret mode."""
    short = audio[:, : 128 * 63]
    got = MelSpectrogram("pallas", True, pad_mode="reflect", **KW)(torch.from_numpy(short)).numpy()
    padded = np.pad(short, ((0, 0), (512, 512)), mode="reflect")
    frames = np.stack([padded[:, i * 128: i * 128 + 1024] for i in range(64)], axis=1)
    jm = JaxMelSpectrogram("xla", True, pad_mode="reflect", **KW)
    w_re, w_im = _dft_matrices(1024, jm.window)
    want = np.asarray(jax_fused_mel(jnp.asarray(frames), jnp.asarray(w_re), jnp.asarray(w_im),
                                    jnp.asarray(jm.fbanks), True, tile_frames=64, interpret=True))
    assert got.shape == want.shape == (2, 64, 128)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_filterbank_and_dft_match_jax():
    jm = JaxMelSpectrogram("xla", True, pad_mode="reflect", **KW)
    tm = MelSpectrogram("pallas", True, pad_mode="reflect", **KW)
    np.testing.assert_array_equal(tm.fbanks.numpy(), jm.fbanks)
    np.testing.assert_array_equal(tm.window.numpy(), jm.window)
    for a, b in zip(dft_matrices(1024, jm.window), _dft_matrices(1024, jm.window)):
        np.testing.assert_array_equal(a, b)


def test_wav_loading_and_windows_match_jax(tmp_path, monkeypatch):
    wav = make_wav(tmp_path / "song.wav", seconds=3.0, sr=22050)
    for normalize in (False, True):
        np.testing.assert_array_equal(load_audio_file(wav, 16000, normalize=normalize),
                                      jax_load_audio_file(wav, 16000, normalize=normalize))
    args = load_config("v32")
    samples = load_audio_file(wav, 16000)
    for parallel in (False, True):
        got = Preprocessor(args, parallel=parallel).segment(samples)
        want = JaxPreprocessor(args, parallel=parallel).segment(samples)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    # other containers go through ffmpeg, which this machine does not have
    # (tests/test_torch_audio_io.py runs them through a stand-in)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="ffmpeg not available"):
        load_audio_file(tmp_path / "song.mp3", 16000)
