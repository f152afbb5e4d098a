"""The port's audio loading against the JAX package's, on the ffmpeg path
too. No ffmpeg binary is at hand, so a stand-in named ``ffmpeg`` goes first on
``PATH``: it takes the JAX loader's command line (``-i``, ``-ar``, f32le to
stdout) and decodes a mono 16-bit WAV at the asked rate, with the stdlib
alone (behind a 4-byte ``FAKE`` prefix, where the bytes must not read as
WAV). Both packages must give the same samples, and the
same error where no ``ffmpeg`` is on ``PATH``.
"""

import os
import stat
import sys
import textwrap

import numpy as np
import pytest

from mapperatorinator_tpu.audio import io as jax_io
from mapperatorinator_tpu.infer.preprocessor import Preprocessor as JaxPreprocessor
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.audio import io
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.infer.preprocessor import Preprocessor
from tests.fixtures.tiny_checkpoint import make_wav

FFMPEG = textwrap.dedent("""\
    #!{python}
    import array, io, sys, wave

    argv = sys.argv[1:]
    data = open(argv[argv.index("-i") + 1], "rb").read()
    with wave.open(io.BytesIO(data[4:] if data.startswith(b"FAKE") else data)) as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, int(argv[argv.index("-ar") + 1])):
            sys.exit("the stand-in decodes mono 16-bit audio at the asked rate only")
        pcm = array.array("h", w.readframes(w.getnframes()))
    sys.stdout.buffer.write(array.array("f", [v / 32768.0 for v in pcm]).tobytes())
""")


@pytest.fixture
def ffmpeg(tmp_path, monkeypatch):
    """A stand-in ffmpeg first on PATH; returns how many times it ran."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "ffmpeg.log"
    script = bin_dir / "ffmpeg"
    script.write_text(FFMPEG.format(python=sys.executable).replace(
        "import array, io, sys, wave\n", f"import array, io, sys, wave\nopen({str(log)!r}, 'a').write('run\\n')\n"))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    return lambda: len(log.read_text().splitlines()) if log.exists() else 0


def test_other_containers_decode_through_ffmpeg_as_in_jax(tmp_path, ffmpeg):
    mp3 = make_wav(tmp_path / "song.mp3", seconds=2.0)  # WAV bytes behind another suffix
    for speed in (1.0, 1.5):
        for normalize in (False, True):
            got = io.load_audio_file(mp3, 16000, speed=speed, normalize=normalize)
            want = jax_io.load_audio_file(mp3, 16000, speed=speed, normalize=normalize)
            assert got.dtype == np.float32 and len(got) == len(want) > 0
            np.testing.assert_array_equal(got, want)
    assert ffmpeg() == 8
    assert len(io.load_audio_file(mp3, 16000)) == 32000

    # the Preprocessor reads it, and the command line no longer refuses it
    args = load_config("v32", [f"audio_path={mp3}", "device=cpu"])
    np.testing.assert_array_equal(Preprocessor(args).load(str(mp3)), JaxPreprocessor(args).load(str(mp3)))
    inference.compile_paths(args)
    assert args.audio_path == str(mp3) and args.output_path == str(tmp_path)


def test_decode_audio_bytes_matches_jax(tmp_path, ffmpeg):
    raw = make_wav(tmp_path / "song.wav", seconds=1.5).read_bytes()
    for data, runs in ((raw, 0), (b"FAKE" + raw, 1)):  # WAV decodes in-process; the rest through ffmpeg
        before = ffmpeg()
        for speed in (1.0, 0.75):
            np.testing.assert_array_equal(io.decode_audio_bytes(data, 16000, speed=speed),
                                          jax_io.decode_audio_bytes(data, 16000, speed=speed))
        assert ffmpeg() - before == 4 * runs


def test_resampling_helpers_match_jax():
    x = np.random.default_rng(0).standard_normal(22050).astype(np.float32)
    for rate, speed in ((22050, 1.0), (44100, 1.25), (16000, 1.0)):
        np.testing.assert_array_equal(io.resample_and_speed(x, rate, 16000, speed),
                                      jax_io.resample_and_speed(x, rate, 16000, speed))
        assert io._resample_ratio(16000, rate * speed) == jax_io._resample_ratio(16000, rate * speed)
    assert io.get_song_length_ms(x, 16000) == jax_io.get_song_length_ms(x, 16000) == 1378.125


def test_missing_ffmpeg_raises_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    mp3 = make_wav(tmp_path / "song.mp3", seconds=0.5)
    errors = []
    for load in (io.load_audio_file, jax_io.load_audio_file):
        with pytest.raises(RuntimeError, match="ffmpeg not available") as err:
            load(mp3, 16000)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(RuntimeError, match="ffmpeg not available"):
        io.decode_audio_bytes(b"FAKE" + mp3.read_bytes(), 16000)
