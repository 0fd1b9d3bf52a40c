"""WAV I/O and the native codec of the port: the cases of ``tests/io/test_wav.py`` and ``tests/native/test_native.py``.

The same cases as the JAX package's tests, on :mod:`ssspy_tpu_torch.io`
and :mod:`ssspy_tpu_torch.native` (the reference writer, which is not
installed, gives way to the JAX package's writer); then the port's readers
against the JAX readers on the same files, to the bit, and the codec's
build: from the port's own source into ``ssspy_tpu_torch/_build/``, never
the JAX package's library, and a failed build kept and raised with the
compiler's message. The codec builds with ``g++`` (present here); a missing
compiler is a failure, not a skip.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from ssspy_tpu import native as jax_native
from ssspy_tpu.io import wavread as jax_wavread
from ssspy_tpu.io import wavwrite as jax_wavwrite
from ssspy_tpu_torch import native, wavread, wavwrite

# ---- tests/io/test_wav.py --------------------------------------------------------------------------------------
def test_roundtrip_mono(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, 1600)
    path = str(tmp_path / "mono.wav")
    wavwrite(path, x, 16000)
    y, sr = wavread(path)
    assert sr == 16000
    assert y.shape == (1600,)
    assert np.allclose(y, x, atol=2 ** -15 + 1e-9)


def test_roundtrip_stereo_channels_first(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (2, 800))
    path = str(tmp_path / "stereo.wav")
    wavwrite(path, x, 8000, channels_first=True)
    y, sr = wavread(path, channels_first=True)
    assert sr == 8000
    assert y.shape == (2, 800)
    assert np.allclose(y, x, atol=2 ** -15 + 1e-9)


def test_frame_offset_and_num_frames(tmp_path):
    x = np.linspace(-0.5, 0.5, 1000)
    path = str(tmp_path / "seek.wav")
    wavwrite(path, x, 16000)
    y_full, _ = wavread(path)
    y_part, _ = wavread(path, frame_offset=100, num_frames=200)
    assert y_part.shape == (200,)
    assert np.allclose(y_part, y_full[100:300])


def test_num_frames_overrun_raises(tmp_path):
    x = np.zeros(100)
    path = str(tmp_path / "short.wav")
    wavwrite(path, x, 16000)
    with pytest.raises(ValueError):
        wavread(path, frame_offset=50, num_frames=100)


def test_invalid_extension():
    with pytest.raises(AssertionError):
        wavwrite("/tmp/foo.mp3", np.zeros(10), 16000)


def test_reads_reference_writer_output(tmp_path):
    """Cross-check against the JAX package's writer (the reference writer is not installed here)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.9, 0.9, 500)
    path = str(tmp_path / "ref.wav")
    jax_wavwrite(path, x, 16000)
    y, sr = wavread(path)
    assert sr == 16000
    assert np.allclose(y, x, atol=2 ** -15 + 1e-9)


# ---- corruption paths (reference parity: tests/dummy/io.py:8-107 +
# tests/package/io/test_wavread.py:202-258 — each broken-RIFF variant
# must raise an EXPLICIT exception, never an opaque struct/numpy error) --


def _write_wav_bytes(
    path,
    riff=b"RIFF",
    ftype=b"WAVE",
    fmt_marker=b"fmt ",
    fmt_size=16,
    fmt_tag=1,
    n_channels=1,
    sample_rate=16000,
    byte_rate=None,
    block_align=None,
    bits=16,
    data_marker=b"data",
    n_frames=64,
    data_size=None,
    truncate_data=None,
    truncate_header=None,
):
    """Parametrized broken-RIFF writer (twin of the reference's
    save_invalid_wavfile, plus truncation variants)."""
    import struct as _struct

    if byte_rate is None:
        byte_rate = (bits * sample_rate * n_channels) // 8
    if block_align is None:
        block_align = (bits * n_channels) // 8
    rng = np.random.default_rng(42)
    payload = rng.integers(
        -(2 ** (bits - 1)), 2 ** (bits - 1), size=(n_frames * n_channels,),
    ).astype(f"<i{bits // 8}").tobytes()
    if data_size is None:
        data_size = len(payload)

    blob = b"".join(
        [
            riff,
            _struct.pack("<I", 36 + len(payload)),
            ftype,
            fmt_marker,
            _struct.pack("<I", fmt_size),
            _struct.pack("<H", fmt_tag),
            _struct.pack("<HIIHH", n_channels, sample_rate, byte_rate, block_align, bits),
            data_marker,
            _struct.pack("<I", data_size),
            payload,
        ]
    )
    if truncate_data is not None:
        blob = blob[: 44 + truncate_data]
    if truncate_header is not None:
        blob = blob[:truncate_header]
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


class TestWavreadCorruption:
    def test_invalid_riff_marker(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", riff=b"RIFX")
        with pytest.raises(NotImplementedError, match="little-endian RIFF"):
            wavread(path)

    def test_invalid_ftype(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", ftype=b"wave")
        with pytest.raises(NotImplementedError, match="Not a WAVE file"):
            wavread(path)

    def test_invalid_fmt_chunk_marker(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", fmt_marker=b"FMT ")
        with pytest.raises(NotImplementedError, match="Expected 'fmt ' chunk"):
            wavread(path)

    def test_invalid_fmt_chunk_size(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", fmt_size=15)
        with pytest.raises(NotImplementedError, match="malformed RIFF/WAVE header"):
            wavread(path)

    def test_non_pcm_format_tag(self, tmp_path):
        # fmt_tag=3 = IEEE float, fmt_tag=0 = the reference's invalid_fmt case
        for tag in (0, 3):
            path = _write_wav_bytes(tmp_path / "x.wav", fmt_tag=tag)
            with pytest.raises(NotImplementedError, match=f"Invalid header {tag}"):
                wavread(path)

    def test_invalid_byte_rate(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", byte_rate=16000 * 2 + 1)
        with pytest.raises(ValueError, match="malformed RIFF/WAVE header"):
            wavread(path)

    def test_invalid_block_align(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", block_align=3)
        with pytest.raises(ValueError, match="malformed RIFF/WAVE header"):
            wavread(path)

    def test_invalid_data_chunk_marker(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", data_marker=b"DATA")
        with pytest.raises(NotImplementedError, match="Expected 'data' chunk"):
            wavread(path)

    def test_truncated_data_chunk(self, tmp_path):
        # data chunk declares 64 frames but the file holds half of them:
        # must be an explicit truncation error, not a numpy buffer error
        path = _write_wav_bytes(tmp_path / "x.wav", truncate_data=64)
        with pytest.raises(ValueError, match="truncated RIFF/WAVE file"):
            wavread(path)

    def test_truncated_header(self, tmp_path):
        path = _write_wav_bytes(tmp_path / "x.wav", truncate_header=20)
        with pytest.raises(ValueError, match="truncated RIFF/WAVE file"):
            wavread(path)

    def test_zero_channels(self, tmp_path):
        path = _write_wav_bytes(
            tmp_path / "x.wav", n_channels=0, byte_rate=0, block_align=1
        )
        with pytest.raises(ValueError, match="malformed RIFF/WAVE header"):
            wavread(path)


# ---- tests/native/test_native.py ----------------------------------------------------------------------------------


def test_native_wav_roundtrip_matches_python(tmp_path):
    rng = np.random.default_rng(0)
    waveform = (rng.standard_normal((1600, 2)) * 0.1).clip(-1, 0.99)
    path = str(tmp_path / "x.wav")
    wavwrite(path, waveform, sample_rate=16000)

    # python reader vs native reader
    py, sr_py = wavread(path, return_2d=True)
    nat, sr_nat = native.wav_read(path)
    assert sr_py == sr_nat == 16000
    np.testing.assert_allclose(nat, py.reshape(nat.shape), atol=1e-6)


def test_native_wav_info(tmp_path):
    # 3-channel via the native writer (the python writer caps at stereo,
    # matching the reference ssspy/io/__init__.py)
    waveform = np.zeros((800, 3), dtype=np.int16)
    path = str(tmp_path / "y.wav")
    native.wav_write_i16(path, waveform, sample_rate=8000)
    ch, sr, bits, frames = native.wav_info(path)
    assert (ch, sr, bits, frames) == (3, 8000, 16, 800)


def test_native_write_read_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal((500, 2)) * 8000).astype(np.int16)
    path = str(tmp_path / "z.wav")
    native.wav_write_i16(path, pcm, sample_rate=44100)

    out, sr = native.wav_read(path)
    assert sr == 44100
    np.testing.assert_allclose(out, pcm / 32768.0, atol=1e-7)

    # python reader agrees too
    py, sr_py = wavread(path, return_2d=True)
    assert sr_py == 44100
    np.testing.assert_allclose(py.reshape(out.shape), out, atol=1e-6)


def test_native_wav_read_offset(tmp_path):
    pcm = np.arange(100, dtype=np.int16)[:, None]
    path = str(tmp_path / "w.wav")
    native.wav_write_i16(path, pcm, sample_rate=8000)
    out, _ = native.wav_read(path, frame_offset=10, num_frames=5)
    np.testing.assert_allclose(out[:, 0] * 32768.0, np.arange(10, 15))


def test_native_wav_invalid_header(tmp_path):
    path = str(tmp_path / "bad.wav")
    with open(path, "wb") as f:
        f.write(b"RIFX" + b"\x00" * 40)
    with pytest.raises(ValueError):
        native.wav_info(path)


def test_native_wav_non_pcm_rejected(tmp_path):
    """IEEE-float format tag (3) is rejected as unsupported."""
    path = str(tmp_path / "float.wav")
    with open(path, "wb") as f:
        data_size = 0
        f.write(b"RIFF" + struct.pack("<I", 36 + data_size) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 8000, 32000, 4, 32))
        f.write(b"data" + struct.pack("<I", data_size))
    with pytest.raises(NotImplementedError):
        native.wav_info(path)


def test_native_convolutive_mix_matches_numpy():
    rng = np.random.default_rng(2)
    n_sources, n_mics, n_samples, n_taps = 3, 4, 2000, 17
    sources = rng.standard_normal((n_sources, n_samples))
    taps = rng.standard_normal((n_mics, n_sources, n_taps))

    mix = native.convolutive_mix(sources, taps)

    expected = np.zeros((n_mics, n_samples))
    for m in range(n_mics):
        for n in range(n_sources):
            expected[m] += np.convolve(sources[n], taps[m, n], mode="same")

    np.testing.assert_allclose(mix, expected, atol=1e-10)


def test_native_convolutive_mix_even_taps():
    rng = np.random.default_rng(3)
    sources = rng.standard_normal((2, 500))
    taps = rng.standard_normal((2, 2, 32))
    mix = native.convolutive_mix(sources, taps)
    expected = np.zeros((2, 500))
    for m in range(2):
        for n in range(2):
            expected[m] += np.convolve(sources[n], taps[m, n], mode="same")
    np.testing.assert_allclose(mix, expected, atol=1e-10)


def test_native_resample_preserves_sine():
    """Resampling a pure tone preserves frequency and amplitude."""
    sr_in, sr_out, f0 = 8000, 16000, 440.0
    t = np.arange(8000) / sr_in
    x = np.sin(2 * np.pi * f0 * t)

    y = native.resample(x, sr_in, sr_out)
    assert y.shape[-1] == 16000

    # compare against the ideal tone at the new rate (skip filter edges)
    t2 = np.arange(y.shape[-1]) / sr_out
    ref = np.sin(2 * np.pi * f0 * t2)
    np.testing.assert_allclose(y[200:-200], ref[200:-200], atol=2e-3)


def test_native_resample_downsample_antialias():
    """Content above the target Nyquist is attenuated on downsampling."""
    sr_in, sr_out = 16000, 8000
    t = np.arange(16000) / sr_in
    x_hi = np.sin(2 * np.pi * 6000.0 * t)  # above 4 kHz target Nyquist
    y = native.resample(x_hi, sr_in, sr_out)
    assert np.abs(y[200:-200]).max() < 0.05

    x_lo = np.sin(2 * np.pi * 1000.0 * t)
    y = native.resample(x_lo, sr_in, sr_out)
    assert np.abs(y[200:-200]).max() > 0.9


def test_native_resample_multichannel_shape():
    x = np.random.default_rng(0).standard_normal((3, 4000))
    y = native.resample(x, 8000, 12000)
    assert y.shape == (3, 6000)


# ---- the port's readers against the JAX readers, and the build ---------------------------------------------------


def _files(tmp_path):
    """WAV files of each layout the readers take: mono and stereo from the writer, 8 channels from the codec, 8 and 32 bits."""
    rng = np.random.default_rng(7)
    paths = {}
    paths["mono"] = str(tmp_path / "mono.wav")
    wavwrite(paths["mono"], rng.uniform(-0.9, 0.9, 700), 16000)
    paths["stereo"] = str(tmp_path / "stereo.wav")
    wavwrite(paths["stereo"], rng.uniform(-0.9, 0.9, (2, 500)), 8000, channels_first=True)
    paths["eight"] = str(tmp_path / "eight.wav")
    native.wav_write_i16(paths["eight"], (rng.standard_normal((300, 8)) * 5000).astype(np.int16), 16000)
    for bits in (8, 32):
        path = str(tmp_path / f"bits{bits}.wav")
        _write_wav_bytes(path, bits=bits, n_channels=2)
        paths[f"bits{bits}"] = path
    return paths


def test_the_readers_equal_the_jax_readers_to_the_bit(tmp_path):
    for name, path in _files(tmp_path).items():
        for kw in ({}, {"return_2d": True}, {"channels_first": True, "return_2d": True}, {"frame_offset": 3, "num_frames": 40}):
            got, ref = wavread(path, **kw), jax_wavread(path, **kw)
            assert got[1] == ref[1] and got[0].dtype == ref[0].dtype, (name, kw)
            np.testing.assert_array_equal(got[0], ref[0])
        if name.startswith("bits"):
            continue  # the codec reads 16-bit PCM only
        got, ref = native.wav_read(path, frame_offset=2), jax_native.wav_read(path, frame_offset=2)
        assert got[1] == ref[1] and got[0].dtype == ref[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], ref[0])
        assert native.wav_info(path) == jax_native.wav_info(path)


def test_the_writers_write_the_jax_writers_bytes(tmp_path):
    rng = np.random.default_rng(8)
    x = rng.uniform(-0.9, 0.9, (2, 400))
    pcm = (rng.standard_normal((200, 5)) * 3000).astype(np.int16)
    for name, write, jax_write, args in (
        ("wave", wavwrite, jax_wavwrite, (x.T, 16000)),
        ("pcm", native.wav_write_i16, jax_native.wav_write_i16, (pcm, 22050)),
    ):
        ours, theirs = str(tmp_path / f"{name}.wav"), str(tmp_path / f"{name}_jax.wav")
        write(ours, *args)
        jax_write(theirs, *args)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()


def test_the_codec_builds_from_the_ports_source_and_never_loads_the_jax_library():
    """A fresh process that imports only the port: the library it maps is the port's own build."""
    code = (
        "from ssspy_tpu_torch import native\n"
        "assert native.available(), native.build_error()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(native.library_path() in maps, 'ssspy_tpu/native' in maps, 'jax' in maps)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False", "False"]
    assert native.library_path().startswith(os.path.join(root, "ssspy_tpu_torch", "_build", "libssspy_native-"))
    assert native.SOURCE == os.path.join(root, "ssspy_tpu_torch", "native", "ssspy_native.cpp")


def test_a_failed_build_is_kept_and_raised(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    assert not native.available()
    assert "g++ failed to build the native codec" in native.build_error()
    with pytest.raises(RuntimeError, match=r"native codec of ssspy_tpu_torch is unavailable: g\+\+ failed"):
        native.wav_info(str(tmp_path / "x.wav"))
    assert not any(name.endswith(".so") for name in os.listdir(tmp_path))
