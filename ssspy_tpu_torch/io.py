"""Host-side WAV (RIFF PCM) I/O: a copy of :mod:`ssspy_tpu.io`, the same errors and the same limits.

Parity target: ssspy/io/__init__.py:8-227 (pure-Python PCM RIFF
reader/writer, no external dependencies). Integer PCM frames are decoded
with ``np.frombuffer`` and normalized to ``[-1, 1)`` floats; writing
accepts float (scaled to int16), int8, or int16 waveforms, mono or stereo
(:mod:`ssspy_tpu_torch.native` writes any channel count).

I/O stays on the host and returns numpy arrays, which
:func:`ssspy_tpu_torch.separate` and the fast paths take as they are.
"""

import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["wavread", "wavwrite"]

_PCM_FORMAT = 1


def _expect(condition: bool, message: str, exc=NotImplementedError) -> None:
    if not condition:
        raise exc(message)


def _read_exact(f, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise an explicit truncation error.

    A truncated RIFF file would otherwise surface as an opaque
    ``struct.error`` / numpy buffer-size error (reference parity:
    ssspy's reader pins explicit messages per corruption —
    tests/package/io/test_wavread.py).
    """
    raw = f.read(n)
    if len(raw) != n:
        raise ValueError(
            f"truncated RIFF/WAVE file: expected {n} bytes of {what}, "
            f"got {len(raw)}."
        )
    return raw


def wavread(
    path: str,
    frame_offset: int = 0,
    num_frames: Optional[int] = None,
    return_2d: Optional[bool] = None,
    channels_first: Optional[bool] = None,
) -> Tuple[np.ndarray, int]:
    """Read a PCM RIFF/WAVE file.

    Returns ``(waveform, sample_rate)`` where the waveform is float in
    ``[-1, 1)``. Multichannel data is returned 2D; mono is 1D unless
    ``return_2d=True``. ``channels_first=True`` yields ``(n_channels, n_samples)``.

    Corrupted files raise explicit errors mirroring the reference's
    contract (ssspy tests/package/io/test_wavread.py): unsupported
    markers/format tags raise ``NotImplementedError``; inconsistent
    sizes/rates and truncation raise ``ValueError``.
    """
    with open(path, "rb") as f:
        _expect(
            _read_exact(f, 4, "RIFF marker") == b"RIFF",
            "Only little-endian RIFF files are supported.",
        )
        _ = struct.unpack("<I", _read_exact(f, 4, "file size"))[0]
        _expect(_read_exact(f, 4, "WAVE marker") == b"WAVE", "Not a WAVE file.")

        _expect(
            _read_exact(f, 4, "fmt chunk marker") == b"fmt ", "Expected 'fmt ' chunk."
        )
        fmt_size = struct.unpack("<I", _read_exact(f, 4, "fmt chunk size"))[0]
        _expect(fmt_size == 16, "malformed RIFF/WAVE header.")
        fmt_tag = struct.unpack("<H", _read_exact(f, 2, "format tag"))[0]
        _expect(fmt_tag == _PCM_FORMAT, f"Invalid header {fmt_tag} is detected.")
        n_channels, sample_rate, byte_rate, block_align, bits = struct.unpack(
            "<HIIHH", _read_exact(f, 14, "fmt fields")
        )
        _expect(n_channels > 0, "malformed RIFF/WAVE header.", ValueError)
        _expect(
            bits * sample_rate * n_channels == 8 * byte_rate,
            "malformed RIFF/WAVE header.",
            ValueError,
        )
        _expect(
            block_align * 8 == bits * n_channels,
            "malformed RIFF/WAVE header.",
            ValueError,
        )
        _expect(bits in (8, 16, 32), f"Invalid bits_per_sample={bits} is detected.")

        _expect(
            _read_exact(f, 4, "data chunk marker") == b"data",
            "Expected 'data' chunk.",
        )
        data_size = struct.unpack("<I", _read_exact(f, 4, "data chunk size"))[0]
        bytes_per_sample = block_align // n_channels
        max_frame = data_size // block_align

        if num_frames is None:
            end_frame = max_frame
        elif num_frames >= 0:
            end_frame = frame_offset + num_frames
            if end_frame > max_frame:
                raise ValueError(f"num_frames={num_frames} is beyond the file length ({max_frame} frames).")
        else:
            raise ValueError(f"num_frames must be a nonnegative integer, got {num_frames}.")

        f.seek(block_align * frame_offset, 1)
        n_read = (end_frame - frame_offset) * n_channels
        raw = _read_exact(f, n_read * bytes_per_sample, "PCM frames")
        data = np.frombuffer(raw, dtype=f"<i{bytes_per_sample}")

    if n_channels > 1 or return_2d:
        data = data.reshape(-1, n_channels)
        if channels_first:
            data = data.T

    vmax = 2 ** (8 * bytes_per_sample - 1)
    return data / vmax, sample_rate


def wavwrite(
    path: str,
    waveform: np.ndarray,
    sample_rate: int,
    channels_first: Optional[bool] = None,
) -> None:
    """Write a waveform as a PCM RIFF/WAVE file (float -> int16 scaling)."""
    assert path[-4:] == ".wav", "only RIFF/WAVE files are supported."

    waveform = np.asarray(waveform)

    if waveform.ndim == 1:
        frames = waveform
        n_channels = 1
    elif waveform.ndim == 2:
        frames = waveform.T if channels_first else waveform
        n_channels = frames.shape[1]
        if n_channels < 1 or n_channels > 2:
            raise ValueError(f"unsupported channel count: {n_channels}.")
    else:
        raise ValueError(
            f"waveform must be 1-D or 2-D, got ndim={waveform.ndim}."
        )

    if frames.dtype.kind == "f":
        bits = 16
        frames = (frames * 2 ** (bits - 1)).astype("<i2")
    elif frames.dtype == np.int8:
        bits = 8
    elif frames.dtype == np.int16:
        bits = 16
        frames = frames.astype("<i2")
    else:
        raise ValueError(f"Invalid dtype={frames.dtype} is detected.")

    byte_rate = (bits * sample_rate * n_channels) // 8
    block_align = byte_rate // sample_rate
    payload = np.ascontiguousarray(frames).tobytes()

    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 4 + 24 + 8 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<I", 16))
        f.write(struct.pack("<H", _PCM_FORMAT))
        f.write(struct.pack("<HIIHH", n_channels, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
