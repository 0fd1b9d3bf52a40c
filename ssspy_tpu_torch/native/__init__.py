"""ctypes bindings of the native host runtime: the WAV codec, the convolutive mixer and the resampler (ssspy_native.cpp).

The port's own copy of :mod:`ssspy_tpu.native`, with its functions and
their errors. The shared library is built with ``g++`` on first use from
the source beside this module into ``ssspy_tpu_torch/_build/`` as
``libssspy_native-<hash>.so`` (the hash covers the source and the flags,
so an edited source is rebuilt), with OpenMP where the compiler has it.
It never loads another copy of the library. A missing ``g++`` or a
failed build is kept: :func:`available` is False and every function
raises with the compiler's message; nothing falls back to another
implementation.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

__all__ = [
    "load",
    "available",
    "wav_info",
    "wav_read",
    "wav_write_i16",
    "convolutive_mix",
    "resample",
    "build_error",
]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ssspy_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
FLAGS = ["-O3", "-shared", "-fPIC"]
OPENMP = "-fopenmp"

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def library_path() -> str:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS + [OPENMP]).encode())
    return os.path.join(BUILD_DIR, f"libssspy_native-{h.hexdigest()[:16]}.so")


def _compile(target: str) -> None:
    """Build ``target`` with ``g++``, with OpenMP and, where that fails, without; raise with both outputs."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found in PATH: the native codec of ssspy_tpu_torch is built from source on first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    logs = []
    try:
        for extra in ([OPENMP], []):
            cmd = [gxx, *FLAGS, *extra, "-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode == 0:
                os.replace(tmp, target)
                return
            logs.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise RuntimeError("g++ failed to build the native codec:\n" + "\n".join(logs))


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; ``None`` where the build failed (:func:`build_error` says why)."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            target = library_path()
            try:
                if not os.path.exists(target):
                    _compile(target)
                _lib = _bind(ctypes.CDLL(target))
            except (OSError, RuntimeError, subprocess.SubprocessError) as error:
                _build_error = str(error)
    return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return load() is not None


def build_error() -> Optional[str]:
    """The compiler's (or loader's) message of a failed build; ``None`` where it built."""
    load()
    return _build_error


def _library() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native codec of ssspy_tpu_torch is unavailable: {_build_error}")
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ssspy_wav_info.restype = ctypes.c_int
    lib.ssspy_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ssspy_wav_read_f32.restype = ctypes.c_int
    lib.ssspy_wav_read_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.ssspy_wav_write_i16.restype = ctypes.c_int
    lib.ssspy_wav_write_i16.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.ssspy_resample.restype = ctypes.c_int
    lib.ssspy_resample.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.ssspy_convolutive_mix.restype = ctypes.c_int
    lib.ssspy_convolutive_mix.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    return lib


def wav_info(path: str):
    """``(n_channels, sample_rate, bits, n_frames)`` by the native parser."""
    lib = _library()
    ch, sr, bits, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = lib.ssspy_wav_info(
        path.encode(), ctypes.byref(ch), ctypes.byref(sr), ctypes.byref(bits), ctypes.byref(frames)
    )
    if rc != 0:
        raise _error(rc, path)
    return ch.value, sr.value, bits.value, frames.value


def wav_read(path: str, frame_offset: int = 0, num_frames: Optional[int] = None):
    """Decode to float32 ``(num_frames, n_channels)`` and the sample rate."""
    lib = _library()
    n_channels, sample_rate, _, total = wav_info(path)
    if num_frames is None:
        num_frames = total - frame_offset
    out = np.empty((num_frames, n_channels), dtype=np.float32)
    rc = lib.ssspy_wav_read_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frame_offset, num_frames
    )
    if rc != 0:
        raise _error(rc, path)
    return out, sample_rate


def wav_write_i16(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write interleaved int16 ``(n_frames, n_channels)`` PCM, any channel count."""
    lib = _library()
    data = np.ascontiguousarray(data, dtype=np.int16)
    if data.ndim == 1:
        data = data[:, None]
    rc = lib.ssspy_wav_write_i16(
        path.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), data.shape[1], data.shape[0], sample_rate
    )
    if rc != 0:
        raise _error(rc, path)


def convolutive_mix(sources: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """FIR mixture ``mix[m] = sum_n convolve(src[n], taps[m, n], "same")``.

    ``sources``: ``(n_sources, n_samples)``; ``taps``: ``(n_mics,
    n_sources, n_taps)``. OpenMP-parallel over output channels.
    """
    lib = _library()
    sources = np.ascontiguousarray(sources, dtype=np.float64)
    taps = np.ascontiguousarray(taps, dtype=np.float64)
    n_sources, n_samples = sources.shape
    n_mics = taps.shape[0]
    if taps.shape[1] != n_sources:
        raise ValueError(f"taps {taps.shape} do not match {n_sources} sources")
    out = np.empty((n_mics, n_samples), dtype=np.float64)
    rc = lib.ssspy_convolutive_mix(
        sources.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_sources,
        n_mics,
        n_samples,
        taps.shape[2],
    )
    if rc != 0:
        raise _error(rc, "convolutive_mix")
    return out


def resample(waveform: np.ndarray, orig_rate: int, target_rate: int, half_width: int = 32) -> np.ndarray:
    """Windowed-sinc resampling of ``(..., n_samples)`` signals.

    Rational-rate polyphase interpolation with a Hann-windowed sinc of
    ``half_width`` zero crossings per side (anti-aliased when
    downsampling), the role scipy's resampling plays in the reference
    dataset pipeline (ssspy/utils/dataset/mird.py:76-86).
    """
    lib = _library()
    g = math.gcd(orig_rate, target_rate)
    p, q = target_rate // g, orig_rate // g
    x = np.ascontiguousarray(waveform, dtype=np.float64)
    flat = x.reshape(-1, x.shape[-1])
    n_out = -(-x.shape[-1] * p // q)  # ceil
    out = np.empty((flat.shape[0], n_out), dtype=np.float64)
    for row_in, row_out in zip(flat, out):
        rc = lib.ssspy_resample(
            row_in.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            row_in.shape[0],
            row_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_out,
            p,
            q,
            half_width,
        )
        if rc != 0:
            raise _error(rc, "resample")
    return out.reshape(x.shape[:-1] + (n_out,))


def _error(rc: int, path: str) -> Exception:
    messages = {
        -1: f"Cannot open {path}.",
        -2: "malformed RIFF/WAVE header.",
        -3: "Unsupported WAV format.",
        -4: "Frame range out of bounds.",
        -5: "I/O error.",
    }
    cls = NotImplementedError if rc == -3 else ValueError
    return cls(messages.get(rc, f"native error {rc}"))
