"""Build and load the hand-written CUDA kernels in ``ops/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``ssspy_tpu_torch/_build/<name>-<hash>.so`` (the hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt), then loaded with
``ctypes``. A missing ``nvcc`` or a failed compile raises with the
compiler's output; nothing falls back to another implementation.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

__all__ = ["load", "find_nvcc", "BUILD_DIR", "SOURCE_DIR", "build_info"]

SOURCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# the toolkit's conventional install root, consulted after PATH and CUDA_HOME
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
# per kernel: seconds spent compiling in this process (0.0 when the library
# was already built) and the compiler's output (ptxas register/spill report)
build_info: Dict[str, dict] = {}
# one lock per kernel, so that threads build different kernels at once
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``PATH``, then ``$CUDA_HOME/bin``, then the default root."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root:
            candidate = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(candidate) and os.access(candidate, os.X_OK):
                return candidate
    raise RuntimeError(
        "nvcc not found (looked in PATH, $CUDA_HOME/bin and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of ssspy_tpu_torch are built "
        "from source on first use and need the CUDA toolkit. CPU tensors take "
        "the plain PyTorch versions and need no toolkit."
    )


def _digest(source: str) -> str:
    """Hash of the source, the headers it may include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    for path in [source] + sorted(glob.glob(os.path.join(SOURCE_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(name: str, source: str) -> str:
    digest = _digest(source)
    target = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(target):
        build_info[name] = {"seconds": 0.0, "log": ""}
        return target

    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info[name] = {
        "seconds": time.perf_counter() - start,
        "log": proc.stderr + proc.stdout,
    }
    return target


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.

    Safe to call from several threads: each kernel has its own lock, so
    different kernels compile in parallel.
    """
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            source = os.path.join(SOURCE_DIR, f"{name}.cu")
            if not os.path.isfile(source):
                raise FileNotFoundError(f"no kernel source {source}")
            lib = ctypes.CDLL(_compile(name, source))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, status: int) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        message = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status} ({message})")
