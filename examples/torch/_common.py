"""Shared helpers of the PyTorch + CUDA example scripts (``ssspy_tpu_torch``).

The same mixture, SI-SDR report and WAV output as ``examples/_common.py``,
with nothing of JAX: the mixture comes from
``ssspy_tpu_torch.utils.dataset.download_sample_speech_data`` and the
WAVs are written by ``ssspy_tpu_torch.wavwrite``. Every script runs on the
card unless it is given ``--device cpu``, and writes its WAVs under
``--out`` (``examples/torch/out/`` by default).
"""

import argparse
import itertools
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # run from anywhere without installing

OUT_DIR = os.path.join(HERE, "out")


def make_mixture(n_sources=3, duration=4.0, seed=0, cache_dir=None):
    """Synthetic convolutive speech-like mixture + ground-truth images: ``(mix (M, n_samples), images (N, M, n_samples))``.

    The file cache is the JAX package's layout, under the temporary
    directory unless ``cache_dir`` is given.
    """
    from ssspy_tpu_torch.utils.dataset import download_sample_speech_data

    images, _ = download_sample_speech_data(
        cache_dir=cache_dir or os.path.join(tempfile.gettempdir(), "ssspy_tpu_torch_examples"),
        n_sources=n_sources,
        max_duration=duration,
        conv=True,
        seed=seed,
    )
    return images.sum(axis=0), images


def to_numpy(a):
    """A tensor (on any device) or an array as a numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def si_sdr(est, ref):
    alpha = np.sum(est * ref) / np.sum(ref**2)
    ref = alpha * ref
    return 10 * np.log10(np.sum(ref**2) / np.sum((est - ref) ** 2))


def report(y, images, mix):
    """Best-permutation mean SI-SDR improvement over the mixture."""
    y = to_numpy(y)
    n = images.shape[0]
    refs = images[:, 0]
    base = np.mean([si_sdr(mix[0], refs[s]) for s in range(n)])
    best = max(
        np.mean([si_sdr(y[p[s]], refs[s]) for s in range(n)])
        for p in itertools.permutations(range(min(n, y.shape[0])))
    )
    print(f"SI-SDR: mixture {base:.2f} dB -> separated {best:.2f} dB "
          f"(+{best - base:.2f} dB)")
    return best


def save_wavs(y, prefix, out_dir=OUT_DIR, sample_rate=16000):
    """Write each source, peak-normalized, as ``<out_dir>/<prefix>_src<n>.wav``; returns the paths."""
    from ssspy_tpu_torch import wavwrite

    # in float64: in float32 the 1e-9 is lost, a peak of exactly 1.0 becomes 32768 and wraps to -32768 in int16
    y = to_numpy(y).astype(np.float64)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for n in range(y.shape[0]):
        path = os.path.join(out_dir, f"{prefix}_src{n}.wav")
        wavwrite(path, y[n] / (np.abs(y[n]).max() + 1e-9), sample_rate)
        paths.append(path)
    print(f"wrote {y.shape[0]} wavs to {out_dir}/{prefix}_src*.wav")
    return paths


def spectral_norm_scale(X):
    """Max per-bin spectral norm — the PDS/ADMM operator-norm bound
    (what the reference's normalize_by_spectral_norm divides by)."""
    X = to_numpy(X)
    return np.linalg.norm(X.swapaxes(0, 1), ord=2, axis=(-2, -1)).max()


def parser(description, fast=None):
    """The scripts' command line: ``--device`` (``cuda`` by default), ``--out``, and ``--fast`` when ``fast`` names its path."""
    p = argparse.ArgumentParser(description=description)
    if fast:
        p.add_argument("--fast", action="store_true", help=fast)
    p.add_argument("--device", default="cuda", help="where the separation runs: cuda (default) or cpu")
    p.add_argument("--out", default=OUT_DIR, help="directory of the separated WAVs (default: examples/torch/out)")
    return p
