"""Synthetic main-path input: an 8-channel, 10 s, 16 kHz convolutive mixture.

numpy-only copy of ``bench.make_mixture`` / ``bench.host_stft``
(bench.py:45-75), the ``np.convolve`` branch, so the port and
``chip_smoke.py`` can build the benchmark's input without the JAX package.
"""

import numpy as np

__all__ = ["make_mixture", "host_stft", "SAMPLE_RATE", "N_CHANNELS", "DURATION_S", "N_FFT", "HOP"]

N_CHANNELS = 8
SAMPLE_RATE = 16_000
DURATION_S = 10.0
N_FFT, HOP = 512, 256


def make_mixture(seed: int = 0, n_channels: int = N_CHANNELS, duration_s: float = DURATION_S) -> np.ndarray:
    """Laplace sources at 16 kHz through random decaying 32-tap filters.

    Returns ``(n_channels, n_samples)`` float64.
    """
    rng = np.random.default_rng(seed)
    n_samples = int(SAMPLE_RATE * duration_s)
    sources = rng.laplace(size=(n_channels, n_samples))
    taps = rng.standard_normal((n_channels, n_channels, 32)) * np.exp(-0.2 * np.arange(32))
    mix = np.zeros_like(sources)
    for m in range(n_channels):
        for n in range(n_channels):
            mix[m] += np.convolve(sources[n], taps[m, n], mode="same")
    return mix


def host_stft(x: np.ndarray, n_fft: int = N_FFT, hop: int = HOP) -> np.ndarray:
    """scipy-convention STFT on the host: ``(*, n_samples) -> (*, n_bins, n_frames)`` complex."""
    win = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    n_frames = (x.shape[-1] - n_fft) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[..., idx] * win
    return np.fft.rfft(frames, axis=-1).swapaxes(-2, -1) / win.sum()
