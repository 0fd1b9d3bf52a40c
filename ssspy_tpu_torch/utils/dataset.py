"""Synthetic inputs: the main path's 8-channel, 10 s, 16 kHz convolutive mixture and the hard scenario.

numpy-only copies of ``bench.make_mixture`` / ``bench.host_stft``
(bench.py:45-75), the ``np.convolve`` branch, of
``ssspy_tpu.utils.dataset.download_sample_speech_data``'s synthetic
mixture (the easy tier of tests/test_fast_fidelity.py) and of
``ssspy_tpu.utils.dataset.hard_speech_mixture`` with its helpers
(ssspy_tpu/utils/dataset/__init__.py:17-67, :70-118, :133-282), without
their file cache, so that the port and ``chip_smoke.py`` build these
inputs without the JAX package.
"""

from typing import Tuple

import numpy as np

__all__ = [
    "make_mixture",
    "host_stft",
    "sample_speech_mixture",
    "hard_speech_mixture",
    "SAMPLE_RATE",
    "N_CHANNELS",
    "DURATION_S",
    "N_FFT",
    "HOP",
]

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


# ---- the easy tier: syllabic pseudo-speech through sparse echoes ----------------------


def _synthetic_speech_like(rng: np.random.Generator, n_samples: int, sample_rate: int) -> np.ndarray:
    """Harmonics and a wideband burst under one sparse syllabic envelope, peak 1."""
    t = np.arange(n_samples) / sample_rate
    f0 = rng.uniform(90.0, 250.0)
    smooth = int(0.12 * sample_rate)
    env = 0.15 + 0.85 * _sparse_envelope(rng, n_samples, 4.0, sample_rate, smooth)
    sig = np.zeros(n_samples)
    for k in range(1, 6):
        sig += np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
    sig += 0.5 * rng.standard_normal(n_samples)
    sig = env * sig
    return sig / np.max(np.abs(sig))


def _synthetic_rir(rng: np.random.Generator, n_channels: int, n_taps: int, decay: float = 0.995) -> np.ndarray:
    """A direct path and 24 exponentially decaying echoes per channel."""
    rir = np.zeros((n_channels, n_taps))
    for ch in range(n_channels):
        direct = rng.integers(4, 16)
        rir[ch, direct] = 1.0
        pos = rng.integers(direct + 1, n_taps, size=24)
        rir[ch, pos] += rng.standard_normal(24) * (decay**pos) * 0.5
    return rir


def sample_speech_mixture(
    n_sources: int = 3,
    max_duration: float = 10.0,
    conv: bool = True,
    seed: int = 42,
    sample_rate: int = 16000,
) -> Tuple[np.ndarray, int]:
    """The synthetic sample mixture: ``(waveform_src_img (n_sources, n_channels, n_samples), sample_rate)``.

    ``n_sources`` speech-like sources, convolved with sparse echo responses
    (``conv``) or mixed instantaneously, ``n_channels == n_sources``; the
    draws of the JAX package's ``download_sample_speech_data``, in its
    order, so the same arguments give the same mixture.
    """
    n_samples = int(max_duration * sample_rate)
    rng = np.random.default_rng(seed + 1000 * n_sources + (1 if conv else 0))
    sources = np.stack([_synthetic_speech_like(rng, n_samples, sample_rate) for _ in range(n_sources)])
    if not conv:
        mixing = rng.standard_normal((n_sources, n_sources))
        return mixing.T[:, :, None] * sources[:, None, :], sample_rate
    n_taps = min(2048, n_samples // 4)
    images = np.zeros((n_sources, n_sources, n_samples))
    for src in range(n_sources):
        rir = _synthetic_rir(rng, n_sources, n_taps)
        for ch in range(n_sources):
            images[src, ch] = np.convolve(sources[src], rir[ch])[:n_samples]
    return images, sample_rate


# ---- the hard scenario: formant pseudo-speech in reverberant rooms ----------------------


def _sparse_envelope(rng, n_samples, events_per_sec, sample_rate, smooth):
    """Sparse syllabic on/off envelope (independent across sources)."""
    smooth = max(1, min(smooth, n_samples))  # convolve("same") follows the longer operand
    onsets = rng.random(n_samples) < events_per_sec / sample_rate
    env = np.convolve(onsets.astype(float), np.ones(smooth), mode="same")
    return np.clip(env, 0.0, 1.0)


def _smooth_walk(rng, n, smooth):
    """Slowly-varying random walk in [0, 1] (smoothed uniform noise)."""
    coarse = rng.random(n // smooth + 2)
    x = np.interp(np.arange(n) / smooth, np.arange(coarse.size), coarse)
    return x


def _formant_speech(rng: np.random.Generator, n_samples: int, sample_rate: int):
    """Formant-modulated pseudo-speech.

    Harmonic excitation with a drifting fundamental, gated by a syllabic
    envelope, plus noise "consonant" bursts; the spectral envelope is a
    set of three formant resonance peaks whose center frequencies wander
    between vowel targets (applied by Hann overlap-add block filtering).
    Speech-like in the properties separation keys on: co-modulating
    super-Gaussian bins, harmonic structure, formant spectral sparsity.
    """
    t = np.arange(n_samples) / sample_rate

    # drifting fundamental: +-4 semitones around a per-speaker base
    f0_base = rng.uniform(95.0, 230.0)
    drift = _smooth_walk(rng, n_samples, int(0.25 * sample_rate))
    f0 = f0_base * 2 ** ((drift - 0.5) * (8 / 12))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate

    # sparser than the easy generator (5% floor, 2.5 events/s): at
    # >=0.3 s RT60 the per-bin instantaneous-mixing model only holds
    # approximately, and measured separability hinges on strong temporal
    # sparsity (0.15/3.5 leaves AuxIVA at ~0 dB improvement; 0.05/2.5
    # recovers ~8-11 dB at n_fft=4096)
    smooth = int(0.12 * sample_rate)
    env = 0.05 + 0.95 * _sparse_envelope(rng, n_samples, 2.5, sample_rate, smooth)

    voiced = np.zeros(n_samples)
    for k in range(1, 13):
        voiced += np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k
    burst_env = _sparse_envelope(
        rng, n_samples, 2.0, sample_rate, int(0.04 * sample_rate)
    )
    sig = env * (voiced + 0.4 * burst_env * rng.standard_normal(n_samples))

    # formant shaping: block overlap-add with per-block formant envelopes
    n_fft, hop = 1024, 512
    window = np.hanning(n_fft)
    freqs = np.fft.rfftfreq(n_fft, 1 / sample_rate)
    n_blocks = max(1, (n_samples - n_fft) // hop + 1)
    centers = np.stack(
        [
            300 + 600 * _smooth_walk(rng, n_blocks, 8),  # F1
            900 + 1500 * _smooth_walk(rng, n_blocks, 8),  # F2
            2400 + 900 * _smooth_walk(rng, n_blocks, 8),  # F3
        ]
    )  # (3, n_blocks)
    bw = np.array([90.0, 140.0, 220.0])[:, None]
    out = np.zeros(n_samples + n_fft)
    for b in range(n_blocks):
        seg = sig[b * hop : b * hop + n_fft]
        if seg.size < n_fft:
            seg = np.pad(seg, (0, n_fft - seg.size))
        spec = np.fft.rfft(seg * window)
        shape = np.sum(
            np.exp(-0.5 * ((freqs[None, :] - centers[:, b : b + 1]) / bw) ** 2),
            axis=0,
        )
        shape = (0.12 + shape) / (1 + (freqs / 3500.0) ** 4)  # rolloff
        out[b * hop : b * hop + n_fft] += np.fft.irfft(spec * shape, n_fft) * window
    out = out[:n_samples]
    peak = np.max(np.abs(out))
    return out / peak if peak > 0 else out


def _reverberant_rir(
    rng: np.random.Generator,
    n_channels: int,
    sample_rate: int,
    rt60: float = 0.35,
):
    """Dense exponentially-decaying room response at a target RT60.

    Direct path with per-channel delays (source direction), sparse early
    reflections inside 50 ms, then a dense Gaussian tail decaying at
    ``10^(-3 t / rt60)`` (the -60 dB-at-RT60 law) — the same energy
    profile as the measured MIRD responses the reference convolves with
    (ssspy/utils/dataset/mird.py:10-86), synthesized deterministically.
    """
    n_taps = int(rt60 * 1.25 * sample_rate)
    t = np.arange(n_taps) / sample_rate
    decay = 10 ** (-3 * t / rt60)
    rir = np.zeros((n_channels, n_taps))
    base_delay = rng.integers(8, 24)
    for ch in range(n_channels):
        direct = base_delay + rng.integers(0, 6)
        rir[ch, direct] = 1.0
        n_early = 12
        early_pos = rng.integers(direct + 8, int(0.05 * sample_rate), size=n_early)
        rir[ch, early_pos] += rng.uniform(-0.7, 0.7, size=n_early)
        tail_start = direct + int(0.008 * sample_rate)
        tail = rng.standard_normal(n_taps) * decay * 0.35
        tail[:tail_start] = 0.0
        rir[ch] += tail
    return rir



def hard_speech_mixture(
    n_sources: int = 4,
    duration: float = 10.0,
    rt60: float = 0.35,
    sample_rate: int = 16000,
    seed: int = 0,
) -> Tuple[np.ndarray, int]:
    """Deterministic hard separation scenario: ``(waveform_src_img (n_sources, n_channels, n_samples), sample_rate)``.

    ``n_sources`` formant-modulated pseudo-speech sources, each convolved
    with an ``rt60``-second dense room response (``n_channels ==
    n_sources``); the draws of the JAX package's generator, in its order.
    """
    n_samples = int(duration * sample_rate)
    rng = np.random.default_rng(seed + 7919 * n_sources)
    sources = np.stack([_formant_speech(rng, n_samples, sample_rate) for _ in range(n_sources)])
    images = np.zeros((n_sources, n_sources, n_samples))
    for src in range(n_sources):
        rir = _reverberant_rir(rng, n_sources, sample_rate, rt60=rt60)
        for ch in range(n_sources):
            images[src, ch] = np.convolve(sources[src], rir[ch])[:n_samples]
    return images, sample_rate
