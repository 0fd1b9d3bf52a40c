"""The benchmark's inputs: seeded convolutive mixtures, and the pool of requests a cell cycles through.

:func:`make_mixture` is a frozen copy of the repository's synthetic
mixture (``bench.py:45-65``; the numpy copy the port carries is
``ssspy_tpu_torch.utils.dataset.make_mixture``): Laplace sources at 16 kHz
through random decaying 32-tap filters. It is copied, not imported, so that
the yardstick stays as it is whatever later changes make of the program.
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

SAMPLE_RATE = 16_000
N_TAPS = 32
TAP_DECAY = 0.2


def make_mixture(seed, n_channels: int = 8, duration_s: float = 10.0, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Laplace sources through random decaying 32-tap filters: ``(n_channels, n_samples)`` float64.

    ``seed``: anything ``numpy.random.default_rng`` takes.
    """
    rng = np.random.default_rng(seed)
    n_samples = int(sample_rate * duration_s)
    sources = rng.laplace(size=(n_channels, n_samples))
    taps = rng.standard_normal((n_channels, n_channels, N_TAPS)) * np.exp(-TAP_DECAY * np.arange(N_TAPS))
    mix = np.zeros_like(sources)
    for m in range(n_channels):
        for n in range(n_channels):
            mix[m] += np.convolve(sources[n], taps[m, n], mode="same")
    return mix


@dataclass
class Request:
    """One call's input: ``waveforms`` float32 ``(B, M, S)`` (batched) or ``(M, S)``; ``draw_seed`` seeds the entry's own draws."""

    index: int
    waveforms: np.ndarray
    draw_seed: int
    audio_seconds: float


def _entropy(seed: int) -> int:
    """The run's seed as non-negative entropy for ``numpy.random.SeedSequence`` (any whole number is taken)."""
    return int(seed) % (1 << 64)


def recording_seed(seed: int, request: int, recording: int) -> int:
    """The mixture seed of one recording of one request of the pool."""
    return int(np.random.SeedSequence([_entropy(seed), request, recording]).generate_state(1, np.uint64)[0])


def draw_seed(seed: int, request: int) -> int:
    """The seed of the ``numpy`` generator handed to an entry that draws its own start (ILRMA's basis and activation)."""
    return int(np.random.SeedSequence([_entropy(seed), request, 1 << 20]).generate_state(1, np.uint64)[0])


def make_pool(seed: int, config: dict, traffic: dict, workers: Optional[int] = None) -> List[Request]:
    """The cell's pool of distinct requests, every one the same size, made from ``seed``.

    Request ``j`` holds ``recordings_per_call`` recordings of
    ``recording_seconds`` at the configuration's channels and rate, each
    from its own seed; batched traffic (more than one recording a call)
    stacks them on a leading axis. The recordings are made on a few host
    threads (``np.convolve`` releases the interpreter lock).
    """
    n_pool = int(traffic["pool"])
    per_call = int(traffic["recordings_per_call"])
    seconds = float(traffic["recording_seconds"])
    jobs = [(j, b) for j in range(n_pool) for b in range(per_call)]

    def one(job):
        j, b = job
        mix = make_mixture(recording_seed(seed, j, b), config["n_channels"], seconds, config["sample_rate"])
        return mix.astype(np.float32)

    with ThreadPoolExecutor(max_workers=workers or min(8, len(jobs))) as pool:
        recordings = list(pool.map(one, jobs))
    requests = []
    for j in range(n_pool):
        batch = np.stack(recordings[j * per_call:(j + 1) * per_call])
        waveforms = batch if per_call > 1 else batch[0]
        requests.append(Request(j, np.ascontiguousarray(waveforms), draw_seed(seed, j), per_call * seconds))
    return requests
