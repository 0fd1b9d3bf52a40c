"""Pair-selection schedules of the pairwise (IP2, ISS2) updates.

Counterpart of :mod:`ssspy_tpu.utils.select_pair` (parity:
ssspy/utils/select_pair.py:5-76). Each selector yields the ``(m, n)``
source pairs of one sweep, in order; the steps loop over them in Python.
"""

import itertools
from typing import Iterable, Optional, Tuple

__all__ = ["sequential_pair_selector", "combination_pair_selector"]


def sequential_pair_selector(
    n_sources: int, stop: Optional[int] = None, step: int = 1, sort: bool = False
) -> Iterable[Tuple[int, int]]:
    """Yield cyclic neighbour pairs ``(m, m + 1 mod N)`` for ``m`` in ``range(0, stop, step)``."""
    if stop is None:
        stop = n_sources

    for m in range(0, stop, step):
        m, n = m % n_sources, (m + 1) % n_sources
        if sort:
            m, n = (n, m) if m > n else (m, n)
        yield m, n


def combination_pair_selector(n_sources: int, sort: bool = False) -> Iterable[Tuple[int, int]]:
    """Yield every unordered source pair ``(m, n)`` with ``m < n``."""
    for m, n in itertools.combinations(range(n_sources), 2):
        if sort:
            m, n = (n, m) if m > n else (m, n)
        yield m, n
