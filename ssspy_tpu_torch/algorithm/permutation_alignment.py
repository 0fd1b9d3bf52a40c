"""Frequency-permutation alignment on tensors (parity: ssspy/algorithm/permutation_alignment.py:12-275).

Counterpart of :mod:`ssspy_tpu.algorithm.permutation_alignment`
(permutation_alignment.py:24-220) and of the fast paths' host aligner
``ssspy_tpu.bss._sc_engine.permutation_align_host`` (_sc_engine.py:181-220).
Each solver is greedy and sequential over frequency bins, with an argmax
over all ``N!`` permutations (``itertools.permutations`` order) at each
step; the walk runs on the input's device, one bin at a time, and the
permutations chosen never cross to the host.

A permutation's score is a sum over sources of pairwise terms, so each
step forms the ``N x N`` matrix of those terms once and reads every
permutation's score from it by a gather, where the JAX package sums
``N! x N x T`` products (at ``N = 8``, 40,320 permutations). ``sequence``
and the extra arrays are ``(n_bins, n_sources, ...)``; every extra array is
permuted in lockstep.
"""

import functools
import itertools
from typing import Callable, Optional

import torch

from ..special.flooring import EPS, identity, max_flooring

__all__ = [
    "permutation_table",
    "correlation_based_permutation_solver",
    "score_based_permutation_solver",
    "permutation_align",
]


@functools.lru_cache(maxsize=None)
def _permutations(n_sources: int) -> torch.Tensor:
    return torch.tensor(list(itertools.permutations(range(n_sources))), dtype=torch.long)


def permutation_table(n_sources: int, device=None) -> torch.Tensor:
    """``(N!, N)`` int64: every permutation of the sources, in ``itertools.permutations`` order (a copy on ``device``)."""
    return _permutations(n_sources).to(device=device, copy=True)


def _check_args(sequence: torch.Tensor, args) -> None:
    if sequence.dim() != 3:
        raise ValueError("expected a 3-D (n_bins, n_sources, n_frames) sequence.")
    for pos_idx, arg in enumerate(args):
        if tuple(arg.shape[:2]) != tuple(sequence.shape[:2]):
            raise ValueError(f"The shape of {pos_idx + 1}th argument is invalid.")


def _permuted(full_perm: torch.Tensor, sequence: torch.Tensor, args):
    """``sequence`` and each of ``args`` with their source axis permuted per bin by ``full_perm (I, N)``."""

    def take(a):
        a = torch.as_tensor(a, device=full_perm.device)
        index = full_perm.reshape(full_perm.shape + (1,) * (a.dim() - 2)).expand(a.shape)
        return torch.gather(a, 1, index)

    out = take(sequence)
    permuted = tuple(take(arg) for arg in args)
    if not permuted:
        return out
    return out, permuted[0] if len(permuted) == 1 else permuted


def _greedy_correlation(P: torch.Tensor) -> torch.Tensor:
    """``full_perm (I, N)`` of the correlation walk over the unit-normalized amplitudes ``P (I, N, T)``.

    Bins are visited in ascending order of their total cross-source
    correlation (a stable sort); at each bin the permutation whose rows
    best match the running criterion (the sum of the aligned bins so far)
    is taken, the first bin keeping its order.
    """
    n_bins, n_sources, _ = P.shape
    perms = permutation_table(n_sources, P.device)
    sources = torch.arange(n_sources, device=P.device)
    correlation = torch.sum(P @ P.transpose(-2, -1), dim=(1, 2))
    order = torch.argsort(correlation, stable=True)
    P_sorted = P[order]
    criterion = P_sorted[0].clone()
    chosen = [sources]
    for k in range(1, n_bins):
        P_bin = P_sorted[k]
        # score(perm) = sum_n sum_t criterion[n, t] P_bin[perm[n], t]
        terms = criterion @ P_bin.T  # (N, N)
        best = perms[torch.argmax(terms[sources, perms].sum(dim=-1))]
        criterion = criterion + P_bin[best]
        chosen.append(best)
    full_perm = torch.empty((n_bins, n_sources), dtype=torch.long, device=P.device)
    full_perm[order] = torch.stack(chosen)
    return full_perm


def correlation_based_permutation_solver(
    sequence: torch.Tensor,
    *args,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
):
    """Greedy bin-by-bin alignment by amplitude correlation (permutation_alignment.py:24-91).

    ``sequence``: ``(n_bins, n_sources, n_frames)``, complex or real; its
    amplitudes are normalized over sources with ``flooring_fn`` before the
    walk. Returns the permuted sequence, and the permuted ``args`` (one
    tensor, or a tuple of them) when given.
    """
    _check_args(sequence, args)
    flooring_fn = identity if flooring_fn is None else flooring_fn
    P = sequence.abs()
    P = P / flooring_fn(torch.sqrt(torch.sum(P**2, dim=1, keepdim=True)))
    return _permuted(_greedy_correlation(P), sequence, args)


def _covariant_index_table(n_bins: int, device=None):
    """Each bin's neighbours (three on each side, its half and its double harmonics), padded: ``(idx, mask)``.

    The neighbourhood of ssspy/algorithm/permutation_alignment.py:222-237,
    laid out as ``ssspy_tpu.algorithm.permutation_alignment._covariant_index_table``
    (permutation_alignment.py:94-117): padded entries point at bin 0 with
    ``mask`` False.
    """
    rows = []
    for bin_idx in range(n_bins):
        lo, hi = max(0, bin_idx - 3), min(n_bins - 1, bin_idx + 3)
        cov = set(range(lo, bin_idx)) | set(range(bin_idx + 1, hi + 1))
        lo, hi = max(0, bin_idx // 2 - 1), min(n_bins - 1, bin_idx // 2 + 1)
        cov |= set(range(lo, hi + 1))
        lo, hi = max(0, 2 * bin_idx - 1), min(n_bins - 1, 2 * bin_idx + 1)
        cov |= set(range(lo, hi + 1))
        rows.append(sorted(cov))
    width = max(len(r) for r in rows)
    idx = torch.zeros((n_bins, width), dtype=torch.long)
    mask = torch.zeros((n_bins, width), dtype=torch.bool)
    for i, r in enumerate(rows):
        idx[i, : len(r)] = torch.tensor(r, dtype=torch.long)
        mask[i, : len(r)] = True
    return idx.to(device), mask.to(device)


def score_based_permutation_solver(
    sequence: torch.Tensor,
    *args,
    global_iter: int = 1,
    local_iter: int = 1,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
):
    """Sawada-style global (centroid) and local (harmonic neighbours) alignment (permutation_alignment.py:120-220).

    ``sequence``: a real ``(n_bins, n_sources, n_frames)`` score sequence
    (a posterior or an amplitude), standardized over frames. ``global_iter``
    rounds align every bin at once to the source centroids, then
    ``local_iter`` sequential passes align each bin to its neighbours, the
    correlations divided by the floored standard deviation of the
    centroids. Returns the permuted sequence, and the permuted ``args`` when
    given.
    """
    _check_args(sequence, args)
    flooring_fn = identity if flooring_fn is None else flooring_fn
    n_bins, n_sources, n_frames = sequence.shape
    device = sequence.device
    perms = permutation_table(n_sources, device)
    sources = torch.arange(n_sources, device=device)
    sign = 2 * torch.eye(n_sources, dtype=sequence.dtype, device=device) - 1  # +1 on the diagonal, -1 off it

    seq_norm = (sequence - sequence.mean(dim=-1, keepdim=True)) / sequence.std(dim=-1, keepdim=True, correction=0)
    full_perm = sources.expand(n_bins, n_sources).clone()

    def scores_of(terms):
        """``terms[..., k, m]``: what source ``k`` placed at ``m`` adds; each permutation's sum over ``m``."""
        return terms[..., perms, sources].sum(dim=-1)

    denom = torch.ones(n_sources, dtype=sequence.dtype, device=device)
    for _ in range(global_iter):
        centroid = seq_norm.mean(dim=0)  # (N, T)
        denom = flooring_fn(centroid.std(dim=-1, correction=0))  # (N,)
        # corr[i, k, n] = mean_t seq_norm[i, k, t] centroid[n, t]; source k at m adds sum_n sign[m, n] corr[i, k, n] / denom[m]
        corr = seq_norm @ centroid.T / n_frames
        best = torch.argmax(scores_of(corr @ sign.T / denom), dim=1)  # (I,)
        perm_max = perms[best]
        seq_norm = torch.gather(seq_norm, 1, perm_max[:, :, None].expand(seq_norm.shape))
        full_perm = torch.gather(full_perm, 1, perm_max)

    cov_idx, cov_mask = _covariant_index_table(n_bins, device)
    weight = cov_mask.to(sequence.dtype)
    for _ in range(local_iter):
        for bin_idx in range(n_bins):
            this = seq_norm[bin_idx]  # (N, T)
            cov = seq_norm[cov_idx[bin_idx]]  # (K, N, T)
            # corr[k, j, n] = mean_t this[j, t] cov[k, n, t], the padded neighbours masked out
            corr = torch.einsum("jt,knt->kjn", this, cov) / n_frames
            terms = torch.einsum("k,kjn,mn->jm", weight[bin_idx], corr, sign) / denom
            best = perms[torch.argmax(scores_of(terms))]
            seq_norm[bin_idx] = this[best]
            full_perm[bin_idx] = full_perm[bin_idx][best]

    return _permuted(full_perm, sequence, args)


def permutation_align(Y: torch.Tensor, *args, eps: float = 1e-10):
    """The fast paths' correlation alignment of separated spectrograms ``Y (I, N, T)``, on ``Y``'s device.

    ``ssspy_tpu.bss._sc_engine.permutation_align_host`` (_sc_engine.py:181-220):
    the amplitudes in float64, each bin first divided by its largest
    amplitude (floored at ``eps``; the unit normalization cancels it, and
    it keeps un-normalized trajectories clear of overflow), normalized over
    sources at ``eps``, then the walk of
    :func:`correlation_based_permutation_solver`. Returns the permuted
    ``Y``, and the permuted ``args`` as a tuple after it when given.
    """
    _check_args(Y, args)
    P = Y.abs().to(torch.float64)
    P = P / torch.clamp(P.amax(dim=(1, 2), keepdim=True), min=eps)
    P = P / torch.clamp(torch.sqrt(torch.sum(P**2, dim=1, keepdim=True)), min=eps)
    full_perm = _greedy_correlation(P)
    out = _permuted(full_perm, Y, args)
    if not args:
        return out
    Y, permuted = out
    return (Y,) + (permuted if isinstance(permuted, tuple) else (permuted,))
