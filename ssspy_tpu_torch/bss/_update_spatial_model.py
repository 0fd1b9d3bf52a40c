"""The reference's public spatial updates: IP1, IP2, ISS1, ISS2, IPA and block-decomposition VCD.

Counterparts of :mod:`ssspy_tpu.bss._update_spatial_model` (parity:
ssspy/bss/_update_spatial_model.py) with its signatures and defaults, on
torch tensors, on the caller's device. Each is a thin wrapper over the
port's routers and steps, with no arithmetic of its own:
:func:`~ssspy_tpu_torch.ops.iva_steps.ip1_update` (K1b),
:func:`~ssspy_tpu_torch.ops.iva_steps.ip2_update` and
:func:`~ssspy_tpu_torch.ops.iva_steps.ip2_pair_update`,
:func:`~ssspy_tpu_torch.ops.iva_steps.iss1_update` (K2),
:func:`~ssspy_tpu_torch.ops.iva_steps.iss2_sweep`,
:func:`~ssspy_tpu_torch.ops.ipa_steps.ipa_sweep` (K1, K7 and K6 in
complex64) and :func:`~ssspy_tpu_torch.ops.ipsdta_steps.vcd_sweep`.

A max-type ``flooring_fn`` (the default ``max_flooring`` at 1e-10, any
partial of it, ``dtype_flooring`` or ``None``) is handed to the routers as
an ``eps``, so complex64 within a kernel's sizes launches the kernel on the
card; any other callable takes the plain routes with the callable where
the JAX function applies it
(:func:`~ssspy_tpu_torch.special.flooring.step_flooring`).
"""

import functools
from typing import Callable, Iterable, Optional, Tuple

import torch

from ..ops.ipa_steps import ipa_sweep
from ..ops.ipsdta_steps import vcd_sweep
from ..ops.iva_steps import ip2_pair_update, ip2_update, ip1_update, iss1_update, iss2_sweep
from ..special.flooring import EPS, identity, max_flooring, step_flooring
from ..utils.select_pair import sequential_pair_selector

__all__ = [
    "update_by_ip1",
    "update_by_ip2",
    "update_by_ip2_one_pair",
    "update_by_iss1",
    "update_by_iss2",
    "update_by_ipa",
    "update_by_block_decomposition_vcd",
]

PairSelector = Callable[[int], Iterable[Tuple[int, int]]]


def _flooring(flooring_fn: Optional[Callable], dtype: torch.dtype) -> dict:
    """``eps`` and ``flooring_fn`` for the routers: ``None`` is the identity, as the JAX functions take it."""
    eps, floor = step_flooring(identity if flooring_fn is None else flooring_fn, dtype)
    return {"eps": eps, "flooring_fn": floor}


def _weight(weight: torch.Tensor) -> torch.Tensor:
    """The JAX functions' ``(N, I, T)`` weight, or ``(N, 1, T)`` broadcast over the bins, as the routers take it."""
    weight = torch.as_tensor(weight)
    return weight[:, 0] if weight.dim() == 3 and weight.shape[1] == 1 else weight


def update_by_ip1(
    demix_filter: torch.Tensor,
    weighted_covariance: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    overwrite: bool = True,
) -> torch.Tensor:
    """The IP1 sweep of ``demix_filter (I, N, M)`` over ``weighted_covariance (I, N, M, M)``; returns the new filters.

    :func:`~ssspy_tpu_torch.ops.iva_steps.ip1_update`: K1b for complex64
    with a max-type floor within its sizes. ``overwrite`` is accepted and
    ignored, as in the JAX function (the input is never modified).
    """
    W = torch.as_tensor(demix_filter)
    return ip1_update(W, torch.as_tensor(weighted_covariance), **_flooring(flooring_fn, W.dtype))


def update_by_ip2(
    demix_filter: torch.Tensor,
    weighted_covariance: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    pair_selector: Optional[PairSelector] = None,
    overwrite: bool = True,
) -> torch.Tensor:
    """The IP2 sweep over ``pair_selector``'s pairs (sequential by default); returns the new filters ``(I, N, M)``."""
    W = torch.as_tensor(demix_filter)
    return ip2_update(
        W, torch.as_tensor(weighted_covariance), pair_selector=pair_selector, **_flooring(flooring_fn, W.dtype)
    )


def update_by_ip2_one_pair(
    demix_filter: torch.Tensor,
    weighted_covariance_pair: torch.Tensor,
    pair: Tuple[int, int],
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
) -> torch.Tensor:
    """One IP2 pair update from the pair's covariances ``(I, 2, M, M)``; returns its new rows ``(I, 2, M)``."""
    W = torch.as_tensor(demix_filter)
    U = torch.as_tensor(weighted_covariance_pair)
    return ip2_pair_update(W, U[:, 0], U[:, 1], pair, **_flooring(flooring_fn, W.dtype))


def update_by_iss1(
    separated: torch.Tensor,
    weight: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
) -> torch.Tensor:
    """The ISS1 sweep of ``separated (N, I, T)`` with ``weight (N, I, T)`` (or ``(N, 1, T)``); returns the new ``Y``.

    :func:`~ssspy_tpu_torch.ops.iva_steps.iss1_update`: K2 for complex64
    with a max-type floor and float32 weights within its sizes.
    """
    Y = torch.as_tensor(separated)
    return iss1_update(Y, _weight(weight), **_flooring(flooring_fn, Y.dtype))


def update_by_iss2(
    separated: torch.Tensor,
    weight: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    pair_selector: Optional[PairSelector] = None,
) -> torch.Tensor:
    """The ISS2 sweep; ``pair_selector`` defaults to every other neighbour pair (``step=2``), as the JAX function's."""
    Y = torch.as_tensor(separated)
    if pair_selector is None:
        pair_selector = functools.partial(sequential_pair_selector, stop=Y.shape[0], step=2)
    return iss2_sweep(Y, _weight(weight), pair_selector=pair_selector, **_flooring(flooring_fn, Y.dtype))


def update_by_ipa(
    separated: torch.Tensor,
    weight: torch.Tensor,
    normalization: bool = True,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    max_iter: int = 1,
) -> torch.Tensor:
    """The IPA sweep (:func:`~ssspy_tpu_torch.ops.ipa_steps.ipa_sweep`); ``normalization`` and ``max_iter`` are its
    ``lqpqm_normalization`` and ``newton_iter``. complex64 with a max-type floor takes the congruence sweep (K1, K7, K6)."""
    Y = torch.as_tensor(separated)
    return ipa_sweep(
        Y, _weight(weight), lqpqm_normalization=normalization, newton_iter=max_iter, **_flooring(flooring_fn, Y.dtype)
    )


def update_by_block_decomposition_vcd(
    demix_filter: torch.Tensor,
    weighted_covariance: torch.Tensor,
    singular_fn: Optional[Callable] = None,
    overwrite: bool = True,
) -> torch.Tensor:
    """One VCD sweep of ``demix_filter (B, J, N, M)`` over ``weighted_covariance (B, J, J, N, M, M)``.

    :func:`~ssspy_tpu_torch.ops.ipsdta_steps.vcd_sweep` with
    ``singular_fn(xi_hat)`` as its singular test, ``xi_hat == 0`` by
    default as in the JAX function. No kernel.
    """
    if singular_fn is None:

        def singular_fn(x):
            return x == 0

    return vcd_sweep(torch.as_tensor(demix_filter), torch.as_tensor(weighted_covariance), singular_fn=singular_fn)
