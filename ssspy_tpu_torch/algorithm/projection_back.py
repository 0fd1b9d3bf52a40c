"""Projection-back scale restoration (parity: ssspy/algorithm/projection_back.py:6-121).

Counterpart of :func:`ssspy_tpu.algorithm.projection_back`. Two modes,
both batched over bins:

- filter mode (``reference=None``): rescale each demixing-filter row by the
  corresponding column of ``W^{-1}`` at the reference channel;
- data mode: least-squares rescale of separated spectrograms against the
  reference-channel mixture.

Inverses use ``torch.linalg.inv_ex``: a singular bin gives non-finite
values, as in the JAX package, instead of an exception (and no host sync
on CUDA).
"""

from typing import Optional

import torch

__all__ = ["projection_back"]


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A)[0]


def projection_back(
    data_or_filter: torch.Tensor,
    reference: Optional[torch.Tensor] = None,
    reference_id: Optional[int] = 0,
) -> torch.Tensor:
    """Restore the scale ambiguity of separated signals.

    Args:
        data_or_filter: demixing filters ``(*, N, M)`` when ``reference`` is
            ``None``, otherwise separated spectrograms ``(N, I, T)``.
        reference: mixture spectrogram ``(M, I, T)`` (data mode only).
        reference_id: reference channel; ``None`` returns per-channel scalings.

    Returns:
        Rescaled filters or spectrograms.
    """
    if reference is None:
        W = data_or_filter  # (*, n_sources, n_channels)
        scale = _inv(W)  # (*, n_channels, n_sources)
        if reference_id is None:
            scale = torch.movedim(scale[..., None], -3, 0)  # (n_channels, *, n_sources, 1)
            return W * scale
        return W * scale[..., reference_id, :, None]

    Y = data_or_filter.transpose(-3, -2)  # (*, n_bins, n_sources, n_frames)
    X = reference.transpose(-3, -2)  # (*, n_bins, n_channels, n_frames)
    YH = Y.transpose(-2, -1).conj()
    scale = (X @ YH) @ _inv(Y @ YH)  # (*, n_bins, n_channels, n_sources)

    if reference_id is None:
        scale = torch.movedim(scale, -2, 0)  # (n_channels, *, n_bins, n_sources)
        return (Y * scale[..., None]).transpose(-3, -2)
    return (Y * scale[..., reference_id, :, None]).transpose(-3, -2)
