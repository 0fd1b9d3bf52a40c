"""Numerically stable softmax and log-sum-exp over an axis (``None``: every element).

Counterparts of ``ssspy_tpu.special.softmax`` and
``ssspy_tpu.special.logsumexp`` (parity: ssspy/special/softmax.py:4-36,
logsumexp.py:4-40) on torch tensors: the maximum is subtracted before the
exponential.
"""

from typing import Optional, Sequence, Union

import torch

__all__ = ["softmax", "logsumexp"]

Axis = Optional[Union[int, Sequence[int]]]


def _dims(X: torch.Tensor, axis: Axis):
    if axis is None:
        return tuple(range(X.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def softmax(X: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """``exp(X - max) / sum exp(X - max)`` over ``axis``."""
    dims = _dims(X, axis)
    exp = torch.exp(X - torch.amax(X, dim=dims, keepdim=True))
    return exp / torch.sum(exp, dim=dims, keepdim=True)


def logsumexp(X: torch.Tensor, axis: Axis = None, keepdims: bool = False) -> torch.Tensor:
    """``log(sum(exp(X)))`` over ``axis``, as ``log(sum(exp(X - max))) + max``."""
    dims = _dims(X, axis)
    vmax = torch.amax(X, dim=dims, keepdim=True)
    v = torch.log(torch.sum(torch.exp(X - vmax), dim=dims, keepdim=True)) + vmax
    return v if keepdims else v.squeeze(dims)
