"""Whitening (parity: ssspy/transform/whiten.py:4-94).

Counterpart of :mod:`ssspy_tpu.transform.whiten` on the batched core of
:mod:`ssspy_tpu_torch.transform.pca`: ``y = Lambda^-1/2 V^H x`` per
covariance slice. FastIVA whitens its spectrogram with
:func:`ssspy_tpu_torch.ops.fixed_point_iva_steps.whiten_spectrogram`, the
embedded eigh of the fast path (K7 in float32).
"""

import torch

from ..utils.device import DEFAULT_DEVICE
from .pca import _channel_axis, _covariance_eigh, _on_device

__all__ = ["whiten"]


def whiten(input, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Sphere the channel axis: the sample covariance becomes the identity.

    Layouts as in the reference: 2D real ``(M, T)``, 3D complex
    ``(M, I, T)``, 3D real ``(B, M, T)``, 4D complex ``(B, M, I, T)``.
    ``device``: the card by default, ``"cpu"`` on the CPU.
    """
    input = _on_device(input, device)
    ch_axis = _channel_axis(input)
    X = torch.movedim(input, ch_axis, -1)  # (*, n_samples or frames, M)
    lamb, V = _covariance_eigh(X)
    Y = (X @ V.conj()) / torch.sqrt(lamb)[..., None, :].to(X.dtype)
    return torch.movedim(Y, -1, ch_axis)
