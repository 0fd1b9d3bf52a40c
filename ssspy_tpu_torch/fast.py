"""Production separator entry points.

Counterpart of :mod:`ssspy_tpu.fast`. The JAX package's ``fast_*`` entry
points run planar ``[real, imag]`` f32 scans; here the same iteration runs
on complex64 tensors through the hand-written kernels
(:mod:`ssspy_tpu_torch.ops.kernels`).

>>> Y, W = fast_auxiva(spectrogram, n_iter=100, device="cuda")  # (N,I,T), (I,N,M)
"""

from typing import Optional, Tuple

import torch

from .ops.iva_steps import auxiva_ip1_step, separate

__all__ = ["fast_auxiva"]


def fast_auxiva(
    spectrogram,
    n_iter: int = 100,
    algorithm: str = "IP1",
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """AuxLaplaceIVA-IP1 in complex64 (counterpart of ``ssspy_tpu.fast.fast_auxiva``, fast.py:96-132).

    ``spectrogram``: complex ``(n_channels, n_bins, n_frames)``, a tensor
    or an array. ``device``: where to run; by default the spectrogram's
    own device (the CPU for an array). Every iteration floors with
    ``eps=1e-10`` as the JAX fast path does. With ``scale_restoration``
    each filter row is rescaled by ``W^{-1}`` at ``reference_id``
    (fast.py:116-126), on the same device. Returns
    ``(separated (N, I, T), demix_filter (I, N, M))``.

    Only ``algorithm="IP1"`` is ported; IP2/ISS1/ISS2/IPA wait for
    ROADMAP.md, Queue 1, item 5.
    """
    if algorithm != "IP1":
        raise NotImplementedError(
            f"fast_auxiva(algorithm={algorithm!r}) is not ported to ssspy_tpu_torch yet "
            "(ROADMAP.md, Queue 1, item 5); only 'IP1' is."
        )
    X = torch.as_tensor(spectrogram, device=device).to(torch.complex64).contiguous()
    n_channels, n_bins, _ = X.shape

    W = torch.eye(n_channels, dtype=X.dtype, device=X.device).expand(n_bins, -1, -1).contiguous()
    for _ in range(n_iter):
        W = auxiva_ip1_step(X, W)

    if scale_restoration:
        scale = torch.linalg.inv_ex(W)[0][:, reference_id, :]  # (I, N)
        W = W * scale[:, :, None]
    return separate(X, W), W
