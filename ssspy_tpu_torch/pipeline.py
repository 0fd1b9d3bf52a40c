"""End-to-end separation pipeline: waveform -> STFT -> BSS -> iSTFT.

Counterpart of :mod:`ssspy_tpu.pipeline`. The transforms run on
``device`` (the card by default), the separator on its own ``device``.
"""

from typing import Optional, Union

import numpy as np
import torch

from .transform import istft, stft
from .utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["separate"]


def separate(
    waveform,
    method,
    n_iter: int = 100,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray, torch.Tensor] = "hann",
    device=DEFAULT_DEVICE,
    **kwargs,
) -> torch.Tensor:
    """Separate a time-domain multichannel mixture end to end.

    ``waveform``: real ``(n_channels, n_samples)``, a tensor or an array,
    moved to ``device`` (the card by default; ``"cpu"`` runs on the CPU).
    ``method``: any frequency-domain separator of :mod:`ssspy_tpu_torch.bss`
    (IVA or ILRMA, with demixing filters or demix-free), which runs on its
    own device. Extra ``kwargs`` are warm-start state forwarded to
    ``method.__call__``.

    Returns the separated waveforms ``(n_sources, n_samples)`` on ``device``.

    >>> from ssspy_tpu_torch.bss import GaussILRMA
    >>> y = separate(mixture, GaussILRMA(n_basis=8, spatial_algorithm="ISS1"), n_iter=50)
    """
    waveform = torch.as_tensor(waveform, device=resolve_device(device))
    if waveform.dim() != 2:
        raise ValueError("waveform must be (n_channels, n_samples)")
    n_samples = waveform.shape[-1]

    spectrogram = stft(waveform, n_fft=n_fft, hop_length=hop_length, window=window, device=waveform.device)
    separated = method(spectrogram, n_iter=n_iter, **kwargs)
    return istft(separated, n_fft=n_fft, hop_length=hop_length, window=window, length=n_samples,
                 device=waveform.device)
