"""End-to-end separation pipeline: waveform -> STFT -> BSS -> iSTFT.

Counterpart of :mod:`ssspy_tpu.pipeline`; every stage runs on the
waveform's device.
"""

from typing import Optional, Union

import numpy as np
import torch

from .transform import istft, stft

__all__ = ["separate"]


def separate(
    waveform,
    method,
    n_iter: int = 100,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray, torch.Tensor] = "hann",
    **kwargs,
) -> torch.Tensor:
    """Separate a time-domain multichannel mixture end to end.

    ``waveform``: real ``(n_channels, n_samples)``, a tensor or an array;
    ``method``: a frequency-domain separator from :mod:`ssspy_tpu_torch.bss`.
    Extra ``kwargs`` are warm-start state forwarded to ``method.__call__``.

    Returns the separated waveforms ``(n_sources, n_samples)``.

    >>> from ssspy_tpu_torch.bss.iva import AuxLaplaceIVA
    >>> y = separate(mixture.cuda(), AuxLaplaceIVA(spatial_algorithm="IP"), n_iter=50)
    """
    waveform = torch.as_tensor(waveform)
    if waveform.dim() != 2:
        raise ValueError("waveform must be (n_channels, n_samples)")
    n_samples = waveform.shape[-1]

    spectrogram = stft(waveform, n_fft=n_fft, hop_length=hop_length, window=window)
    separated = method(spectrogram, n_iter=n_iter, **kwargs)
    return istft(separated, n_fft=n_fft, hop_length=hop_length, window=window, length=n_samples)
