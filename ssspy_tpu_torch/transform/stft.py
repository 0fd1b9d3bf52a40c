"""STFT / iSTFT matching ``scipy.signal.stft``/``istft`` conventions.

Counterpart of :func:`ssspy_tpu.transform.stft` / ``istft``
(ssspy_tpu/transform/stft.py:25-119) on ``torch.fft.rfft``/``irfft``:

- periodic window (``sym=False``), default Hann,
- ``center=True``: ``n_fft//2`` zeros prepended/appended,
- zero-padding so frames tile the signal exactly,
- forward scaling ``1 / win.sum()``, least-squares overlap-add inverse.

Spectrograms are laid out ``(*, n_bins, n_frames)``. Both transforms run
on ``device``, the card by default (``"cpu"`` runs on the CPU): the input,
a tensor or an array, is moved there before any arithmetic.
"""

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["stft", "istft", "get_window"]


def get_window(
    window: Union[str, np.ndarray, torch.Tensor],
    n: int,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> torch.Tensor:
    """Return a periodic analysis window of length ``n``."""
    if isinstance(window, str):
        k = np.arange(n)
        if window == "hann":
            w = 0.5 - 0.5 * np.cos(2 * np.pi * k / n)
        elif window == "hamming":
            w = 0.54 - 0.46 * np.cos(2 * np.pi * k / n)
        elif window in ("boxcar", "rect", "rectangular"):
            w = np.ones(n)
        else:
            raise ValueError(f"Unsupported window: {window}.")
    else:
        w = window
        if tuple(w.shape) != (n,):
            raise ValueError(f"window shape {tuple(w.shape)} != ({n},)")
    return torch.as_tensor(w).to(device=device, dtype=dtype)


def _frame_index(n_frames: int, n_fft: int, hop_length: int, device) -> torch.Tensor:
    idx = torch.arange(n_frames, device=device)[:, None] * hop_length
    return (idx + torch.arange(n_fft, device=device)[None, :]).reshape(-1)


def stft(
    waveform,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray, torch.Tensor] = "hann",
    center: bool = True,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Short-time Fourier transform of ``(*, n_samples)`` real signals.

    Returns a contiguous complex spectrogram ``(*, n_bins, n_frames)`` with
    ``n_bins = n_fft // 2 + 1``, numerically matching
    ``scipy.signal.stft(x, nperseg=n_fft, noverlap=n_fft - hop_length)[2]``,
    on ``device`` (the card by default; raises without one unless
    ``device="cpu"``).
    """
    if hop_length is None:
        hop_length = n_fft // 2

    x = torch.as_tensor(waveform, device=resolve_device(device))
    win = get_window(window, n_fft, dtype=x.dtype, device=x.device)
    n_samples = x.shape[-1]

    pad_left = n_fft // 2 if center else 0
    total = n_samples + 2 * pad_left
    # pad the tail so (total - n_fft) is a whole number of hops
    n_frames = max(math.ceil((total - n_fft) / hop_length), 0) + 1
    pad_right = (n_frames - 1) * hop_length + n_fft - total + pad_left
    x = F.pad(x, (pad_left, pad_right))

    frames = x.unfold(-1, n_fft, hop_length)  # (*, n_frames, n_fft)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1) / win.sum()
    return spec.transpose(-2, -1).contiguous()


def istft(
    spectrogram,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray, torch.Tensor] = "hann",
    center: bool = True,
    length: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Inverse STFT via least-squares (windowed) overlap-add.

    Accepts ``(*, n_bins, n_frames)`` complex spectrograms from
    :func:`stft` and returns ``(*, n_samples)`` signals, matching
    ``scipy.signal.istft`` for the same window/hop, on ``device`` as
    :func:`stft` takes it.
    """
    if hop_length is None:
        hop_length = n_fft // 2

    spec = torch.as_tensor(spectrogram, device=resolve_device(device))
    n_frames = spec.shape[-1]
    rdtype = spec.real.dtype
    win = get_window(window, n_fft, dtype=rdtype, device=spec.device)

    frames = torch.fft.irfft(spec.transpose(-2, -1), n=n_fft, dim=-1)
    frames = frames * (win.sum() * win)  # undo forward scaling, LS window

    total = (n_frames - 1) * hop_length + n_fft
    idx = _frame_index(n_frames, n_fft, hop_length, spec.device)

    batch_shape = spec.shape[:-2]
    out = torch.zeros(batch_shape + (total,), dtype=rdtype, device=spec.device)
    out.index_add_(-1, idx, frames.reshape(batch_shape + (-1,)))

    norm = torch.zeros(total, dtype=rdtype, device=spec.device)
    norm.index_add_(0, idx, (win**2).repeat(n_frames))
    norm = torch.where(norm > 1e-10, norm, torch.ones_like(norm))
    out = out / norm

    pad_left = n_fft // 2 if center else 0
    out = out[..., pad_left:]
    if length is not None:
        out = out[..., :length]
    return out
