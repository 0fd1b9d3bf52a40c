"""What the plain references share: the scipy-convention STFT and iSTFT, the IP1 sweep, and the precision they run in.

Plain PyTorch, written from the published algorithms (tky823/ssspy's
``AuxLaplaceIVA`` and ``GaussILRMA``, scipy's ``stft``/``istft``): no module
of the program is imported, and nothing the program made is taken.

A reference runs in one of two precisions (:class:`Precision`):

- ``"float64"``: complex128 throughout, the reference that decides ``correct``;
- ``"tf32"``: the control, the step below what the configurations state
  (complex64 with TF32 off): complex64 arithmetic whose matrix products take
  their operands rounded to TF32 (10 mantissa bits, round to nearest even),
  as tensor cores do when TF32 is switched on, and accumulate in float32.
  The rounding is done here rather than by ``allow_tf32``, so the control is
  the same on every device and certain to reach every product.
"""

import math

import torch
import torch.nn.functional as F

from bssbench.metrics.k1_roofline import flops as covariance_flops
from bssbench.metrics.k1b_roofline import flops as sweep_flops

PRECISIONS = ("float64", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, or complex64 part by part) rounded to TF32's 10 mantissa bits, to nearest even."""
    if x.is_complex():
        return torch.view_as_complex(tf32_round(torch.view_as_real(x.resolve_conj()).contiguous()))
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


class Precision:
    """The dtypes and the products of one precision (:data:`PRECISIONS`)."""

    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {name!r}; expected one of {PRECISIONS}")
        self.name = name
        self.tf32 = name == "tf32"
        self.real = torch.float32 if self.tf32 else torch.float64
        self.complex = torch.complex64 if self.tf32 else torch.complex128

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as a matrix product takes it."""
        return tf32_round(x) if self.tf32 else x

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def hann(n_fft: int, dtype, device) -> torch.Tensor:
    """The periodic Hann window (scipy's ``get_window("hann", n_fft)``)."""
    k = torch.arange(n_fft, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / n_fft)).to(dtype)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``scipy.signal.stft`` of real ``(*, S)``: ``(*, n_fft // 2 + 1, frames)``, centred, padded to whole hops, scaled by ``1 / sum(window)``."""
    win = hann(n_fft, x.dtype, x.device)
    pad = n_fft // 2
    total = x.shape[-1] + 2 * pad
    n_frames = max(math.ceil((total - n_fft) / hop), 0) + 1
    x = F.pad(x, (pad, (n_frames - 1) * hop + n_fft - total + pad))
    frames = x.unfold(-1, n_fft, hop)  # (*, frames, n_fft)
    return (torch.fft.rfft(frames * win, dim=-1) / win.sum()).transpose(-2, -1)


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """``scipy.signal.istft``'s least-squares overlap-add of ``(*, bins, frames)``: ``(*, length)``."""
    n_frames = spec.shape[-1]
    real = spec.real.dtype
    win = hann(n_fft, real, spec.device)
    frames = torch.fft.irfft(spec.transpose(-2, -1), n=n_fft, dim=-1) * (win.sum() * win)
    total = (n_frames - 1) * hop + n_fft
    index = (torch.arange(n_frames, device=spec.device)[:, None] * hop + torch.arange(n_fft, device=spec.device)).reshape(-1)
    out = torch.zeros(spec.shape[:-2] + (total,), dtype=real, device=spec.device)
    out.index_add_(-1, index, frames.reshape(spec.shape[:-2] + (-1,)))
    norm = torch.zeros(total, dtype=real, device=spec.device)
    norm.index_add_(0, index, (win * win).repeat(n_frames))
    out = out / torch.where(norm > 1e-10, norm, torch.ones_like(norm))
    return out[..., n_fft // 2:n_fft // 2 + length]


def weighted_covariance(p: Precision, X: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """``U[..., i, n] = mean_t phi[..., n, (i,) t] x_it x_it^H`` of ``X (..., I, M, T)``; ``phi`` ``(..., N, T)`` or ``(..., N, I, T)``."""
    XH = X.transpose(-2, -1).conj()
    per_bin = phi.dim() == X.dim()
    out = []
    for n in range(phi.shape[-2 if not per_bin else -3]):
        w = phi[..., n, :, :] if per_bin else phi[..., n, :].unsqueeze(-2)  # (..., I, T) or (..., 1, T)
        out.append(p.matmul(X * w.unsqueeze(-2), XH))
    return torch.stack(out, dim=-3) / X.shape[-1]


def ip1_sweep(p: Precision, W: torch.Tensor, U: torch.Tensor, eps: float) -> torch.Tensor:
    """One sequential IP1 sweep over the sources (Ono, 2011): ``w_n = (W U_n)^-1 e_n / sqrt(w_n^H U_n w_n)``, row ``n`` of ``W`` its conjugate.

    ``W``: ``(..., N, M)``; ``U``: ``(..., N, M, M)``. A row whose
    ``w^H U w`` is not positive keeps its value; the root is floored at ``eps``.
    """
    W = W.clone()
    n_sources, n_channels = W.shape[-2:]
    eye = torch.eye(n_sources, n_channels, dtype=W.dtype, device=W.device)
    for n in range(n_sources):
        U_n = U[..., n, :, :]
        w = torch.linalg.solve(p.matmul(W, U_n), eye[n].expand(W.shape[:-2] + (n_channels,)).unsqueeze(-1))
        wUw = (w.conj() * p.matmul(U_n, w)).sum(dim=(-2, -1)).real
        denom = torch.clamp(torch.sqrt(torch.clamp(wUw, min=0.0)), min=eps)
        row = w[..., 0].conj() / denom[..., None]
        W[..., n, :] = torch.where((wUw > 0)[..., None], row, W[..., n, :])
    return W


def project_back(W: torch.Tensor, reference_id: int) -> torch.Tensor:
    """Projection back (Murata et al., 2001): row ``n`` of ``W`` scaled by ``(W^-1)[reference_id, n]``."""
    return W * torch.linalg.inv(W)[..., reference_id, :, None]


def spectrogram(p: Precision, waveforms, config: dict, device) -> torch.Tensor:
    """The mixture's STFT in ``p``'s precision, bins before channels: ``(..., I, M, T)``."""
    x = torch.as_tensor(waveforms).to(device=device, dtype=p.real)
    return stft(x, config["n_fft"], config["hop_length"]).to(p.complex).transpose(-3, -2)


def transform_flops(s: dict) -> float:
    """The STFT of ``M`` channels and the iSTFT of ``N`` sources of one recording, ``T`` frames each: a real FFT of
    ``n_fft`` points (``2.5 n_fft log2 n_fft``) and its window (``n_fft``) a frame. ``s``: ``Cell.shapes()``."""
    return (s["M"] + s["N"]) * s["T"] * (2.5 * s["n_fft"] * math.log2(s["n_fft"]) + s["n_fft"])


def demix_flops(s: dict) -> float:
    """The demixing product ``y = W x`` of one recording over its bins and frames."""
    return 8 * s["I"] * s["T"] * s["N"] * s["M"]


def ip1_iteration_flops(s: dict) -> float:
    """One IP1 iteration of one recording: the demixing product, the squared magnitudes and their sums
    (``4 N I T``), the weighted covariance and the IP1 sweep (counted in their roofline readers)."""
    return demix_flops(s) + 4 * s["N"] * s["I"] * s["T"] + covariance_flops(s["M"], s["N"], s["I"], s["T"]) \
        + sweep_flops(s["I"], s["N"], s["M"])


def waveforms_of(Y: torch.Tensor, config: dict, length: int) -> torch.Tensor:
    """Separated spectrograms ``(..., I, N, T)`` back to waveforms ``(..., N, length)``."""
    return istft(Y.transpose(-3, -2), config["n_fft"], config["hop_length"], length)
