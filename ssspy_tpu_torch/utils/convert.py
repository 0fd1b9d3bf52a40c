"""Bridge between the JAX package's arrays and the port's tensors.

The JAX fast paths carry complex values as planar ``(2, ...)`` float32
arrays (``[real, imag]``); its class API carries complex arrays. These
helpers turn either into complex tensors on a chosen device and back, so
both packages can be fed the same state. They take numpy arrays (a JAX
array converts with ``np.asarray``) and import nothing from JAX. The
batched carries of the JAX package's multi-device runners
(``ssspy_tpu/parallel``) put the planes after the utterance axis, ``(B,
2, ...)``: pass ``plane_axis=1``.
"""

from typing import Dict, List, Union

import numpy as np
import torch

__all__ = ["planar_to_complex", "complex_to_planar", "from_jax_state"]


def planar_to_complex(a, device=None, plane_axis: int = 0) -> torch.Tensor:
    """Planar real array, ``[real, imag]`` on ``plane_axis`` -> complex tensor without that axis, on ``device``.

    ``(2, ...)`` by default; ``plane_axis=1`` for a batched carry ``(B, 2,
    ...)``. float32 planes give complex64, float64 planes complex128.
    """
    a = np.asarray(a)
    if a.ndim <= plane_axis or a.shape[plane_axis] != 2 or np.iscomplexobj(a):
        raise ValueError(f"expected a real planar array with 2 planes on axis {plane_axis}, got {a.dtype} {a.shape}")
    re, im = (np.take(a, k, axis=plane_axis) for k in (0, 1))
    return torch.complex(torch.from_numpy(re.copy()), torch.from_numpy(im.copy())).to(device)


def complex_to_planar(t: torch.Tensor) -> np.ndarray:
    """Complex tensor ``(...)`` -> planar ``(2, ...)`` real numpy array on the host."""
    t = t.detach().cpu()
    return np.stack([t.real.numpy(), t.imag.numpy()], axis=0)


# the state keys of the JAX classes and fast paths, by kind
_COMPLEX_KEYS = (
    "X", "W", "Y",  # spectrograms and demixing filters
    "Xw",  # the fixed-point IVA classes' whitened spectrogram
    "dual",  # PDS dual
    "V1", "V2", "Y1", "Y2", "quad_inv",  # ADMM fast-path auxiliaries, duals, (X X^H + I)^-1
    "auxiliary1", "auxiliary2", "dual1", "dual2",  # ADMM class auxiliaries and duals
    "H", "XX",  # dense MNMF spatial and instant covariances
    "B",  # cACGMM covariances
)
_REAL_KEYS = (
    "T", "V", "Z",  # NMF basis, activation and latent (ILRMA and MNMF); FastICA's whitened waveform
    "variance",  # the Gaussian source model of AuxGaussIVA and GradGaussIVA
    "alpha",  # cACGMM mixing weights
)
_COMPLEX_LIST_KEYS = ("T_parts",)  # IPSDTA's PSDTF basis, one entry per block part


def from_jax_state(
    state: Dict, device=None, real_keys=(), plane_axis: int = 0
) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
    """Convert a JAX class or fast-path state dict (e.g. ``{"X": Xs, "W": Ws}``).

    The kind of each entry is decided by its key, never by its shape:
    ``X``, ``W``, ``Y``, the prox family's ``dual``, ``V1``, ``V2``,
    ``Y1``, ``Y2``, ``quad_inv``, ``auxiliary1``, ``auxiliary2``,
    ``dual1`` and ``dual2``, and dense MNMF's ``H`` and ``XX`` are
    complex and arrive either complex (class
    state) or planar ``(2, ...)`` real (fast-path state, through
    :func:`planar_to_complex`), and so is the fixed-point classes' ``Xw``;
    ``T``, ``V``, ``Z``, the Gaussian models' ``variance`` and cACGMM's
    ``alpha`` are real and keep their dtype, whatever their leading axis;
    cACGMM's covariances ``B`` are complex. The keys named in
    ``real_keys`` are real as well: the ICA classes' waveform ``X`` and
    demixing matrix ``W`` are real, so their state converts with
    ``real_keys=("X", "W")`` (a real ``(2, ...)`` array is never read as
    planar then). ``T_parts``, IPSDTA's basis,
    is a list (or tuple) of complex parts ``(N, K, B_p, J_p, J_p)``, each
    complex or planar ``(2, N, K, B_p, J_p, J_p)`` (the JAX fast path's
    ``T0``, ``T1``), and becomes a list of complex tensors. Any other key
    raises. ``plane_axis=1`` reads the planar entries of a batched runner's
    carry, ``(B, 2, ...)``: ``W (B, 2, I, N, M)`` becomes ``(B, I, N, M)``,
    each basis part ``(B, 2, N, K, B_p, J, J)`` becomes ``(B, N, K, B_p, J,
    J)``; the real entries keep their shapes.
    """

    def as_complex(a):
        a = np.asarray(a)
        if np.iscomplexobj(a):
            return torch.from_numpy(a.copy()).to(device)
        return planar_to_complex(a, device, plane_axis=plane_axis)

    out = {}
    for key, value in state.items():
        if key in _COMPLEX_LIST_KEYS:
            if not isinstance(value, (list, tuple)):
                raise ValueError(f"state entry {key!r} must be a list of parts, got {type(value).__name__}")
            out[key] = [as_complex(part) for part in value]
            continue
        a = np.asarray(value)
        if key in _COMPLEX_KEYS and key not in real_keys:
            out[key] = as_complex(a)
        elif key in _REAL_KEYS or key in real_keys:
            if np.iscomplexobj(a):
                raise ValueError(f"state entry {key!r} must be real, got {a.dtype}")
            out[key] = torch.from_numpy(a.copy()).to(device)
        else:
            raise ValueError(
                f"unknown state key {key!r}; expected one of {_COMPLEX_KEYS + _REAL_KEYS + _COMPLEX_LIST_KEYS}"
            )
    return out
