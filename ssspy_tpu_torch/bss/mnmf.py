"""Multichannel NMF with dense spatial covariances: ``MNMFBase``, ``MNMF`` and ``GaussMNMF``.

Counterpart of :mod:`ssspy_tpu.bss.mnmf` (parity target
ssspy/bss/mnmf.py:21-1073) for the full-rank spatial-covariance model: per
source an NMF power ``Lamb_n = T_n V_n`` (or, with ``partitioning``, a
shared basis and activation through the latent ``Z``) scales a spatial
covariance ``H_n``, the sources are separated by the multichannel Wiener
filter, and there is no demixing matrix. One iteration is
:func:`ssspy_tpu_torch.ops.mnmf_steps.gauss_mnmf_step`, whose routes follow
the input's dtype: complex64 runs the fused model pass K5 and the Jacobi
eigh K7, complex128 the reference's eigh model. FastGaussMNMF is not ported
yet (ROADMAP.md, Queue 1).
"""

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..ops.ilrma_steps import reconstruct_nmf
from ..ops.mnmf_steps import _model, gauss_mnmf_loss, gauss_mnmf_step, instant_covariance, wiener_separate
from ..special.flooring import EPS, dtype_flooring, resolve_flooring_spec, sweep_eps
from ..utils.device import DEFAULT_DEVICE
from .base import IterativeMethodBase, config_repr

__all__ = ["MNMFBase", "MNMF", "GaussMNMF"]


def mnmf_eps(flooring_fn: Callable) -> float:
    """The ``eps`` the MNMF step floors and projects with, from the class's ``flooring_fn``.

    ``sc_flooring_eps(flooring_fn, 1e-10)`` of the JAX class
    (ssspy_tpu/bss/mnmf.py:490): the default ``"dtype"`` flooring gives the
    step's own 1e-10 in either precision, a ``max_flooring`` its ``eps``.
    """
    return EPS if flooring_fn is dtype_flooring else sweep_eps(flooring_fn, torch.float64)


class MNMFBase(IterativeMethodBase):
    """Base class of MNMF (parity: ssspy/bss/mnmf.py:21-297).

    ``n_sources`` defaults to the number of channels and may be smaller or
    larger. ``rng``: the ``np.random.Generator`` the NMF factors are drawn
    from on the host, in the JAX class's order (basis, activation, then
    with ``partitioning`` the latent, normalized over sources), floored
    with ``flooring_fn`` and moved to ``device`` (the card by default). Warm
    start through ``basis=``, ``activation=`` and ``latent=``.
    """

    def __init__(
        self,
        n_basis: int,
        n_sources: Optional[int] = None,
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss, device=device)

        self.n_basis = n_basis
        self.n_sources = n_sources
        self.partitioning = partitioning
        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.normalization = normalization
        self.reference_id = reference_id
        self.rng = np.random.default_rng() if rng is None else rng

    def __repr__(self) -> str:
        keys = ["n_basis"]
        if self.n_sources is not None:
            keys += ["n_sources"]
        if hasattr(self, "n_channels"):
            keys += ["n_channels"]
        keys += ["partitioning", "normalization", "record_loss", "reference_id"]
        return config_repr(self, type(self).__name__, keys)

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        """Bind ``input``, reset from the warm-start ``kwargs``, iterate, separate."""
        self._bind_input(input)
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        self.output = self.separate(self.input)
        return self.output

    def _reset(self, **kwargs) -> None:
        self._set_warm_start(kwargs)
        n_channels, n_bins, n_frames = self.input.shape
        if self.n_sources is None:
            self.n_sources = n_channels
        self.n_channels, self.n_bins, self.n_frames = n_channels, n_bins, n_frames
        self._init_instant_covariance()
        self._init_nmf()

    def _init_instant_covariance(self) -> None:
        """``XX[i,t] = x x^H``, projected as the step projects (parity: ssspy/bss/mnmf.py:167-188)."""
        self.instant_covariance = instant_covariance(self.input, eps=mnmf_eps(self.flooring_fn))

    def _init_nmf(self) -> None:
        """Random NMF factors where none is set (ssspy_tpu/bss/mnmf.py:215-252)."""
        real = self.input.real.dtype
        if self.partitioning:
            shapes = {
                "basis": (self.n_bins, self.n_basis),
                "activation": (self.n_basis, self.n_frames),
                "latent": (self.n_sources, self.n_basis),
            }
        else:
            shapes = {
                "basis": (self.n_sources, self.n_bins, self.n_basis),
                "activation": (self.n_sources, self.n_basis, self.n_frames),
            }
        for name, shape in shapes.items():
            if hasattr(self, name):
                value = getattr(self, name).to(dtype=real).contiguous().clone()
            else:
                draw = self.rng.random(shape)
                if name == "latent":
                    draw = draw / draw.sum(axis=0)
                value = self.flooring_fn(torch.as_tensor(draw, dtype=real, device=self.input.device))
            setattr(self, name, value)

    def separate(self, input):
        raise NotImplementedError("subclasses must implement separate.")

    def reconstruct_nmf(self, basis, activation, latent=None):
        return reconstruct_nmf(basis, activation, latent)


class MNMF(MNMFBase):
    """MNMF with dense spatial covariances (parity: ssspy/bss/mnmf.py:300-414).

    ``spatial`` starts at ``I / M`` for every source and bin, or from the
    warm start ``spatial=``.
    """

    def _init_nmf(self) -> None:
        super()._init_nmf()
        X = self.input
        if hasattr(self, "spatial"):
            H = self.spatial.to(dtype=X.dtype).contiguous().clone()
        else:
            H = torch.eye(self.n_channels, dtype=X.dtype, device=X.device) / self.n_channels
            H = H.expand(self.n_sources, self.n_bins, -1, -1).contiguous()
        self.spatial = H

    def reconstruct_mnmf(self, basis, activation, spatial, latent=None):
        """``R = sum_n Lamb_n H_n``: (N,I,T) x (N,I,M,M) -> (I,T,M,M)."""
        return _model(reconstruct_nmf(basis, activation, latent), spatial)


class GaussMNMF(MNMF):
    """Gaussian MNMF (parity: ssspy/bss/mnmf.py:681-1073).

    No demixing matrix: the model is per-source spatial covariances ``H_n``
    scaled by NMF powers, the spatial update is the geometric mean
    ``P^-1 # HQH`` and separation is the multichannel Wiener filter at
    ``reference_id`` (:func:`~ssspy_tpu_torch.ops.mnmf_steps.wiener_separate`).
    ``flooring_fn`` must floor with ``max(., eps)`` (``"dtype"``, ``"f32"``,
    ``"f64"``, ``None`` or a ``max_flooring`` partial); ``eps`` is 1e-10
    under ``"dtype"`` in either precision, as the JAX class's step takes it.
    """

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        state = {"XX": self.instant_covariance, "T": self.basis, "V": self.activation, "H": self.spatial}
        if self.partitioning:
            state["Z"] = self.latent
        return state

    def commit_state(self, state) -> None:
        self._state = state
        self.basis, self.activation = state["T"], state["V"]
        self.spatial = state["H"]
        if self.partitioning:
            self.latent = state["Z"]

    def separate(self, input):
        """Multichannel Wiener filter, reference channel row; the model projected as in the step."""
        Lamb = reconstruct_nmf(self.basis, self.activation, self.latent if self.partitioning else None)
        return wiener_separate(
            input, Lamb, self.spatial, reference_id=self.reference_id, eps=mnmf_eps(self.flooring_fn)
        )

    # ---- one iteration and the loss -------------------------------------------

    def make_step(self):
        eps, normalization = mnmf_eps(self.flooring_fn), bool(self.normalization)

        def step(state):
            out = gauss_mnmf_step(
                state["XX"], state["T"], state["V"], state["H"], Z=state.get("Z"), eps=eps,
                normalization=normalization,
            )
            return {**state, **dict(zip(("T", "V", "H", "Z"), out))}

        return step

    def make_loss(self):
        eps = mnmf_eps(self.flooring_fn)

        def loss(state):
            return gauss_mnmf_loss(state["XX"], state["T"], state["V"], state["H"], Z=state.get("Z"), eps=eps)

        return loss
