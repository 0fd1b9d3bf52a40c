"""Multichannel NMF: ``MNMFBase``, ``MNMF`` and ``GaussMNMF`` (dense spatial covariances), ``FastMNMFBase`` and ``FastGaussMNMF``.

Counterpart of :mod:`ssspy_tpu.bss.mnmf` (parity target
ssspy/bss/mnmf.py:21-1073) for the full-rank spatial-covariance model: per
source an NMF power ``Lamb_n = T_n V_n`` (or, with ``partitioning``, a
shared basis and activation through the latent ``Z``) scales a spatial
covariance ``H_n``, the sources are separated by the multichannel Wiener
filter, and there is no demixing matrix. One iteration is
:func:`ssspy_tpu_torch.ops.mnmf_steps.gauss_mnmf_step`, whose routes follow
the input's dtype: complex64 runs the fused model pass K5 and the Jacobi
eigh K7, complex128 the reference's eigh model.

FastGaussMNMF (parity target ssspy/bss/mnmf.py:1076-1675) jointly
diagonalizes the spatial covariances, ``R_n = Q^-1 diag(Lamb_n d_n) Q^-H``:
one iteration is
:func:`ssspy_tpu_torch.ops.fast_mnmf_steps.fast_gauss_mnmf_step`, whose
diagonalizer update runs the weighted covariance K1 and the IP1 sweep K1b
in complex64 and their plain versions in complex128.
"""

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.fast_mnmf_steps import check_diagonalizer, fast_gauss_mnmf_loss, fast_gauss_mnmf_step, fast_mnmf_separate
from ..ops.ilrma_steps import reconstruct_nmf
from ..ops.mnmf_steps import _model, gauss_mnmf_loss, gauss_mnmf_step, instant_covariance, wiener_separate
from ..special.flooring import EPS, F32_EPS, dtype_flooring, resolve_flooring_spec, step_flooring
from ..utils.device import DEFAULT_DEVICE
# re-exported, as the reference does
from ._update_spatial_model import (  # noqa: F401
    update_by_ip1,
    update_by_ip2,
)
from .base import IterativeMethodBase, config_repr, default_pair_selector

__all__ = ["MNMFBase", "MNMF", "GaussMNMF", "FastMNMFBase", "FastGaussMNMF"]


def mnmf_flooring(flooring_fn: Callable) -> Tuple[float, Optional[Callable]]:
    """``(eps, floor)`` of the MNMF, IPSDTA and cACGMM steps, from the class's ``flooring_fn``.

    A max-type flooring gives ``(eps, None)`` with the eps of
    ``sc_flooring_eps(flooring_fn, 1e-10)`` of the JAX class
    (ssspy_tpu/bss/mnmf.py:490): the default ``"dtype"`` flooring gives the
    step's own 1e-10 in either precision, a ``max_flooring`` its ``eps``.
    Any other callable gives ``(1e-10, flooring_fn)``: the steps apply it
    where the JAX complex class does and keep 1e-10 where that class floors
    with a constant.
    """
    return step_flooring(flooring_fn, torch.float64, EPS if flooring_fn is dtype_flooring else None)


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
        self._init_nmf()

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

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self._init_instant_covariance()

    def _init_instant_covariance(self) -> None:
        """``XX[i,t] = x x^H``, projected as the step projects (parity: ssspy/bss/mnmf.py:167-188)."""
        eps, floor = mnmf_flooring(self.flooring_fn)
        self.instant_covariance = instant_covariance(self.input, eps=eps, flooring_fn=floor)

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
    A max-type ``flooring_fn`` (``"dtype"``, ``"f32"``, ``"f64"``, ``None``
    or a ``max_flooring`` partial) is an ``eps``, 1e-10 under ``"dtype"`` in
    either precision, as the JAX class's step takes it; any other callable
    floors where the JAX complex class floors with it, on the unfused eigh
    model (:mod:`ssspy_tpu_torch.ops.mnmf_steps`).
    """

    # ---- state plumbing ----------------------------------------------------

    warm_start_keys = {"T": "basis", "V": "activation", "H": "spatial", "Z": "latent"}

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
        eps, floor = mnmf_flooring(self.flooring_fn)
        return wiener_separate(input, Lamb, self.spatial, reference_id=self.reference_id, eps=eps, flooring_fn=floor)

    # ---- one iteration and the loss -------------------------------------------

    def make_step(self):
        (eps, floor), normalization = mnmf_flooring(self.flooring_fn), bool(self.normalization)

        def step(state):
            out = gauss_mnmf_step(
                state["XX"], state["T"], state["V"], state["H"], Z=state.get("Z"), eps=eps,
                normalization=normalization, flooring_fn=floor,
            )
            return {**state, **dict(zip(("T", "V", "H", "Z"), out))}

        return step

    def make_loss(self):
        eps, floor = mnmf_flooring(self.flooring_fn)

        def loss(state):
            return gauss_mnmf_loss(
                state["XX"], state["T"], state["V"], state["H"], Z=state.get("Z"), eps=eps, flooring_fn=floor
            )

        return loss


class FastMNMFBase(MNMFBase):
    """Base of FastMNMF (parity: ssspy/bss/mnmf.py:417-678): a diagonalizer per bin and diagonal loadings.

    The start, where no warm start is set, is drawn in the JAX class's order
    (ssspy_tpu/bss/mnmf.py:573-584): the basis ``(N, I, K)``, the activation
    ``(N, K, T)``, then the loadings ``spatial (I, N, M)``; the diagonalizer
    starts at the identity. complex128 floors each draw with ``flooring_fn``,
    as the JAX complex class does; complex64 starts as
    :func:`ssspy_tpu_torch.fast.fast_gauss_mnmf` and the JAX class's float32
    engine do (ssspy_tpu/bss/mnmf.py:805-833): the basis and activation as
    drawn, the loadings floored at 1e-10, all cast to float32. Warm start
    through ``basis=``, ``activation=``, ``diagonalizer=`` and ``spatial=``.
    """

    def _init_nmf(self) -> None:
        real, device = self.input.real.dtype, self.input.device
        shapes = {
            "basis": (self.n_sources, self.n_bins, self.n_basis),
            "activation": (self.n_sources, self.n_basis, self.n_frames),
            "spatial": (self.n_bins, self.n_sources, self.n_channels),
        }
        for name, shape in shapes.items():
            if hasattr(self, name):
                value = getattr(self, name).to(dtype=real).contiguous().clone()
            else:
                draw = self.rng.random(shape)
                if real == torch.float32:
                    draw = np.maximum(draw, 1e-10) if name == "spatial" else draw
                    value = torch.from_numpy(draw.astype(np.float32)).to(device)
                else:
                    value = self.flooring_fn(torch.as_tensor(draw, dtype=real, device=device))
            setattr(self, name, value)
        if hasattr(self, "diagonalizer"):
            Q = self.diagonalizer.to(dtype=self.input.dtype).contiguous().clone()
        else:
            Q = torch.eye(self.n_channels, dtype=self.input.dtype, device=device)
            Q = Q.expand(self.n_bins, -1, -1).contiguous()
        self.diagonalizer = Q


class FastGaussMNMF(FastMNMFBase):
    """FastMNMF with joint diagonalization (parity: ssspy/bss/mnmf.py:1076-1675).

    The dense covariances become ``R_n = Q^-1 diag(Lamb_n d_n) Q^-H``; ``Q``
    is updated by IP1 over per-channel weighted covariances. One iteration
    is :func:`~ssspy_tpu_torch.ops.fast_mnmf_steps.fast_gauss_mnmf_step` at
    the ``eps`` of a max-type ``flooring_fn`` (1e-10 in complex128 and 1e-6 in
    complex64 under ``"dtype"``, the float32 engine's floor; any other
    callable floors where the JAX complex class does), so that in
    complex64 the class equals :func:`ssspy_tpu_torch.fast.fast_gauss_mnmf`
    from the same draws. ``separate`` is the Wiener filter in the
    diagonalized space, on the device
    (:func:`~ssspy_tpu_torch.ops.fast_mnmf_steps.fast_mnmf_separate`).
    ``diagonalizer_algorithm="IP2"`` runs the IP2 pair updates over
    ``pair_selector``'s pairs (sequential by default) on the same
    covariances; ``partitioning`` is not supported, as in the reference.
    """

    def __init__(
        self,
        n_basis: int,
        n_sources: Optional[int] = None,
        diagonalizer_algorithm: str = "IP",
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: bool = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        check_diagonalizer(diagonalizer_algorithm)
        if partitioning:
            raise ValueError("partitioning function is not supported.")
        super().__init__(
            n_basis, n_sources=n_sources, partitioning=partitioning, flooring_fn=flooring_fn, callbacks=callbacks,
            normalization=normalization, record_loss=record_loss, reference_id=reference_id, rng=rng, device=device,
        )
        self.diagonalizer_algorithm = diagonalizer_algorithm
        self.pair_selector = default_pair_selector(diagonalizer_algorithm, pair_selector)

    def __repr__(self) -> str:
        keys = ["n_basis"]
        if self.n_sources is not None:
            keys += ["n_sources"]
        if hasattr(self, "n_channels"):
            keys += ["n_channels"]
        keys += ["diagonalizer_algorithm", "partitioning", "record_loss", "reference_id"]
        return config_repr(self, "FastGaussMNMF", keys)

    def _flooring(self) -> Tuple[float, Optional[Callable]]:
        """The step's ``(eps, floor)``: a max-type ``flooring_fn``'s eps, in complex64 at least 1e-6
        (ssspy_tpu/bss/_sc_engine.py:68-86); any other callable as :func:`~ssspy_tpu_torch.special.flooring.step_flooring` gives it."""
        eps, floor = step_flooring(self.flooring_fn, self.input.dtype)
        return (max(eps, F32_EPS) if self.input.dtype == torch.complex64 else eps), floor

    # ---- state plumbing ----------------------------------------------------

    warm_start_keys = {"T": "basis", "V": "activation", "Q": "diagonalizer", "D": "spatial"}

    def init_state(self):
        return {"X": self.input, "T": self.basis, "V": self.activation, "Q": self.diagonalizer, "D": self.spatial}

    def commit_state(self, state) -> None:
        self._state = state
        self.basis, self.activation = state["T"], state["V"]
        self.diagonalizer, self.spatial = state["Q"], state["D"]

    def separate(self, input):
        """Wiener filter in the diagonalized space, reference channel row (parity: ssspy/bss/mnmf.py:1174-1217)."""
        X = torch.as_tensor(input, device=self.input.device)
        return fast_mnmf_separate(X, self.basis, self.activation, self.diagonalizer, self.spatial,
                                  reference_id=self.reference_id, flooring_fn=self._flooring()[1])

    # ---- one iteration and the loss -------------------------------------------

    def make_step(self):
        (eps, floor), normalization, algorithm = self._flooring(), bool(self.normalization), self.diagonalizer_algorithm
        pair_selector = self.pair_selector

        def step(state):
            Q, T, V, D = fast_gauss_mnmf_step(
                state["X"], state["Q"], state["T"], state["V"], state["D"], eps=eps, normalization=normalization,
                diagonalizer=algorithm, pair_selector=pair_selector, flooring_fn=floor,
            )
            return {**state, "Q": Q, "T": T, "V": V, "D": D}

        return step

    def make_loss(self):
        eps = self._flooring()[0]

        def loss(state):
            return fast_gauss_mnmf_loss(state["X"], state["Q"], state["T"], state["V"], state["D"], eps=eps)

        return loss
