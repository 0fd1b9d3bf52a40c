"""Complex angular central Gaussian mixture model (cACGMM): ``CACGMMBase`` and ``CACGMM``.

Counterpart of :mod:`ssspy_tpu.bss.cacgmm` (parity target
ssspy/bss/cacgmm.py:21-738): EM over unit-norm observation vectors with
soft-mask separation, ``n_sources > n_channels`` allowed. The state is
``{alpha (N, I), B (N, I, M, M)}``; one EM iteration is
:func:`ssspy_tpu_torch.ops.cacgmm_steps.step`, the same call
:func:`ssspy_tpu_torch.fast.fast_cacgmm` makes, so that in complex64 the
class equals the fast path from the same draws. Its E-step eigh and M-step
PSD projection take the Jacobi kernel K7 in complex64 and
``torch.linalg.eigh`` in complex128. After the loop the posterior is taken
once more from the final parameters, and the permutations are aligned once
(:mod:`ssspy_tpu_torch.algorithm.permutation_alignment`), on the device.
"""

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..algorithm.permutation_alignment import (
    correlation_based_permutation_solver,
    score_based_permutation_solver,
)
from ..ops import cacgmm_steps
from ..special.flooring import choose_flooring_fn, floor, resolve_flooring_spec
from ..utils.device import DEFAULT_DEVICE
from .base import IterativeMethodBase, config_repr
from .mnmf import mnmf_flooring

__all__ = ["CACGMMBase", "CACGMM"]

PERMUTATION_ALIGNMENTS = ("posterior_score", "amplitude_score", "posterior_correlation", "amplitude_correlation")


class CACGMMBase(IterativeMethodBase):
    """Base class of cACGMM (parity: ssspy/bss/cacgmm.py:21-420).

    ``rng`` draws the start where none is set, in the JAX class's order
    (ssspy_tpu/bss/cacgmm.py:82-105): the mixing weights ``(N, I)``,
    normalized over sources, then the diagonals of the covariances ``(N, I,
    M)``, normalized over channels; complex64 casts them to float32 and
    complex64 after the normalization, as the fast path does. Warm start
    through ``mixing=`` and ``covariance=``. A max-type ``flooring_fn`` is
    an ``eps``: the unit normalization and the step floor with it, 1e-10
    under ``"dtype"`` in either precision, as the JAX class's float32
    engine does. Any other callable floors the norms of the unit
    normalization (ssspy_tpu/bss/cacgmm.py:70) and the places of the step
    that the JAX complex class floors with it
    (:mod:`ssspy_tpu_torch.ops.cacgmm_steps`).
    """

    def __init__(
        self,
        n_sources: Optional[int] = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        record_loss: bool = True,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss, device=device)
        self.n_sources = n_sources
        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.rng = np.random.default_rng() if rng is None else rng

    def __repr__(self) -> str:
        keys = (["n_sources"] if self.n_sources is not None else []) + ["record_loss"]
        return config_repr(self, "CACGMM", keys)

    def _step_kwargs(self) -> dict:
        """``eps`` and ``flooring_fn`` of the steps (:func:`~ssspy_tpu_torch.bss.mnmf.mnmf_flooring`)."""
        return dict(zip(("eps", "flooring_fn"), mnmf_flooring(self.flooring_fn)))

    def _reset(self, **kwargs) -> None:
        self._set_warm_start(kwargs)
        X = self.input
        self.unit_input = X / floor(torch.linalg.vector_norm(X, dim=0), **self._step_kwargs())
        n_channels, n_bins, n_frames = X.shape
        if self.n_sources is None:
            self.n_sources = n_channels
        self.n_channels, self.n_bins, self.n_frames = n_channels, n_bins, n_frames
        self._init_parameters()

    def _init_parameters(self) -> None:
        """Random mixing weights and diagonal covariances where none is set (parity: ssspy/bss/cacgmm.py:158-191)."""
        X, rng = self.input, self.rng
        real = X.real.dtype
        if hasattr(self, "mixing"):
            self.mixing = self.mixing.to(dtype=real).contiguous().clone()
        else:
            alpha = rng.random((self.n_sources, self.n_bins))
            self.mixing = torch.from_numpy(alpha / alpha.sum(axis=0)).to(device=X.device, dtype=real)
        if hasattr(self, "covariance"):
            self.covariance = self.covariance.to(dtype=X.dtype).contiguous().clone()
        else:
            B_diag = rng.random((self.n_sources, self.n_bins, self.n_channels))
            B = (B_diag / B_diag.sum(axis=-1, keepdims=True))[..., None] * np.eye(self.n_channels)
            self.covariance = torch.from_numpy(B).to(device=X.device, dtype=X.dtype)
        self.posterior = None

    def normalize_covariance(self) -> None:
        """``B`` over its trace."""
        if not self.normalization:
            raise RuntimeError("a normalization mode is required.")
        B = self.covariance
        self.covariance = B / B.diagonal(dim1=-2, dim2=-1).real.sum(dim=-1)[..., None, None]

    def compute_logdet(self, covariance: torch.Tensor) -> torch.Tensor:
        return torch.linalg.slogdet(covariance)[1]

    # ---- permutation alignment (after the loop) -------------------------------

    def solve_permutation(self, flooring_fn="self") -> None:
        """Align the sources across bins by the mode ``permutation_alignment`` names (``True``: ``"posterior_score"``)."""
        flooring_fn = choose_flooring_fn(flooring_fn, method=self)
        mode = self.permutation_alignment
        if not mode:
            raise RuntimeError("enable permutation_alignment to use this solver.")
        mode = "posterior_score" if mode is True else mode
        if mode not in PERMUTATION_ALIGNMENTS:
            raise NotImplementedError(f"permutation_alignment {mode} is not implemented.")
        target, solver = mode.split("_")
        if solver == "score":
            self.solve_permutation_by_score(target=target, flooring_fn=flooring_fn)
        else:
            self.solve_permutation_by_correlation(target=target, flooring_fn=flooring_fn)

    def _by_bin(self):
        """``(alpha (I, N), B (I, N, M, M), gamma (I, N, T))``."""
        return self.mixing.transpose(0, 1), self.covariance.transpose(0, 1), self.posterior.transpose(0, 1)

    def _set_by_bin(self, alpha, B, gamma) -> None:
        self.mixing, self.covariance, self.posterior = alpha.transpose(0, 1), B.transpose(0, 1), gamma.transpose(0, 1)

    def solve_permutation_by_score(self, target: str = "posterior", flooring_fn="self") -> None:
        if target not in ("posterior", "amplitude"):
            raise ValueError(f"Invalid target {target} is specified.")
        flooring_fn = choose_flooring_fn(flooring_fn, method=self)
        alpha, B, gamma = self._by_bin()
        kw = dict(global_iter=getattr(self, "global_iter", 1), local_iter=getattr(self, "local_iter", 1),
                  flooring_fn=flooring_fn)
        if target == "posterior":
            gamma, (alpha, B) = score_based_permutation_solver(gamma, alpha, B, **kw)
        else:
            amplitude = self.separate(self.input, posterior=self.posterior).abs().transpose(0, 1)
            _, (alpha, B, gamma) = score_based_permutation_solver(amplitude, alpha, B, gamma, **kw)
        self._set_by_bin(alpha, B, gamma)
        self.output = self.separate(self.input, posterior=self.posterior)

    def solve_permutation_by_correlation(self, target: str = "amplitude", flooring_fn="self") -> None:
        if target != "amplitude":
            raise NotImplementedError("only target='amplitude' is implemented.")
        flooring_fn = choose_flooring_fn(flooring_fn, method=self)
        alpha, B, gamma = self._by_bin()
        Y = self.separate(self.input, posterior=self.posterior).transpose(0, 1)
        Y, (alpha, B, gamma) = correlation_based_permutation_solver(Y, alpha, B, gamma, flooring_fn=flooring_fn)
        self._set_by_bin(alpha, B, gamma)
        self.output = Y.transpose(0, 1)


class CACGMM(CACGMMBase):
    """cACGMM (parity: ssspy/bss/cacgmm.py:423-738).

    ``permutation_alignment``: ``True`` (``"posterior_score"``),
    ``"amplitude_score"`` (both with the keywords ``global_iter`` and
    ``local_iter``), ``"amplitude_correlation"``, or ``False``;
    ``"posterior_correlation"`` raises, as in the reference. ``impl``
    (``"eigh"`` or ``"chol"``) and ``covariance_impl`` (``"einsum"`` or
    ``"kernel"``) choose the step's routes
    (:mod:`ssspy_tpu_torch.ops.cacgmm_steps`). ``separate`` is the posterior
    times the ``reference_id`` channel of the mixture.
    """

    def __init__(
        self,
        n_sources: Optional[int] = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: bool = True,
        permutation_alignment: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "eigh",
        covariance_impl: str = "einsum",
        device=DEFAULT_DEVICE,
        **kwargs,
    ) -> None:
        super().__init__(n_sources=n_sources, flooring_fn=flooring_fn, callbacks=callbacks,
                         record_loss=record_loss, rng=rng, device=device)
        cacgmm_steps._check(impl, covariance_impl)
        self.normalization = normalization
        self.permutation_alignment = permutation_alignment
        self.reference_id = reference_id
        self.impl, self.covariance_impl = impl, covariance_impl

        if permutation_alignment is True or permutation_alignment in ("posterior_score", "amplitude_score"):
            valid_keys = {"global_iter", "local_iter"}
        else:
            valid_keys = set()
        invalid_keys = set(kwargs) - valid_keys
        if invalid_keys:
            raise ValueError(f"Invalid keywords {invalid_keys} are given.")
        for key, value in kwargs.items():
            setattr(self, key, value)

    def __repr__(self) -> str:
        keys = (["n_sources"] if self.n_sources is not None else [])
        keys += ["record_loss", "normalization", "permutation_alignment", "reference_id"]
        return config_repr(self, "CACGMM", keys)

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        """Bind ``input``, reset from the warm-start ``kwargs``, iterate, take the posterior, align, separate."""
        self._bind_input(input)
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        self.update_posterior()
        if self.permutation_alignment:
            self.solve_permutation()
        self.output = self.separate(self.input, posterior=self.posterior)
        return self.output

    # ---- state plumbing ----------------------------------------------------

    warm_start_keys = {"alpha": "mixing", "B": "covariance"}  # not Z, the unit input

    def init_state(self):
        return {"Z": self.unit_input, "alpha": self.mixing, "B": self.covariance}

    def commit_state(self, state) -> None:
        self._state = state
        self.mixing, self.covariance = state["alpha"], state["B"]

    def update_posterior(self) -> None:
        """The posterior of the current parameters (one more E-step)."""
        self.posterior = cacgmm_steps.posterior(self.unit_input, self.mixing, self.covariance, impl=self.impl,
                                                **self._step_kwargs())

    def separate(self, input, posterior: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Soft-mask separation ``Y_n = gamma_n X_ref`` (parity: ssspy/bss/cacgmm.py:561-601)."""
        X = torch.as_tensor(input, device=self.input.device)
        if posterior is None:
            posterior = cacgmm_steps.posterior(self.unit_input, self.mixing, self.covariance, impl=self.impl,
                                               **self._step_kwargs())
        return posterior.to(X.dtype) * X[self.reference_id]

    # ---- one iteration and the loss -------------------------------------------

    def make_step(self):
        kw = dict(normalization=bool(self.normalization), impl=self.impl, covariance_impl=self.covariance_impl,
                  **self._step_kwargs())

        def step(state):
            alpha, B = cacgmm_steps.step(state["Z"], state["alpha"], state["B"], **kw)
            return {**state, "alpha": alpha, "B": B}

        return step

    def make_loss(self):
        kw = dict(impl=self.impl, **self._step_kwargs())

        def loss(state):
            return cacgmm_steps.loss(state["Z"], state["alpha"], state["B"], **kw)

        return loss
