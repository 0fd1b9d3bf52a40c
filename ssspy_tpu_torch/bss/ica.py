"""Independent component analysis (ICA) in the time domain.

Counterpart of :mod:`ssspy_tpu.bss.ica` (parity target ssspy/bss/ica.py):
``GradICABase``, ``GradICA``, ``NaturalGradICA``, ``FastICABase``,
``FastICA``, ``GradLaplaceICA`` and ``NaturalGradLaplaceICA``. The input is
a real ``(M, T)`` waveform and the demixing matrix one real ``(N, M)``
matrix; the iterations run in :class:`~ssspy_tpu_torch.bss.base.IterativeMethodBase`'s
Python loop, the loss read once after it. No kernel: each step is a few
products over the samples.
"""

from typing import Callable, List, Optional, Union

import torch

from ..ops.ica_steps import grad_ica_step
from ..transform import whiten
from ..utils.device import DEFAULT_DEVICE
from .base import IterativeMethodBase, config_repr

__all__ = [
    "GradICABase",
    "FastICABase",
    "GradICA",
    "NaturalGradICA",
    "FastICA",
    "GradLaplaceICA",
    "NaturalGradLaplaceICA",
]


class _ICABase(IterativeMethodBase):
    """What both ICA bases share: the input's shape and the demixing matrix's warm start."""

    warm_start_keys = {"W": "demix_filter"}  # not FastICA's Z, the whitened input

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self._bind_input(input)
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        return self.output

    def _reset(self, **kwargs) -> None:
        self._set_warm_start(kwargs)
        X = self.input
        n_channels, n_samples = X.shape
        self.n_sources, self.n_channels = n_channels, n_channels
        self.n_samples = n_samples
        if getattr(self, "demix_filter", None) is None:
            self.demix_filter = torch.eye(n_channels, dtype=X.dtype, device=X.device)
        else:
            self.demix_filter = self.demix_filter.to(dtype=X.dtype).clone()


class GradICABase(_ICABase):
    """Base class of gradient-descent ICA (parity: ssspy/bss/ica.py:11-194).

    ``score_fn(Y)`` gives the score ``Phi (N, T)``; each step moves ``W``
    by ``step_size`` along ``(Phi Y^T / T - I) W`` (natural) or
    ``(Phi Y^T / T - I) W^-T`` (vanilla, ``W^-T`` by ``solve_ex``), the
    diagonal dropped unless ``is_holonomic``. ``device``: the card by
    default, ``"cpu"`` on the CPU.
    """

    _natural = False  # NaturalGradICA: True

    def __init__(
        self,
        step_size: float = 1e-1,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        record_loss: bool = True,
        device=DEFAULT_DEVICE,
    ) -> None:
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if score_fn is None:
            raise ValueError("a score_fn must be provided.")
        super().__init__(callbacks=callbacks, record_loss=record_loss, device=device)
        self.step_size = step_size
        self.contrast_fn = contrast_fn
        self.score_fn = score_fn
        self.is_holonomic = is_holonomic

    def __repr__(self) -> str:
        return config_repr(self, "GradICA", ["step_size", "is_holonomic", "record_loss"])

    def separate(self, input, demix_filter):
        """``y_t = W x_t``: ``(N, M) @ (M, T) -> (N, T)``."""
        return demix_filter @ input

    def compute_logdet(self, demix_filter):
        return torch.linalg.slogdet(demix_filter)[1]

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self.output = self.demix_filter @ self.input

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = state["W"] @ state["X"]

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            W = state["W"]
            return torch.sum(torch.mean(contrast_fn(W @ state["X"]), dim=1)) - torch.linalg.slogdet(W)[1]

        return loss

    def make_step(self):
        score_fn, step_size, is_holonomic, natural = self.score_fn, self.step_size, self.is_holonomic, self._natural

        def step(state):
            W = grad_ica_step(state["X"], state["W"], score_fn, step_size=step_size, is_holonomic=is_holonomic,
                              natural=natural)
            return {**state, "W": W}

        return step


class GradICA(GradICABase):
    """ICA by gradient descent (parity: ssspy/bss/ica.py:406-555)."""


class NaturalGradICA(GradICABase):
    """ICA by natural gradient descent (parity: ssspy/bss/ica.py:557-708)."""

    _natural = True

    def __repr__(self) -> str:
        return "Natural" + super().__repr__()


class FastICABase(_ICABase):
    """Base class of FastICA on the whitened input (parity: ssspy/bss/ica.py:196-404).

    The input is whitened by :func:`ssspy_tpu_torch.transform.whiten`; the
    loss is the contrast alone.
    """

    def __init__(
        self,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        d_score_fn: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        record_loss: bool = True,
        device=DEFAULT_DEVICE,
    ) -> None:
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if score_fn is None:
            raise ValueError("a score_fn must be provided.")
        if d_score_fn is None:
            raise ValueError("a d_score_fn must be provided.")
        super().__init__(callbacks=callbacks, record_loss=record_loss, device=device)
        self.contrast_fn = contrast_fn
        self.score_fn = score_fn
        self.d_score_fn = d_score_fn

    def __repr__(self) -> str:
        return config_repr(self, "FastICA", ["record_loss"])

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self.whitened_input = whiten(self.input, device=self.input.device)
        self.output = self.demix_filter @ self.whitened_input

    def separate(self, input, demix_filter, use_whitening: bool = True):
        """Demix, whitening first by default: ``(N, M) @ (M, T) -> (N, T)``."""
        return demix_filter @ (whiten(input, device=demix_filter.device) if use_whitening else input)

    def init_state(self):
        return {"Z": self.whitened_input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = state["W"] @ state["Z"]

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            return torch.sum(torch.mean(contrast_fn(state["W"] @ state["Z"]), dim=-1))

        return loss


class FastICA(FastICABase):
    """Fast ICA by fixed-point iteration (parity: ssspy/bss/ica.py:710-843).

    One sweep over the sources in order: ``w <- E[phi'(y)] w - E[phi(y) z]``,
    the rows updated before it in this sweep projected out, then unit norm.
    """

    def make_step(self):
        score_fn, d_score_fn = self.score_fn, self.d_score_fn

        def step(state):
            Z, W = state["Z"], state["W"]
            rows = []
            for w_n in W.unbind(0):
                y_n = w_n @ Z  # (T,)
                w_n = torch.mean(d_score_fn(y_n)) * w_n - torch.mean(score_fn(y_n) * Z, dim=-1)
                if rows:
                    W_prev = torch.stack(rows)
                    w_n = w_n - torch.sum(torch.sum(W_prev * w_n, dim=-1, keepdim=True) * W_prev, dim=0)
                rows.append(w_n / torch.linalg.vector_norm(w_n))
            return {**state, "W": torch.stack(rows)}

        return step


class GradLaplaceICA(GradICA):
    """Gradient-descent ICA with a Laplace prior (parity: ssspy/bss/ica.py:846-1001): contrast ``|y|``, score ``sign(y)``."""

    def __init__(
        self,
        step_size: float = 1e-1,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        record_loss: bool = True,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            step_size=step_size,
            contrast_fn=torch.abs,
            score_fn=torch.sign,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            record_loss=record_loss,
            device=device,
        )

    def __repr__(self) -> str:
        return config_repr(self, type(self).__name__, ["step_size", "is_holonomic", "record_loss"])


class NaturalGradLaplaceICA(GradLaplaceICA, NaturalGradICA):
    """Natural-gradient ICA with a Laplace prior (parity: ssspy/bss/ica.py:1004-1095)."""
