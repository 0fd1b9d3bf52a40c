"""Frequency-domain ICA (FDICA): the gradient and auxiliary-function classes.

Counterpart of :mod:`ssspy_tpu.bss.fdica` (parity target ssspy/bss/fdica.py):
``FDICABase``, ``GradFDICABase``, ``GradFDICA``, ``NaturalGradFDICA``,
``AuxFDICA`` (IP, IP1, IP2 with any ``pair_selector``), and their Laplace
classes ``GradLaplaceFDICA``, ``NaturalGradLaplaceFDICA`` and
``AuxLaplaceFDICA``. FDICA runs an independent ICA in every frequency bin
(the contrast is per scalar), so after the loop the sources are aligned
across bins (:func:`~ssspy_tpu_torch.algorithm.permutation_alignment.correlation_based_permutation_solver`,
on the device) before the scale is restored. The separator runs on its
``device`` (the card by default); its steps go through the routers of
:mod:`ssspy_tpu_torch.ops.iva_steps` (K1 with ``(N, I, T)`` weights and
the IP1 sweep K1b in complex64, the plain routes in complex128).

The Laplace classes weigh and score with ``1 / flooring_fn(|y|)``, the
form of the fast paths (:mod:`ssspy_tpu_torch.ops.fdica_steps`), so that a
class with the fast path's floor runs its trajectory to the bit; the
generic classes take ``d_contrast_fn(|y|) / flooring_fn(2 |y|)`` as the
reference does. The two differ only where ``|y|`` is under the floor.
"""

from typing import Callable, List, Optional, Union

import torch

from ..algorithm import correlation_based_permutation_solver
from ..ops.iva_steps import PairSelector, auxiva_ip2_step, covariance, grad_iva_step, ip1_update
from ..ops.iva_steps import separate as _separate
from ..special.flooring import choose_flooring_fn, step_flooring, sweep_eps
from ..utils.device import DEFAULT_DEVICE
from ..utils.select_pair import sequential_pair_selector
# re-exported, as the reference does
from ._update_spatial_model import (  # noqa: F401
    update_by_ip1,
    update_by_ip2_one_pair,
)
from .base import SeparatorBase, config_repr

__all__ = [
    "FDICABase",
    "GradFDICABase",
    "GradFDICA",
    "NaturalGradFDICA",
    "AuxFDICA",
    "GradLaplaceFDICA",
    "NaturalGradLaplaceFDICA",
    "AuxLaplaceFDICA",
]

SPATIAL_ALGORITHMS = ("IP", "IP1", "IP2")
PERMUTATION_ALIGNMENTS = ("spectrogram_correlation",)


def _laplace_contrast(y: torch.Tensor) -> torch.Tensor:
    return 2 * y.abs()


class FDICABase(SeparatorBase):
    """Base class of FDICA (parity: ssspy/bss/fdica.py:32-327).

    ``permutation_alignment``: ``True`` or ``"spectrogram_correlation"``
    aligns the sources across bins by their amplitude correlation after the
    loop; ``False`` leaves them as each bin's ICA found them. Then the scale
    is restored (projection back or the minimal distortion principle), as
    in the IVA classes. ``device`` as in
    :class:`~ssspy_tpu_torch.bss.base.IterativeMethodBase`.
    """

    def __init__(
        self,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        permutation_alignment: Union[bool, str] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.permutation_alignment = permutation_alignment

    def __repr__(self) -> str:
        keys = ["permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "FDICA", keys)

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        """Bind ``input``, reset from the warm-start ``kwargs``, iterate, then align, restore the scale and separate."""
        self._bind_input(input)
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        return self._finalize()

    def _reset(self, **kwargs) -> None:
        self._set_warm_start(kwargs)
        n_channels, n_bins, n_frames = self.input.shape
        self.n_sources, self.n_channels = n_channels, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames
        self._reset_demix_filter(kwargs)

    def separate(self, input, demix_filter):
        """Per-bin demixing ``(M, I, T) -> (N, I, T)``."""
        return _separate(input, demix_filter)

    def compute_logdet(self, demix_filter):
        return torch.linalg.slogdet(demix_filter)[1]

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = _separate(state["X"], state["W"])

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            W = state["W"]
            G = contrast_fn(_separate(state["X"], W))  # (N, I, T)
            return torch.sum(torch.sum(torch.mean(G, dim=2), dim=0) - 2 * torch.linalg.slogdet(W)[1])

        return loss

    # ---- permutation alignment and the end of a call ---------------------------------------------

    def solve_permutation(self) -> None:
        """Align the sources across bins by the mode ``permutation_alignment`` names (ssspy_tpu/bss/fdica.py:146-157)."""
        mode = self.permutation_alignment
        if not mode:
            raise RuntimeError("enable permutation_alignment to use this solver.")
        if mode is True:
            mode = PERMUTATION_ALIGNMENTS[0]
        if mode not in PERMUTATION_ALIGNMENTS:
            raise NotImplementedError(f"permutation_alignment {mode} is not implemented.")
        self.solve_permutation_by_correlation()

    def solve_permutation_by_correlation(self, flooring_fn="self") -> None:
        """Permute the sources of every bin, output and filters together, by amplitude correlation (fdica.py:159-168)."""
        flooring_fn = choose_flooring_fn(flooring_fn, method=self)
        Y = _separate(self.input, self.demix_filter)
        Y, W = correlation_based_permutation_solver(Y.transpose(0, 1), self.demix_filter, flooring_fn=flooring_fn)
        self.output, self.demix_filter = Y.transpose(0, 1), W

    def _finalize(self) -> torch.Tensor:
        """Alignment, scale restoration and the final separation (ssspy_tpu/bss/fdica.py:198-207)."""
        if self.permutation_alignment:
            self.solve_permutation()
        if self.scale_restoration:
            self.restore_scale()
        self.output = _separate(self.input, self.demix_filter)
        return self.output


class GradFDICABase(FDICABase):
    """Base of gradient-descent FDICA (parity: ssspy/bss/fdica.py:329-456).

    ``score_fn(Y)`` gives the score per scalar ``(N, I, T)``; each step is
    :func:`~ssspy_tpu_torch.ops.iva_steps.grad_iva_step` (``W`` moves by
    ``step_size`` along ``(PhiY - I) W`` in the natural classes, along
    ``(PhiY - I) W^-H`` otherwise, the diagonal dropped unless
    ``is_holonomic``). No kernel.
    """

    _natural = False  # NaturalGradFDICA: True

    def __init__(
        self,
        step_size: float = 1e-1,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        permutation_alignment: Union[bool, str] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if score_fn is None:
            raise ValueError("a score_fn must be provided.")
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.step_size = step_size
        self.contrast_fn = contrast_fn
        self.score_fn = score_fn
        self.is_holonomic = is_holonomic

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, type(self).__name__, keys)

    def make_step(self):
        score_fn, step_size, is_holonomic, natural = self.score_fn, self.step_size, self.is_holonomic, self._natural

        def step(state):
            W = state["W"]
            Y = _separate(state["X"], W)
            return {**state, "W": grad_iva_step(W, Y, score_fn(Y), step_size, is_holonomic, natural)}

        return step


class GradFDICA(GradFDICABase):
    """FDICA by gradient descent (parity: ssspy/bss/fdica.py:458-655)."""


class NaturalGradFDICA(GradFDICABase):
    """FDICA by natural gradient descent (parity: ssspy/bss/fdica.py:658-844)."""

    _natural = True


class AuxFDICA(FDICABase):
    """Auxiliary-function FDICA (parity: ssspy/bss/fdica.py:846-1246).

    ``spatial_algorithm="IP"``/``"IP1"``: each step weighs every scalar by
    ``d_contrast_fn(|y|) / flooring_fn(2 |y|)``, takes the weighted
    covariance with those ``(N, I, T)`` weights and runs the IP1 sweep.
    ``"IP2"``: for each pair of ``pair_selector`` (sequential by default),
    the weights of the pair's two current rows, their covariances (K1 at
    two sources) and the IP2 pair update.
    """

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[PairSelector] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        permutation_alignment: Union[bool, str] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        if spatial_algorithm not in SPATIAL_ALGORITHMS:
            raise ValueError(f"unsupported option: {spatial_algorithm}.")
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if d_contrast_fn is None:
            raise ValueError("a d_contrast_fn must be provided.")
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.spatial_algorithm = spatial_algorithm
        self.contrast_fn = contrast_fn
        self.d_contrast_fn = d_contrast_fn
        if pair_selector is None and spatial_algorithm == "IP2":
            pair_selector = sequential_pair_selector
        self.pair_selector = pair_selector

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, type(self).__name__, keys)

    def _varphi(self, Y: torch.Tensor) -> torch.Tensor:
        """The MM weight per scalar, ``d_contrast_fn(|y|) / flooring_fn(2 |y|)`` (ssspy_tpu/bss/fdica.py:546-548)."""
        Y_abs = Y.abs()
        return self.d_contrast_fn(Y_abs) / self.flooring_fn(2 * Y_abs)

    def make_step(self):
        varphi_of = self._varphi
        # a max-type flooring_fn is an eps for the kernels; any other reaches the spatial updates that the
        # JAX class floors with it (update_by_ip1, update_by_ip2_one_pair: ssspy_tpu/bss/fdica.py:561, :574)
        eps, floor = step_flooring(self.flooring_fn, self.input.dtype)

        if self.spatial_algorithm == "IP2":
            pair_selector = self.pair_selector

            def step(state):
                W = auxiva_ip2_step(state["X"], state["W"], eps=eps, pair_selector=pair_selector,
                                    varphi_of=lambda Y, pair: varphi_of(Y), flooring_fn=floor)
                return {**state, "W": W}

        else:

            def step(state):
                X, W = state["X"], state["W"]
                U = covariance(X, varphi_of(_separate(X, W)))
                return {**state, "W": ip1_update(W, U, eps=eps, flooring_fn=floor)}

        return step


class GradLaplaceFDICA(GradFDICA):
    """Gradient FDICA with a Laplace prior (parity: ssspy/bss/fdica.py:1248-1384): score ``y / flooring_fn(|y|)``."""

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        permutation_alignment: Union[bool, str] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        def score_fn(y):
            return y / self.flooring_fn(y.abs())

        super().__init__(
            step_size=step_size,
            contrast_fn=_laplace_contrast,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )


class NaturalGradLaplaceFDICA(GradLaplaceFDICA, NaturalGradFDICA):
    """Natural-gradient FDICA with a Laplace prior (parity: ssspy/bss/fdica.py:1386-1524)."""


class AuxLaplaceFDICA(AuxFDICA):
    """AuxFDICA with a Laplace prior (parity: ssspy/bss/fdica.py:1527-1667).

    In complex64 the weight per scalar is ``1 / flooring_fn(|y|)``, the
    fast paths' form
    (:func:`~ssspy_tpu_torch.ops.fdica_steps.scalar_laplace_varphi`): with
    the floor of ``fast_aux_fdica`` (``"dtype"`` in complex64, 1e-6) the
    class runs its trajectory to the bit. In complex128, and with a
    ``flooring_fn`` that is not ``max(., eps)``, it takes the JAX complex
    class's form ``2 / flooring_fn(2 |y|)`` (ssspy_tpu/bss/fdica.py:546-548),
    which differs from the other where ``|y|`` falls under the floor.
    """

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[PairSelector] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        permutation_alignment: Union[bool, str] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            spatial_algorithm=spatial_algorithm,
            contrast_fn=_laplace_contrast,
            d_contrast_fn=lambda y: 2 * torch.ones_like(y),
            flooring_fn=flooring_fn,
            pair_selector=pair_selector,
            callbacks=callbacks,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )

    def _varphi(self, Y: torch.Tensor) -> torch.Tensor:
        if Y.dtype != torch.complex64 or sweep_eps(self.flooring_fn, Y.dtype) is None:
            return super()._varphi(Y)
        return 1.0 / self.flooring_fn(Y.abs())
