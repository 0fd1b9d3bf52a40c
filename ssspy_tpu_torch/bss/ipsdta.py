"""Independent positive semidefinite tensor analysis (IPSDTA): Gauss and Student's-t source models.

Counterpart of :mod:`ssspy_tpu.bss.ipsdta` (parity target
ssspy/bss/ipsdta.py) for ``IPSDTABase``, ``BlockDecompositionIPSDTABase``,
``GaussIPSDTA`` and ``TIPSDTA`` with the MM source update and the VCD
spatial update. The source model is a PSDTF with block decomposition of the
bin axis: ``n_blocks`` blocks, the last ``n_remains`` of them one bin longer,
each block a full PSD covariance over its bins per basis
(:mod:`ssspy_tpu_torch.ops.ipsdta_steps`). One iteration is
:func:`~ssspy_tpu_torch.ops.ipsdta_steps.ipsdta_vcd_step`, the same function
that ``fast_gauss_ipsdta`` and ``fast_t_ipsdta`` run; its routes follow the
input's dtype (complex64: the model's inverse through the kernel K3 and the
geometric mean's eigh through K7; complex128: the reference's eigh model).
The EM source update and the FPI spatial update raise
``NotImplementedError``, as in the JAX package and the reference.
"""

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..ops.ipsdta_steps import (
    _model,
    ipsdta_loss,
    ipsdta_vcd_step,
    normalize_psdtf,
    part_shapes,
    random_psdtf,
)
from ..ops.iva_steps import clogabsdet, separate
from ..ops.mnmf_steps import psd_project
from ..utils.device import DEFAULT_DEVICE
# re-exported, as the reference does
from ._update_spatial_model import (  # noqa: F401
    update_by_block_decomposition_vcd,
)
from .base import SeparatorBase, config_repr
from .mnmf import mnmf_flooring

__all__ = ["IPSDTABase", "BlockDecompositionIPSDTABase", "GaussIPSDTA", "TIPSDTA"]

spatial_algorithms = ["FPI", "VCD"]
source_algorithms = ["EM", "MM"]


class IPSDTABase(SeparatorBase):
    """Base class of IPSDTA (parity: ssspy/bss/ipsdta.py:26-382).

    ``rng``: the ``np.random.Generator`` the PSDTF start is drawn from, on
    the host and in the JAX class's order, then moved to ``device`` (the
    card by default).
    """

    def __init__(
        self,
        n_basis: int,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        if reference_id is None and scale_restoration:
            raise ValueError("scale_restoration=True needs a reference_id channel.")
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.n_basis = n_basis
        self.rng = np.random.default_rng() if rng is None else rng

    def __repr__(self) -> str:
        keys = ["n_basis", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "IPSDTA", keys)

    def separate(self, input, demix_filter):
        return separate(input, demix_filter)

    def compute_logdet(self, demix_filter):
        return clogabsdet(demix_filter)


class BlockDecompositionIPSDTABase(IPSDTABase):
    """IPSDTA with block decomposition of the frequency axis (parity: ssspy/bss/ipsdta.py:385-697).

    ``basis`` is one tensor ``(N, K, B, J, J)``, or, when the bins do not
    divide into ``n_blocks`` (``n_remains > 0``), a tuple of it and the
    remainder part ``(N, K, n_remains, J + 1, J + 1)``; ``activation`` is
    ``(N, K, T)``. Warm start through ``basis=``, ``activation=`` and
    ``demix_filter=``. A start that is drawn is normalized (unit summed
    trace, with ``source_normalization``); a warm start of both the basis
    and the activation goes on as given, since each step normalizes, so
    that a resumed run repeats the uninterrupted one to the bit (the JAX
    class normalizes it again, which moves it by rounding). ``flooring_fn`` must floor with ``max(., eps)``; the
    step projects, floors and tests singular VCD updates with that ``eps``,
    1e-10 under ``"dtype"`` in either precision, as the JAX step takes it.
    """

    dof = None  # the Gaussian model
    source_normalization = True
    source_algorithm = "MM"
    spatial_algorithm = "VCD"

    def __init__(
        self,
        n_basis: int,
        n_blocks: int,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            n_basis,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            device=device,
        )
        self.n_blocks = n_blocks

    def __repr__(self) -> str:
        keys = ["n_basis", "n_blocks", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "IPSDTA", keys)

    @property
    def n_remains(self) -> int:
        if not hasattr(self, "n_bins"):
            raise AttributeError("n_remains is undefined until n_bins is known (bind input first).")
        return self.n_bins % self.n_blocks

    def _basis_parts(self, basis) -> list:
        return list(basis) if isinstance(basis, (tuple, list)) else [basis]

    def _basis_from_parts(self, parts):
        return tuple(parts) if len(parts) > 1 else parts[0]

    def _reset(self, **kwargs) -> None:
        if self.source_algorithm != "MM":
            # the reference raises when the EM update is reached (ssspy/bss/ipsdta.py:860-863, :1374-1377)
            raise NotImplementedError(f"the {self.source_algorithm} source update of IPSDTA is not implemented; use MM.")
        if self.spatial_algorithm != "VCD":
            raise NotImplementedError(f"the {self.spatial_algorithm} spatial update of IPSDTA is not implemented; use VCD.")
        self._set_warm_start(kwargs)
        n_channels, n_bins, n_frames = self.input.shape
        self.n_sources, self.n_channels = n_channels, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames
        self._reset_demix_filter(kwargs)
        self._init_block_decomposition_psdtf()

    def _init_block_decomposition_psdtf(self) -> None:
        """The PSDTF start (ssspy_tpu/bss/ipsdta.py:226-267): random where no warm start is set.

        Normalized unless both the basis and the activation were given (see the class).
        """
        X = self.input
        warm = hasattr(self, "basis") and hasattr(self, "activation")
        eps, floor = mnmf_flooring(self.flooring_fn)
        T_parts, V = random_psdtf(
            self.rng, self.n_sources, self.n_basis, self.n_frames, part_shapes(self.n_bins, self.n_blocks),
            X.dtype, X.device, eps, basis=not hasattr(self, "basis"), activation=not hasattr(self, "activation"),
            flooring_fn=floor,
        )
        if T_parts is None:
            T_parts = [
                torch.as_tensor(p, device=X.device).to(X.dtype).contiguous().clone()
                for p in self._basis_parts(self.basis)
            ]
        if V is None:
            V = torch.as_tensor(self.activation, device=X.device).to(X.real.dtype).contiguous().clone()
        if self.source_normalization and not warm:
            T_parts, V = normalize_psdtf(T_parts, V)
        self.basis, self.activation = self._basis_from_parts(T_parts), V

    def reconstruct_block_decomposition_psdtf(self, basis, activation):
        """Per-part projected model ``(N, T, B, J, J)`` (parity: ssspy/bss/ipsdta.py:584-663)."""
        eps = mnmf_flooring(self.flooring_fn)[0]
        parts = [psd_project(_model(T, activation), eps, "eigh") for T in self._basis_parts(basis)]
        return self._basis_from_parts(parts)

    def normalize_block_decomposition_psdtf(self) -> None:
        """Unit summed trace of each basis, the scale moved to the activation (parity: ssspy/bss/ipsdta.py:666-697)."""
        if not self.source_normalization:
            raise RuntimeError("a source_normalization mode is required.")
        T_parts, self.activation = normalize_psdtf(self._basis_parts(self.basis), self.activation)
        self.basis = self._basis_from_parts(T_parts)

    # ---- state plumbing ----------------------------------------------------

    warm_start_keys = {"W": "demix_filter", "T_parts": "basis", "V": "activation"}

    def init_state(self):
        return {
            "X": self.input,
            "W": self.demix_filter,
            "T_parts": tuple(self._basis_parts(self.basis)),
            "V": self.activation,
        }

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter, self.activation = state["W"], state["V"]
        self.basis = self._basis_from_parts(list(state["T_parts"]))
        self.output = separate(state["X"], state["W"])

    # ---- one iteration and the loss -------------------------------------------

    def make_step(self):
        (eps, floor), dof, normalization = mnmf_flooring(self.flooring_fn), self.dof, bool(self.source_normalization)

        def step(state):
            W, T_parts, V = ipsdta_vcd_step(
                state["X"], state["W"], state["T_parts"], state["V"], dof=dof, eps=eps, normalization=normalization,
                flooring_fn=floor,
            )
            return {**state, "W": W, "T_parts": tuple(T_parts), "V": V}

        return step

    def make_loss(self):
        (eps, floor), dof = mnmf_flooring(self.flooring_fn), self.dof

        def loss(state):
            return ipsdta_loss(state["X"], state["W"], state["T_parts"], state["V"], dof=dof, eps=eps, flooring_fn=floor)

        return loss


def _check_algorithms(source_algorithm: str, spatial_algorithm: str) -> None:
    if source_algorithm not in source_algorithms:
        raise ValueError(f"unsupported option: {source_algorithm}.")
    if spatial_algorithm not in spatial_algorithms:
        raise ValueError(f"unsupported option: {spatial_algorithm}.")


class GaussIPSDTA(BlockDecompositionIPSDTABase):
    """Gaussian IPSDTA (parity: ssspy/bss/ipsdta.py:700-1227).

    ``source_normalization=False`` skips the unit-trace normalization of the
    basis, at the start and in every iteration.
    """

    def __init__(
        self,
        n_basis: int,
        n_blocks: int,
        source_algorithm: str = "MM",
        spatial_algorithm: str = "VCD",
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        source_normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        _check_algorithms(source_algorithm, spatial_algorithm)
        super().__init__(
            n_basis,
            n_blocks,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            device=device,
        )
        self.source_normalization = source_normalization
        self.source_algorithm = source_algorithm
        self.spatial_algorithm = spatial_algorithm

    def __repr__(self) -> str:
        keys = ["n_basis", "n_blocks", "source_algorithm", "spatial_algorithm", "source_normalization",
                "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GaussIPSDTA", keys)


class TIPSDTA(BlockDecompositionIPSDTABase):
    """Student's-t IPSDTA (parity: ssspy/bss/ipsdta.py:1230-1869).

    The t prior couples the two block parts through the frame weight
    ``pi = (dof + 2 I) / (dof + 2 sum_b y^H R^-1 y)``, taken afresh before
    each of the basis, activation and spatial updates.
    """

    def __init__(
        self,
        n_basis: int,
        n_blocks: int,
        dof: float,
        source_algorithm: str = "MM",
        spatial_algorithm: str = "VCD",
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        source_normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        _check_algorithms(source_algorithm, spatial_algorithm)
        super().__init__(
            n_basis,
            n_blocks,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            device=device,
        )
        self.dof = float(dof)
        self.source_normalization = source_normalization
        self.source_algorithm = source_algorithm
        self.spatial_algorithm = spatial_algorithm

    def __repr__(self) -> str:
        keys = ["n_basis", "n_blocks", "dof", "source_algorithm", "spatial_algorithm", "source_normalization",
                "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "TIPSDTA", keys)
