"""Kernels of the separation hot path and the steps built on them."""

from .ilrma_steps import (
    gauss_ilrma_ip1_step,
    gauss_ilrma_iss1_step,
    ilrma_ip_step,
    ilrma_iss_step,
    ilrma_loss,
)
from .iva_steps import (
    auxiva_ip1_step,
    auxiva_iss1_step,
    clogabsdet,
    iva_laplace_loss,
    ls_demix,
    separate,
)
from .kernels import (
    gauss_jordan_solve_nopivot,
    ip1_sweep,
    ip1_sweep_plain,
    iss1_sweep,
    iss1_sweep_plain,
    weighted_covariance,
    weighted_covariance_plain,
)

__all__ = [
    "auxiva_ip1_step",
    "auxiva_iss1_step",
    "clogabsdet",
    "iva_laplace_loss",
    "ls_demix",
    "separate",
    "gauss_ilrma_ip1_step",
    "gauss_ilrma_iss1_step",
    "ilrma_ip_step",
    "ilrma_iss_step",
    "ilrma_loss",
    "gauss_jordan_solve_nopivot",
    "ip1_sweep",
    "ip1_sweep_plain",
    "iss1_sweep",
    "iss1_sweep_plain",
    "weighted_covariance",
    "weighted_covariance_plain",
]
