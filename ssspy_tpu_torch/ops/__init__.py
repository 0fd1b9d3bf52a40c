"""Kernels of the separation hot path and the steps built on them."""

from .iva_steps import auxiva_ip1_step, clogabsdet, iva_laplace_loss, separate
from .kernels import (
    gauss_jordan_solve_nopivot,
    ip1_sweep,
    ip1_sweep_plain,
    weighted_covariance,
    weighted_covariance_plain,
)

__all__ = [
    "auxiva_ip1_step",
    "clogabsdet",
    "iva_laplace_loss",
    "separate",
    "gauss_jordan_solve_nopivot",
    "ip1_sweep",
    "ip1_sweep_plain",
    "weighted_covariance",
    "weighted_covariance_plain",
]
