"""Linear-algebra helpers of the port: the proximal operators of the prox family, IPA's LQPQM solver, the closed-form 2 x 2 generalized eigenproblem of IP2 and ISS2, and the eigendecomposition-free routes (pivot-certified Cholesky, shift-invert top eigenvector, QDWH schedule, secular root)."""

from . import eig_free, eigh, lqpqm, prox
from .eig_free import (
    chol_piv,
    qdwh_schedule,
    secular_root_solve,
    top_eigvec_shift_invert,
    tri_lower_inv,
)
from .eigh import gevd2
from .lqpqm import lqpqm2

__all__ = [
    "eig_free",
    "eigh",
    "gevd2",
    "lqpqm",
    "lqpqm2",
    "prox",
    "chol_piv",
    "tri_lower_inv",
    "top_eigvec_shift_invert",
    "qdwh_schedule",
    "secular_root_solve",
]
