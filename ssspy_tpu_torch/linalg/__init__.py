"""Linear-algebra helpers of the port: the reference's public helpers (the (generalized) Hermitian eigendecompositions, the 2 x 2 inverse, the solve, quadratic forms, matrix square roots, the geometric mean, the cubic solver and cube root, LQPQM), the proximal operators of the prox family, the closed-form 2 x 2 generalized eigenproblem of IP2 and ISS2, and the eigendecomposition-free routes (pivot-certified Cholesky, shift-invert top eigenvector, QDWH schedule, secular root).

As in :mod:`ssspy_tpu.linalg`, the name ``eigh`` here is the function; its
module stays importable as ``ssspy_tpu_torch.linalg.eigh`` (``from
ssspy_tpu_torch.linalg.eigh import gevd2``).
"""

from . import eig_free, lqpqm, matrix, prox
from .eig_free import (
    chol_piv,
    qdwh_schedule,
    secular_root_solve,
    top_eigvec_shift_invert,
    tri_lower_inv,
)
from .eigh import eigh, eigh2, gevd2
from .lqpqm import cbrt, lqpqm2, solve_cubic
from .matrix import gmeanmh, inv2, invsqrtmh, quadratic, solve, sqrtmh

__all__ = [
    "cbrt",
    "quadratic",
    "inv2",
    "eigh",
    "eigh2",
    "sqrtmh",
    "invsqrtmh",
    "gmeanmh",
    "solve_cubic",
    "lqpqm2",
    "solve",
    "eig_free",
    "gevd2",
    "lqpqm",
    "matrix",
    "prox",
    "chol_piv",
    "tri_lower_inv",
    "top_eigvec_shift_invert",
    "qdwh_schedule",
    "secular_root_solve",
]
