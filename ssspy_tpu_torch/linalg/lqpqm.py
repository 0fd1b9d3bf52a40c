"""Log-quadratically penalized quadratic minimization (LQPQM, type 2): IPA's inner solver.

Counterpart of :mod:`ssspy_tpu.linalg.lqpqm` (parity target
ssspy/linalg/lqpqm.py:13-352) on torch tensors. Both branches (singular
``v = 0`` and regular) are computed for the whole batch and merged with
``torch.where``, and the Newton iteration runs a fixed ``max_iter`` trips in
a Python loop that freezes converged entries elementwise, so nothing in
here reads a value back to the host.
"""

import functools
import math
from typing import Callable, Optional, Union

import torch

from ..special.flooring import EPS, identity, max_flooring
from ..special.psd import eigh_in_batches

__all__ = ["cbrt", "solve_cubic", "lqpqm2", "solve_equation"]


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root: the real root of a real tensor, the principal branch (phase / 3) of a complex one.

    Counterpart of ``ssspy_tpu.linalg.cubic.cbrt`` (cubic.py:6-12).
    """
    if x.is_complex():
        return torch.polar(x.abs() ** (1 / 3), x.angle() / 3)
    return torch.sign(x) * x.abs() ** (1 / 3)


def solve_cubic(
    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, D: Optional[torch.Tensor] = None, all: bool = True
) -> torch.Tensor:
    """The roots of cubic equations by Cardano's formula, elementwise over the batch.

    With ``D`` solves ``A x^3 + B x^2 + C x + D = 0`` (every ``A != 0``),
    otherwise the monic ``x^3 + A x^2 + B x + C = 0``. The three complex
    roots stacked on a new leading axis (``all=True``), else the first.
    Counterpart of ``ssspy_tpu.linalg.solve_cubic`` (polynomial.py:14-36;
    parity: ssspy/linalg/polynomial.py:9-95).
    """
    if D is not None:
        return solve_cubic(B / A, C / A, D / A, all=all)
    P = -(A**2) / 3 + B
    Q = (2 * A**3) / 27 - (A * B) / 3 + C
    cdtype = torch.complex128 if torch.float64 in (P.real.dtype, Q.real.dtype) else torch.complex64
    P, Q = P.to(cdtype), Q.to(cdtype)
    omega = torch.complex(torch.tensor(-0.5), torch.tensor(math.sqrt(3) / 2)).to(cdtype)
    discriminant = (Q / 2) ** 2 + (P / 3) ** 3
    U = cbrt(-Q / 2 + torch.sqrt(discriminant))
    singular = P == 0  # U = 0 exactly when P = 0
    U = torch.where(singular, torch.ones_like(U), U)
    V = -P / (3 * U)
    X1 = torch.where(singular, cbrt(-Q), U + V)
    X2 = torch.where(singular, X1 * omega, U * omega + V * omega.conj())
    X3 = torch.where(singular, X1 * omega.conj(), U * omega.conj() + V * omega)
    x = torch.stack([X1, X2, X3]) - A / 3
    return x if all else x[0]


def _floor_at_zero(flooring_fn: Callable, like: torch.Tensor) -> torch.Tensor:
    """``flooring_fn(0)`` as a 0-dim real tensor of ``like``'s precision and device."""
    return flooring_fn(torch.zeros((), dtype=like.real.dtype, device=like.device))


def lqpqm2(
    H: torch.Tensor,
    v: torch.Tensor,
    z: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    singular_fn: Optional[Union[str, Callable]] = "flooring",
    max_iter: int = 10,
) -> torch.Tensor:
    """Solve ``min_q q^H q - log((q + v)^H H (q + v) + z)``, batched over bins.

    ``H``: PSD ``(n_bins, K, K)``; ``v``: ``(n_bins, K)``; ``z``: real
    ``(n_bins,)``. ``singular_fn`` marks ``||v||`` as singular:
    ``"flooring"`` is ``x < flooring_fn(0)``, ``None`` is ``x == 0``.
    Returns the solutions ``(n_bins, K)``. The reference form
    (lqpqm.py:27-91): eigendecomposition of ``H`` and the eigen-sum
    ``sum_i sigma_i phi_i v~_i / (lamb - phi_i)``. The singular branch steps
    along the top eigenvector (a column of the eigenvector matrix; the
    reference indexes a row: same norm, other direction). The float32 sweep
    uses :func:`ssspy_tpu_torch.ops.ipa_steps.lqpqm2` instead, whose
    solution does not cancel at the pole.
    """
    if flooring_fn is None:
        flooring_fn = identity
    if singular_fn is None:
        def singular_fn(x):
            return x == 0
    elif isinstance(singular_fn, str):
        if singular_fn != "flooring":
            raise ValueError(f"unknown singular_fn {singular_fn!r}; expected 'flooring', None or a callable")
        floor0 = _floor_at_zero(flooring_fn, H)

        def singular_fn(x):  # noqa: F811
            return x < floor0
    elif not callable(singular_fn):
        raise TypeError("singular_fn must be callable.")

    phi, sigma = eigh_in_batches(H)
    is_singular = singular_fn(torch.linalg.vector_norm(v, dim=-1))

    phi_max = phi[..., -1]
    sigma_max = sigma[..., :, -1]
    lamb_singular = torch.maximum(z, phi_max)
    positive = phi_max > 0
    scale = torch.where(
        positive, (lamb_singular - z) / torch.where(positive, phi_max, 1.0), 0.0
    )
    scale = torch.sqrt(torch.clamp(scale, min=0))
    y_singular = scale[..., None] * sigma_max

    v_tilde = torch.sum(sigma.conj() * v[..., :, None], dim=-2)
    lamb = solve_equation(phi, v_tilde, z, flooring_fn=flooring_fn, max_iter=max_iter, normalization=True)
    denom = lamb[..., None] - phi
    denom = torch.where(denom == 0, 1.0, denom)
    y_non_singular = torch.sum(sigma * (phi * v_tilde / denom)[..., None, :], dim=-1)

    return torch.where(is_singular[..., None], y_singular, y_non_singular)


def solve_equation(
    phi: torch.Tensor,
    v: torch.Tensor,
    z: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    max_iter: int = 10,
    normalization: bool = True,
    root_finder: Optional[Callable] = None,
) -> torch.Tensor:
    """Largest root of ``f(l) = l^2 sum_i phi_i |v_i|^2 / (l - phi_i)^2 - l + z``.

    ``phi``: real ``(n_bins, K)``; ``v``: ``(n_bins, K)`` (only ``|v|`` is
    read); ``z``: ``(n_bins,)``. Terms with ``phi |v|^2`` under
    ``flooring_fn(0)`` are masked out, a cubic through the top term gives
    the start (``root_finder``, :func:`_find_largest_root` by default), and
    ``max_iter`` Newton trips follow, each falling back to the midpoint
    towards ``phi_max`` when it would cross the pole.

    A quirk of the reference, kept for parity (lqpqm.py:109-123): with
    ``normalization`` the substitution ``l = phi_max l~`` divides ``v`` by
    ``phi_max`` where it needs ``sqrt(phi_max)``, so the normalized Newton
    converges to the root of another secular function and the returned
    value does not in general satisfy ``f(l) = 0``. IPA converges to the
    same separation either way, because the sweep pre-normalizes by the
    trace.
    """
    if flooring_fn is None:
        flooring_fn = identity
    if root_finder is None:
        root_finder = _find_largest_root
    floor0 = _floor_at_zero(flooring_fn, phi)
    v = v.abs()

    keep = phi * v**2 >= floor0
    phi = torch.where(keep, phi, 0.0)
    v = torch.where(keep, v, 0.0)

    max_index = torch.argmax(phi, dim=-1, keepdim=True)
    phi_max = flooring_fn(torch.gather(phi, -1, max_index)[..., 0])
    v_max = torch.gather(v, -1, max_index)[..., 0]

    if normalization:
        phi_max_original = phi_max
        phi = phi / phi_max[..., None]
        v = v / phi_max[..., None]
        v_max = v_max / phi_max
        z = z / phi_max
        phi_max = torch.ones_like(phi_max)

    A = -(phi_max * v_max**2 + 2 * phi_max + z)
    B = (phi_max + 2 * z) * phi_max
    C = -(phi_max**2) * z
    lamb = root_finder(A, B, C)

    # the clamp below turns NaN into the bracket's edge (the comparison is
    # False) but lets +inf through max(lamb, z): a non-finite start, which
    # float32 reaches on degenerate coefficients, takes the edge as well
    lamb = torch.where(torch.isfinite(lamb), lamb, phi_max)
    lamb = torch.where(lamb > phi_max, lamb, phi_max + floor0)
    lamb = torch.maximum(lamb, z)

    for _ in range(max_iter):
        f = _fn(lamb, phi, v, z)
        mu = lamb - f / _d_fn(lamb, phi, v)
        candidate = torch.where(mu > phi_max, mu, (phi_max + lamb) / 2)
        lamb = torch.where(f.abs() <= floor0, lamb, candidate)

    if normalization:
        lamb = lamb * phi_max_original
    return lamb


def _root_scale(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Homogeneous scale ``s = max(|A|, sqrt|B|, cbrt|C|)`` of ``x^3 + A x^2 + B x + C`` (1 where that is 0).

    With ``x = s t`` the cubic in ``t`` has coefficients of order 1. The
    reference evaluates Cardano on the raw ones, which overflows float32
    when every ``phi |v|^2`` falls under the mask floor: ``phi_max``
    collapses to ``eps``, ``z / eps`` reaches 1e9 and ``A^3`` 1e29. Every
    branch condition of the root formulas is invariant under the scaling,
    so the same branches are taken (lqpqm.py:183-200).
    """
    s = torch.maximum(torch.maximum(A.abs(), B.abs().sqrt()), C.abs() ** (1 / 3))
    return torch.where(s > 0, s, 1.0)


def _find_largest_root(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Largest real root of ``x^3 + A x^2 + B x + C`` by Cardano's formula on complex tensors.

    The roots that come as complex-conjugate pairs are masked out of the
    maximum; the coefficients are rescaled first (:func:`_root_scale`).
    Counterpart of ``_find_largest_root`` (lqpqm.py:203-245).
    """
    s_scale = _root_scale(A, B, C)
    A, B, C = A / s_scale, B / s_scale**2, C / s_scale**3
    P = -(A**2) / 3 + B
    Q = (2 * A**3) / 27 - (A * B) / 3 + C

    cdtype = torch.complex128 if P.dtype == torch.float64 else torch.complex64
    omega = complex(-0.5, math.sqrt(3.0) / 2)
    omega_conj = omega.conjugate()
    Pc, Qc = P.to(cdtype), Q.to(cdtype)

    discriminant = ((Q / 2) ** 2 + (P / 3) ** 3).to(cdtype)
    U = cbrt(-Qc / 2 + torch.sqrt(discriminant))
    is_singular = U == 0
    U = torch.where(is_singular, torch.ones_like(U), U)
    V = -Pc / (3 * U)

    X1 = torch.where(is_singular, cbrt(-Qc), U + V)
    X2 = (U * omega + V * omega_conj).real
    X3 = (U * omega_conj + V * omega).real

    # X2 and X3 are a complex-conjugate pair where the cubic is monotonic
    # or its discriminant is positive
    paired = (P >= 0) | (discriminant.real > 0)
    neg_inf = torch.full_like(X2, -math.inf)
    roots = torch.stack([X1.real, torch.where(paired, neg_inf, X2), torch.where(paired, neg_inf, X3)], dim=-1)
    return (roots.amax(dim=-1) - A / 3) * s_scale


def _find_largest_root_real(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """:func:`_find_largest_root` in real arithmetic, quirks included (lqpqm.py:248-293).

    - Positive discriminant: the reference takes the real part of the
      principal complex cube root, which for ``-Q/2 + sqrt(D) < 0`` is
      ``(u + w) / 2`` and not the real root ``-(u + w)``. The value only
      seeds a clamped Newton iteration.
    - Otherwise three real roots, the largest ``2 r cos(theta / 3)``.
    """
    s_scale = _root_scale(A, B, C)
    A, B, C = A / s_scale, B / s_scale**2, C / s_scale**3
    P = -(A**2) / 3 + B
    Q = (2 * A**3) / 27 - (A * B) / 3 + C
    D = (Q / 2) ** 2 + (P / 3) ** 3

    s = -Q / 2 + torch.sqrt(torch.clamp(D, min=0))
    u = s.abs() ** (1 / 3)
    w = -P / (3 * torch.where(u > 0, u, 1.0))
    x1 = torch.where(s >= 0, u + w, (u + w) / 2)
    # s == 0: X1 = cbrt(-Q), on the principal branch where -Q < 0
    cbrt_q = Q.abs() ** (1 / 3)
    x1_zero = torch.where(-Q >= 0, cbrt_q, cbrt_q / 2)
    root_pos = torch.where(u > 0, x1, x1_zero)

    P_neg = torch.clamp(P, max=0)
    r = torch.sqrt(-P_neg / 3)
    cos_arg = torch.where(r > 0, 3 * Q / torch.where(r > 0, 2 * P_neg * r, 1.0), 1.0)
    theta = torch.arccos(torch.clamp(cos_arg, -1, 1))
    root_neg = 2 * r * torch.cos(theta / 3)

    return (torch.where(D > 0, root_pos, root_neg) - A / 3) * s_scale


def _fn(lamb, phi, v, z):
    denom = (lamb[..., None] - phi) ** 2
    denom = torch.where(denom == 0, 1.0, denom)
    return lamb**2 * torch.sum(phi * v.abs() ** 2 / denom, dim=-1) - lamb + z


def _d_fn(lamb, phi, v):
    denom = (lamb[..., None] - phi) ** 3
    denom = torch.where(denom == 0, 1.0, denom)
    return -2 * lamb * torch.sum((phi * v.abs()) ** 2 / denom, dim=-1) - 1
