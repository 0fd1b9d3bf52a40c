"""Eigendecomposition-free linear algebra on real embeddings of Hermitian matrices.

Counterparts of the XLA helpers of ``ssspy_tpu/ops/splitc.py`` that replace
an eigh by Cholesky factors and triangular solves: the pivot-certified
Cholesky ``_chol_unrolled_piv`` (:3179-3202) and ``_tri_lower_inv``
(:3205-3219); the shift-invert top eigenvector ``_top_eigvec_shift_invert_sc``
(:3929-3989); the QDWH weight schedule ``_qdwh_schedule`` (:3798-3820) of
the polar factor; and the LQPQM secular root without an eigh,
``_largest_real_cubic_root`` (:1296-1316), ``_secular_model_root``
(:1319-1330), ``_psd_power_probe`` (:1333-1349) and
``_secular_root_solve_sc`` (:1352-1500). The port takes complex tensors and
embeds them here; float64 runs the JAX package's float64 arithmetic, float32
its float32 arithmetic. None of them is a kernel: each is a chain of small
batched PyTorch operations, on whatever device its input lies.

The JAX package takes these routes only on a float32 TPU, where its Jacobi
eigh dominates the step. The port's paths keep their eigh routes (the
Jacobi kernel K7) by default; each free route is an option of the step
that uses it (``ops.ipa_steps.lqpqm2``'s ``secular_impl="solve"``,
``ops.fixed_point_iva_steps.polar``'s ``impl="qdwh"``,
``faster_iva_step``'s ``eig_impl="solve"``).
"""

import math
from typing import List, Tuple

import torch

from .lqpqm import cbrt

__all__ = [
    "block_embed",
    "chol_piv",
    "tri_lower_inv",
    "psd_power_probe",
    "top_eigvec_shift_invert",
    "qdwh_schedule",
    "largest_real_cubic_root",
    "secular_model_root",
    "secular_root_solve",
]

def block_embed(A: torch.Tensor) -> torch.Tensor:
    """Real embedding ``E(A) = [[Ar, -Ai], [Ai, Ar]]`` of complex ``(..., m, k)``: ``(..., 2m, 2k)``."""
    Ar, Ai = A.real, A.imag
    return torch.cat([torch.cat([Ar, -Ai], dim=-1), torch.cat([Ai, Ar], dim=-1)], dim=-2)


def _symmetric_embed(A: torch.Tensor) -> torch.Tensor:
    """``E(A)`` of Hermitian ``A``, symmetrised against rounding."""
    E = block_embed(A)
    return (E + E.transpose(-1, -2)) / 2


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A x``."""
    return (A @ x[..., None])[..., 0]


def _mtv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A^T x``."""
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def _unit(x: torch.Tensor, tiny: float) -> torch.Tensor:
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1)), min=tiny)[..., None]


def chol_piv(S: torch.Tensor, tiny: float = 1e-30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky factor of real symmetric ``(..., n, n)``, column by column, and its least pivot.

    Cholesky-Banachiewicz as ``splitc._chol_unrolled_piv``
    (splitc.py:3179-3202): each diagonal entry is floored at ``tiny`` before
    its square root divides the column, so a semidefinite or indefinite
    input still gives a finite factor (``torch.linalg.cholesky_ex`` stops at
    the first failed pivot). The second output is ``min_j c_jj``, the least
    pivot before the floor: positive exactly where ``S`` is positive
    definite, the certificate the bisections below read.
    """
    n = S.shape[-1]
    rows = torch.arange(n, device=S.device)
    cols: List[torch.Tensor] = []
    least = None
    for j in range(n):
        c = S[..., :, j]
        if j:
            L = torch.stack(cols, dim=-1)  # (..., n, j)
            c = c - (L @ L[..., j, :, None])[..., 0]
        pivot = c[..., j]
        least = pivot if least is None else torch.minimum(least, pivot)
        d = torch.sqrt(torch.clamp(c[..., j : j + 1], min=tiny))
        cols.append(torch.where(rows >= j, c / d, torch.zeros_like(c)))
    return torch.stack(cols, dim=-1), least


def tri_lower_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of real lower-triangular ``(..., n, n)``: ``splitc._tri_lower_inv`` (splitc.py:3205-3219).

    The JAX package unrolls the forward substitution on the identity for
    its TPU; here it is one batched triangular solve.
    """
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def psd_power_probe(E: torch.Tensor) -> torch.Tensor:
    """Start of a power or inverse iteration on real PSD ``(..., n, n)``: ``E r + diag(E)``.

    ``r_k = 1 + cos(k * golden angle)``, fixed and nonnegative: the diagonal
    alone can be orthogonal to the top eigenspace (``v v^H`` with
    ``v = (1, -1) / sqrt(2)``). Counterpart of ``splitc._psd_power_probe``
    (splitc.py:1333-1349).
    """
    idx = torch.arange(E.shape[-1], dtype=E.dtype, device=E.device)
    r = 1.0 + torch.cos(idx * 2.399963229728653)
    return (E @ r) + E.diagonal(dim1=-2, dim2=-1)


def top_eigvec_shift_invert(
    A: torch.Tensor, bisect_trips: int = 12, inv_iters: int = 3, tiny: float = 1e-30
) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of Hermitian PSD ``A (..., M, M)``, without an eigh: ``(..., M)``.

    On the real ``2M x 2M`` embedding ``E``: two squared power steps from
    :func:`psd_power_probe` give a Rayleigh quotient below ``lamb_max`` and
    the Gershgorin bound one above; ``bisect_trips`` bisections on whether
    ``mu I - E`` is positive definite (the least pivot of :func:`chol_piv`)
    close in on ``lamb_max`` from above; then ``inv_iters`` inverse iterations
    reuse the factor of the last certified shift. Each complex eigenvalue
    comes twice in the embedding, so the result is the top eigenvector up to
    a phase. Counterpart of ``splitc._top_eigvec_shift_invert_sc``
    (splitc.py:3929-3989). The certificate must be the factor's own:
    ``torch.linalg.cholesky_ex`` certified shifts within ~1e-7 of
    ``lamb_max`` whose unrolled factor then failed, and the inverse iteration
    went non-finite (PERF.md, section 6).
    """
    M = A.shape[-1]
    E = _symmetric_embed(A)
    eye2 = torch.eye(2 * M, dtype=E.dtype, device=E.device)

    gersh = torch.amax(torch.sum(E.abs(), dim=-1), dim=-1)
    x = psd_power_probe(E)
    for _ in range(2):
        x = _unit(x, tiny)
        x = _mv(E, _mv(E, x))
    den = torch.sum(x * x, dim=-1)
    rayleigh = torch.where(den > 0, torch.sum(_mv(E, x) * x, dim=-1) / torch.clamp(den, min=tiny), 0.0)

    lo = rayleigh
    hi = gersh * (1 + 8 * torch.finfo(E.dtype).eps) + tiny
    for _ in range(bisect_trips):
        mid = (lo + hi) / 2
        pd = chol_piv(mid[..., None, None] * eye2 - E, tiny=tiny)[1] > 0
        hi = torch.where(pd, mid, hi)
        lo = torch.where(pd, lo, mid)

    L_inv = tri_lower_inv(chol_piv(hi[..., None, None] * eye2 - E, tiny=tiny)[0])
    v = x
    for _ in range(inv_iters):
        v = _mtv(L_inv, _mv(L_inv, _unit(v, tiny)))
    v = _unit(v, tiny)
    return torch.complex(v[..., :M], v[..., M:])


def qdwh_schedule(l0: float = 1e-5, max_iter: int = 8, tol: float = 1e-8) -> List[Tuple[float, float, float]]:
    """The dynamically weighted Halley weights ``(a, b, c)`` from a lower bound ``l0`` on ``sigma_min``.

    Nakatsukasa and Higham's QDWH schedule, computed on the host once;
    the weights tend to ``(3, 1, 3)`` (plain Halley) as the bound nears 1.
    Counterpart of ``splitc._qdwh_schedule`` (splitc.py:3798-3820).
    """
    schedule = []
    l = float(l0)  # noqa: E741
    for _ in range(max_iter):
        d = (4 * (1 - l * l) / (l**4)) ** (1.0 / 3.0)
        s = math.sqrt(1 + d)
        a = s + 0.5 * math.sqrt(max(8 - 4 * d + 8 * (2 - l * l) / (l * l * s), 0.0))
        b = (a - 1) ** 2 / 4
        c = a + b - 1
        schedule.append((a, b, c))
        l = l * (a + b * l * l) / (1 + c * l * l)  # noqa: E741
        if 1 - l < tol:
            break
    return schedule


def largest_real_cubic_root(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Largest real root of ``x^3 + A x^2 + B x + C`` by Cardano, the true real root where there is one.

    Unlike :func:`ssspy_tpu_torch.linalg.lqpqm._find_largest_root_real`,
    which keeps the reference's principal-branch quirk. Counterpart of
    ``splitc._largest_real_cubic_root`` (splitc.py:1296-1316).
    """
    P = -(A**2) / 3 + B
    Q = (2 * A**3) / 27 - (A * B) / 3 + C
    D = (Q / 2) ** 2 + (P / 3) ** 3

    sqrt_D = torch.sqrt(torch.clamp(D, min=0.0))
    root_pos = cbrt(-Q / 2 + sqrt_D) + cbrt(-Q / 2 - sqrt_D)

    # D <= 0 (so P <= 0): three real roots, the largest 2 r cos(theta / 3)
    r = torch.sqrt(torch.clamp(-P / 3, min=0.0))
    r_safe = torch.where(r > 0, r, 1.0)
    theta = torch.arccos(torch.clamp(-Q / (2 * r_safe**3), -1.0, 1.0))
    root_neg = 2 * r * torch.cos(theta / 3)
    return torch.where(D > 0, root_pos, root_neg) - A / 3


def secular_model_root(p: torch.Tensor, q2: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Root right of ``max(p, z)`` of the one-pole model ``q2 l^2 / (l - p)^2 - l + z`` (``q2 >= 0``).

    The largest real root of ``l^3 - (2p + z + q2) l^2 + (p^2 + 2pz) l - p^2 z``.
    Counterpart of ``splitc._secular_model_root`` (splitc.py:1319-1330), with
    one departure: near the pole Cardano cancels the offset ``delta = l - p``
    (in float32 it lands on ``p`` itself, a point the root lies strictly right
    of, once ``delta / p`` falls under ~1e-4). There, for ``p > z`` and
    ``delta / p <= eps^(1/3)``, the root is ``p + delta`` from the near-pole
    form of the model, ``delta = (p + delta) sqrt(q2 / (p + delta - z))``,
    started at ``p sqrt(q2 / (p - z))`` and refined twice (each refinement
    gains a factor ``delta / p``). Left to Cardano, the secular solve took that
    pole as a candidate on every other trip and ended up to 4% from the root in
    float32 (PERF.md, section 6); in float64 the two agree to rounding.
    """
    tiny = torch.finfo(p.dtype).tiny
    root = largest_real_cubic_root(-(2 * p + z + q2), p * p + 2 * p * z, -p * p * z)
    delta = p * torch.sqrt(q2 / torch.clamp(p - z, min=tiny))
    for _ in range(2):
        delta = (p + delta) * torch.sqrt(q2 / torch.clamp(p + delta - z, min=tiny))
    near_pole = (p > z) & ((delta <= torch.finfo(p.dtype).eps ** (1 / 3) * p) | (root <= p))
    return torch.where(near_pole, p + delta, root)


def secular_root_solve(
    H: torch.Tensor, v: torch.Tensor, z: torch.Tensor, trips: int = 8, tiny: float = 1e-30
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Largest root of the LQPQM secular equation without an eigendecomposition.

    ``f(l) = l^2 sum_i phi_i |v~_i|^2 / (l - phi_i)^2 - l + z`` for Hermitian
    PSD ``H (..., K, K)``, ``v (..., K)`` and real ``z (...)``, through the
    resolvent identities ``sum phi |v~|^2 / (l - phi)^2 = s^H H s`` and
    ``sum phi^2 |v~|^2 / (l - phi)^3 = w^H (l I - H)^-1 w`` with
    ``s = (l I - H)^-1 v`` and ``w = H s``: each of the ``trips`` is one
    :func:`chol_piv` of the embedded ``mu I - E(H)`` and triangular solves.
    The bracket starts at ``[max(z + v^H H v, phi_est), max(2 gersh, z + 4
    v^H H v)]``, ``phi_est`` the Rayleigh quotient of
    :func:`top_eigvec_shift_invert` (8 bisections); each trip takes the
    root of the pole model fitted to ``(S, S')`` where it lands in the
    bracket, else of the model anchored at ``phi_est``, else Newton, else
    the midpoint; a non-positive pivot certifies ``mu`` below the root. The
    result is clamped into the last certified bracket.

    Returns ``(root, (phi_est, top))``, ``top`` the unit top eigenvector
    (complex, up to phase). Counterpart of ``splitc._secular_root_solve_sc``
    (splitc.py:1352-1500).
    """
    K = H.shape[-1]
    E = _symmetric_embed(H)
    v2 = torch.cat([v.real, v.imag], dim=-1)
    eye2 = torch.eye(2 * K, dtype=E.dtype, device=E.device)

    top = top_eigvec_shift_invert(H, bisect_trips=8, tiny=tiny)
    top2 = torch.cat([top.real, top.imag], dim=-1)
    phi_est = torch.sum(top2 * _mv(E, top2), dim=-1)

    gersh = torch.amax(torch.sum(E.abs(), dim=-1), dim=-1)
    c = torch.sum(v2 * _mv(E, v2), dim=-1)  # v^H H v

    lo = torch.maximum(z + c, phi_est)
    hi = torch.maximum(2 * gersh, z + 4 * c)
    hi = torch.maximum(hi, lo + lo.abs() * 1e-6 + tiny)

    tol = 8 * torch.finfo(E.dtype).eps
    mu = hi
    converged = torch.zeros_like(z, dtype=torch.bool)
    for _ in range(trips):
        L, least = chol_piv(mu[..., None, None] * eye2 - E, tiny=tiny)
        pd = least > 0
        L_inv = tri_lower_inv(L)
        s2 = _mtv(L_inv, _mv(L_inv, v2))  # (mu I - H)^-1 v
        w2 = _mv(E, s2)  # H s
        g = torch.sum(s2 * w2, dim=-1)
        t2 = _mv(L_inv, w2)
        h = torch.sum(t2 * t2, dim=-1)  # w^H (mu I - H)^-1 w
        f = mu * mu * g - mu + z
        df = -2 * mu * h - 1.0
        lo = torch.where(~pd | (f >= 0), mu, lo)
        hi = torch.where(pd & (f < 0), mu, hi)
        # the pole model fitted to (S, S') at mu: its pole p = mu h / (g + h)
        p = mu * h / torch.clamp(g + h, min=tiny)
        model_ok = pd & (g + h > 0)
        g_safe = torch.where(model_ok, g, 0.0)
        fitted = secular_model_root(p, g_safe * (mu - p) ** 2, z)
        anchored = secular_model_root(phi_est, g_safe * (mu - phi_est) ** 2, z)
        newton = mu - f / df
        candidate = torch.where(
            model_ok & (fitted >= lo) & (fitted <= hi),
            fitted,
            torch.where(
                model_ok & (anchored >= lo) & (anchored <= hi),
                anchored,
                torch.where(pd & (newton >= lo) & (newton <= hi), newton, (lo + hi) / 2),
            ),
        )
        converged = converged | (pd & (f.abs() <= tol * (z.abs() + mu.abs() + 1.0)))
        mu = torch.where(converged, mu, candidate)

    mu = torch.minimum(torch.maximum(mu, torch.maximum(lo, phi_est)), hi)
    return mu, (phi_est, top)
