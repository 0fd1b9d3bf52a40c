"""ssspy_tpu_torch's eigendecomposition-free routes against the JAX package, on the CPU.

Same numpy inputs, made from a seed, through the JAX function and its port
in float64: the pivot-certified Cholesky and its triangular inverse, the
QDWH schedule and polar factor, the cubic and pole-model roots, the power
probe, the shift-invert top eigenvector (up to phase), the secular root,
``lqpqm2`` and one IPA sweep with ``secular_impl="solve"`` and one
FasterIVA step with ``eig_impl="solve"``. The secular problems are those of
``tests/ops/test_splitc_ipa.py::TestSecularSolve``. Every JAX function with
a loop runs jitted (at XLA's lowest backend optimization), once per module where
several tests read it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.ops import splitc
from ssspy_tpu_torch.linalg import eig_free
from ssspy_tpu_torch.ops import fixed_point_iva_steps as fp
from ssspy_tpu_torch.ops import ipa_steps

torch.set_num_threads(1)

TOL = 1e-10


def _run(fn, *args):
    """``fn(*args)`` jitted at XLA's lowest backend optimization: the unrolled solvers compile in half the time."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _planes(a):
    return jnp.asarray(a.real), jnp.asarray(a.imag)


def _complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _secular_problem(seed, B=24, K=2):
    """``tests/ops/test_splitc_ipa.py::TestSecularSolve._problem`` at a smaller batch."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, K, K)) + 1j * rng.standard_normal((B, K, K))
    H = A @ np.conj(np.swapaxes(A, -1, -2)) / K
    v = rng.standard_normal((B, K)) + 1j * rng.standard_normal((B, K))
    z = np.abs(rng.standard_normal(B)) * 3 + 0.05
    return H, v, z


def _regime(name):
    """The secular regimes: random, a near-singular ``v`` (root at the pole) and ``v = 0`` (the singular branch)."""
    H, v, z = _secular_problem({"random": 0, "near_pole": 1, "singular": 2}[name])
    if name == "near_pole":
        v = v * 1e-4
    elif name == "singular":
        v = np.zeros_like(v)
    return H, v, z


# ---- the Cholesky, its inverse and the certificate --------------------------------------------------


def test_chol_piv_and_tri_lower_inv_match_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((32, 6, 6))
    S = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(6)
    w = np.linalg.eigvalsh(S)
    S_bad = S - (w[:, 0] + 0.05)[:, None, None] * np.eye(6)  # indefinite: a pivot goes <= 0, the factor stays finite
    for S_in, definite in ((S, True), (S_bad, False)):
        L_ref, piv_ref = _run(splitc._chol_unrolled_piv, jnp.asarray(S_in))
        L, piv = eig_free.chol_piv(torch.from_numpy(S_in))
        assert np.isfinite(L.numpy()).all()
        assert _rel_err(L.numpy(), L_ref) <= TOL and _rel_err(piv.numpy(), piv_ref) <= TOL
        assert bool((piv > 0).all()) == definite and bool((piv <= 0).all()) == (not definite)
    L = torch.from_numpy(np.array(_run(splitc._chol_unrolled, jnp.asarray(S))))
    assert _rel_err(eig_free.tri_lower_inv(L).numpy(), _run(splitc._tri_lower_inv, jnp.asarray(L.numpy()))) <= TOL


def test_qdwh_schedule_cubic_roots_and_power_probe_match_jax():
    assert eig_free.qdwh_schedule() == splitc._qdwh_schedule()
    assert eig_free.qdwh_schedule(1e-3, 4) == splitc._qdwh_schedule(1e-3, 4)
    rng = np.random.default_rng(4)
    A, B, C = (rng.standard_normal(200) * 3 for _ in range(3))  # one and three real roots both
    got = eig_free.largest_real_cubic_root(*map(torch.from_numpy, (A, B, C))).numpy()
    assert _rel_err(got, splitc._largest_real_cubic_root(*map(jnp.asarray, (A, B, C)))) <= TOL
    p, q2, z = rng.random(200) * 2, rng.random(200), rng.random(200) * 3
    got = eig_free.secular_model_root(*map(torch.from_numpy, (p, q2, z))).numpy()
    assert _rel_err(got, splitc._secular_model_root(*map(jnp.asarray, (p, q2, z)))) <= TOL
    assert (got > np.maximum(p, z) - 1e-12).all()
    E = rng.standard_normal((5, 8, 8))
    E = E @ np.swapaxes(E, -1, -2)
    assert _rel_err(eig_free.psd_power_probe(torch.from_numpy(E)).numpy(), splitc._psd_power_probe(jnp.asarray(E))) <= TOL


# ---- the shift-invert top eigenvector and FasterIVA's step -------------------------------------------------


def _phase_free(v):
    """``v`` with its largest-magnitude component made real positive."""
    k = np.argmax(np.abs(v), axis=-1)[..., None]
    anchor = np.take_along_axis(v, k, axis=-1)
    return v * np.conj(anchor) / np.abs(anchor)


def test_top_eigvec_shift_invert_matches_jax_up_to_phase():
    H, _, _ = _secular_problem(5, B=40, K=3)
    H[:4] = np.eye(3) * 0.5 + np.outer([1, -1, 0], [1, -1, 0])  # the probe's adversarial case
    ref = _complex(_run(splitc._top_eigvec_shift_invert_sc, *_planes(H)))
    got = eig_free.top_eigvec_shift_invert(torch.from_numpy(H)).numpy()
    assert _rel_err(_phase_free(got), _phase_free(ref)) <= 1e-8
    lamb, V = np.linalg.eigh(H)
    np.testing.assert_allclose(np.abs(np.sum(V[..., -1].conj() * got, axis=-1)), 1.0, atol=1e-8)


def test_faster_iva_step_with_the_solve_route_matches_jax(monkeypatch):
    """The shift-invert eigenvectors with the QDWH polar, the JAX package's float32 TPU pairing (its ``"auto"``
    takes both there); off a TPU its step's polar is the eigh one, so the JAX reference is given QDWH here."""
    rng = np.random.default_rng(6)
    Z = rng.standard_normal((2, 9, 40)) + 1j * rng.standard_normal((2, 9, 40))
    W = np.linalg.qr(np.eye(2) + 0.3 * (rng.standard_normal((9, 2, 2)) + 1j * rng.standard_normal((9, 2, 2))))[0]
    monkeypatch.setattr(splitc, "_polar_sc", functools.partial(splitc._polar_sc, impl="qdwh"))
    step = functools.partial(splitc.faster_iva_step_sc, eig_impl="solve")
    ref = _complex(_run(step, jnp.stack(_planes(Z)), jnp.stack(_planes(W))))
    got = fp.faster_iva_step(torch.from_numpy(Z), torch.from_numpy(W), eig_impl="solve").numpy()
    assert _rel_err(got, ref) <= 1e-8
    eigh = fp.faster_iva_step(torch.from_numpy(Z), torch.from_numpy(W)).numpy()
    assert _rel_err(got, eigh) <= 1e-8  # both routes take the same canonical phase
    with pytest.raises(ValueError, match="eig_impl"):
        fp.top_eigvec(torch.from_numpy(Z[:, :, :3]), impl="jacobi")


# ---- the QDWH polar factor ----------------------------------------------------------------------------------


def test_qdwh_polar_matches_jax_and_the_eigh_polar():
    rng = np.random.default_rng(7)
    W = rng.standard_normal((20, 4, 4)) + 1j * rng.standard_normal((20, 4, 4))
    W[:3] *= np.array([1.0, 1.0, 1.0, 1e-2])  # condition ~1e3, inside the schedule's 1e-5 bound
    ref = _complex(_run(functools.partial(splitc._polar_sc, impl="qdwh"), *_planes(W)))
    got = fp.polar(torch.from_numpy(W), impl="qdwh").numpy()
    assert _rel_err(got, ref) <= TOL
    np.testing.assert_allclose(got.conj().swapaxes(-1, -2) @ got, np.broadcast_to(np.eye(4), W.shape), atol=1e-10)
    assert _rel_err(got, fp.polar(torch.from_numpy(W)).numpy()) <= 1e-8  # the schedule stops at 1 - l < 1e-8
    with pytest.raises(ValueError, match="polar impl"):
        fp.polar(torch.from_numpy(W), impl="svd")


# ---- the secular root, LQPQM and the IPA sweep --------------------------------------------------------------


REGIMES = ("random", "near_pole", "singular")
TRIPS = 8  # the trips the port's float64 "solve" route takes (12 in float32)


@functools.lru_cache(maxsize=None)
def _jax_secular():
    """The JAX root, ``phi_max`` estimate and ``lqpqm2`` solution of every regime, as one batch (one compile each)."""
    H, v, z = (np.concatenate(parts) for parts in zip(*map(_regime, REGIMES)))
    args = (*_planes(H), *_planes(v), jnp.asarray(z))
    root, (phi_est, _) = _run(functools.partial(splitc._secular_root_solve_sc, trips=TRIPS), *args)
    y = _complex(_run(functools.partial(splitc.lqpqm2_sc, secular_impl="solve", secular_trips=TRIPS), *args))
    return {name: tuple(np.split(a, len(REGIMES))[k] for a in (np.asarray(root), np.asarray(phi_est), y))
            for k, name in enumerate(REGIMES)}


@pytest.mark.parametrize("name", REGIMES)
def test_secular_root_and_lqpqm2_solve_match_jax(name):
    H, v, z = _regime(name)
    root_ref, phi_ref, y_ref = _jax_secular()[name]
    root, (phi_est, top) = eig_free.secular_root_solve(*map(torch.from_numpy, (H, v, z)), trips=TRIPS)
    assert _rel_err(root.numpy(), root_ref) <= TOL and _rel_err(phi_est.numpy(), phi_ref) <= TOL
    phi = np.linalg.eigvalsh(H)
    assert (root.numpy() >= phi[:, -1] * (1 - 1e-12)).all()
    y = ipa_steps.lqpqm2(*map(torch.from_numpy, (H, v, z)), secular_impl="solve").numpy()
    if name == "singular":  # the direction is the top eigenvector's, up to phase; the norm is the branch's
        np.testing.assert_allclose(np.linalg.norm(y, axis=-1), np.linalg.norm(y_ref, axis=-1), rtol=1e-8)
    else:
        # y = (lamb I - H)^-1 H v scales the root's relative error (held to TOL above) by lamb / (lamb - phi_max),
        # which reaches 2e4 where the root hugs the pole
        amplification = np.max(root_ref / (root_ref - phi[:, -1]))
        assert _rel_err(y, y_ref) <= TOL * max(amplification, 100)
    if name == "random":
        # the solution is stationary, grad_q [q^H q - log((q + v)^H H (q + v) + z)] = 0 (at the pole the
        # amplified rounding above scales the gradient too)
        s = y + v
        quad = np.real(np.einsum("bi,bij,bj->b", s.conj(), H, s)) + z
        grad = 2 * y - 2 * np.einsum("bij,bj->bi", H, s) / quad[:, None]
        assert np.abs(grad).max() <= 1e-8 * (np.abs(y).max() + 1)


def test_ipa_sweep_with_the_solve_route_matches_jax():
    """One sweep, complex128 (the direct data flow), ``secular_impl="solve"``; two sources keep the JAX trace short."""
    rng = np.random.default_rng(9)
    Y = rng.standard_normal((2, 4, 30)) + 1j * rng.standard_normal((2, 4, 30))
    varphi = 0.5 + rng.random((2, 30))
    sweep = functools.partial(splitc.ipa_sweep_sc, psd_impl="eigh", secular_impl="solve", secular_trips=TRIPS,
                              stats_impl="direct")
    ref = _complex(_run(sweep, *_planes(Y), jnp.asarray(varphi)))
    got = ipa_steps.ipa_sweep(torch.from_numpy(Y), torch.from_numpy(varphi), secular_impl="solve")
    assert got.dtype == torch.complex128
    assert _rel_err(got.numpy(), ref) <= 1e-8
    with pytest.raises(ValueError, match="secular_impl"):
        ipa_steps.ipa_sweep(torch.from_numpy(Y), torch.from_numpy(varphi), secular_impl="newton")


def test_the_eigh_routes_stay_the_default():
    """No default moves: each step with its eigh route named equals the step as a caller calls it."""
    rng = np.random.default_rng(10)
    Y = torch.from_numpy(rng.standard_normal((3, 5, 30)) + 1j * rng.standard_normal((3, 5, 30)))
    varphi = torch.from_numpy(0.5 + rng.random((3, 30)))
    assert torch.equal(ipa_steps.ipa_sweep(Y, varphi), ipa_steps.ipa_sweep(Y, varphi, secular_impl="eigh"))
    Y32, varphi32 = Y.to(torch.complex64), varphi.float()
    assert torch.equal(ipa_steps.ipa_sweep(Y32, varphi32), ipa_steps.ipa_sweep(Y32, varphi32, secular_impl="eigh"))
    W = torch.eye(3, dtype=Y.dtype).expand(5, -1, -1).contiguous()
    assert torch.equal(fp.faster_iva_step(Y, W), fp.faster_iva_step(Y, W, eig_impl="eigh"))
    assert torch.equal(fp.fast_iva_step(Y, W), fp.fast_iva_step(Y, W, polar_impl="eigh"))


def test_the_pole_model_root_keeps_its_offset_in_float32():
    """Near the pole float32 Cardano cancels ``l - p`` and lands on the pole, which the secular solve then took as a
    candidate on every other trip (4% from the root on the card's IPA pencils); the near-pole solution keeps it."""
    q2 = np.logspace(-12, -2, 41)
    p, z = np.full_like(q2, 0.9845082759857178), np.full_like(q2, 3.0083e-5)
    ref = eig_free.secular_model_root(*map(torch.from_numpy, (p, q2, z))).numpy()
    got = eig_free.secular_model_root(*(torch.from_numpy(a.astype(np.float32)) for a in (p, q2, z))).double().numpy()
    assert (got > p.astype(np.float32)).all()
    # the offset itself, to 1% and float32's spacing at p
    assert (np.abs(got - ref) <= 1e-2 * (ref - p) + 2 * np.spacing(np.float32(p))).all()
