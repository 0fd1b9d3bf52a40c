"""ssspy_tpu_torch IP2 and ISS2 (AuxIVA, ILRMA, FastGaussMNMF's diagonalizer) against the JAX package and the fixtures.

Same numpy inputs through the JAX function and its port: the closed-form
2 x 2 generalized eigenproblem against ``splitc._gevd2_sc`` and
``linalg.eigh.eigh2``; the IP2 pair update (with its degenerate-bin
freeze), the ISS2 sweep with both weight shapes and every step against
the JAX steps (float64 within 1e-10, float32 within 1e-4 relative); a
combination ``pair_selector`` against the JAX classes; every IP2/ISS2
class in complex128 on ``tests/regression/fixtures`` (the reference's
1e-7); the fast paths against the JAX fast paths and the easy tier's
fidelity pins; the kernels each complex64 path hands its inputs to. All on
the CPU (``device="cpu"``), where the kernel wrappers take their plain
versions. Each JAX fast path is run once per module.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.bss.ilrma import GaussILRMA as JaxGaussILRMA
from ssspy_tpu.bss.iva import AuxIVA as JaxAuxIVA
from ssspy_tpu.bss.mnmf import FastGaussMNMF as JaxFastGaussMNMF
from ssspy_tpu.fast import fast_auxiva as jax_fast_auxiva
from ssspy_tpu.fast import fast_gauss_ilrma as jax_fast_gauss_ilrma
from ssspy_tpu.fast import fast_gauss_mnmf as jax_fast_gauss_mnmf
from ssspy_tpu.fast import fast_ggd_ilrma as jax_fast_ggd_ilrma
from ssspy_tpu.fast import fast_t_ilrma as jax_fast_t_ilrma
from ssspy_tpu.linalg.eigh import eigh2 as jax_eigh2
from ssspy_tpu.ops import splitc
from ssspy_tpu.utils.select_pair import combination_pair_selector as jax_combination
from ssspy_tpu_torch.bss import AuxIVA, AuxLaplaceIVA, FastGaussMNMF, GaussILRMA, GGDILRMA, TILRMA
from ssspy_tpu_torch.fast import (
    fast_auxiva,
    fast_gauss_ilrma,
    fast_gauss_mnmf,
    fast_ggd_ilrma,
    fast_t_ilrma,
)
from ssspy_tpu_torch.linalg import gevd2
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops.fast_mnmf_steps import fast_gauss_mnmf_step
from ssspy_tpu_torch.ops.ilrma_steps import gauss_ilrma_ip2_step, gauss_ilrma_iss2_step, ilrma_ip_step, ilrma_iss_step
from ssspy_tpu_torch.ops.iva_steps import (
    auxiva_ip2_step,
    auxiva_iss2_step,
    ip2_pair_update,
    ip2_update,
    iss2_sweep,
)
from ssspy_tpu_torch.utils import (
    combination_pair_selector,
    complex_to_planar,
    from_jax_state,
    host_stft,
    make_mixture,
    sequential_pair_selector,
)
from tests.regression.test_regression import N_ITER, _input, _load, _nmf_init

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _complex(dtype):
    return np.complex128 if dtype == np.float64 else np.complex64


def _planar(a, dtype):
    return jnp.asarray(np.stack([a.real, a.imag]).astype(dtype))


def _from_planar(a):
    a = np.asarray(a)
    return a[0] + 1j * a[1]


def _spectrogram(n_channels=3, n_fft=16, n_frames=40, seed=0):
    """Small convolutive mixture STFT: ``(n_channels, n_fft // 2 + 1, n_frames)`` complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _near_identity(rng, n_bins, n_channels, scale=0.2):
    noise = rng.standard_normal((n_bins, n_channels, n_channels)) + 1j * rng.standard_normal((n_bins, n_channels, n_channels))
    return np.eye(n_channels)[None] + scale * noise


def _hermitian_pd(rng, shape, rank=3):
    a = rng.standard_normal(shape + (2, rank)) + 1j * rng.standard_normal(shape + (2, rank))
    return a @ a.conj().swapaxes(-1, -2)


def _pencil_parts(A):
    return A[..., 0, 0].real, A[..., 0, 1].real, A[..., 0, 1].imag, A[..., 1, 1].real


# ---- the 2 x 2 generalized eigenproblem ------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gevd2_matches_jax_scalar_and_complex_forms(dtype):
    rng = np.random.default_rng(1)
    A, B = _hermitian_pd(rng, (200,)), _hermitian_pd(rng, (200,))
    A[:5], B[:5] = 2.5 * np.eye(2), np.eye(2)  # C = 2.5 I exactly: the degenerate branch, e_1
    cdt = _complex(dtype)
    lo, hi = gevd2(torch.from_numpy(A.astype(cdt)), torch.from_numpy(B.astype(cdt)))
    assert lo.dtype == torch.from_numpy(A.astype(cdt)).dtype and lo.shape == (200, 2)

    parts = [jnp.asarray(p.astype(dtype)) for p in _pencil_parts(A) + _pencil_parts(B)]
    ref_lo, ref_hi = splitc._gevd2_sc(*parts)
    for got, ref in ((lo, ref_lo), (hi, ref_hi)):
        ref = np.stack([np.asarray(ref[0]) + 1j * np.asarray(ref[1]), np.asarray(ref[2]) + 1j * np.asarray(ref[3])], -1)
        scale = np.abs(ref).max(axis=-1, keepdims=True)
        assert np.abs(got.numpy() - ref).max() <= (1e-12 if dtype == np.float64 else 1e-5) * scale.max()

    if dtype == np.float64:  # the complex engine's Cholesky reduction, the same ascending order and gauge
        _, Z = jax_eigh2(jnp.asarray(A[5:]), jnp.asarray(B[5:]))
        Z = np.asarray(Z)
        np.testing.assert_allclose(lo.numpy()[5:], Z[..., 0], atol=1e-12 * np.abs(Z).max())
        np.testing.assert_allclose(hi.numpy()[5:], Z[..., 1], atol=1e-12 * np.abs(Z).max())


def test_gevd2_solves_the_pencil_in_ascending_order():
    rng = np.random.default_rng(2)
    A, B = _hermitian_pd(rng, (50,)), _hermitian_pd(rng, (50,))
    lo, hi = gevd2(torch.from_numpy(A), torch.from_numpy(B))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    lambdas = []
    for z in (lo, hi):
        Az, Bz = (At @ z[..., None])[..., 0], (Bt @ z[..., None])[..., 0]
        lamb = (z.conj() * Az).sum(-1).real / (z.conj() * Bz).sum(-1).real
        torch.testing.assert_close(Az, lamb[:, None] * Bz, rtol=0, atol=1e-10 * float(Az.abs().max()))
        lambdas.append(lamb)
    assert bool((lambdas[0] <= lambdas[1]).all())


# ---- the IP2 pair update and the ISS2 sweep --------------------------------------------------------


def _pair_problem(seed, n_channels=3, n_bins=9, n_frames=40):
    rng = np.random.default_rng(seed)
    X = _spectrogram(n_channels=n_channels, seed=seed)[:, :n_bins, :n_frames]
    W = _near_identity(rng, X.shape[1], n_channels)
    return X, W, rng


@pytest.mark.parametrize("pair", [(0, 1), (2, 0)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ip2_pair_update_matches_jax(dtype, pair):
    X, W, rng = _pair_problem(3)
    phi = rng.random((3, X.shape[-1])) + 0.5
    U = np.einsum("nt,pit,qit->inpq", phi, X, X.conj()) / X.shape[-1]
    m, n = pair
    ref = splitc.ip2_pair_update_sc(
        *_planar(W, dtype), *_planar(U[:, m], dtype), *_planar(U[:, n], dtype), pair, eps=1e-10
    )
    ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    cdt = _complex(dtype)
    got = ip2_pair_update(
        torch.from_numpy(W.astype(cdt)), torch.from_numpy(U[:, m].astype(cdt)), torch.from_numpy(U[:, n].astype(cdt)),
        pair, eps=1e-10,
    )
    assert got.shape == (9, 2, 3) and got.dtype == torch.from_numpy(W.astype(cdt)).dtype
    assert _rel_err(got.numpy(), ref) <= TOL[dtype]


def test_ip2_pair_update_freezes_degenerate_bins():
    """A silent bin (zero covariances) and a NaN bin keep their rows, as ``ip2_pair_update_sc`` keeps them."""
    X, W, rng = _pair_problem(4)
    phi = rng.random((3, X.shape[-1])) + 0.5
    U = np.einsum("nt,pit,qit->inpq", phi, X, X.conj()) / X.shape[-1]
    U[2] = 0.0
    U[5, 1, 0, 0] = np.nan
    got = ip2_pair_update(torch.from_numpy(W), torch.from_numpy(U[:, 0]), torch.from_numpy(U[:, 1]), (0, 1))
    for i in (2, 5):
        np.testing.assert_array_equal(got[i].numpy(), W[i, [0, 1]])
    ref = splitc.ip2_pair_update_sc(*_planar(W, np.float64), *_planar(U[:, 0], np.float64),
                                    *_planar(U[:, 1], np.float64), (0, 1))
    ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    assert np.isfinite(got.numpy()).all()
    # every other bin moved
    assert all(not np.allclose(got[i].numpy(), W[i, [0, 1]]) for i in range(9) if i not in (2, 5))


@pytest.mark.parametrize("per_bin", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_iss2_sweep_matches_jax(dtype, per_bin):
    X, W, rng = _pair_problem(5, n_channels=4)
    Y = np.einsum("inm,mit->nit", W, X)
    phi = rng.random((4, X.shape[1], X.shape[2]) if per_bin else (4, X.shape[2])) + 0.5
    Yr, Yi = splitc.iss2_sweep_sc(*_planar(Y, dtype), jnp.asarray(phi.astype(dtype)), eps=1e-10)
    ref = np.asarray(Yr) + 1j * np.asarray(Yi)
    got = iss2_sweep(torch.from_numpy(Y.astype(_complex(dtype))), torch.from_numpy(phi.astype(dtype)))
    assert got.dtype == torch.from_numpy(Y.astype(_complex(dtype))).dtype
    assert _rel_err(got.numpy(), ref) <= TOL[dtype]


def test_iss2_sweep_keeps_the_signed_determinant_floor():
    """A complement row whose pair statistics are singular takes the floored determinant's sign, as in the JAX sweep."""
    X, W, rng = _pair_problem(6)
    Y = np.einsum("inm,mit->nit", W, X)
    phi = rng.random((3, X.shape[1], X.shape[2])) + 0.5
    phi[2, 4] = 0.0  # row 2's weights vanish in bin 4: its 2 x 2 system is all zero there
    Yr, Yi = splitc.iss2_sweep_sc(*_planar(Y, np.float64), jnp.asarray(phi), eps=1e-10,
                                  tiny=1e-20)
    ref = np.asarray(Yr) + 1j * np.asarray(Yi)
    got = iss2_sweep(torch.from_numpy(Y), torch.from_numpy(phi), tiny=1e-20).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_auxiva_ip2_and_iss2_steps_match_jax(dtype):
    X, W, _ = _pair_problem(7, n_channels=3, n_bins=17)
    Xs, Ws = _planar(X, dtype), _planar(W, dtype)
    ref = _from_planar(splitc.auxiva_ip2_step_sc(Xs, Ws, covariance_impl="einsum"))
    state = from_jax_state({"X": np.asarray(Xs), "W": np.asarray(Ws)})
    assert state["W"].dtype == torch.from_numpy(W.astype(_complex(dtype))).dtype
    assert _rel_err(auxiva_ip2_step(state["X"], state["W"]).numpy(), ref) <= TOL[dtype]

    Y = np.einsum("inm,mit->nit", W, X)
    Ys = _planar(Y, dtype)
    ref = _from_planar(splitc.auxiva_iss2_step_sc(Ys))
    got = auxiva_iss2_step(from_jax_state({"Y": np.asarray(Ys)})["Y"])
    assert _rel_err(got.numpy(), ref) <= TOL[dtype]


def _ilrma_problem(seed=8, n_basis=2):
    X, W, rng = _pair_problem(seed, n_channels=3, n_bins=9)
    T0 = rng.random((3, X.shape[1], n_basis))
    V0 = rng.random((3, n_basis, X.shape[2]))
    return X, W, T0, V0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gauss_ilrma_ip2_and_iss2_steps_match_jax(dtype):
    X, W, T0, V0 = _ilrma_problem()
    eps = 1e-10 if dtype == np.float64 else 1e-6
    T0, V0 = T0.astype(dtype), V0.astype(dtype)
    Ws, T, V = splitc.gauss_ilrma_ip2_step_sc(_planar(X, dtype), _planar(W, dtype), jnp.asarray(T0),
                                              jnp.asarray(V0), eps=eps, covariance_impl="einsum")
    state = from_jax_state({"X": np.asarray(_planar(X, dtype)), "W": np.asarray(_planar(W, dtype)), "T": T0, "V": V0})
    W_t, T_t, V_t = gauss_ilrma_ip2_step(state["X"], state["W"], state["T"], state["V"], eps=eps)
    assert _rel_err(W_t.numpy(), _from_planar(Ws)) <= TOL[dtype]
    assert _rel_err(T_t.numpy(), T) <= TOL[dtype] and _rel_err(V_t.numpy(), V) <= TOL[dtype]

    Y = np.einsum("inm,mit->nit", W, X)
    Ys, T, V = splitc.gauss_ilrma_iss2_step_sc(_planar(Y, dtype), jnp.asarray(T0), jnp.asarray(V0), eps=eps)
    Y_t, T_t, V_t = gauss_ilrma_iss2_step(torch.from_numpy(Y.astype(_complex(dtype))), torch.from_numpy(T0),
                                          torch.from_numpy(V0), eps=eps)
    assert _rel_err(Y_t.numpy(), _from_planar(Ys)) <= TOL[dtype]
    assert _rel_err(T_t.numpy(), T) <= TOL[dtype] and _rel_err(V_t.numpy(), V) <= TOL[dtype]


@pytest.mark.parametrize(
    "model,kwargs", [("t", {"dof": 5.0}), ("t", {"dof": 5.0, "me": True}), ("ggd", {"shape": 1.5})]
)
@pytest.mark.parametrize("spatial", ["IP2", "ISS2"])
def test_generic_ilrma_ip2_and_iss2_steps_match_jax_f32(spatial, model, kwargs):
    X, W, T0, V0 = _ilrma_problem(seed=9)
    T0, V0 = T0.astype(np.float32), V0.astype(np.float32)
    if spatial == "IP2":
        out = splitc.ilrma_ip_step_sc(_planar(X, np.float32), _planar(W, np.float32), jnp.asarray(T0),
                                      jnp.asarray(V0), model=model, spatial=spatial, **kwargs)
        got = ilrma_ip_step(torch.from_numpy(X.astype(np.complex64)), torch.from_numpy(W.astype(np.complex64)),
                            torch.from_numpy(T0), torch.from_numpy(V0), model=model, spatial=spatial, **kwargs)
    else:
        Y = np.einsum("inm,mit->nit", W, X)
        out = splitc.ilrma_iss_step_sc(_planar(Y, np.float32), jnp.asarray(T0), jnp.asarray(V0), model=model,
                                       spatial=spatial, **kwargs)
        got = ilrma_iss_step(torch.from_numpy(Y.astype(np.complex64)), torch.from_numpy(T0), torch.from_numpy(V0),
                             model=model, spatial=spatial, **kwargs)
    assert _rel_err(complex_to_planar(got[0]), np.asarray(out[0])) <= 1e-4
    for a, b in zip(got[1:], out[1:]):
        assert _rel_err(a.numpy(), b) <= 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fast_gauss_mnmf_ip2_step_matches_jax(dtype):
    X, Q, rng = _pair_problem(10, n_channels=3, n_bins=9)
    T0, V0 = rng.random((3, 9, 2)).astype(dtype), rng.random((3, 2, X.shape[-1])).astype(dtype)
    D0 = np.maximum(rng.random((9, 3, 3)), 1e-10).astype(dtype)
    eps = 1e-10 if dtype == np.float64 else 1e-6
    Qs, T, V, D = splitc.fast_gauss_mnmf_step_sc(_planar(X, dtype), _planar(Q, dtype), jnp.asarray(T0),
                                                  jnp.asarray(V0), jnp.asarray(D0), eps=eps, diagonalizer="IP2")
    cdt = _complex(dtype)
    got = fast_gauss_mnmf_step(torch.from_numpy(X.astype(cdt)), torch.from_numpy(Q.astype(cdt)),
                               torch.from_numpy(T0), torch.from_numpy(V0), torch.from_numpy(D0), eps=eps,
                               diagonalizer="IP2")
    assert _rel_err(got[0].numpy(), _from_planar(Qs)) <= TOL[dtype]
    for a, b in zip(got[1:], (T, V, D)):
        assert _rel_err(a.numpy(), b) <= TOL[dtype]


def test_ip2_update_over_fixed_covariances_is_the_sequential_pair_updates():
    X, W, rng = _pair_problem(11, n_channels=4)
    phi = rng.random((4, X.shape[1], X.shape[2])) + 0.5
    U = torch.from_numpy(np.einsum("nit,pit,qit->inpq", phi, X, X.conj()) / X.shape[-1])
    W_t = torch.from_numpy(W)
    manual = W_t
    for m, n in sequential_pair_selector(4):
        rows = ip2_pair_update(manual, U[:, m], U[:, n], (m, n))
        manual = manual.clone()
        manual[:, m], manual[:, n] = rows[:, 0], rows[:, 1]
    torch.testing.assert_close(ip2_update(W_t, U), manual, rtol=0, atol=0)


# ---- a combination pair selector against the JAX classes -------------------------------------------


def _jax_contrast(y):
    return 2 * jnp.linalg.norm(y, axis=1)


def _jax_d_contrast(y):
    return 2 * jnp.ones_like(y)


@pytest.mark.parametrize("spatial", ["IP2", "ISS2"])
def test_combination_pair_selector_matches_the_jax_class(spatial):
    X = _spectrogram(n_channels=3, seed=12)
    jax_iva = JaxAuxIVA(spatial_algorithm=spatial, contrast_fn=_jax_contrast, d_contrast_fn=_jax_d_contrast,
                        pair_selector=jax_combination)
    Y_jax = np.asarray(jax_iva(X.copy(), n_iter=4))
    iva = AuxLaplaceIVA(spatial_algorithm=spatial, pair_selector=combination_pair_selector, device="cpu")
    assert iva.pair_selector is combination_pair_selector
    Y = iva(torch.from_numpy(X.copy()), n_iter=4)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(iva.loss, jax_iva.loss, rtol=1e-9)

    init = _nmf_init(*X.shape)
    jax_ilrma = JaxGaussILRMA(n_basis=2, spatial_algorithm=spatial, pair_selector=jax_combination)
    Y_jax = np.asarray(jax_ilrma(X.copy(), n_iter=3, **init))
    ilrma = GaussILRMA(n_basis=2, spatial_algorithm=spatial, pair_selector=combination_pair_selector, device="cpu")
    Y = ilrma(torch.from_numpy(X.copy()), n_iter=3, **init)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(ilrma.loss, jax_ilrma.loss, rtol=1e-9)


@pytest.mark.parametrize("spatial", ["IP2", "ISS2"])
def test_partitioned_ilrma_matches_the_jax_class(spatial):
    """The shared-basis model with IP2 and ISS2, complex128, against the JAX class from the same factors."""
    X = _spectrogram(n_channels=3, seed=18)
    rng = np.random.default_rng(19)
    Z = rng.random((3, 2))
    init = {"latent": Z / Z.sum(axis=0), "basis": rng.random((X.shape[1], 2)), "activation": rng.random((2, X.shape[2]))}
    ref = JaxGaussILRMA(n_basis=2, spatial_algorithm=spatial, partitioning=True)
    Y_jax = np.asarray(ref(X.copy(), n_iter=3, **init))
    ilrma = GaussILRMA(n_basis=2, spatial_algorithm=spatial, partitioning=True, device="cpu")
    Y = ilrma(torch.from_numpy(X.copy()), n_iter=3, **init)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9 * np.abs(Y_jax).max())
    np.testing.assert_allclose(ilrma.loss, ref.loss, rtol=1e-9)


def test_fast_gauss_mnmf_class_with_a_combination_selector_matches_jax():
    X = _spectrogram(n_channels=3, seed=13)
    jax_mnmf = JaxFastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2", pair_selector=jax_combination,
                                rng=np.random.default_rng(14))
    Y_jax = np.asarray(jax_mnmf(X.copy(), n_iter=3))
    mnmf = FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2", pair_selector=combination_pair_selector,
                         rng=np.random.default_rng(14), device="cpu")
    Y = mnmf(torch.from_numpy(X.copy()), n_iter=3)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(mnmf.loss, jax_mnmf.loss, rtol=1e-9)


def test_default_pair_selectors_follow_the_jax_classes():
    for spatial in ("IP2", "ISS2"):
        assert AuxLaplaceIVA(spatial_algorithm=spatial, device="cpu").pair_selector is sequential_pair_selector
        assert GaussILRMA(n_basis=2, spatial_algorithm=spatial, device="cpu").pair_selector is sequential_pair_selector
    assert AuxLaplaceIVA(device="cpu").pair_selector is None
    assert FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2", device="cpu").pair_selector is sequential_pair_selector
    assert list(combination_pair_selector(4, sort=True)) == list(jax_combination(4, sort=True))


# ---- the classes on the regression fixtures (complex128) --------------------------------------------


def _laplace_contrast(y):
    return 2 * torch.linalg.vector_norm(y, dim=1)


def _laplace_d_contrast(y):
    return 2 * torch.ones_like(y)


FIXTURE_CASES = {
    "auxiva_ip2": lambda: (AuxIVA(spatial_algorithm="IP2", contrast_fn=_laplace_contrast,
                                  d_contrast_fn=_laplace_d_contrast, device="cpu"), False),
    "auxiva_iss2": lambda: (AuxIVA(spatial_algorithm="ISS2", contrast_fn=_laplace_contrast,
                                   d_contrast_fn=_laplace_d_contrast, device="cpu"), False),
    "gauss_ilrma_ip2": lambda: (GaussILRMA(n_basis=2, spatial_algorithm="IP2", device="cpu"), True),
    "gauss_ilrma_ip2_me": lambda: (GaussILRMA(n_basis=2, spatial_algorithm="IP2", source_algorithm="ME",
                                              device="cpu"), True),
    "gauss_ilrma_iss2": lambda: (GaussILRMA(n_basis=2, spatial_algorithm="ISS2", device="cpu"), True),
    "gauss_ilrma_iss2_me": lambda: (GaussILRMA(n_basis=2, spatial_algorithm="ISS2", source_algorithm="ME",
                                               device="cpu"), True),
    "t_ilrma_ip2_mm": lambda: (TILRMA(n_basis=2, dof=1000, spatial_algorithm="IP2", device="cpu"), True),
    "t_ilrma_ip2_me": lambda: (TILRMA(n_basis=2, dof=1000, spatial_algorithm="IP2", source_algorithm="ME",
                                      device="cpu"), True),
    "t_ilrma_iss2_mm": lambda: (TILRMA(n_basis=2, dof=1000, spatial_algorithm="ISS2", device="cpu"), True),
    "t_ilrma_iss2_me": lambda: (TILRMA(n_basis=2, dof=1000, spatial_algorithm="ISS2", source_algorithm="ME",
                                       device="cpu"), True),
    "ggd_ilrma_ip2": lambda: (GGDILRMA(n_basis=2, beta=1.5, spatial_algorithm="IP2", device="cpu"), True),
    "ggd_ilrma_iss2": lambda: (GGDILRMA(n_basis=2, beta=1.5, spatial_algorithm="ISS2", device="cpu"), True),
    "fast_gauss_mnmf_ip2": lambda: (FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2",
                                                  rng=np.random.default_rng(11), device="cpu"), False),
}


def _si_sdr_db(est, ref):
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    return 10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err)))


@pytest.mark.parametrize("fixture", sorted(FIXTURE_CASES))
def test_class_matches_regression_fixture(fixture):
    """tests/regression/test_regression.py's IP2/ISS2 cases on the port: complex128 within 1e-7."""
    method, nmf = FIXTURE_CASES[fixture]()
    X = _input()
    init = _nmf_init(*X.shape) if nmf else {}
    Y = method(torch.from_numpy(X.copy()), n_iter=N_ITER, **init)
    target = _load(fixture)
    assert Y.dtype == torch.complex128 and Y.shape == target.shape
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert min(_si_sdr_db(Y[n].numpy(), target[n]) for n in range(Y.shape[0])) > 50
    assert method.loss[-1] < method.loss[0]


# ---- the fast paths ----------------------------------------------------------------------------


def _small_mixture():
    return _spectrogram(n_channels=3, n_fft=32, n_frames=48, seed=15)


@functools.lru_cache(maxsize=None)
def _jax_fast(name):
    """The JAX fast path's separated output on :func:`_small_mixture`, run once per module."""
    X = _small_mixture()
    rng = np.random.default_rng(16)
    runs = {
        "auxiva-IP2": lambda: jax_fast_auxiva(X, n_iter=4, algorithm="IP2")[0],
        "auxiva-ISS2": lambda: jax_fast_auxiva(X, n_iter=4, algorithm="ISS2")[0],
        "gauss-IP2": lambda: jax_fast_gauss_ilrma(X, n_basis=2, n_iter=3, algorithm="IP2", rng=rng)[0],
        "gauss-ISS2": lambda: jax_fast_gauss_ilrma(X, n_basis=2, n_iter=3, algorithm="ISS2", rng=rng)[0],
        "gauss-partitioning-IP2": lambda: jax_fast_gauss_ilrma(X, n_basis=2, n_iter=3, algorithm="IP2",
                                                               partitioning=True, rng=rng)[0],
        "t-ISS2": lambda: jax_fast_t_ilrma(X, n_basis=2, dof=5, n_iter=3, algorithm="ISS2", rng=rng)[0],
        "ggd-IP2": lambda: jax_fast_ggd_ilrma(X, n_basis=2, beta=1.5, n_iter=3, algorithm="IP2", rng=rng)[0],
        "mnmf-IP2": lambda: jax_fast_gauss_mnmf(X, n_basis=2, n_iter=3, diagonalizer_algorithm="IP2", rng=rng)[0],
    }
    return np.asarray(runs[name]())


PORT_FAST = {
    "auxiva-IP2": lambda X, rng: fast_auxiva(X, n_iter=4, algorithm="IP2", device="cpu")[0],
    "auxiva-ISS2": lambda X, rng: fast_auxiva(X, n_iter=4, algorithm="ISS2", device="cpu")[0],
    "gauss-IP2": lambda X, rng: fast_gauss_ilrma(X, n_basis=2, n_iter=3, algorithm="IP2", rng=rng, device="cpu")[0],
    "gauss-ISS2": lambda X, rng: fast_gauss_ilrma(X, n_basis=2, n_iter=3, algorithm="ISS2", rng=rng,
                                                  device="cpu")[0],
    "gauss-partitioning-IP2": lambda X, rng: fast_gauss_ilrma(X, n_basis=2, n_iter=3, algorithm="IP2",
                                                              partitioning=True, rng=rng, device="cpu")[0],
    "t-ISS2": lambda X, rng: fast_t_ilrma(X, n_basis=2, dof=5, n_iter=3, algorithm="ISS2", rng=rng,
                                          device="cpu")[0],
    "ggd-IP2": lambda X, rng: fast_ggd_ilrma(X, n_basis=2, beta=1.5, n_iter=3, algorithm="IP2", rng=rng,
                                             device="cpu")[0],
    "mnmf-IP2": lambda X, rng: fast_gauss_mnmf(X, n_basis=2, n_iter=3, diagonalizer_algorithm="IP2", rng=rng,
                                               device="cpu")[0],
}


@pytest.mark.parametrize("name", sorted(PORT_FAST))
def test_fast_path_matches_the_jax_fast_path(name):
    X = _small_mixture()
    Y = PORT_FAST[name](X, np.random.default_rng(16))
    assert Y.dtype == torch.complex64 and Y.shape == X.shape
    ref = _jax_fast(name)
    sdr = min(_si_sdr_db(Y[n].numpy().astype(np.complex128), ref[n]) for n in range(3))
    assert sdr >= 40.0, f"{name}: {sdr:.1f} dB"  # float32 both, sums in another order: far inside 0.1 dB


@pytest.fixture(scope="module")
def easy_tier():
    """tests/test_fast_fidelity.py's mixture, STFT and quality measure on the port."""
    from tests.test_fast_fidelity import HOP, N_FFT, _best_perm_si_sdr
    from ssspy_tpu_torch.transform import istft, stft
    from ssspy_tpu_torch.utils import sample_speech_mixture

    images, _ = sample_speech_mixture(n_sources=2, max_duration=2.0, conv=True, seed=0)
    mix = images.sum(axis=0)
    X = stft(torch.from_numpy(mix), n_fft=N_FFT, hop_length=HOP, device="cpu").numpy()

    def quality(Y):
        y = istft(torch.as_tensor(Y).to(torch.complex128), n_fft=N_FFT, hop_length=HOP, length=mix.shape[-1],
                  device="cpu")
        return _best_perm_si_sdr(y.numpy(), images[:, 0])

    with open(os.path.join(TESTS, "fidelity_pins.json")) as f:
        pins = json.load(f)
    return X, quality, pins


class _FixedRng:
    """Hands out fixed draws in order (tests/test_fast_fidelity.py:136-143)."""

    def __init__(self, *draws):
        self.draws = list(draws)

    def random(self, shape):
        value = self.draws.pop(0)
        assert value.shape == tuple(shape)
        return value


def _pinned_run(pin, X):
    if pin.startswith("auxiva_"):
        return fast_auxiva(X, n_iter=30, algorithm=pin.split("_")[-1], device="cpu")[0]
    if pin.startswith("gauss_ilrma_"):
        rng = np.random.default_rng(11)
        draws = _FixedRng(rng.random((2, X.shape[1], 2)), rng.random((2, 2, X.shape[2])))
        return fast_gauss_ilrma(X, n_basis=2, n_iter=30, algorithm=pin.split("_")[-1], rng=draws, device="cpu")[0]
    return fast_gauss_mnmf(X, n_basis=2, n_iter=20, diagonalizer_algorithm="IP2", rng=np.random.default_rng(7),
                           device="cpu")[0]


@pytest.mark.parametrize("pin", ["auxiva_IP2", "auxiva_ISS2", "gauss_ilrma_IP2", "gauss_ilrma_ISS2",
                                 "fast_gauss_mnmf_IP2"])
def test_fast_path_meets_the_fidelity_pin(pin, easy_tier):
    """tests/test_fast_fidelity.py's IP2/ISS2 cases on the port: within 0.1 dB of the pinned reference SI-SDR."""
    X, quality, pins = easy_tier
    got = quality(_pinned_run(pin, X))
    assert abs(got - pins[pin]) <= 0.1, f"{pin}: {got:.3f} vs {pins[pin]:.3f} dB"


# ---- the kernels each complex64 path hands its inputs to ----------------------------------------------


def test_complex64_paths_hand_the_kernels_what_they_take(monkeypatch):
    """IP2: K1 at two sources once a pair and no K1b; ILRMA-IP2 and FastGaussMNMF-IP2: K1 once an iteration; ISS2: none."""
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    checked = []

    def checking(X, varphi):
        K._check_weighted_covariance(X, varphi)
        checked.append(tuple(varphi.shape))
        return K.weighted_covariance_plain(X, varphi)

    def refuse(*args, **kwargs):
        raise AssertionError("no path here runs this kernel")

    monkeypatch.setattr(K, "weighted_covariance", checking)
    for name in ("ip1_sweep", "iss1_sweep", "jacobi_eigh", "ipa_congruence"):
        monkeypatch.setattr(K, name, refuse)
    X = _spectrogram(n_channels=3, seed=17).astype(np.complex64)
    T = X.shape[-1]
    fast_auxiva(X, n_iter=2, algorithm="IP2", device="cpu")
    AuxLaplaceIVA(spatial_algorithm="IP2", device="cpu")(torch.from_numpy(X), n_iter=2)
    assert checked == [(2, T)] * 12
    checked.clear()
    fast_gauss_ilrma(X, n_basis=2, n_iter=2, algorithm="IP2", rng=np.random.default_rng(0), device="cpu")
    fast_gauss_mnmf(X, n_basis=2, n_iter=2, diagonalizer_algorithm="IP2", rng=np.random.default_rng(0), device="cpu")
    assert checked == [(3, 9, T)] * 4
    checked.clear()
    fast_auxiva(X, n_iter=2, algorithm="ISS2", device="cpu")
    fast_gauss_ilrma(X, n_basis=2, n_iter=2, algorithm="ISS2", rng=np.random.default_rng(0), device="cpu")
    assert checked == []
    # complex128: the routers send K1's work to its plain version
    AuxLaplaceIVA(spatial_algorithm="IP2", device="cpu")(torch.from_numpy(X.astype(np.complex128)), n_iter=1)
    assert checked == []


def test_ip2_and_iss2_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    X = np.zeros((2, 3, 4), np.complex64)
    entry_points = [
        lambda: AuxLaplaceIVA(spatial_algorithm="IP2"),
        lambda: GaussILRMA(n_basis=2, spatial_algorithm="ISS2"),
        lambda: FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2"),
        lambda: fast_auxiva(X, n_iter=1, algorithm="ISS2"),
        lambda: fast_gauss_ilrma(X, n_basis=2, n_iter=1, algorithm="IP2"),
        lambda: fast_gauss_mnmf(X, n_basis=2, n_iter=1, diagonalizer_algorithm="IP2"),
    ]
    if torch.cuda.is_available():
        assert AuxLaplaceIVA(spatial_algorithm="IP2").device.type == "cuda"
    else:
        for call in entry_points:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
