"""ssspy_tpu_torch prox family (PDSIVA, HVA, ADMMIVA) and the Jacobi eigh K7 against the JAX package.

Same numpy inputs through the JAX function and its port: the Jacobi plain
version against ``jacobi_eigh`` in its XLA form and its Pallas body in
interpret mode (f32), the embedded eigh and the log-det prox against the
split-complex functions (f64 with LAPACK on both sides, f32 with the
port's Jacobi against JAX's LAPACK), the masks and steps, the complex128
classes against the JAX classes and the ``hva.npz`` fixture, the f32 fast
paths, and the JAX-state bridge. All on the CPU (``device="cpu"``), where
the kernel wrapper takes its plain version; the card tests are in
tests/test_torch_cuda.py.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.bss.admmbss import MaskingADMMBSS as JaxMaskingADMMBSS
from ssspy_tpu.bss.hva import HVA as JaxHVA
from ssspy_tpu.bss.hva import MaskingADMMHVA as JaxMaskingADMMHVA
from ssspy_tpu.bss.iva import ADMMIVA as JaxADMMIVA
from ssspy_tpu.bss.iva import PDSIVA as JaxPDSIVA
from ssspy_tpu.bss.pdsbss import PDSBSS as JaxPDSBSS
from ssspy_tpu.bss.pdsbss import MaskingPDSBSS as JaxMaskingPDSBSS
from ssspy_tpu.fast import fast_admm_iva as jax_fast_admm_iva
from ssspy_tpu.fast import fast_hva as jax_fast_hva
from ssspy_tpu.fast import fast_pds_iva as jax_fast_pds_iva
from ssspy_tpu.linalg import prox as jax_prox
from ssspy_tpu.ops.jacobi import _round_pairs
from ssspy_tpu.ops.jacobi import jacobi_eigh as jax_jacobi_eigh
from ssspy_tpu.ops.splitc import (
    _herm_eigh_embed,
    admm_iva_step_sc,
    admm_quad_inv_sc,
    harmonic_mask_sc,
    hva_admm_step_sc,
    hva_pds_step_sc,
    pds_iva_step_sc,
    prox_iva_loss_sc,
    prox_l21_sc,
    prox_neg_logdet_sc,
)
from ssspy_tpu_torch.bss import (
    ADMMIVA,
    HVA,
    PDSBSS,
    PDSIVA,
    MaskingADMMBSS,
    MaskingADMMHVA,
    MaskingPDSBSS,
    MaskingPDSHVA,
)
from ssspy_tpu_torch.fast import fast_admm_iva, fast_hva, fast_pds_iva
from ssspy_tpu_torch.linalg import prox
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops import prox_steps as P
from ssspy_tpu_torch.utils import complex_to_planar, from_jax_state, host_stft, make_mixture

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "regression", "fixtures")


def _rel_err(got, ref):
    """Largest error relative to the largest reference entry (absolute where the reference is all 0)."""
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() or 1.0)


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planar(a, dtype=np.float64):
    return np.stack([a.real, a.imag]).astype(dtype)


def _jax_complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _symmetric(rng, B, n, dtype=np.float32):
    A = rng.standard_normal((B, n, n))
    return (A + A.swapaxes(-1, -2)).astype(dtype)


def _spectrogram(n_channels=3, n_fft=16, n_frames=24, seed=0):
    """Small convolutive mixture STFT: (n_channels, n_fft//2 + 1, n_frames) complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _eigh_errors(A, lamb, V):
    """Reconstruction ``|V diag(lamb) V^T - A|`` and orthogonality ``|V^T V - I|``, float64."""
    A, lamb, V = (np.asarray(a, np.float64) for a in (A, lamb, V))
    recon = np.abs((V * lamb[..., None, :]) @ V.swapaxes(-1, -2) - A).max()
    ortho = np.abs(V.swapaxes(-1, -2) @ V - np.eye(A.shape[-1])).max()
    return recon, ortho


# ---- K7: the Jacobi plain version against JAX -------------------------------------


@pytest.mark.parametrize("n", [2, 3, 5, 8, 16, 32])
def test_round_pairs_is_the_jax_schedule(n):
    assert K.round_pairs(n) == _round_pairs(n)
    table = K.partner_table(n).numpy()
    assert table.shape == (n if n % 2 else n - 1, n) and table.dtype == np.int32
    for row in table:  # an involution: partners pair up, the bye partners itself
        np.testing.assert_array_equal(row[row], np.arange(n))
    assert (table == np.arange(n)).sum() == (n if n % 2 else 0)


# the lanes interpreter takes ~47 s at n = 32 on this CPU, so n = 32 is held
# against the XLA form only
@pytest.mark.parametrize(
    "n,impl",
    [(n, "xla") for n in (2, 3, 5, 8, 16, 32)] + [(n, "lanes_interpret") for n in (2, 3, 5, 8, 16)],
)
def test_jacobi_plain_matches_jax_f32(n, impl):
    A = _symmetric(np.random.default_rng(n), 12, n)
    lamb_ref, _ = jax_jacobi_eigh(jnp.asarray(A), impl=impl)
    lamb, V = K.jacobi_eigh_plain(torch.from_numpy(A))
    assert lamb.dtype == V.dtype == torch.float32 and V.shape == A.shape
    scale = np.abs(np.asarray(lamb_ref)).max()
    # the same rounds in the same order; only the association of f32 terms differs
    assert np.abs(lamb.numpy() - np.asarray(lamb_ref)).max() <= 1e-5 * scale
    assert np.all(np.diff(lamb.numpy(), axis=-1) >= 0)
    recon, ortho = _eigh_errors(A, lamb, V)
    assert recon <= 1e-5 * scale and ortho <= 1e-5


def test_jacobi_tied_diagonal_pairs_rotate():
    # tau = 0 with a nonzero off-diagonal still rotates: sgn(0) = +1 (jacobi.py:153-161)
    lamb, _ = K.jacobi_eigh_plain(torch.tensor([[[1.0, 0.5], [0.5, 1.0]]]))
    np.testing.assert_allclose(lamb.numpy()[0], [0.5, 1.5], atol=1e-6)
    A4 = np.diag([2.0, 2.0, 1.0, 3.0]).astype(np.float32)
    A4[0, 1] = A4[1, 0] = 0.7
    lamb4, _ = K.jacobi_eigh_plain(torch.from_numpy(A4[None]))
    np.testing.assert_allclose(lamb4.numpy()[0], np.linalg.eigvalsh(A4.astype(np.float64)), atol=1e-6)


def test_jacobi_plain_f64_matches_numpy():
    """6 sweeps at n = 16 in f64, against LAPACK.

    Measured here: eigenvalues 1.2e-14, reconstruction 1.3e-13 (relative to
    max |A|), orthogonality 6.0e-15; held at 1e-13, 1e-12 and 1e-13.
    """
    A = _symmetric(np.random.default_rng(7), 20, 16, np.float64)
    lamb, V = K.jacobi_eigh_plain(torch.from_numpy(A))
    scale = np.abs(A).max()
    assert np.abs(lamb.numpy() - np.linalg.eigvalsh(A)).max() <= 1e-13 * scale
    recon, ortho = _eigh_errors(A, lamb, V)
    assert recon <= 1e-12 * scale and ortho <= 1e-13


def test_jacobi_zero_and_nan_inputs():
    # all apq under tiny: every rotation is the identity, V = I
    lamb, V = K.jacobi_eigh_plain(torch.zeros((3, 5, 5)))
    assert torch.equal(lamb, torch.zeros(3, 5)) and torch.equal(V, torch.eye(5).expand(3, 5, 5))
    # NaN in, NaN out: no data-dependent exit; the other matrices are untouched
    A = torch.from_numpy(_symmetric(np.random.default_rng(8), 2, 4))
    A[0, 1, 2] = float("nan")
    lamb, V = K.jacobi_eigh_plain(A)
    assert torch.isnan(lamb[0]).any() and torch.isfinite(lamb[1]).all()
    torch.testing.assert_close(lamb[1:], K.jacobi_eigh_plain(A[1:])[0], rtol=0, atol=0)


def test_jacobi_wrapper_takes_plain_on_cpu():
    A = torch.from_numpy(_symmetric(np.random.default_rng(9), 6, 7))
    before = K.jacobi_eigh.launches
    got = K.jacobi_eigh(A)
    ref = K.jacobi_eigh_plain(A)
    assert K.jacobi_eigh.launches == before  # plain calls are not launches
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize(
    "shape,dtype,transpose,message",
    [
        ((4, 8, 8), torch.float64, False, "float32"),
        ((4, 1, 1), torch.float32, False, "2 <= n <= 32"),
        ((4, 33, 33), torch.float32, False, "2 <= n <= 32"),
        ((4, 8, 7), torch.float32, False, "square"),
        ((8, 8), torch.float32, False, r"\(B, n, n\)"),
        ((8, 4, 8), torch.float32, True, "contiguous"),
        ((4, 8, 8), torch.float32, False, "CUDA"),
    ],
    ids=["float64", "n1", "n33", "non_square", "unbatched", "non_contiguous", "device"],
)
def test_jacobi_kernel_rejects_what_it_does_not_take(shape, dtype, transpose, message):
    A = torch.zeros(shape, dtype=dtype, device="meta")
    if transpose:
        A = A.transpose(0, 1)
    with pytest.raises(ValueError, match=message):
        K.jacobi_eigh(A)


# ---- the embedded eigh and the log-det prox ------------------------------------------


def _hermitian(rng, B, m):
    A = _complex(rng, (B, m, m))
    return A @ A.conj().swapaxes(-1, -2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_herm_eigh_embed_matches_jax(dtype):
    A = _hermitian(np.random.default_rng(10), 9, 3)
    Ap = _planar(A, dtype)
    lamb_ref, _ = _herm_eigh_embed(jnp.asarray(Ap[0]), jnp.asarray(Ap[1]))
    lamb, V = P.herm_eigh_embed(torch.complex(torch.from_numpy(Ap[0]), torch.from_numpy(Ap[1])))
    assert lamb.dtype == torch.from_numpy(Ap[0]).dtype and V.shape == (9, 6, 6)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    scale = np.abs(np.asarray(lamb_ref)).max()
    assert np.abs(lamb.numpy() - np.asarray(lamb_ref)).max() <= tol * scale
    # eigenvalues come doubled and adjacent
    assert np.abs(lamb.numpy()[:, 0::2] - lamb.numpy()[:, 1::2]).max() <= tol * scale
    recon, ortho = _eigh_errors(P.block_embed(torch.from_numpy(A)).numpy(), lamb, V)
    assert recon <= 10 * tol * scale and ortho <= 10 * tol


def test_symm_eigh_routes_by_dtype(monkeypatch):
    calls = []
    monkeypatch.setattr(K, "jacobi_eigh", lambda A: calls.append(A.shape) or K.jacobi_eigh_plain(A))
    S = torch.from_numpy(_symmetric(np.random.default_rng(11), 6, 4, np.float64))
    P.symm_eigh(S)  # float64: LAPACK, never the Jacobi wrapper
    assert calls == []
    P.symm_eigh(S.to(torch.float32).reshape(2, 3, 4, 4))  # float32: one call, batch flattened
    assert calls == [(6, 4, 4)]
    with pytest.raises(ValueError, match="float32 or float64"):
        P.symm_eigh(S.to(torch.float16))


@pytest.mark.parametrize("lift_null", [False, True], ids=["plain", "lift_null"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_prox_neg_logdet_matches_jax(dtype, lift_null):
    G = _complex(np.random.default_rng(12), (9, 3, 3))
    Gp = _planar(G, dtype)
    ref = _jax_complex(
        prox_neg_logdet_sc(jnp.asarray(Gp[0]), jnp.asarray(Gp[1]), step_size=0.7, lift_null=lift_null)
    )
    got = P.prox_neg_logdet(
        torch.complex(torch.from_numpy(Gp[0]), torch.from_numpy(Gp[1])), step_size=0.7, lift_null=lift_null
    )
    # f32: the port's Jacobi against JAX's LAPACK on the CPU
    assert _rel_err(got.numpy(), ref) <= (1e-10 if dtype == np.float64 else 1e-4)
    # the prox of -log det has the singular values (s + sqrt(s^2 + 4 step)) / 2
    s = np.linalg.svd(G, compute_uv=False)
    want = np.sort((s + np.sqrt(s**2 + 2.8)) / 2, axis=-1)
    got_s = np.sort(np.linalg.svd(got.numpy().astype(np.complex128), compute_uv=False), axis=-1)
    assert np.abs(got_s - want).max() <= (1e-12 if dtype == np.float64 else 1e-5) * want.max()


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64], ids=["f64", "f32"])
def test_prox_neg_logdet_lift_null_exact_on_singular_matrices(dtype):
    """The cases of tests/ops/test_splitc_prox.py:97-127: every null direction lifts to sqrt(step)."""
    rng = np.random.default_rng(5)
    step = 0.7
    atol = 1e-12 if dtype == torch.complex128 else 1e-6
    P0 = P.prox_neg_logdet(torch.zeros((3, 4, 4), dtype=dtype), step_size=step, lift_null=True)
    np.testing.assert_allclose(P0.numpy(), np.sqrt(step) * np.tile(np.eye(4), (3, 1, 1)), atol=atol)

    a = _complex(rng, (5, 4, 3))
    b = _complex(rng, (5, 3, 4))
    G = a @ b  # rank 3 of 4
    Pg = P.prox_neg_logdet(torch.from_numpy(G).to(dtype), step_size=step, lift_null=True)
    s_g = np.linalg.svd(G, compute_uv=False)
    s_p = np.sort(np.linalg.svd(Pg.numpy().astype(np.complex128), compute_uv=False), axis=-1)
    f = (s_g + np.sqrt(s_g**2 + 4 * step)) / 2
    want = np.sort(np.concatenate([f[:, :3], np.full((5, 1), np.sqrt(step))], axis=1), axis=-1)
    # f32: the rank-3 matrix's null sigma is f32 roundoff of a ~10x larger s_max
    np.testing.assert_allclose(s_p, want, atol=1e-8 if dtype == torch.complex128 else 2e-4)


def test_prox_neg_logdet_reads_sigma_from_column_norms():
    """An ill-conditioned G (s = 1e3 ... 1e-3) in f64, against the exact prox.

    sqrt(lambda) of the Gram carries an absolute error of ~eps s_max^2 into
    the small singular values (the JAX function: 1.5e-5 here); the column
    norms of E(G) V one of ~eps s_max (the port: 2.2e-7).
    """
    rng = np.random.default_rng(13)
    U, _ = np.linalg.qr(_complex(rng, (4, 4)))
    V, _ = np.linalg.qr(_complex(rng, (4, 4)))
    s = np.array([1e3, 1.0, 1e-2, 1e-3])
    G = ((U * s) @ V.conj().T)[None]
    want = (U * ((s + np.sqrt(s**2 + 4 * 0.5)) / 2)) @ V.conj().T
    got = P.prox_neg_logdet(torch.from_numpy(G), step_size=0.5)[0].numpy()
    ref = _jax_complex(prox_neg_logdet_sc(jnp.asarray(G.real), jnp.asarray(G.imag), step_size=0.5))[0]
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got - want).max() * 10 <= np.abs(ref - want).max()


def test_linalg_prox_matches_jax():
    rng = np.random.default_rng(14)
    x = _complex(rng, (3, 5, 6))
    X = torch.from_numpy(x)
    np.testing.assert_allclose(prox.l1(X, 0.6).numpy(), np.asarray(jax_prox.l1(jnp.asarray(x), 0.6)), atol=1e-12)
    np.testing.assert_allclose(
        prox.l21(X, 0.6, axis2=1).numpy(), np.asarray(jax_prox.l21(jnp.asarray(x), 0.6, axis2=1)), atol=1e-12
    )
    r = np.abs(x)
    np.testing.assert_allclose(
        prox.neg_log(torch.from_numpy(r), 0.3).numpy(), np.asarray(jax_prox.neg_log(jnp.asarray(r), 0.3)), atol=1e-12
    )
    G = x[:, :3, :3]
    np.testing.assert_allclose(
        prox.neg_logdet(torch.from_numpy(G), 0.4).numpy(), np.asarray(jax_prox.neg_logdet(jnp.asarray(G), 0.4)),
        atol=1e-10,
    )
    Gr = G.real
    np.testing.assert_allclose(
        prox.neg_logdet(torch.from_numpy(Gr), 0.4).numpy(), np.asarray(jax_prox.neg_logdet(jnp.asarray(Gr), 0.4)),
        atol=1e-10,
    )


# ---- the masks and the steps ----------------------------------------------------------


def test_prox_l21_matches_jax():
    Z = _complex(np.random.default_rng(15), (3, 9, 24))
    ref = _jax_complex(prox_l21_sc(jnp.asarray(Z.real), jnp.asarray(Z.imag), step_size=0.7))
    np.testing.assert_allclose(P.prox_l21(torch.from_numpy(Z), step_size=0.7).numpy(), ref, atol=1e-12)


@pytest.mark.parametrize("n_real", [None, 7], ids=["all_bins", "padded"])
@pytest.mark.parametrize("mask_iter", [1, 2])
def test_harmonic_mask_matches_jax(mask_iter, n_real):
    Z = _complex(np.random.default_rng(16), (3, 9, 24))
    if n_real is not None:
        Z[:, n_real:] = 0  # trailing zero padding of the bin axis
    ref = np.asarray(
        harmonic_mask_sc(jnp.asarray(Z.real), jnp.asarray(Z.imag), 0.4, mask_iter=mask_iter, n_real=n_real)
    )
    got = P.harmonic_mask(torch.from_numpy(Z), 0.4, mask_iter=mask_iter, n_real=n_real).numpy()
    assert got.shape == (3, 9, 24) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, atol=1e-12)
    if n_real is not None:
        # the real bins see only the real bins: the same mask as the unpadded input
        unpadded = P.harmonic_mask(torch.from_numpy(Z[:, :n_real]), 0.4, mask_iter=mask_iter).numpy()
        np.testing.assert_allclose(got[:, :n_real], unpadded, atol=1e-12)


def test_harmonic_mask_floors_through_flooring_fn():
    Z = _complex(np.random.default_rng(17), (2, 9, 8))
    Z[:, 3] = 0
    Zt = torch.from_numpy(Z)
    torch.testing.assert_close(
        P.harmonic_mask(Zt, 0.5, flooring_fn=lambda y: torch.clamp(y, min=1e-3)),
        P.harmonic_mask(Zt, 0.5, eps=1e-3),
    )


def _mixture(seed, M=3, I=9, T=24):
    return _complex(np.random.default_rng(seed), (M, I, T))


def _pds_start(X):
    M, I, T = X.shape
    W0 = np.tile(np.eye(M, dtype=complex), (I, 1, 1))
    return W0, np.zeros((M, I, T), complex)


def _run_pds(X, dtype, n_steps, jax_step, torch_step, **kw):
    W0, Y0 = _pds_start(X)
    Xs, Ws, Ys = (jnp.asarray(_planar(a, dtype)) for a in (X, W0, Y0))
    state = from_jax_state({"X": _planar(X, dtype), "W": _planar(W0, dtype), "dual": _planar(Y0, dtype)})
    X_t, W, Y = state["X"], state["W"], state["dual"]
    for _ in range(n_steps):
        Ws, Ys = jax_step(Xs, Ws, Ys, **kw)
        W, Y = torch_step(X_t, W, Y, **kw)
    return (W, Y), (_jax_complex(Ws), _jax_complex(Ys))


_PDS_STEPS = [("pds_iva", pds_iva_step_sc, P.pds_iva_step), ("hva_pds", hva_pds_step_sc, P.hva_pds_step)]


@pytest.mark.parametrize("relaxation", [1.0, 0.5])
@pytest.mark.parametrize("name,jax_step,torch_step", _PDS_STEPS, ids=[s[0] for s in _PDS_STEPS])
def test_pds_steps_match_jax_f64(name, jax_step, torch_step, relaxation):
    (W, Y), (W_ref, Y_ref) = _run_pds(
        _mixture(20), np.float64, 3, jax_step, torch_step, mu1=0.8, mu2=1.2, relaxation=relaxation
    )
    assert W.dtype == torch.complex128
    np.testing.assert_allclose(W.numpy(), W_ref, atol=1e-8)
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-8)


@pytest.mark.parametrize("name,jax_step,torch_step", _PDS_STEPS, ids=[s[0] for s in _PDS_STEPS])
def test_pds_steps_match_jax_f32(name, jax_step, torch_step):
    (W, Y), (W_ref, Y_ref) = _run_pds(_mixture(21), np.float32, 1, jax_step, torch_step)
    assert W.dtype == torch.complex64
    assert _rel_err(W.numpy(), W_ref) <= 1e-4 and _rel_err(Y.numpy(), Y_ref) <= 1e-4


def _run_admm(X, dtype, n_steps, jax_step, torch_step, **kw):
    M, I, T = X.shape
    zf, zs = np.zeros((I, M, M), complex), np.zeros((M, I, T), complex)
    Xs = jnp.asarray(_planar(X, dtype))
    quad_inv = admm_quad_inv_sc(Xs)
    jax_state = [jnp.asarray(_planar(a, dtype)) for a in (zf, zs, zf, zs)]
    state = from_jax_state(
        {"X": _planar(X, dtype), "V1": _planar(zf, dtype), "V2": _planar(zs, dtype), "Y1": _planar(zf, dtype),
         "Y2": _planar(zs, dtype), "quad_inv": np.asarray(quad_inv)}
    )
    Q = P.admm_quad_inv(state["X"])
    assert _rel_err(Q.numpy(), _jax_complex(quad_inv)) <= (1e-12 if dtype == np.float64 else 1e-5)
    torch_state = [state[k] for k in ("V1", "V2", "Y1", "Y2")]
    for _ in range(n_steps):
        W_ref, *jax_state = jax_step(Xs, *jax_state, quad_inv=quad_inv, **kw)
        W, *torch_state = torch_step(state["X"], *torch_state, quad_inv=state["quad_inv"], **kw)
    return [W] + torch_state, [_jax_complex(a) for a in [W_ref] + jax_state]


_ADMM_STEPS = [("admm_iva", admm_iva_step_sc, P.admm_iva_step), ("hva_admm", hva_admm_step_sc, P.hva_admm_step)]


@pytest.mark.parametrize("relaxation", [1.0, 0.5])
@pytest.mark.parametrize("name,jax_step,torch_step", _ADMM_STEPS, ids=[s[0] for s in _ADMM_STEPS])
def test_admm_steps_match_jax_f64(name, jax_step, torch_step, relaxation):
    gots, refs = _run_admm(_mixture(22), np.float64, 3, jax_step, torch_step, rho=1.3, relaxation=relaxation)
    for got, ref in zip(gots, refs):  # W, V, Vt, Y, Yt
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-8)


@pytest.mark.parametrize("name,jax_step,torch_step", _ADMM_STEPS, ids=[s[0] for s in _ADMM_STEPS])
def test_admm_steps_match_jax_f32(name, jax_step, torch_step):
    # two steps: the first maps the zero state to sqrt(1/rho) I exactly, the second is general
    gots, refs = _run_admm(_mixture(23), np.float32, 2, jax_step, torch_step)
    assert gots[0].dtype == torch.complex64
    for got, ref in zip(gots, refs):
        assert _rel_err(got.numpy(), ref) <= 1e-4


def test_prox_iva_loss_matches_jax():
    X = _mixture(25)
    W = np.eye(3)[None] + 0.1 * _complex(np.random.default_rng(26), (9, 3, 3))
    ref = float(prox_iva_loss_sc(jnp.asarray(_planar(X)), jnp.asarray(_planar(W))))
    got = float(P.prox_iva_loss(torch.from_numpy(X), torch.from_numpy(W)))
    assert abs(got - ref) <= 1e-10 * abs(ref)


# ---- the classes against the JAX classes (complex128) -------------------------------------


def _input():
    return np.load(os.path.join(FIXTURES, "input.npz"))["spectrogram"]


_CLASS_CASES = [
    ("PDSIVA", JaxPDSIVA, PDSIVA, {"mu1": 0.8, "mu2": 1.2}),
    ("PDSIVA_relaxed", JaxPDSIVA, PDSIVA, {"relaxation": 0.5}),
    ("ADMMIVA", JaxADMMIVA, ADMMIVA, {"rho": 1.3}),
    ("HVA", JaxHVA, HVA, {}),
    ("MaskingADMMHVA", JaxMaskingADMMHVA, MaskingADMMHVA, {}),
]


@pytest.mark.parametrize("name,jax_cls,torch_cls,kwargs", _CLASS_CASES, ids=[c[0] for c in _CLASS_CASES])
def test_prox_classes_match_jax_classes(name, jax_cls, torch_cls, kwargs):
    X = _input()
    jax_method = jax_cls(**kwargs)
    torch_method = torch_cls(device="cpu", **kwargs)
    Y_ref = np.asarray(jax_method(X.copy(), n_iter=5))
    Y = torch_method(torch.from_numpy(X.copy()), n_iter=5)
    assert Y.dtype == torch.complex128 and Y.shape == X.shape
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-8 * np.abs(Y_ref).max())
    np.testing.assert_allclose(torch_method.demix_filter.numpy(), np.asarray(jax_method.demix_filter), rtol=1e-8)
    if jax_method.loss is None:
        assert torch_method.loss is None
    else:
        # ADMM's initial W = I: its first step's loss is +inf (W = 0) on both sides
        np.testing.assert_allclose(torch_method.loss, jax_method.loss, rtol=1e-9)
        assert len(torch_method.loss) == 6


def test_hva_matches_regression_fixture():
    """HVA at the JAX package's own tolerance (tests/regression/test_regression.py:171-176)."""
    target = np.load(os.path.join(FIXTURES, "hva.npz"))["target"]
    Y = HVA(device="cpu")(torch.from_numpy(_input().copy()), n_iter=10)
    np.testing.assert_allclose(Y.numpy(), target, atol=5e-7)


def test_hva_fixture_needs_sigma_from_column_norms():
    """The split-complex reference route, sqrt(lambda) of the Gram in f64, misses ``hva.npz``.

    Ten HVA steps of ``hva_pds_step_sc`` in float64 with projection back:
    measured 1.3e-4 from the fixture (tolerance 5e-7); the port, which reads
    each singular value as a column norm of E(G) V, meets it
    (test_hva_matches_regression_fixture).
    """
    X = _input()
    target = np.load(os.path.join(FIXTURES, "hva.npz"))["target"]
    W0, Y0 = _pds_start(X)
    Xs, Ws, Ys = (jnp.asarray(_planar(a)) for a in (X, W0, Y0))
    step = jax.jit(lambda W, Y: hva_pds_step_sc(Xs, W, Y))
    for _ in range(10):
        Ws, Ys = step(Ws, Ys)
    W = _jax_complex(Ws)
    W = W * np.linalg.inv(W)[:, 0, :][:, :, None]
    assert np.abs(np.einsum("inm,mit->nit", W, X) - target).max() > 5e-7


def test_prox_divergence_on_loud_input_is_the_references():
    """Where the prox family diverges, the JAX package diverges the same way.

    ADMMIVA at rho = 1 on the spectrogram over its largest magnitude: the
    complex128 classes (JAX's with its SVD prox) both reach max |W| ~2.3e20
    after 20 iterations, within 1e-8 of each other. HVA's f32 step on the
    unscaled spectrogram: its filters grow ~100x per iteration here and leave
    f32 at the same iteration through JAX and through the port.
    """
    X = host_stft(make_mixture(seed=0, duration_s=0.25), n_fft=128, hop=64)  # (8, 65, 63)
    X_max = X / np.abs(X).max()
    jax_method = JaxADMMIVA(record_loss=False, scale_restoration=False)
    jax_method(X_max.copy(), n_iter=20)
    torch_method = ADMMIVA(record_loss=False, scale_restoration=False, device="cpu")
    torch_method(torch.from_numpy(X_max.copy()), n_iter=20)
    W_ref = np.abs(np.asarray(jax_method.demix_filter)).max()
    W_max = float(torch_method.demix_filter.abs().max())
    assert W_ref > 1e15 and abs(W_max - W_ref) <= 1e-8 * W_ref

    X32 = X.astype(np.complex64)
    W0, Y0 = _pds_start(X32)
    Xs, Ws, Ys = (jnp.asarray(_planar(a, np.float32)) for a in (X32, W0, Y0))
    step = jax.jit(lambda W, Y: hva_pds_step_sc(Xs, W, Y))
    X_t, W, Y = (torch.from_numpy(a.astype(np.complex64)) for a in (X32, W0, Y0))
    first_ref = first = None
    for it in range(1, 41):
        Ws, Ys = step(Ws, Ys)
        W, Y = P.hva_pds_step(X_t, W, Y)
        if first_ref is None and not np.isfinite(np.asarray(Ws)).all():
            first_ref = it
        if first is None and not torch.isfinite(torch.view_as_real(W)).all():
            first = it
    assert first_ref is not None and first == first_ref


def test_admm_iva_on_a_short_cut_diverges_as_the_references():
    """ADMMIVA at rho = 1 diverges on a 1 s cut of the mixture even on the spectral-norm scaling, in the JAX class too.

    On the 10 s mixture that scaling lets it converge; on 63 frames (8
    channels, 257 bins) the complex128 loss falls for a few iterations,
    passes its first value again near iteration 10 and grows some 30x every
    five iterations from there, through the JAX class and the port alike:
    both climb above the first loss at the same iteration (within one) and
    stand beyond 1e10 after 40. The 10 s run's convergence is no guarantee
    for other inputs.
    """
    X = host_stft(make_mixture(seed=0, duration_s=1.0), n_fft=512, hop=256)
    assert X.shape == (8, 257, 63)
    torch_method = ADMMIVA(scale_restoration=False, device="cpu")
    X_spec = torch_method.normalize_by_spectral_norm(X)
    assert np.linalg.norm(X_spec.numpy().transpose(1, 0, 2), ord=2, axis=(1, 2)).max() <= 1 + 1e-12
    torch_method(X_spec, n_iter=40)
    jax_method = JaxADMMIVA(scale_restoration=False)
    jax_method(X_spec.numpy().copy(), n_iter=40)

    def first_climb(loss):
        """The first iteration, after the loss has fallen, at which it is not finite or above where it started."""
        fell = False
        for it, value in enumerate(loss):
            fell = fell or value < loss[0]
            if fell and not value < loss[0]:
                return it
        return None

    climb, climb_ref = first_climb(torch_method.loss), first_climb(jax_method.loss)
    assert climb is not None and climb_ref is not None and abs(climb - climb_ref) <= 1
    for loss in (torch_method.loss, jax_method.loss):
        assert min(loss) < loss[0] and not loss[-1] < 1e10  # fell first; then beyond 1e10, or not finite
    # the two trajectories are one: the growth rates agree, not only the verdict
    grown = [it for it in range(climb, 41) if np.isfinite(torch_method.loss[it]) and np.isfinite(jax_method.loss[it])]
    np.testing.assert_allclose(
        np.log(np.array(torch_method.loss)[grown]), np.log(np.array(jax_method.loss)[grown]), rtol=1e-3
    )


def test_pds_iva_on_max_magnitude_scaling_rises_as_the_references():
    """PDSIVA at mu1 = mu2 = 1 needs ``mu1 mu2 max_i ||X_i||_2^2 <= 1``; the max-magnitude scaling breaks it.

    On the spectrogram over its largest magnitude (bench.py:413) the
    condition reads ~23 here, and the complex128 loss climbs ~4.6x in 20
    iterations through the JAX class and the port alike (within 1e-12 of each
    other). On the spectral-norm scaling the condition holds and the loss
    falls at every iteration.
    """
    X = host_stft(make_mixture(seed=0, duration_s=0.25), n_fft=128, hop=64)  # (8, 65, 63)
    X_max = X / np.abs(X).max()
    assert np.linalg.norm(X_max.transpose(1, 0, 2), ord=2, axis=(1, 2)).max() ** 2 > 10
    jax_method = JaxPDSIVA(scale_restoration=False)
    jax_method(X_max.copy(), n_iter=20)
    torch_method = PDSIVA(scale_restoration=False, device="cpu")
    torch_method(torch.from_numpy(X_max.copy()), n_iter=20)
    np.testing.assert_allclose(torch_method.loss, jax_method.loss, rtol=1e-12)
    assert torch_method.loss[-1] > 4 * torch_method.loss[0]

    scaled = PDSIVA(scale_restoration=False, device="cpu")
    X_spec = scaled.normalize_by_spectral_norm(X)
    assert np.linalg.norm(X_spec.numpy().transpose(1, 0, 2), ord=2, axis=(1, 2)).max() <= 1 + 1e-12
    scaled(X_spec, n_iter=20)
    assert (np.diff(scaled.loss) < 0).all()


def _l1_prox(x, step_size=1):
    return prox.l1(x, step_size=step_size)


def _jax_l1_prox(x, step_size=1):
    return jax_prox.l1(x, step_size=step_size)


def test_pds_bss_with_two_penalties_matches_jax():
    X = _input()
    torch_penalties = [lambda y: torch.linalg.vector_norm(y, dim=1).sum(), lambda y: y.abs().sum()]
    jax_penalties = [lambda y: jnp.linalg.norm(y, axis=1).sum(), lambda y: jnp.abs(y).sum()]
    torch_proxes = [lambda x, step_size=1: prox.l21(x, step_size, axis2=1), _l1_prox]
    jax_proxes = [lambda x, step_size=1: jax_prox.l21(x, step_size, axis2=1), _jax_l1_prox]
    jax_method = JaxPDSBSS(penalty_fn=jax_penalties, prox_penalty=jax_proxes, mu2=0.5)
    torch_method = PDSBSS(penalty_fn=torch_penalties, prox_penalty=torch_proxes, mu2=0.5, device="cpu")
    Y_ref = np.asarray(jax_method(X.copy(), n_iter=4))
    Y = torch_method(torch.from_numpy(X.copy()), n_iter=4)
    assert torch_method.dual.shape == (2,) + X.shape
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-8 * np.abs(Y_ref).max())
    np.testing.assert_allclose(torch_method.dual.numpy(), np.asarray(jax_method.dual), atol=1e-8)
    np.testing.assert_allclose(torch_method.loss, jax_method.loss, rtol=1e-9)


def test_class_warm_start_from_jax_state_and_callbacks():
    """A JAX PDSIVA and ADMMIVA run, their state carried to the port's classes through the bridge."""
    X = _input()
    for jax_cls, torch_cls, keys in (
        (JaxPDSIVA, PDSIVA, ("demix_filter", "dual")),
        (JaxADMMIVA, ADMMIVA, ("demix_filter", "auxiliary1", "auxiliary2", "dual1", "dual2")),
    ):
        first = jax_cls(scale_restoration=False)
        first(X.copy(), n_iter=2)
        state = from_jax_state(
            {("W" if k == "demix_filter" else k): np.asarray(getattr(first, k)) for k in keys}
        )
        init = {k: state["W" if k == "demix_filter" else k] for k in keys}
        seen_jax, seen_torch = [], []
        jax_method = jax_cls(callbacks=lambda m: seen_jax.append(len(m.loss)))
        torch_method = torch_cls(device="cpu", callbacks=lambda m: seen_torch.append(len(m.loss)))
        Y_ref = np.asarray(jax_method(X.copy(), n_iter=3, **{k: np.asarray(getattr(first, k)) for k in keys}))
        Y = torch_method(torch.from_numpy(X.copy()), n_iter=3, **init)
        assert seen_torch == seen_jax == [1, 2, 3, 4]
        np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-8 * np.abs(Y_ref).max())
        np.testing.assert_allclose(torch_method.loss, jax_method.loss, rtol=1e-9)


def test_class_options_and_their_errors():
    with pytest.warns(DeprecationWarning, match="alpha"):
        assert PDSIVA(alpha=0.5, device="cpu").relaxation == 0.5
    with pytest.warns(DeprecationWarning, match="alpha"):
        assert ADMMIVA(alpha=0.7, device="cpu").relaxation == 0.7
    with pytest.raises(AssertionError, match="mutually exclusive"):
        PDSIVA(alpha=0.5, relaxation=0.3, device="cpu")
    with pytest.raises(AssertionError, match="needs a penalty_fn"):
        PDSBSS(prox_penalty=_l1_prox, record_loss=True, device="cpu")
    with pytest.raises(AssertionError, match="needs a penalty_fn"):
        MaskingADMMBSS(mask_fn=lambda z: torch.ones_like(z.real), record_loss=True, device="cpu")
    with pytest.raises(ValueError, match="prox_penalty"):
        PDSBSS(device="cpu")
    with pytest.raises(ValueError, match="mask_fn"):
        MaskingPDSBSS(device="cpu")
    with pytest.raises(ValueError, match="prox_penalty is required"):
        PDSIVA(contrast_fn=lambda y: y.abs(), device="cpu")
    with pytest.raises(ValueError, match="contrast_fn is required"):
        ADMMIVA(prox_penalty=_l1_prox, device="cpu")
    assert PDSBSS(prox_penalty=_l1_prox, device="cpu").record_loss is False
    assert "MaskingPDSHVA(mu1=1, mu2=1, relaxation=1, mask_iter=1" in repr(MaskingPDSHVA(device="cpu"))
    # the deprecated aux1 / aux2 warm-start keywords
    X = torch.from_numpy(_input().copy())
    M, I, T = X.shape
    method = ADMMIVA(device="cpu", record_loss=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        method(X, n_iter=1, aux1=torch.zeros((I, M, M), dtype=X.dtype))
    assert any("aux1" in str(w.message) for w in caught)


def test_custom_masks_take_the_generic_steps():
    X = _input()
    half = 0.5
    for jax_cls, torch_cls, kw in (
        (JaxMaskingPDSBSS, MaskingPDSBSS, {"mu1": 0.9}),
        (JaxMaskingADMMBSS, MaskingADMMBSS, {"rho": 1.1}),
    ):
        jax_method = jax_cls(mask_fn=lambda z: half * jnp.ones(z.shape), **kw)
        torch_method = torch_cls(mask_fn=lambda z: torch.full(z.shape, half, dtype=z.real.dtype), device="cpu", **kw)
        Y_ref = np.asarray(jax_method(X.copy(), n_iter=3))
        Y = torch_method(torch.from_numpy(X.copy()), n_iter=3)
        np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-8 * np.abs(Y_ref).max())


def test_normalize_by_spectral_norm_matches_jax():
    X = _input()
    ref = np.asarray(JaxPDSIVA().normalize_by_spectral_norm(X))
    got = PDSIVA(device="cpu").normalize_by_spectral_norm(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


# ---- the fast paths (f32) -------------------------------------------------------------


_FAST_CASES = [
    ("pds_iva", jax_fast_pds_iva, fast_pds_iva, {"mu1": 0.9}, True),
    ("admm_iva", jax_fast_admm_iva, fast_admm_iva, {"rho": 1.2}, True),
    ("hva", jax_fast_hva, fast_hva, {}, False),
]


@pytest.mark.parametrize("scale_restoration", [True, False], ids=["restored", "raw"])
@pytest.mark.parametrize("name,jax_fn,torch_fn,kwargs,normalized", _FAST_CASES, ids=[c[0] for c in _FAST_CASES])
def test_fast_prox_paths_match_jax_f32(name, jax_fn, torch_fn, kwargs, normalized, scale_restoration):
    X = _spectrogram(seed=30)
    if normalized:
        X = X / np.abs(X).max()  # bench.py:413
    common = dict(n_iter=4, scale_restoration=scale_restoration, **kwargs)
    Y_ref, W_ref = jax_fn(X, **common)
    Y, W = torch_fn(X, device="cpu", **common)
    assert Y.dtype == W.dtype == torch.complex64 and Y.shape == X.shape and W.shape == (9, 3, 3)
    # the port's Jacobi against JAX's LAPACK on the CPU, over 4 f32 iterations
    assert _rel_err(Y.numpy(), Y_ref) <= 1e-3 and _rel_err(W.numpy(), W_ref) <= 1e-3


def test_fast_admm_needs_an_iteration():
    with pytest.raises(ValueError, match="at least 1"):
        fast_admm_iva(np.zeros((2, 3, 4), np.complex64), n_iter=0, device="cpu")


# ---- the state bridge -----------------------------------------------------------------


def test_from_jax_state_takes_the_prox_keys():
    rng = np.random.default_rng(40)
    pds = {"X": rng.standard_normal((2, 3, 5, 7)), "W": rng.standard_normal((2, 5, 3, 3)),
           "dual": rng.standard_normal((2, 3, 5, 7))}
    admm = {k: rng.standard_normal((2, 5, 3, 3)).astype(np.float32) for k in ("V1", "Y1", "quad_inv")}
    admm.update({k: rng.standard_normal((2, 3, 5, 7)).astype(np.float32) for k in ("V2", "Y2")})
    cls = {k: _complex(rng, (1, 3, 5, 7)) for k in ("auxiliary2", "dual2")}
    cls.update({k: _complex(rng, (5, 3, 3)) for k in ("auxiliary1", "dual1", "dual")})
    for state in (pds, admm, cls):
        out = from_jax_state(state)
        for key, value in state.items():
            assert out[key].is_complex(), key
            expected = value if np.iscomplexobj(value) else value[0] + 1j * value[1]
            np.testing.assert_array_equal(out[key].numpy(), expected)
            if not np.iscomplexobj(value):
                np.testing.assert_array_equal(complex_to_planar(out[key]), value)
    with pytest.raises(ValueError, match="unknown state key 'aux'"):
        from_jax_state({"aux": np.zeros((2, 3))})


# ---- every path hands the kernel what it takes; the default device ---------------------


def test_every_prox_path_hands_the_kernel_what_it_takes(monkeypatch):
    """K7's own checks (dtype, shape, contiguity) pass on every path's inputs, and B = 2I with the lift.

    On the CPU the wrapper takes its plain version before any check, so
    here it runs its kernel's checks (all but the device) first.
    """
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    batches = []

    def checking(A, sweeps=None, tiny=1e-30):
        K._check_jacobi_eigh(A)
        batches.append(A.shape[0])
        return K.jacobi_eigh_plain(A, sweeps, tiny)

    monkeypatch.setattr(K, "jacobi_eigh", checking)
    X = _spectrogram(seed=50).astype(np.complex64)
    Xt = torch.from_numpy(X)
    I = X.shape[1]
    runs = [
        (lambda: PDSIVA(device="cpu")(Xt, n_iter=2), I),
        (lambda: HVA(device="cpu")(Xt, n_iter=2), I),
        (lambda: MaskingPDSHVA(device="cpu", relaxation=0.5)(Xt, n_iter=2), I),
        (lambda: ADMMIVA(device="cpu")(Xt, n_iter=2), 2 * I),
        (lambda: MaskingADMMHVA(device="cpu")(Xt, n_iter=2), 2 * I),
        (lambda: fast_pds_iva(X, n_iter=2, device="cpu"), I),
        (lambda: fast_hva(X, n_iter=2, device="cpu"), I),
        (lambda: fast_admm_iva(X, n_iter=2, device="cpu"), 2 * I),
    ]
    for run, batch in runs:
        batches.clear()
        run()
        assert batches == [batch, batch]  # one eigh per iteration


def test_prox_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    X = np.zeros((2, 3, 4), np.complex64)
    entry_points = [
        lambda: PDSIVA(),
        lambda: ADMMIVA(),
        lambda: HVA(),
        lambda: MaskingPDSHVA(),
        lambda: MaskingADMMHVA(),
        lambda: PDSBSS(prox_penalty=_l1_prox),
        lambda: MaskingPDSBSS(mask_fn=lambda z: z.abs()),
        lambda: fast_pds_iva(X, n_iter=1),
        lambda: fast_admm_iva(X, n_iter=1),
        lambda: fast_hva(X, n_iter=1),
    ]
    if torch.cuda.is_available():
        assert PDSIVA().device.type == "cuda"
    else:
        for call in entry_points:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert HVA(device="cpu").device == torch.device("cpu")


def test_normalize_by_spectral_norm_moves_its_input_to_the_separators_device(monkeypatch):
    """A numpy spectrogram is scaled on the separator's device (the card by default), not where it came from."""
    import ssspy_tpu_torch.bss.proxbss as proxbss

    seen = []

    def recording(A):
        seen.append(A.device)
        n = 2 * A.shape[-1]
        return torch.ones(A.shape[:-2] + (n,), device=A.device), None

    monkeypatch.setattr(proxbss, "herm_eigh_embed", recording)
    method = PDSIVA(device="cpu")
    method.device = torch.device("meta")  # a device other than the input's, present without a card
    X = _spectrogram(seed=51)
    out = method.normalize_by_spectral_norm(X)
    assert seen == [torch.device("meta")] and out.device == torch.device("meta") and out.shape == X.shape
