"""ssspy_tpu_torch dense GaussMNMF against the JAX package and the fixtures.

Same numpy inputs through the JAX function and its port: the plain
versions of the inverse sandwich (K4) and the fused model pass (K5)
against ``planar_inv_sandwich_sc`` and ``planar_model_traces_sc`` (their
XLA form and their Pallas body in interpret mode); the step in complex128
against the JAX x64 step and in complex64 against the JAX f32 step; the
loss; the ``GaussMNMF`` class on ``tests/regression/fixtures``; the fast
path against the class, the JAX fast path and the fidelity pin. All on the
CPU (``device="cpu"``), where the kernel wrappers take their plain
versions; the kernels themselves are held against them on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.bss.mnmf import GaussMNMF as JaxGaussMNMF
from ssspy_tpu.fast import fast_gauss_mnmf_dense as jax_fast_gauss_mnmf_dense
from ssspy_tpu.ops.pallas_kernels import planar_inv_sandwich_sc, planar_model_traces_sc
from ssspy_tpu.ops.splitc import gauss_mnmf_loss_sc, gauss_mnmf_step_sc, instant_covariance_sc
from ssspy_tpu_torch.bss import GaussMNMF
from ssspy_tpu_torch.fast import fast_gauss_mnmf_dense
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops import mnmf_steps
from ssspy_tpu_torch.ops.mnmf_steps import (
    gauss_mnmf_loss,
    gauss_mnmf_step,
    gmean2,
    instant_covariance,
    wiener_separate,
)
from ssspy_tpu_torch.utils import complex_to_planar, from_jax_state, host_stft, make_mixture

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS, "regression", "fixtures")
KERNEL_SHAPES = [(3, 5, 37, 4), (2, 4, 130, 8)]  # (N, I, T, m), tests/ops/test_pallas_kernels.py:96


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _crandn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planes(a, dtype=np.float64):
    return jnp.asarray(a.real.astype(dtype)), jnp.asarray(a.imag.astype(dtype))


def _to_complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _spectrogram(n_channels=3, n_fft=16, n_frames=40, seed=0):
    """Small convolutive mixture STFT: (n_channels, n_fft//2 + 1, n_frames) complex128 (9 bins at n_fft=16)."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _psd(rng, *shape):
    """Hermitian positive definite complex64 ``shape = (..., m, m)``."""
    m = shape[-1]
    A = _crandn(rng, shape)
    return (A @ A.conj().swapaxes(-1, -2) / m + 0.1 * np.eye(m)).astype(np.complex64)


def _mnmf_operands(seed=2, N=3, I=5, T=37, m=4):
    """PSD spatial and instant covariances and positive powers, complex64 (test_pallas_kernels.py:77-93)."""
    rng = np.random.default_rng(seed)
    H, XX = _psd(rng, N, I, m, m), _psd(rng, I, T, m, m)
    Lamb = (rng.random((N, I, T)) + 0.05).astype(np.float32)
    return Lamb, H, XX


# ---- K4 and K5: the plain versions against the JAX package --------------------------------


@pytest.mark.parametrize(
    "shape,impl", [(KERNEL_SHAPES[0], "gj"), (KERNEL_SHAPES[1], "gj"), (KERNEL_SHAPES[0], "interpret")]
)
def test_inv_sandwich_plain_matches_jax(shape, impl):
    _, I, T, m = shape
    rng = np.random.default_rng(3)
    R, C = _psd(rng, I, T, m, m), _psd(rng, I, T, m, m)
    ref = planar_inv_sandwich_sc(*_planes(R, np.float32), *_planes(C, np.float32), impl=impl)
    Rinv, S = K.inv_sandwich_plain(torch.from_numpy(R), torch.from_numpy(C))
    # the JAX elimination runs on the real embedding: the sums of each side in another order
    for got, want in ((Rinv, ref[:2]), (S, ref[2:])):
        assert got.dtype == torch.complex64 and got.shape == R.shape
        assert _rel_err(got.numpy(), _to_complex(want)) <= 2e-4


@pytest.mark.parametrize(
    "shape,impl", [(KERNEL_SHAPES[0], "gj"), (KERNEL_SHAPES[1], "gj"), (KERNEL_SHAPES[0], "interpret")]
)
def test_model_traces_plain_matches_jax(shape, impl):
    N, I, T, m = shape
    Lamb, H, XX = _mnmf_operands(N=N, I=I, T=T, m=m)
    ref = planar_model_traces_sc(
        jnp.asarray(Lamb), *_planes(H, np.float32), *_planes(XX, np.float32), eps=1e-6, impl=impl
    )
    got = K.model_traces_plain(*map(torch.from_numpy, (Lamb, H, XX)), eps=1e-6)
    want = (ref[0], ref[1], _to_complex(ref[2:4]), _to_complex(ref[4:6]))
    # tests/ops/test_pallas_kernels.py:101-105: relative to max, the traces reorder f32 sums
    for g, w, name in zip(got, want, ("t1", "t2", "P", "Q")):
        assert tuple(g.shape) == np.shape(w), name
        assert _rel_err(g.numpy(), w) <= 2e-4, name


def test_wrappers_take_the_plain_versions_on_cpu():
    Lamb, H, XX = map(torch.from_numpy, _mnmf_operands(seed=4))
    before = (K.inv_sandwich.launches, K.model_traces.launches)
    for got, want in zip(K.inv_sandwich(XX, XX), K.inv_sandwich_plain(XX, XX)):
        assert torch.equal(got, want)
    for got, want in zip(K.model_traces(Lamb, H, XX, 1e-6), K.model_traces_plain(Lamb, H, XX, 1e-6)):
        assert torch.equal(got, want)
    assert (K.inv_sandwich.launches, K.model_traces.launches) == before


def test_gj_inverse_plain_inverts_and_floors_the_pivot():
    rng = np.random.default_rng(5)
    A = _crandn(rng, (7, 5, 5))
    R = torch.from_numpy(A @ A.conj().swapaxes(-1, -2) + np.eye(5))
    np.testing.assert_allclose((K.gj_inverse_plain(R) @ R).numpy(), np.broadcast_to(np.eye(5), R.shape), atol=1e-12)
    # a zero system: each pivot floors to 1e-20 and the result stays finite
    zero = torch.zeros((2, 3, 3), dtype=torch.complex64)
    out = K.gj_inverse_plain(zero)
    assert torch.isfinite(torch.view_as_real(out)).all()
    assert torch.equal(out, torch.eye(3, dtype=out.dtype).expand_as(out) / 1e-20)


def test_model_traces_stays_finite_on_zero_bins_and_a_tiny_lamb():
    Lamb, H, XX = _mnmf_operands(seed=6, N=3, I=5, T=37, m=4)
    XX[[1, 3]] = 0
    Lamb[:, 2] = 1e-30
    t1, t2, P, Q = K.model_traces_plain(*map(torch.from_numpy, (Lamb, H, XX)), eps=1e-10)
    for out in (t1, t2, torch.view_as_real(P), torch.view_as_real(Q)):
        assert torch.isfinite(out).all()
    assert float(t1[:, [1, 3]].abs().max()) == 0.0 and float(Q[:, [1, 3]].abs().max()) == 0.0


def test_kernel_checks():
    """What the K4 and K5 wrappers refuse, without a card: the checks run before the device's."""
    R = torch.zeros((6, 4, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="all CUDA tensors"):
        K._check_inv_sandwich(R, R)  # everything else passes; the CPU tensors are the last check
    with pytest.raises(ValueError, match="complex64"):
        K._check_inv_sandwich(R.to(torch.complex128), R.to(torch.complex128))
    with pytest.raises(ValueError, match="does not match"):
        K._check_inv_sandwich(R, R[:3])
    with pytest.raises(ValueError, match="contiguous"):
        K._check_inv_sandwich(R.mT, R)
    with pytest.raises(ValueError, match="m <= 16"):
        big = torch.zeros((2, 17, 17), dtype=torch.complex64)
        K._check_inv_sandwich(big, big)

    Lamb, H, XX = map(torch.from_numpy, _mnmf_operands(seed=7))
    with pytest.raises(ValueError, match="all CUDA tensors"):
        K._check_model_traces(Lamb, H, XX)
    with pytest.raises(ValueError, match="float32 Lamb"):
        K._check_model_traces(Lamb.double(), H, XX)
    with pytest.raises(ValueError, match="complex64 H and XX"):
        K._check_model_traces(Lamb, H, XX.to(torch.complex128))
    with pytest.raises(ValueError, match="does not match"):
        K._check_model_traces(Lamb, H, XX[:, :5])
    with pytest.raises(ValueError, match="contiguous"):
        K._check_model_traces(Lamb, H.mT, XX)
    with pytest.raises(ValueError, match="shared memory"):
        K._check_model_traces(
            torch.zeros((40, 2, 3)), torch.zeros((40, 2, 16, 16), dtype=torch.complex64),
            torch.zeros((2, 3, 16, 16), dtype=torch.complex64),
        )


# ---- the step and the loss against the JAX step ---------------------------------------------


def _step_inputs(seed, n_sources=None, n_channels=3, partitioning=False, K_=2):
    X = _spectrogram(n_channels=n_channels, seed=seed)
    M, I, T = X.shape
    N = M if n_sources is None else n_sources
    rng = np.random.default_rng(seed + 1)
    if partitioning:
        Z = rng.random((N, K_))
        factors = (rng.random((I, K_)), rng.random((K_, T)), np.maximum(Z / Z.sum(axis=0), 1e-10))
    else:
        factors = (rng.random((N, I, K_)), rng.random((N, K_, T)))
    H0 = np.tile(np.eye(M, dtype=complex) / M, (N, I, 1, 1))
    return X, factors, H0


def _run_steps(X, factors, H0, n_iter, dtype, **kw):
    """``n_iter`` JAX steps and port steps from the same start; returns both ``(T, V, H[, Z])``."""
    real = np.float64 if dtype == np.complex128 else np.float32
    XXs = instant_covariance_sc(jnp.asarray(np.stack(_planes(X, real))), psd_impl=kw.get("psd_impl", "auto"))
    factors = [f.astype(real) for f in factors]
    T, V = jnp.asarray(factors[0]), jnp.asarray(factors[1])
    Z = jnp.asarray(factors[2]) if len(factors) == 3 else None
    Hs = jnp.stack(_planes(H0, real))
    step = jax.jit(lambda XXs, T, V, Hs, Z: gauss_mnmf_step_sc(XXs, T, V, Hs, Z=Z, **kw))
    for _ in range(n_iter):
        out = step(XXs, T, V, Hs, Z)
        T, V, Hs = out[:3]
        Z = out[3] if Z is not None else None
    ref = [np.asarray(T), np.asarray(V), _to_complex(Hs)] + ([np.asarray(Z)] if Z is not None else [])

    port_kw = {k: v for k, v in kw.items() if k != "fuse"}
    XX = instant_covariance(torch.from_numpy(X.astype(dtype)), psd_impl=kw.get("psd_impl", "auto"))
    state = [torch.from_numpy(f) for f in factors]
    H = torch.from_numpy(H0.astype(dtype))
    for _ in range(n_iter):
        out = gauss_mnmf_step(XX, state[0], state[1], H, Z=state[2] if len(state) == 3 else None, **port_kw)
        state, H = [out[0], out[1], *out[3:]], out[2]
    got = [state[0].numpy(), state[1].numpy(), H.numpy()] + ([state[2].numpy()] if len(state) == 3 else [])
    return got, ref


@pytest.mark.parametrize(
    "n_channels,n_sources,partitioning",
    [(3, None, False), (3, None, True), (2, 3, False)],
    ids=["determined", "partitioning", "overdetermined"],
)
def test_gauss_mnmf_step_matches_jax_x64(n_channels, n_sources, partitioning):
    X, factors, H0 = _step_inputs(8, n_sources=n_sources, n_channels=n_channels, partitioning=partitioning)
    got, ref = _run_steps(X, factors, H0, 3, np.complex128, psd_impl="eigh")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-7)


@pytest.mark.parametrize("partitioning", [False, True], ids=["plain", "partitioning"])
def test_gauss_mnmf_step_matches_jax_f32_fused(partitioning):
    """The complex64 default (ridge model, chol geometric mean, the fused pass) against JAX's unfused f32 step."""
    X, factors, H0 = _step_inputs(9, partitioning=partitioning)
    got, ref = _run_steps(X, factors, H0, 3, np.complex64, psd_impl="ridge", gmean_impl="chol", fuse="off")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-6 * np.abs(r).max())


def test_gauss_mnmf_step_matches_jax_f32_eigh_model():
    """The complex64 eigh model runs unfused: K4's plain version, K7's for every projection."""
    X, factors, H0 = _step_inputs(10)
    got, ref = _run_steps(X, factors, H0, 2, np.complex64, psd_impl="eigh", gmean_impl="chol", fuse="off")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("partitioning", [False, True], ids=["plain", "partitioning"])
def test_gauss_mnmf_loss_matches_jax(dtype, partitioning):
    X, factors, H0 = _step_inputs(11, partitioning=partitioning)
    real = np.float64 if dtype == np.complex128 else np.float32
    rng = np.random.default_rng(12)
    A = _crandn(rng, H0.shape)
    H = (A @ A.conj().swapaxes(-1, -2) / 3 + 0.1 * np.eye(3)).astype(dtype)
    factors = [f.astype(real) for f in factors]
    Z = factors[2] if partitioning else None
    XXs = instant_covariance_sc(jnp.asarray(np.stack(_planes(X, real))))
    ref = float(gauss_mnmf_loss_sc(XXs, *map(jnp.asarray, factors[:2]), jnp.stack(_planes(H, real)),
                                   Z=None if Z is None else jnp.asarray(Z)))
    XX = instant_covariance(torch.from_numpy(X.astype(dtype)))
    got = gauss_mnmf_loss(XX, *map(torch.from_numpy, factors[:2]), torch.from_numpy(H),
                          Z=None if Z is None else torch.from_numpy(Z))
    assert got.dim() == 0
    assert abs(float(got) - ref) <= (1e-10 if dtype == np.complex128 else 1e-5) * abs(ref)


def test_float32_spatial_floor_keeps_the_step_finite(monkeypatch):
    """The complex64 step's floor on H: eigenvalues at ``F32_SPATIAL_REL`` times the top one (``spatial_projection``).

    On an 8-channel mixture a spatial covariance nears rank one, the
    absolute 1e-10 ridge vanishes under float32 rounding, and without the
    floor (the JAX step's projection) a trace that is non-negative in exact
    arithmetic comes out negative: the step is non-finite by iteration 31
    (the JAX float32 step fails the same way on a 3 s cut of the 8-channel,
    10 s mixture). With the floor the same iterations stay finite and the
    loss falls.
    """
    wave = make_mixture(seed=0, n_channels=8, duration_s=0.5)
    X = torch.from_numpy(host_stft(wave, n_fft=256, hop=128).astype(np.complex64))
    M, I, T = X.shape
    XX = instant_covariance(X)
    rng = np.random.default_rng(0)
    start = [torch.from_numpy(np.maximum(rng.random(s), 1e-10).astype(np.float32)) for s in ((M, I, 4), (M, 4, T))]
    start.append((torch.eye(M, dtype=X.dtype) / M).expand(M, I, M, M).contiguous())

    def iterations(n_iter):
        state = start
        for it in range(n_iter):
            state = gauss_mnmf_step(XX, *state)
            if not all(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all() for t in state):
                return it, state
        return n_iter, state

    assert mnmf_steps.F32_SPATIAL_REL == 1e-6
    n_iter, state = iterations(31)
    assert n_iter == 31
    assert float(gauss_mnmf_loss(XX, *state)) < float(gauss_mnmf_loss(XX, *start))
    monkeypatch.setattr(mnmf_steps, "spatial_projection", lambda G, eps, psd_impl: mnmf_steps.psd_project(G, eps, psd_impl))
    assert iterations(31)[0] < 31


def test_routes_by_dtype(monkeypatch):
    assert mnmf_steps._routes(torch.complex64) == ("ridge", "chol")
    assert mnmf_steps._routes(torch.complex128) == ("eigh", "eigh2")
    assert mnmf_steps._routes(torch.complex64, "eigh", "eigh2") == ("eigh", "eigh2")
    with pytest.raises(ValueError, match="complex64 or complex128"):
        mnmf_steps._routes(torch.float32)
    with pytest.raises(ValueError, match="psd_impl"):
        mnmf_steps._routes(torch.complex64, "tikhonov")
    with pytest.raises(ValueError, match="gmean_impl"):
        mnmf_steps._routes(torch.complex64, "auto", "lapack")


def test_eigh_in_batches_matches_one_eigh():
    """The card's route for complex128 eighs above ``CUDA_EIGH_BATCH`` matrices, here on the CPU: same result, same shapes."""
    from ssspy_tpu_torch.special.psd import eigh_in_batches

    rng = np.random.default_rng(22)
    A = torch.from_numpy(_crandn(rng, (3, 10, 4, 4)))
    A = A + A.mH
    lamb, P = eigh_in_batches(A, 7)
    lamb_ref, P_ref = torch.linalg.eigh(A)
    assert lamb.shape == lamb_ref.shape and P.shape == P_ref.shape
    assert torch.equal(lamb, lamb_ref) and torch.equal(P, P_ref)
    assert all(torch.equal(a, b) for a, b in zip(eigh_in_batches(A, 30), (lamb_ref, P_ref)))


def test_gmean2_routes_agree_and_solve_the_riccati_equation():
    rng = np.random.default_rng(13)
    A, B = (_crandn(rng, (6, 4, 4)) for _ in range(2))
    A, B = (torch.from_numpy(C @ C.conj().swapaxes(-1, -2) + 0.5 * np.eye(4)) for C in (A, B))
    G_eigh, G_chol = gmean2(A, B, impl="eigh2"), gmean2(A, B, impl="chol")
    np.testing.assert_allclose(G_chol.numpy(), G_eigh.numpy(), atol=1e-10)
    np.testing.assert_allclose((G_eigh @ A @ G_eigh).numpy(), B.numpy(), atol=1e-10)


def test_wiener_separate_matches_the_reference_filter():
    """One solve for every source against the reference's W_n = R^-1 R_n (fast.py:902-908)."""
    rng = np.random.default_rng(14)
    X = _crandn(rng, (3, 5, 11))
    A = _crandn(rng, (2, 5, 3, 3))
    H = A @ A.conj().swapaxes(-1, -2) + 0.1 * np.eye(3)
    Lamb = rng.random((2, 5, 11)) + 0.1
    R_n = np.einsum("nit,nipq->nitpq", Lamb, H)
    W = np.swapaxes(np.linalg.solve(R_n.sum(axis=0)[None], R_n), -2, -1).conj()[..., 1, :]
    ref = np.einsum("nitm,mit->nit", W, X)
    got = wiener_separate(*map(torch.from_numpy, (X, Lamb, H)), reference_id=1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)


# ---- the class and the fast path --------------------------------------------------------------


def _nmf_init(n_sources, n_bins, n_frames, n_basis=2, seed=5):
    """The warm start of tests/regression/test_regression.py:_nmf_init."""
    rng = np.random.default_rng(seed)
    return {
        "basis": rng.random((n_sources, n_bins, n_basis)),
        "activation": rng.random((n_sources, n_basis, n_frames)),
    }


def test_gauss_mnmf_class_matches_regression_fixture():
    X = np.load(os.path.join(FIXTURES, "input.npz"))["spectrogram"]
    target = np.load(os.path.join(FIXTURES, "gauss_mnmf.npz"))["target"]
    mnmf = GaussMNMF(n_basis=2, device="cpu")
    Y = mnmf(torch.from_numpy(X.copy()), n_iter=3, **_nmf_init(*X.shape))
    assert Y.dtype == torch.complex128 and Y.shape == target.shape
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert len(mnmf.loss) == 4 and mnmf.loss[-1] < mnmf.loss[0]


@pytest.mark.parametrize(
    "kwargs",
    [{"partitioning": True}, {"n_sources": 2, "normalization": False}, {"n_sources": 4}],
    ids=["partitioning", "underdetermined_unnormalized", "overdetermined"],
)
def test_gauss_mnmf_class_matches_jax_class(kwargs):
    X = _spectrogram(seed=15)
    ref = JaxGaussMNMF(n_basis=2, rng=np.random.default_rng(16), **kwargs)
    Y_ref = np.asarray(ref(X.copy(), n_iter=3))
    seen = []
    mnmf = GaussMNMF(n_basis=2, rng=np.random.default_rng(16), device="cpu", callbacks=lambda m: seen.append(m.loss[-1]), **kwargs)
    Y = mnmf(torch.from_numpy(X.copy()), n_iter=3)
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-9)
    np.testing.assert_allclose(mnmf.loss, ref.loss, rtol=1e-10)
    assert seen == mnmf.loss
    for name in ("basis", "activation", "spatial") + (("latent",) if kwargs.get("partitioning") else ()):
        np.testing.assert_allclose(getattr(mnmf, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-9)
    assert repr(mnmf).startswith("GaussMNMF(n_basis=2")


def test_gauss_mnmf_class_warm_starts():
    """A second call continues from the first call's factors, as the JAX class does; record_loss=False keeps none."""
    X = _spectrogram(seed=17)
    ref = JaxGaussMNMF(n_basis=2, rng=np.random.default_rng(18))
    ref(X.copy(), n_iter=2)
    Y_ref = np.asarray(ref(X.copy(), n_iter=2, initial_call=False))
    mnmf = GaussMNMF(n_basis=2, rng=np.random.default_rng(18), device="cpu")
    mnmf(torch.from_numpy(X.copy()), n_iter=2)
    Y = mnmf(torch.from_numpy(X.copy()), n_iter=2, initial_call=False)
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-9)
    assert len(mnmf.loss) == len(ref.loss) == 5
    quiet = GaussMNMF(n_basis=2, record_loss=False, device="cpu", rng=np.random.default_rng(18))
    quiet(torch.from_numpy(X.copy()), n_iter=1)
    assert quiet.loss is None


def test_fast_gauss_mnmf_dense_matches_class_and_jax():
    """tests/test_fast.py:488-502 on the port, and against the JAX fast path itself."""
    X = _spectrogram(n_channels=2, n_fft=64, seed=19)[:, :33]
    Y_fast, (T, V, H) = fast_gauss_mnmf_dense(X, n_basis=2, n_iter=3, rng=np.random.default_rng(13), device="cpu")
    assert Y_fast.dtype == torch.complex64 and Y_fast.shape == X.shape
    assert T.shape == (2, 33, 2) and V.shape == (2, 2, X.shape[-1]) and H.shape == (2, 33, 2, 2)
    Y_cls = GaussMNMF(n_basis=2, rng=np.random.default_rng(13), device="cpu")(
        torch.from_numpy(X.astype(np.complex64)), n_iter=3
    )
    np.testing.assert_allclose(Y_fast.numpy(), Y_cls.numpy(), atol=5e-3)
    Y_jax, _ = jax_fast_gauss_mnmf_dense(X, n_basis=2, n_iter=3, rng=np.random.default_rng(13))
    assert _rel_err(Y_fast.numpy(), Y_jax) <= 1e-3
    # n_sources on two channels: over- and under-determined
    for n_sources in (3, 1):
        Y3, _ = fast_gauss_mnmf_dense(X, n_basis=2, n_iter=2, n_sources=n_sources, rng=np.random.default_rng(1), device="cpu")
        Y3_jax, _ = jax_fast_gauss_mnmf_dense(X, n_basis=2, n_iter=2, n_sources=n_sources, rng=np.random.default_rng(1))
        assert Y3.shape == (n_sources,) + X.shape[1:]
        assert _rel_err(Y3.numpy(), Y3_jax) <= 1e-3


def test_fast_gauss_mnmf_dense_meets_the_fidelity_pin(tmp_path):
    """tests/test_fast_fidelity.py:541-562 on the port: within 0.1 dB of the pinned reference SI-SDR."""
    from ssspy_tpu.transform import stft
    from ssspy_tpu.utils.dataset import download_sample_speech_data
    from tests.test_fast_fidelity import HOP, N_FFT, _quality

    images, _ = download_sample_speech_data(
        cache_dir=str(tmp_path), n_sources=2, max_duration=2.0, conv=True, seed=0
    )
    mix = images.sum(axis=0)
    X = np.array(stft(mix, n_fft=N_FFT, hop_length=HOP))
    Y, _ = fast_gauss_mnmf_dense(X, n_basis=2, n_iter=10, rng=np.random.default_rng(5), device="cpu")
    with open(os.path.join(TESTS, "fidelity_pins.json")) as f:
        want = json.load(f)["gauss_mnmf_dense"]
    got = _quality(Y.numpy(), images, mix)
    assert abs(got - want) <= 0.1, f"{got:.3f} vs {want:.3f} dB"


def test_state_bridge_takes_the_mnmf_keys():
    rng = np.random.default_rng(20)
    H, XX = _crandn(rng, (2, 5, 3, 3)), _crandn(rng, (5, 7, 3, 3))
    Hs, XXs = (np.stack([a.real, a.imag]).astype(np.float32) for a in (H, XX))
    T, V, Z = rng.random((2, 5, 2)), rng.random((2, 2, 7)), rng.random((2, 2))
    planar = from_jax_state({"H": Hs, "XX": XXs, "T": T, "V": V, "Z": Z})
    assert planar["H"].dtype == planar["XX"].dtype == torch.complex64
    np.testing.assert_array_equal(complex_to_planar(planar["XX"]), XXs)
    assert planar["Z"].dtype == torch.float64 and planar["T"].shape == (2, 5, 2)
    # the class state arrives complex; a real XX is read as planar by its key, whatever its shape
    complex_state = from_jax_state({"H": H, "XX": XX})
    assert complex_state["H"].dtype == torch.complex128
    np.testing.assert_array_equal(complex_state["XX"].numpy(), XX)
    with pytest.raises(ValueError, match="planar"):
        from_jax_state({"XX": XX.real})


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is driven by chip_smoke.py")
    X = _spectrogram(seed=21)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussMNMF(n_basis=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast_gauss_mnmf_dense(X, n_basis=2, n_iter=1)


def test_complex64_paths_hand_the_kernels_what_they_take(monkeypatch):
    """The dense-MNMF paths pass K4's, K5's and K7's own argument checks, at their launch counts.

    On the CPU the wrappers take their plain versions before any check, so
    here each wrapper runs its kernel's checks (all but the device) first.
    """
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    checked = {}
    for name, check, plain, n_checked in (
        ("inv_sandwich", K._check_inv_sandwich, K.inv_sandwich_plain, 2),
        ("model_traces", K._check_model_traces, K.model_traces_plain, 3),
        ("jacobi_eigh", K._check_jacobi_eigh, K.jacobi_eigh_plain, 1),
    ):

        def checking(*args, _name=name, _check=check, _plain=plain, _n=n_checked, **kwargs):
            _check(*args[:_n])
            checked[_name] = checked.get(_name, 0) + 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(K, name, checking)

    X = _spectrogram(seed=22).astype(np.complex64)
    n_iter = 2
    fast_gauss_mnmf_dense(X, n_basis=2, n_iter=n_iter, rng=np.random.default_rng(23), device="cpu")
    mnmf = GaussMNMF(n_basis=2, partitioning=True, rng=np.random.default_rng(23), device="cpu")
    mnmf(torch.from_numpy(X), n_iter=n_iter)
    # K5: three passes per iteration, a fourth with the latent; K7: the geometric mean's eigh and H's floor
    assert checked == {"model_traces": 3 * n_iter + 4 * n_iter, "jacobi_eigh": 2 * 2 * n_iter}

    checked.clear()
    XX = instant_covariance(torch.from_numpy(X), psd_impl="eigh")
    M, I, T = X.shape
    state = (torch.ones((M, I, 2)), torch.ones((M, 2, T)), torch.eye(M, dtype=XX.dtype).expand(M, I, M, M) / M)
    gauss_mnmf_step(XX, *state, psd_impl="eigh")
    gauss_mnmf_loss(XX, *state[:2], state[2].contiguous(), psd_impl="eigh")
    # K4 three times; K7 for XX, the model three times, P, HQH, the mean and H, the loss's model
    assert checked == {"inv_sandwich": 3, "jacobi_eigh": 1 + 3 + 4 + 1}
