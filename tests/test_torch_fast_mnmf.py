"""ssspy_tpu_torch FastGaussMNMF against the JAX package and the fixtures.

Same numpy inputs through the JAX function and its port: the step in
float32 against the JAX f32 step (``ssspy_tpu.ops.splitc.fast_gauss_mnmf_step_sc``)
within 1e-4 relative, and in float64 against its x64 run within 1e-10; the
loss; the class in complex128 on ``tests/regression/fixtures`` (the
reference's 1e-7), and in complex64 against ``fast_gauss_mnmf`` from the
same draws; ``fast_gauss_mnmf`` against the JAX fast path by SI-SDR and
against the easy tier's fidelity pin; the routes of the diagonalizer
update through the kernels' own checks. All on the CPU (``device="cpu"``),
where the kernel wrappers take their plain versions.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.bss.mnmf import FastGaussMNMF as JaxFastGaussMNMF
from ssspy_tpu.fast import fast_gauss_mnmf as jax_fast_gauss_mnmf
from ssspy_tpu.ops.splitc import fast_gauss_mnmf_loss_sc, fast_gauss_mnmf_step_sc
from ssspy_tpu_torch.bss import FastGaussMNMF, FastMNMFBase
from ssspy_tpu_torch.fast import fast_gauss_mnmf
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops.fast_mnmf_steps import fast_gauss_mnmf_loss, fast_gauss_mnmf_step, fast_mnmf_separate
from ssspy_tpu_torch.utils import host_stft, make_mixture
from tests.regression.test_regression import N_ITER, _input, _load

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 2


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _spectrogram(n_channels=3, n_fft=16, n_frames=40, seed=0):
    """Small convolutive mixture STFT: (n_channels, n_fft//2 + 1, n_frames) complex128 (9 bins at n_fft=16)."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _problem(seed=30, n_channels=3, n_sources=3, K_=2):
    """3 channels, 9 bins, 40 frames; the factors drawn as ``fast_gauss_mnmf`` draws them, a diagonalizer near I."""
    X = _spectrogram(n_channels=n_channels, seed=seed)
    M, I, T = X.shape
    rng = np.random.default_rng(seed + 1)
    Q = np.eye(M) + 0.1 * (rng.standard_normal((I, M, M)) + 1j * rng.standard_normal((I, M, M)))
    T0, V0 = rng.random((n_sources, I, K_)), rng.random((n_sources, K_, T))
    D0 = np.maximum(rng.random((I, n_sources, M)), 1e-10)
    return X, Q, T0, V0, D0


def _run_jax(problem, dtype, eps):
    real = np.float64 if dtype == np.complex128 else np.float32
    X, Q, T0, V0, D0 = problem
    Xs = jnp.asarray(np.stack([X.real, X.imag]).astype(real))
    Qs = jnp.asarray(np.stack([Q.real, Q.imag]).astype(real))
    T, V, D = (jnp.asarray(a.astype(real)) for a in (T0, V0, D0))
    step = jax.jit(functools.partial(fast_gauss_mnmf_step_sc, eps=eps))
    for _ in range(N_STEPS):
        Qs, T, V, D = step(Xs, Qs, T, V, D)
    loss = float(jax.jit(functools.partial(fast_gauss_mnmf_loss_sc, eps=eps))(Xs, Qs, T, V, D))
    return np.asarray(Qs[0]) + 1j * np.asarray(Qs[1]), np.asarray(T), np.asarray(V), np.asarray(D), loss


def _run_port(problem, dtype, eps):
    real = np.float64 if dtype == np.complex128 else np.float32
    X, Q, T0, V0, D0 = problem
    Xt, Qt = torch.from_numpy(X.astype(dtype)), torch.from_numpy(Q.astype(dtype))
    T, V, D = (torch.from_numpy(a.astype(real)) for a in (T0, V0, D0))
    for _ in range(N_STEPS):
        Qt, T, V, D = fast_gauss_mnmf_step(Xt, Qt, T, V, D, eps=eps)
    loss = fast_gauss_mnmf_loss(Xt, Qt, T, V, D, eps=eps)
    assert loss.dim() == 0
    return Qt.numpy(), T.numpy(), V.numpy(), D.numpy(), float(loss)


@pytest.fixture(scope="module")
def steps():
    """``{dtype: (jax result, port result)}`` on one problem: float32 at eps 1e-6, float64 at 1e-10."""
    problem = _problem()
    return {
        dtype: (_run_jax(problem, dtype, eps), _run_port(problem, dtype, eps))
        for dtype, eps in ((np.complex64, 1e-6), (np.complex128, 1e-10))
    }


@pytest.mark.parametrize("dtype, tol", [(np.complex64, 1e-4), (np.complex128, 1e-10)], ids=["f32", "x64"])
@pytest.mark.parametrize("index, name", list(enumerate(["Q", "T", "V", "D"])))
def test_step_matches_jax(steps, dtype, tol, index, name):
    ref, got = steps[dtype]
    assert got[index].dtype == (dtype if name == "Q" else np.dtype(dtype).type(0).real.dtype)
    assert _rel_err(got[index], ref[index]) <= tol, name


@pytest.mark.parametrize("dtype, tol", [(np.complex64, 1e-5), (np.complex128, 1e-12)], ids=["f32", "x64"])
def test_loss_matches_jax(steps, dtype, tol):
    ref, got = steps[dtype]
    assert abs(got[4] - ref[4]) <= tol * abs(ref[4])


def test_step_with_more_sources_than_channels_stays_finite():
    X, Q, T0, V0, D0 = _problem(seed=32, n_channels=2, n_sources=3)
    out = fast_gauss_mnmf_step(*(torch.from_numpy(a) for a in (X, Q, T0, V0, D0)))
    assert [tuple(a.shape) for a in out] == [Q.shape, T0.shape, V0.shape, D0.shape]
    assert all(torch.isfinite(torch.view_as_real(a) if a.is_complex() else a).all() for a in out)


def test_a_silent_bin_stays_finite():
    """The 1e-30 denominator floor: a zero bin gives no 0/0 that the activation update would spread."""
    X, Q, T0, V0, D0 = _problem(seed=33)
    X[:, 4] = 0
    out = fast_gauss_mnmf_step(*(torch.from_numpy(a.astype(np.complex64 if np.iscomplexobj(a) else np.float32))
                                 for a in (X, Q, T0, V0, D0)))
    assert all(torch.isfinite(torch.view_as_real(a) if a.is_complex() else a).all() for a in out)


def test_separate_matches_the_host_filter_of_the_jax_fast_path():
    """ssspy_tpu/fast.py:752-767 in NumPy, against the port's filter on the same factors."""
    X, Q, T0, V0, D0 = _problem(seed=34)
    Lamb = np.maximum(T0 @ V0, 1e-10)
    Q_inv = np.linalg.inv(Q)
    R_n = np.einsum("ipm,nitm,iqm->nitpq", Q_inv, np.einsum("nit,nim->nitm", Lamb, D0.swapaxes(0, 1)), Q_inv.conj())
    W = np.linalg.solve(R_n.sum(axis=0)[None], R_n)
    ref = np.einsum("nitm,mit->nit", W.swapaxes(-2, -1).conj()[..., 1, :], X)
    got = fast_mnmf_separate(*(torch.from_numpy(a) for a in (X, T0, V0, Q, D0)), reference_id=1)
    assert _rel_err(got.numpy(), ref) <= 1e-12


# ---- the class ---------------------------------------------------------------------------


def test_class_matches_regression_fixture():
    """tests/regression/test_regression.py:154-159 on the port, complex128, at the reference's 1e-7."""
    X = _input()
    mnmf = FastGaussMNMF(n_basis=2, rng=np.random.default_rng(11), device="cpu")
    Y = mnmf(torch.from_numpy(X.copy()), n_iter=N_ITER)
    target = _load("fast_gauss_mnmf_ip1")
    assert Y.dtype == torch.complex128
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert len(mnmf.loss) == N_ITER + 1 and mnmf.loss[-1] < mnmf.loss[0]


def test_complex64_class_equals_the_fast_path_from_the_same_draws():
    X = _spectrogram(n_channels=2, n_fft=64, seed=35)[:, :33]
    Y_fast, (T, V, Q, D) = fast_gauss_mnmf(X, n_basis=2, n_iter=3, rng=np.random.default_rng(36), device="cpu")
    mnmf = FastGaussMNMF(n_basis=2, rng=np.random.default_rng(36), device="cpu")
    Y_cls = mnmf(torch.from_numpy(X.astype(np.complex64)), n_iter=3)
    assert torch.equal(Y_cls, Y_fast)
    for got, ref in ((mnmf.basis, T), (mnmf.activation, V), (mnmf.diagonalizer, Q), (mnmf.spatial, D)):
        assert torch.equal(got, ref)


def test_class_attributes_warm_start_and_what_raises():
    X = torch.from_numpy(_spectrogram(n_channels=2, n_fft=32, seed=37))
    mnmf = FastGaussMNMF(n_basis=2, rng=np.random.default_rng(38), device="cpu")
    assert isinstance(mnmf, FastMNMFBase)
    mnmf(X, n_iter=2)
    assert mnmf.basis.shape == (2, 17, 2) and mnmf.activation.shape == (2, 2, X.shape[-1])
    assert mnmf.diagonalizer.shape == (17, 2, 2) and mnmf.spatial.shape == (17, 2, 2)
    assert "FastGaussMNMF(n_basis=2" in repr(mnmf)
    # a warm start continues where the first run stopped: 2 + 2 iterations equal 4
    state = {k: getattr(mnmf, k) for k in ("basis", "activation", "diagonalizer", "spatial")}
    Y_warm = FastGaussMNMF(n_basis=2, device="cpu")(X, n_iter=2, **state)
    Y_four = FastGaussMNMF(n_basis=2, rng=np.random.default_rng(38), device="cpu")(X, n_iter=4)
    np.testing.assert_allclose(Y_warm.numpy(), Y_four.numpy(), atol=1e-10)
    quiet = FastGaussMNMF(n_basis=2, record_loss=False, rng=np.random.default_rng(38), device="cpu")
    quiet(X, n_iter=1)
    assert quiet.loss is None
    # the IP2 diagonalizer is ported since: it runs and equals the JAX class from the same draws
    ip2 = FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2", rng=np.random.default_rng(38), device="cpu")
    ref = JaxFastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2", rng=np.random.default_rng(38))
    np.testing.assert_allclose(ip2(X, n_iter=2).numpy(), np.asarray(ref(X.numpy().copy(), n_iter=2)), atol=1e-9)
    np.testing.assert_allclose(ip2.loss, ref.loss, rtol=1e-9)
    with pytest.raises(ValueError, match="partitioning"):
        FastGaussMNMF(n_basis=2, partitioning=True, device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP3", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FastGaussMNMF(n_basis=2)


# ---- the fast path -------------------------------------------------------------------------


def _si_sdr_db(est, ref):
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    return float(10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err))))


def test_fast_gauss_mnmf_matches_the_jax_fast_path():
    X = _spectrogram(n_channels=3, n_fft=64, seed=39)[:, :33]
    Y, (T, V, Q, D) = fast_gauss_mnmf(X, n_basis=2, n_iter=5, rng=np.random.default_rng(40), device="cpu")
    Y_jax, (T_jax, V_jax, Q_jax, D_jax) = jax_fast_gauss_mnmf(X, n_basis=2, n_iter=5, rng=np.random.default_rng(40))
    assert Y.dtype == torch.complex64 and Y.shape == X.shape
    assert T.shape == T_jax.shape and V.shape == V_jax.shape and Q.shape == Q_jax.shape and D.shape == D_jax.shape
    sdr = min(_si_sdr_db(Y[n].numpy().astype(np.complex128), Y_jax[n]) for n in range(3))
    assert sdr >= 40.0  # the JAX package's float32 scan, another order of sums: far inside 0.1 dB
    assert _rel_err(Q.numpy(), Q_jax) <= 1e-3
    # the IP2 diagonalizer, ported since: the JAX fast path's within the same 40 dB
    Y2, _ = fast_gauss_mnmf(X, n_basis=2, n_iter=5, diagonalizer_algorithm="IP2", rng=np.random.default_rng(40),
                            device="cpu")
    Y2_jax, _ = jax_fast_gauss_mnmf(X, n_basis=2, n_iter=5, diagonalizer_algorithm="IP2", rng=np.random.default_rng(40))
    assert min(_si_sdr_db(Y2[n].numpy().astype(np.complex128), Y2_jax[n]) for n in range(3)) >= 40.0


def test_fast_gauss_mnmf_meets_the_fidelity_pin(tmp_path):
    """tests/test_fast_fidelity.py:564-595 (IP1) on the port: within 0.1 dB of the pinned reference SI-SDR."""
    from ssspy_tpu.transform import stft
    from ssspy_tpu.utils.dataset import download_sample_speech_data
    from tests.test_fast_fidelity import HOP, N_FFT, _quality

    images, _ = download_sample_speech_data(cache_dir=str(tmp_path), n_sources=2, max_duration=2.0, conv=True, seed=0)
    mix = images.sum(axis=0)
    X = np.array(stft(mix, n_fft=N_FFT, hop_length=HOP))
    Y, _ = fast_gauss_mnmf(X, n_basis=2, n_iter=20, rng=np.random.default_rng(7), device="cpu")
    with open(os.path.join(TESTS, "fidelity_pins.json")) as f:
        want = json.load(f)["fast_gauss_mnmf_IP1"]
    got = _quality(Y.numpy(), images, mix)
    assert abs(got - want) <= 0.1, f"{got:.3f} vs {want:.3f} dB"


def test_complex64_paths_hand_the_kernels_what_they_take(monkeypatch):
    """The diagonalizer update passes K1's and K1b's own checks: per-channel weights ``(M, I, T)``, ``N = M``."""
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    checked = {}
    for name, check, plain in (
        ("weighted_covariance", K._check_weighted_covariance, K.weighted_covariance_plain),
        ("ip1_sweep", K._check_ip1_sweep, K.ip1_sweep_plain),
    ):

        def checking(*args, _name=name, _check=check, _plain=plain, **kwargs):
            _check(*args)
            checked[_name] = checked.get(_name, 0) + 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(K, name, checking)
    X = _spectrogram(n_channels=2, n_fft=32, seed=41)
    fast_gauss_mnmf(X, n_basis=2, n_iter=2, rng=np.random.default_rng(42), device="cpu")
    FastGaussMNMF(n_basis=2, rng=np.random.default_rng(42), device="cpu")(torch.from_numpy(X.astype(np.complex64)), n_iter=2)
    assert checked == {"weighted_covariance": 4, "ip1_sweep": 4}
    FastGaussMNMF(n_basis=2, rng=np.random.default_rng(42), device="cpu")(torch.from_numpy(X), n_iter=2)
    assert checked == {"weighted_covariance": 4, "ip1_sweep": 4}  # complex128: the plain versions, by the routers
