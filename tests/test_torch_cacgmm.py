"""ssspy_tpu_torch cACGMM, the permutation solvers and the waveform entry points against the JAX package and the fixtures.

Same numpy inputs through the JAX function and its port: the EM step
(``impl="eigh"`` and ``"chol"``, both ``covariance_impl`` options, the
kernel option against the Pallas kernel in interpret mode) against
``ssspy_tpu.ops.splitc.cacgmm_step_sc`` in float64 and float32, the
posterior and the loss; the dead-component case of
tests/ops/test_splitc_cacgmm.py in float32; both permutation solvers and
the fast paths' aligner at N = 2, 3 and 4, the permutations chosen compared
exactly; the class in complex128 on ``tests/regression/fixtures`` and in
each ``permutation_alignment`` mode against the JAX class; ``fast_cacgmm``
against the JAX fast path and the easy tier's fidelity pin;
``fast_auxiva_wave`` and ``fast_gauss_ilrma_wave`` against their JAX twins.
All on the CPU (``device="cpu"``), where the kernel wrappers take their
plain versions. Each JAX program is compiled once per module.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.algorithm.permutation_alignment import (
    correlation_based_permutation_solver as jax_correlation_solver,
)
from ssspy_tpu.algorithm.permutation_alignment import score_based_permutation_solver as jax_score_solver
from ssspy_tpu.bss._sc_engine import permutation_align_host
from ssspy_tpu.bss.cacgmm import CACGMM as JaxCACGMM
from ssspy_tpu.fast import fast_auxiva_wave as jax_fast_auxiva_wave
from ssspy_tpu.fast import fast_cacgmm as jax_fast_cacgmm
from ssspy_tpu.fast import fast_gauss_ilrma_wave as jax_fast_gauss_ilrma_wave
from ssspy_tpu.ops.splitc import cacgmm_loss_sc, cacgmm_posterior_sc, cacgmm_step_sc
from ssspy_tpu_torch.algorithm import (
    correlation_based_permutation_solver,
    permutation_align,
    score_based_permutation_solver,
)
from ssspy_tpu_torch.bss import CACGMM, CACGMMBase
from ssspy_tpu_torch.fast import fast_auxiva_wave, fast_cacgmm, fast_gauss_ilrma_wave
from ssspy_tpu_torch.ops import cacgmm_steps
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.utils import host_stft, make_mixture
from tests.regression.test_regression import N_ITER, _input, _load

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 3
# (impl, covariance_impl). The JAX step's counterpart of the kernel option is its Pallas kernel, interpreted, in
# float32, and the same branch on the kernel's XLA einsum ("auto" off the TPU) in float64, which the Pallas kernel
# would compute in float32
ROUTES = [("eigh", "einsum"), ("chol", "einsum"), ("eigh", "kernel"), ("chol", "kernel")]
JAX_COVARIANCE = {("einsum", np.float64): "einsum", ("einsum", np.float32): "einsum",
                  ("kernel", np.float64): "auto", ("kernel", np.float32): "interpret"}


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _setup(seed=0, M=3, N=3, I=9, T=24):
    """tests/ops/test_splitc_cacgmm.py:10-20: observations, their unit form and a start."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M, I, T)) + 1j * rng.standard_normal((M, I, T))
    Z = X / np.maximum(np.linalg.norm(X, axis=0), 1e-10)
    alpha = rng.random((N, I))
    alpha = alpha / alpha.sum(axis=0)
    B_diag = rng.random((N, I, M))
    B_diag = B_diag / B_diag.sum(axis=-1, keepdims=True)
    return X, Z, alpha, (B_diag[:, :, :, None] * np.eye(M)).astype(complex)


def _run_jax(Z, alpha, B, real, impl, covariance_impl):
    Zs = jnp.asarray(np.stack([Z.real, Z.imag]).astype(real))
    Bs = jnp.asarray(np.stack([B.real, B.imag]).astype(real))
    a = jnp.asarray(alpha.astype(real))
    step = jax.jit(functools.partial(cacgmm_step_sc, eps=1e-10, impl=impl, covariance_impl=JAX_COVARIANCE[covariance_impl, real]))
    for _ in range(N_STEPS):
        a, Bs = step(Zs, a, Bs)
    gamma = cacgmm_posterior_sc(Zs, a, Bs)
    loss = float(cacgmm_loss_sc(Zs, a, Bs))
    return np.asarray(a), np.asarray(Bs[0]) + 1j * np.asarray(Bs[1]), np.asarray(gamma), loss


def _run_port(Z, alpha, B, real, impl, covariance_impl):
    cdtype = np.complex128 if real == np.float64 else np.complex64
    Zt, Bt = torch.from_numpy(Z.astype(cdtype)), torch.from_numpy(B.astype(cdtype))
    a = torch.from_numpy(alpha.astype(real))
    for _ in range(N_STEPS):
        a, Bt = cacgmm_steps.step(Zt, a, Bt, impl=impl, covariance_impl=covariance_impl)
    # the JAX posterior and loss take their default route, the eigh
    gamma = cacgmm_steps.posterior(Zt, a, Bt)
    loss = cacgmm_steps.loss(Zt, a, Bt)
    assert loss.dim() == 0
    return a.numpy(), Bt.numpy(), gamma.numpy(), float(loss)


@pytest.fixture(scope="module")
def steps():
    """``{(impl, covariance_impl, real): (jax result, port result)}`` on one start."""
    _, Z, alpha, B = _setup()
    return {
        (impl, cov, real): (_run_jax(Z, alpha, B, real, impl, cov), _run_port(Z, alpha, B, real, impl, cov))
        for impl, cov in ROUTES
        for real in (np.float64, np.float32)
    }


@pytest.mark.parametrize("real, tol", [(np.float64, 1e-10), (np.float32, 2e-4)], ids=["x64", "f32"])
@pytest.mark.parametrize("impl, covariance_impl", ROUTES)
def test_step_posterior_and_loss_match_jax(steps, impl, covariance_impl, real, tol):
    ref, got = steps[(impl, covariance_impl, real)]
    for name, a, b in zip(("alpha", "B", "gamma"), got[:3], ref[:3]):
        assert _rel_err(a, b) <= tol, name
    assert abs(got[3] - ref[3]) <= tol * abs(ref[3])


def test_chol_and_eigh_agree_at_the_ridge_level():
    """tests/ops/test_splitc_cacgmm.py:63-89 on the port: one float32 step of each route, within 1e-5."""
    _, Z, alpha, B = _setup(seed=3, I=17, T=40)
    Zt, a, Bt = torch.from_numpy(Z.astype(np.complex64)), torch.from_numpy(alpha.astype(np.float32)), torch.from_numpy(B.astype(np.complex64))
    a1, B1 = cacgmm_steps.step(Zt, a, Bt, impl="eigh")
    a2, B2 = cacgmm_steps.step(Zt, a, Bt, impl="chol")
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), atol=1e-5)
    np.testing.assert_allclose(B1.numpy(), B2.numpy(), atol=1e-5)


@pytest.mark.parametrize("impl", cacgmm_steps.IMPLS)
def test_a_dead_component_stays_finite_and_dead(impl):
    """tests/ops/test_splitc_cacgmm.py:92-117 in float32: the posterior-sum floor keeps the M-step finite."""
    _, Z, alpha, B = _setup(seed=2)
    alpha[1] = 0.0
    alpha = alpha / alpha.sum(axis=0)
    Zt = torch.from_numpy(Z.astype(np.complex64))
    a, Bt = torch.from_numpy(alpha.astype(np.float32)), torch.from_numpy(B.astype(np.complex64))
    for _ in range(3):
        a, Bt = cacgmm_steps.step(Zt, a, Bt, impl=impl)
    assert torch.isfinite(a).all() and torch.isfinite(torch.view_as_real(Bt)).all()
    assert bool((a[1] == 0).all())
    gamma = cacgmm_steps.posterior(Zt, a, Bt, impl=impl)
    assert torch.isfinite(gamma).all()


def test_more_sources_than_channels_stays_finite():
    _, Z, alpha, B = _setup(seed=1, M=2, N=3)
    Zt = torch.from_numpy(Z.astype(np.complex64))
    a, Bt = torch.from_numpy(alpha.astype(np.float32)), torch.from_numpy(B.astype(np.complex64))
    for _ in range(5):
        a, Bt = cacgmm_steps.step(Zt, a, Bt)
    assert torch.isfinite(a).all() and torch.isfinite(torch.view_as_real(Bt)).all()
    with pytest.raises(ValueError, match="impl"):
        cacgmm_steps.step(Zt, a, Bt, impl="lu")
    with pytest.raises(ValueError, match="covariance_impl"):
        cacgmm_steps.step(Zt, a, Bt, covariance_impl="pallas")


def test_the_kernel_option_hands_k1_what_it_takes(monkeypatch):
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    shapes = []

    def checking(X, phi):
        K._check_weighted_covariance(X, phi)
        shapes.append(tuple(phi.shape))
        return K.weighted_covariance_plain(X, phi)

    monkeypatch.setattr(K, "weighted_covariance", checking)
    _, Z, alpha, B = _setup(seed=4, M=2, N=3)
    cacgmm_steps.step(torch.from_numpy(Z.astype(np.complex64)), torch.from_numpy(alpha.astype(np.float32)),
                      torch.from_numpy(B.astype(np.complex64)), covariance_impl="kernel")
    assert shapes == [(3, 9, 24)]


# ---- the permutation solvers ------------------------------------------------------------------


def _sequence(N, seed, I=23, T=30, complex_=False):
    """A sequence whose sources are scrambled per bin: each bin a random permutation of shared source envelopes."""
    rng = np.random.default_rng(seed)
    env = rng.random((N, T)) ** 3
    out = np.empty((I, N, T))
    for i in range(I):
        out[i] = env[rng.permutation(N)] * (1 + 0.3 * rng.random((N, T)))
    if complex_:
        out = out * np.exp(2j * np.pi * rng.random((I, N, T)))
    return out


def _index(I, N):
    return np.tile(np.arange(N), (I, 1))


@pytest.mark.parametrize("N", [2, 3, 4])
def test_correlation_solver_chooses_the_jax_permutations(N):
    Y = _sequence(N, seed=50 + N, complex_=True)
    Y_jax, idx_jax = jax_correlation_solver(jnp.asarray(Y), jnp.asarray(_index(*Y.shape[:2])))
    Y_port, idx_port = correlation_based_permutation_solver(torch.from_numpy(Y), torch.from_numpy(_index(*Y.shape[:2])))
    np.testing.assert_array_equal(idx_port.numpy(), np.asarray(idx_jax))
    np.testing.assert_allclose(Y_port.numpy(), np.asarray(Y_jax), atol=0)
    assert len(set(map(tuple, idx_port.numpy()))) > 1  # the walk did permute


@pytest.mark.parametrize("iters", [(1, 1), (2, 2), (0, 1)], ids=["1-1", "2-2", "local-only"])
@pytest.mark.parametrize("N", [2, 3, 4])
def test_score_solver_chooses_the_jax_permutations(N, iters):
    global_iter, local_iter = iters
    seq = _sequence(N, seed=60 + N)
    B = np.random.default_rng(N).standard_normal((seq.shape[0], N, 2, 2))
    kw = dict(global_iter=global_iter, local_iter=local_iter)
    seq_jax, (idx_jax, B_jax) = jax_score_solver(jnp.asarray(seq), jnp.asarray(_index(*seq.shape[:2])), jnp.asarray(B), **kw)
    seq_port, (idx_port, B_port) = score_based_permutation_solver(
        torch.from_numpy(seq), torch.from_numpy(_index(*seq.shape[:2])), torch.from_numpy(B), **kw)
    np.testing.assert_array_equal(idx_port.numpy(), np.asarray(idx_jax))
    np.testing.assert_array_equal(seq_port.numpy(), np.asarray(seq_jax))
    np.testing.assert_array_equal(B_port.numpy(), np.asarray(B_jax))
    assert len(set(map(tuple, idx_port.numpy()))) > 1


@pytest.mark.parametrize("N", [2, 3, 4])
def test_fast_path_alignment_chooses_the_host_permutations(N):
    """``permutation_align`` against ``permutation_align_host``: float64 amplitudes, the per-bin prescale."""
    Y = _sequence(N, seed=70 + N, complex_=True).astype(np.complex64) * 1e20  # far past the float32 square
    idx = _index(*Y.shape[:2])
    Y_host, idx_host = permutation_align_host(Y.copy(), idx.copy())
    Y_port, idx_port = permutation_align(torch.from_numpy(Y), torch.from_numpy(idx))
    np.testing.assert_array_equal(idx_port.numpy(), idx_host)
    np.testing.assert_array_equal(Y_port.numpy(), Y_host)
    assert permutation_align(torch.from_numpy(Y)).shape == Y.shape


def test_solvers_refuse_mismatched_arguments():
    seq = torch.from_numpy(_sequence(2, seed=80))
    with pytest.raises(ValueError, match="1th argument"):
        correlation_based_permutation_solver(seq, torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="3-D"):
        score_based_permutation_solver(seq[0])


# ---- the class ----------------------------------------------------------------------------


def test_class_matches_regression_fixture():
    """tests/regression/test_regression.py:137-142 on the port, complex128, at the reference's 1e-7."""
    X = _input()
    gmm = CACGMM(rng=np.random.default_rng(9), device="cpu")
    Y = gmm(torch.from_numpy(X.copy()), n_iter=N_ITER)
    assert Y.dtype == torch.complex128
    np.testing.assert_allclose(Y.numpy(), _load("cacgmm"), atol=1e-7)
    assert len(gmm.loss) == N_ITER + 1 and gmm.loss[-1] < gmm.loss[0]


@pytest.mark.parametrize("mode", ["posterior_score", "amplitude_score", "amplitude_correlation", False])
def test_class_matches_the_jax_class_in_each_alignment(mode):
    X = _input()
    kw = dict(global_iter=2, local_iter=2) if mode in ("posterior_score", "amplitude_score") else {}
    ref = JaxCACGMM(rng=np.random.default_rng(90), permutation_alignment=mode, impl="complex", **kw)
    Y_ref = np.asarray(ref(X.copy(), n_iter=5))
    gmm = CACGMM(rng=np.random.default_rng(90), permutation_alignment=mode, device="cpu", **kw)
    Y = gmm(torch.from_numpy(X.copy()), n_iter=5)
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-9)
    np.testing.assert_allclose(gmm.posterior.numpy(), np.asarray(ref.posterior), atol=1e-9)
    np.testing.assert_allclose(gmm.mixing.numpy(), np.asarray(ref.mixing), atol=1e-9)
    np.testing.assert_allclose(np.asarray(gmm.loss), np.asarray(ref.loss), rtol=1e-10)


def test_posterior_correlation_raises_as_in_the_jax_class():
    X = _input()
    with pytest.raises(AssertionError):
        JaxCACGMM(rng=np.random.default_rng(91), permutation_alignment="posterior_correlation", impl="complex")(
            X.copy(), n_iter=1)
    with pytest.raises(NotImplementedError, match="amplitude"):
        CACGMM(rng=np.random.default_rng(91), permutation_alignment="posterior_correlation", device="cpu")(
            torch.from_numpy(X.copy()), n_iter=1)


def test_class_attributes_warm_start_and_what_raises():
    X = torch.from_numpy(_input())
    gmm = CACGMM(n_sources=3, rng=np.random.default_rng(92), permutation_alignment=False, device="cpu")
    assert isinstance(gmm, CACGMMBase)
    gmm(X, n_iter=2)
    M, I, T = X.shape
    assert gmm.mixing.shape == (3, I) and gmm.covariance.shape == (3, I, M, M) and gmm.posterior.shape == (3, I, T)
    assert "CACGMM(n_sources=3" in repr(gmm)
    state = {"mixing": gmm.mixing, "covariance": gmm.covariance}
    Y_warm = CACGMM(n_sources=3, permutation_alignment=False, device="cpu")(X, n_iter=2, **state)
    Y_four = CACGMM(n_sources=3, rng=np.random.default_rng(92), permutation_alignment=False, device="cpu")(X, n_iter=4)
    np.testing.assert_allclose(Y_warm.numpy(), Y_four.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="Invalid keywords"):
        CACGMM(permutation_alignment="amplitude_correlation", global_iter=2, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        CACGMM(impl="lu", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CACGMM()


def test_complex64_class_equals_the_fast_path_from_the_same_draws():
    X = host_stft(make_mixture(seed=93, n_channels=2, duration_s=0.3), n_fft=64, hop=32)
    Y_fast = fast_cacgmm(X, n_iter=4, permutation_alignment=False, rng=np.random.default_rng(94), device="cpu")
    gmm = CACGMM(rng=np.random.default_rng(94), permutation_alignment=False, device="cpu")
    Y_cls = gmm(torch.from_numpy(X.astype(np.complex64)), n_iter=4)
    assert torch.equal(Y_cls, Y_fast)
    chol = CACGMM(rng=np.random.default_rng(94), impl="chol", device="cpu")
    assert torch.isfinite(torch.view_as_real(chol(torch.from_numpy(X.astype(np.complex64)), n_iter=4))).all()


# ---- the fast paths ---------------------------------------------------------------------------


def _si_sdr_db(est, ref):
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    return float(10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err))))


def test_fast_cacgmm_matches_the_jax_fast_path():
    X = host_stft(make_mixture(seed=95, n_channels=3, duration_s=0.5), n_fft=64, hop=32)
    for n_sources in (None, 4):
        Y = fast_cacgmm(X, n_iter=5, n_sources=n_sources, rng=np.random.default_rng(96), device="cpu")
        Y_jax = jax_fast_cacgmm(X, n_iter=5, n_sources=n_sources, rng=np.random.default_rng(96))
        assert Y.dtype == torch.complex64 and Y.shape == Y_jax.shape
        assert min(_si_sdr_db(Y[n].numpy().astype(np.complex128), Y_jax[n]) for n in range(Y.shape[0])) >= 40.0


def test_fast_cacgmm_meets_the_fidelity_pin(tmp_path):
    """tests/test_fast_fidelity.py:462-484 on the port: within 0.1 dB of the pinned reference SI-SDR."""
    from ssspy_tpu.transform import stft
    from ssspy_tpu_torch.utils.dataset import download_sample_speech_data
    from tests.test_fast_fidelity import HOP, N_FFT, _quality

    images, _ = download_sample_speech_data(cache_dir=str(tmp_path), n_sources=2, max_duration=2.0, conv=True, seed=0)
    mix = images.sum(axis=0)
    X = np.array(stft(mix, n_fft=N_FFT, hop_length=HOP))
    Y = fast_cacgmm(X, n_iter=50, rng=np.random.default_rng(3), device="cpu")
    with open(os.path.join(TESTS, "fidelity_pins.json")) as f:
        want = json.load(f)["cacgmm"]
    got = _quality(Y.numpy(), images, mix)
    assert abs(got - want) <= 0.1, f"{got:.3f} vs {want:.3f} dB"


@pytest.fixture(scope="module")
def wave():
    return make_mixture(seed=97, n_channels=2, duration_s=1.0)


@pytest.mark.parametrize("algorithm", ["IP1", "ISS1"])
def test_fast_auxiva_wave_matches_its_jax_twin(wave, algorithm):
    y = fast_auxiva_wave(wave, n_iter=10, algorithm=algorithm, device="cpu")
    y_jax = jax_fast_auxiva_wave(wave, n_iter=10, algorithm=algorithm)
    assert y.dtype == torch.float32 and tuple(y.shape) == wave.shape
    assert min(_si_sdr_db(y[n].numpy().astype(np.float64), y_jax[n].astype(np.float64)) for n in range(2)) >= 40.0


@pytest.mark.parametrize("algorithm", ["IP1", "ISS1"])
def test_fast_gauss_ilrma_wave_matches_its_jax_twin(wave, algorithm):
    y = fast_gauss_ilrma_wave(wave, n_basis=2, n_iter=10, algorithm=algorithm, rng=np.random.default_rng(98), device="cpu")
    y_jax = jax_fast_gauss_ilrma_wave(wave, n_basis=2, n_iter=10, algorithm=algorithm, rng=np.random.default_rng(98))
    assert y.dtype == torch.float32 and tuple(y.shape) == wave.shape
    assert min(_si_sdr_db(y[n].numpy().astype(np.float64), y_jax[n].astype(np.float64)) for n in range(2)) >= 40.0


def test_fast_auxiva_wave_is_the_spectrogram_path_between_the_transforms(wave):
    """IPA is compared with the port's own stft -> fast_auxiva -> istft: float32 IPA is not comparable output to output
    against another implementation (one sweep turns a relative 1e-7 into dB, tests/test_torch_ipa.py)."""
    from ssspy_tpu_torch.fast import fast_auxiva
    from ssspy_tpu_torch.transform import istft, stft

    y = fast_auxiva_wave(wave, n_iter=3, algorithm="IPA", n_fft=256, device="cpu")
    x = torch.from_numpy(wave).to(torch.float32)
    Y, _ = fast_auxiva(stft(x, n_fft=256, device="cpu"), n_iter=3, algorithm="IPA", device="cpu")
    assert torch.equal(y, istft(Y, n_fft=256, length=wave.shape[-1], device="cpu"))


def test_waveform_entry_points_raise_for_what_is_not_ported(wave):
    """IP2 and ISS2 are ported since: ``fast_auxiva_wave`` runs them as stft, the spectrogram path and istft;
    ``fast_gauss_ilrma_wave`` takes IP1 and ISS1 only, as its JAX twin (fast.py:1043)."""
    from ssspy_tpu_torch.fast import fast_auxiva
    from ssspy_tpu_torch.transform import istft, stft

    x = torch.from_numpy(wave).to(torch.float32)
    for algorithm in ("IP2", "ISS2"):
        y = fast_auxiva_wave(wave, n_iter=1, algorithm=algorithm, n_fft=256, device="cpu")
        Y, _ = fast_auxiva(stft(x, n_fft=256, device="cpu"), n_iter=1, algorithm=algorithm, device="cpu")
        assert torch.equal(y, istft(Y, n_fft=256, length=wave.shape[-1], device="cpu"))
    with pytest.raises(ValueError, match="no IP2"):
        fast_gauss_ilrma_wave(wave, n_basis=2, n_iter=1, algorithm="IP2", device="cpu")
    with pytest.raises(AssertionError):
        jax_fast_gauss_ilrma_wave(wave, n_basis=2, n_iter=1, algorithm="IP2")
    with pytest.raises(ValueError, match="no IPA|IP1"):
        fast_gauss_ilrma_wave(wave, n_basis=2, n_iter=1, algorithm="IPA", device="cpu")