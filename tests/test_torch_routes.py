"""The routers of K1, K1b, K2 and K6: complex64 within a kernel's sizes to the kernel, anything else to its plain version.

On the CPU the kernel wrappers take their plain versions before any check,
so these tests send CPU tensors down the card's branch instead
(``kernels._on_cpu`` patched to False, the device check a no-op): there a
wrapper runs its kernel's own checks and, where they pass, reaches the
launch, which raises :class:`Launched` here. A router must send complex128,
and each size just past a kernel's limit, to the plain version without
touching the wrapper, and the result must be the plain version's; the
wrappers themselves still refuse both. The paths (classes, ``fast_*``,
``separate``) are then driven with every wrapper replaced by its checks, a
record and its plain version. All on the CPU; the card tests
(tests/test_torch_cuda.py) drive the same on the card.
"""

import numpy as np
import pytest
import torch

from ssspy_tpu_torch import separate as torch_separate
from ssspy_tpu_torch.bss import AuxLaplaceIVA, GaussILRMA
from ssspy_tpu_torch.fast import fast_auxiva, fast_gauss_ilrma
from ssspy_tpu_torch.ops import ipa_steps, iva_steps
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.utils import host_stft, make_mixture

torch.set_num_threads(1)


class Launched(Exception):
    """Raised where a wrapper would launch its kernel."""


@pytest.fixture
def card_branch(monkeypatch):
    """CPU tensors take each wrapper's card branch: its checks, then a launch that raises :class:`Launched`."""
    monkeypatch.setattr(K, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)

    def launch(name):
        raise Launched(name)

    monkeypatch.setattr(K, "_entry", launch)


def _complex(rng, shape, dtype):
    return torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype))


def _real(rng, shape, dtype):
    return torch.from_numpy((rng.random(shape) + 0.1).astype(dtype))


def _covariance_case(dtype, M, N=None):
    N = M if N is None else N
    rng = np.random.default_rng(M + N)
    real = np.float32 if dtype == np.complex64 else np.float64
    return _complex(rng, (M, 3, 5), dtype), _real(rng, (N, 3, 5), real)


def _ip1_case(dtype, M):
    rng = np.random.default_rng(M)
    X = _complex(rng, (M, 3, 4 * M), dtype)
    U = K.weighted_covariance_plain(X, torch.ones((M, 4 * M), dtype=X.real.dtype))
    return torch.eye(M, dtype=X.dtype) + 0.1 * _complex(rng, (3, M, M), dtype), U


def _iss1_case(dtype, N):
    rng = np.random.default_rng(N)
    real = np.float32 if dtype == np.complex64 else np.float64
    return _complex(rng, (N, 3, 6), dtype), _real(rng, (N, 3, 6), real)


def _congruence_case(dtype, N):
    rng = np.random.default_rng(N)
    T = torch.eye(N, dtype=torch.complex64 if dtype == np.complex64 else torch.complex128) + 0.1 * _complex(rng, (3, N, N), dtype)
    return T, _complex(rng, (3, N, N, N), dtype), _complex(rng, (3, N, N), dtype)


# (router, wrapper, plain version, case maker, the kernel's largest size, the size just past it, its refusal)
ROUTES = {
    "covariance": (iva_steps.covariance, "weighted_covariance", K.weighted_covariance_plain, _covariance_case,
                   (25, 25), (26, 26), "exceeds what one block"),
    "ip1_update": (iva_steps.ip1_update, "ip1_sweep", K.ip1_sweep_plain, _ip1_case, (17,), (18,), "exceeds"),
    "iss1_update": (iva_steps.iss1_update, "iss1_sweep", K.iss1_sweep_plain, _iss1_case, (16,), (17,), "exceeds"),
    "congruence_round": (ipa_steps.congruence_round, "ipa_congruence", K.ipa_congruence_plain, _congruence_case,
                         (16,), (17,), "N, S <= 16"),
}


def test_the_limits_are_the_kernels_own():
    """The sizes the routers test against are where each predicate turns."""
    assert K.weighted_covariance_takes(25, 25) and not K.weighted_covariance_takes(26, 26)
    assert 25 * 25 * 26 // 2 <= 8192 < 26 * 26 * 27 // 2
    assert K.ip1_sweep_takes(17) and not K.ip1_sweep_takes(18)
    assert K.iss1_sweep_takes(16) and not K.iss1_sweep_takes(17)
    assert K.ipa_congruence_takes(16, 16) and not K.ipa_congruence_takes(17, 17)
    assert not K.ipa_congruence_takes(16, 17) and not K.ipa_congruence_takes(17, 16)


@pytest.mark.parametrize("router", list(ROUTES))
def test_complex64_within_the_limit_goes_to_the_kernel(router, card_branch):
    route, wrapper, _, case, inside, _, _ = ROUTES[router]
    with pytest.raises(Launched, match=wrapper):
        route(*case(np.complex64, *inside))
    with pytest.raises(Launched, match=wrapper):
        route(*case(np.complex64, 2))


@pytest.mark.parametrize("where", ["complex128", "past the limit", "complex128 past the limit"])
@pytest.mark.parametrize("router", list(ROUTES))
def test_complex128_and_sizes_past_the_limit_go_to_the_plain_version(router, where, card_branch):
    """The router answers with the plain version's result and never reaches the wrapper, which would refuse."""
    route, wrapper, plain, case, inside, past, refusal = ROUTES[router]
    dtype = np.complex64 if where == "past the limit" else np.complex128
    args = case(dtype, *(inside if where == "complex128" else past))
    got = route(*args)
    ref = plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the wrapper itself still refuses it on the card
    with pytest.raises(ValueError, match="complex64" if dtype == np.complex128 else refusal):
        getattr(K, wrapper)(*args)


def test_a_float64_weight_with_complex64_goes_to_the_plain_version(card_branch):
    X, phi = _covariance_case(np.complex64, 3, 3)
    phi = phi.double()
    assert torch.equal(iva_steps.covariance(X, phi), K.weighted_covariance_plain(X, phi))
    Y, phi = _iss1_case(np.complex64, 3)
    assert torch.equal(iva_steps.iss1_update(Y, phi.double()), K.iss1_sweep_plain(Y, phi.double()))


def test_the_plain_route_of_ip1_is_the_lu_solve(card_branch):
    W, U = _ip1_case(np.complex128, 3)
    assert torch.equal(iva_steps.ip1_update(W, U, eps=1e-8), K.ip1_sweep_plain(W, U, eps=1e-8, solve_impl="lu"))


# ---- the paths -----------------------------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Each of the four wrappers runs its kernel's checks (all but the device), records the call, answers plain."""
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    calls = []
    for name, check, plain in (
        ("weighted_covariance", K._check_weighted_covariance, K.weighted_covariance_plain),
        ("ip1_sweep", K._check_ip1_sweep, K.ip1_sweep_plain),
        ("iss1_sweep", K._check_iss1_sweep, K.iss1_sweep_plain),
        ("ipa_congruence", K._check_ipa_congruence, K.ipa_congruence_plain),
    ):

        def wrapper(*args, _name=name, _check=check, _plain=plain, **kwargs):
            _check(*args)
            calls.append(_name)
            return _plain(*args, **kwargs)

        monkeypatch.setattr(K, name, wrapper)
    return calls


def _spectrogram(n_channels, n_fft=64, n_frames=24, seed=0):
    n_samples = (n_frames - 1) * (n_fft // 2)
    return host_stft(make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000), n_fft=n_fft, hop=n_fft // 2)


@pytest.mark.parametrize(
    "label, make",
    [
        ("AuxIVA-IP1", lambda: AuxLaplaceIVA(spatial_algorithm="IP", device="cpu")),
        ("AuxIVA-ISS1", lambda: AuxLaplaceIVA(spatial_algorithm="ISS1", device="cpu")),
        ("AuxIVA-IPA", lambda: AuxLaplaceIVA(spatial_algorithm="IPA", device="cpu")),
        ("GaussILRMA-IP1", lambda: GaussILRMA(n_basis=2, spatial_algorithm="IP", device="cpu", rng=np.random.default_rng(1))),
        ("GaussILRMA-ISS1", lambda: GaussILRMA(n_basis=2, spatial_algorithm="ISS1", device="cpu", rng=np.random.default_rng(1))),
        ("GaussILRMA-IPA", lambda: GaussILRMA(n_basis=2, spatial_algorithm="IPA", device="cpu", rng=np.random.default_rng(1))),
    ],
)
def test_complex128_classes_reach_no_kernel(label, make, recorded):
    """A complex128 class runs its IP1, ISS1 or IPA sweep on the plain versions and ends where the plain run ends."""
    X = torch.from_numpy(_spectrogram(3))
    assert X.dtype == torch.complex128
    method = make()
    Y = method(X, n_iter=3)
    assert recorded == []
    assert torch.isfinite(torch.view_as_real(Y)).all() and len(method.loss) == 4
    assert method.loss[-1] < method.loss[0]


def test_complex64_classes_reach_the_kernels(recorded):
    X = torch.from_numpy(_spectrogram(3).astype(np.complex64))
    AuxLaplaceIVA(spatial_algorithm="IP", device="cpu")(X, n_iter=2)
    AuxLaplaceIVA(spatial_algorithm="ISS1", device="cpu")(X, n_iter=2)
    AuxLaplaceIVA(spatial_algorithm="IPA", device="cpu")(X, n_iter=1)
    assert set(recorded) == {"weighted_covariance", "ip1_sweep", "iss1_sweep", "ipa_congruence"}


def test_separate_on_a_float64_waveform_reaches_no_kernel(recorded):
    """The docstring's example: a float64 numpy mixture through GaussILRMA-ISS1 carries complex128 end to end."""
    x = make_mixture(seed=3, n_channels=2, duration_s=0.1)
    y = torch_separate(x, GaussILRMA(n_basis=2, spatial_algorithm="ISS1", device="cpu", rng=np.random.default_rng(2)),
                       n_iter=3, n_fft=128, device="cpu")
    assert recorded == [] and y.dtype == torch.float64 and tuple(y.shape) == x.shape
    assert torch.isfinite(y).all()


@pytest.mark.parametrize(
    "algorithm, n_channels, kernels, plain",
    [
        ("IP1", 18, {"weighted_covariance"}, "ip1_sweep"),  # K1 takes 18 channels, K1b stops at 17
        ("ISS1", 17, set(), "iss1_sweep"),
        ("IPA", 17, {"weighted_covariance"}, "ipa_congruence"),
    ],
)
def test_fast_auxiva_past_a_size_limit_takes_the_plain_route(algorithm, n_channels, kernels, plain, recorded):
    X = _spectrogram(n_channels, n_frames=3 * n_channels, seed=4)
    Y, _ = fast_auxiva(X, n_iter=1, algorithm=algorithm, device="cpu")
    assert set(recorded) == kernels and plain not in recorded
    assert torch.isfinite(torch.view_as_real(Y)).all()


def test_fast_gauss_ilrma_past_the_iss1_limit_takes_the_plain_route(recorded):
    X = _spectrogram(17, n_frames=40, seed=5)
    Y, _, _ = fast_gauss_ilrma(X, n_basis=2, n_iter=1, algorithm="ISS1", rng=np.random.default_rng(6), device="cpu")
    assert recorded == [] and torch.isfinite(torch.view_as_real(Y)).all()
