"""ssspy_tpu_torch CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
module imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; there, skip the repository's conftest (which
configures JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from ssspy_tpu_torch.ops import kernels as K

MAIN_PATH = (8, 257, 626, 8)  # (M, I, T, N): 8 channels, STFT 512/256 of 10 s at 16 kHz


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see README, 'PyTorch + CUDA port')")
    return torch.device("cuda")


def _complex(rng, shape, device):
    return torch.complex(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
    ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
def test_weighted_covariance_kernel_matches_plain(cuda_device, per_bin):
    rng = np.random.default_rng(8)
    M, I, T, N = MAIN_PATH
    X = _complex(rng, (M, I, T), cuda_device)
    phi_shape = (N, I, T) if per_bin else (N, T)
    phi = torch.from_numpy(rng.random(phi_shape, dtype=np.float32) + 0.1).to(cuda_device)
    before = K.weighted_covariance.launches
    U = K.weighted_covariance(X, phi)
    ref = K.weighted_covariance_plain(X, phi)
    torch.cuda.synchronize()
    assert K.weighted_covariance.launches == before + 1
    # both sides sum T f32 terms, in different orders
    assert (U - ref).abs().max() / ref.abs().max() <= 1e-5
    assert torch.equal(U, U.transpose(-2, -1).conj())


@pytest.mark.cuda
def test_ip1_sweep_kernel_matches_its_exact_twin(cuda_device):
    rng = np.random.default_rng(9)
    M, I, T, N = MAIN_PATH
    X = _complex(rng, (M, I, T), cuda_device)
    U = K.weighted_covariance_plain(X, torch.ones((N, T), device=cuda_device))
    U[[0, 128]] = 0  # silent bins
    W = torch.eye(M, dtype=U.dtype, device=cuda_device) + 0.1 * _complex(rng, (I, N, M), cuda_device)
    before = K.ip1_sweep.launches
    got = K.ip1_sweep(W, U, eps=1e-10)
    ref = K.ip1_sweep_plain(W, U, eps=1e-10, solve_impl="gjnp")
    torch.cuda.synchronize()
    assert K.ip1_sweep.launches == before + 1
    assert torch.equal(got[0], W[0]) and torch.equal(got[128], W[128])
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert (got - ref).abs().max() / ref.abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
@pytest.mark.parametrize("shape", [(8, 257, 626), (8, 16, 4000)], ids=["main_path", "streamed"])
def test_iss1_sweep_kernel_matches_plain(cuda_device, shape, per_bin):
    rng = np.random.default_rng(10)
    N, I, T = shape
    Y = _complex(rng, (N, I, T), cuda_device)
    Y[:, [0, 5]] = 0  # silent bins
    phi_shape = (N, I, T) if per_bin else (N, T)
    phi = torch.from_numpy(rng.random(phi_shape, dtype=np.float32) + 0.1).to(cuda_device)
    assert K.iss1_sweep_resident(N, T, per_bin) == (T == 626)
    before = K.iss1_sweep.launches
    got = K.iss1_sweep(Y, phi, eps=1e-6)
    ref = K.iss1_sweep_plain(Y, phi, eps=1e-6)
    torch.cuda.synchronize()
    assert K.iss1_sweep.launches == before + 1
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert torch.equal(got[:, [0, 5]], Y[:, [0, 5]])
    # both sides sum T f32 terms in different orders over N sequential updates
    assert (got - ref).abs().max() / ref.abs().max() <= 1e-4


@pytest.mark.cuda
def test_kernels_reject_a_wrong_dtype_on_the_card(cuda_device):
    X = torch.zeros((3, 5, 7), dtype=torch.complex128, device=cuda_device)
    with pytest.raises(ValueError, match="complex64"):
        K.weighted_covariance(X, torch.ones((3, 7), device=cuda_device))
    with pytest.raises(ValueError, match="complex64"):
        K.iss1_sweep(X, torch.ones((3, 7), device=cuda_device))


def _symmetric(rng, B, n, device):
    A = rng.standard_normal((B, n, n), dtype=np.float32)
    return torch.from_numpy(A + A.swapaxes(-1, -2)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(257, 16, 16), (514, 16, 16), (40, 3, 3), (40, 7, 7), (20, 32, 32)],
    ids=["pds", "admm", "n3", "n7", "n32"],
)
def test_jacobi_eigh_kernel_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(11)
    A = _symmetric(rng, *shape[:2], cuda_device)
    before = K.jacobi_eigh.launches
    lamb, V = K.jacobi_eigh(A)
    lamb_ref, _ = K.jacobi_eigh_plain(A)
    torch.cuda.synchronize()
    assert K.jacobi_eigh.launches == before + 1
    scale = lamb_ref.abs().max()
    # the same rounds; compare eigenvalues, the reconstruction and V^T V, never raw columns
    assert (lamb - lamb_ref).abs().max() <= 1e-5 * scale
    assert (torch.diff(lamb, dim=-1) >= 0).all()
    recon = (V * lamb[:, None, :]) @ V.transpose(-1, -2)
    assert (recon - A).abs().max() <= 1e-5 * scale
    eye = torch.eye(shape[-1], device=cuda_device)
    assert (V.transpose(-1, -2) @ V - eye).abs().max() <= 1e-5


@pytest.mark.cuda
def test_jacobi_eigh_kernel_zero_batch_gives_the_identity(cuda_device):
    lamb, V = K.jacobi_eigh(torch.zeros((9, 16, 16), device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(lamb, torch.zeros_like(lamb))
    assert torch.equal(V, torch.eye(16, device=cuda_device).expand(9, 16, 16))


@pytest.mark.cuda
def test_jacobi_eigh_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="float32"):
        K.jacobi_eigh(torch.zeros((4, 8, 8), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError, match="2 <= n <= 32"):
        K.jacobi_eigh(torch.zeros((4, 33, 33), device=cuda_device))


@pytest.mark.cuda
def test_normalize_by_spectral_norm_runs_on_the_card(cuda_device):
    """A numpy spectrogram is scaled on the card, through one K7 launch, as the separator's own input is."""
    from ssspy_tpu_torch.bss import PDSIVA

    rng = np.random.default_rng(12)
    X = (rng.standard_normal((4, 33, 50)) + 1j * rng.standard_normal((4, 33, 50))).astype(np.complex64)
    before = K.jacobi_eigh.launches
    out = PDSIVA().normalize_by_spectral_norm(X)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and out.dtype == torch.complex64
    assert K.jacobi_eigh.launches == before + 1
    norm = torch.linalg.matrix_norm(out.permute(1, 0, 2), ord=2).max()
    assert abs(float(norm) - 1) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(257, 8, 8), (40, 3, 5), (9, 16, 16), (33, 2, 2)], ids=["main_path", "s3_n5", "s16_n16", "s2_n2"])
def test_ipa_congruence_kernel_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(13)
    I, S, N = shape
    T, U, G = _complex(rng, (I, N, N), cuda_device), _complex(rng, (I, S, N, N), cuda_device), _complex(rng, (I, N, N), cuda_device)
    U[[0, I // 2]] = 0  # silent bins
    before = K.ipa_congruence.launches
    U_new, G_new = K.ipa_congruence(T, U, G)
    U_ref, G_ref = K.ipa_congruence_plain(T, U, G)
    torch.cuda.synchronize()
    assert K.ipa_congruence.launches == before + 1
    assert torch.isfinite(torch.view_as_real(U_new)).all() and torch.isfinite(torch.view_as_real(G_new)).all()
    assert not U_new[[0, I // 2]].any()
    # N-term f32 complex sums, in another order on each side
    assert (U_new - U_ref).abs().max() <= 1e-5 * U_ref.abs().max()
    assert (G_new - G_ref).abs().max() <= 1e-5 * G_ref.abs().max()


@pytest.mark.cuda
def test_ipa_congruence_kernel_rejects_what_it_does_not_take(cuda_device):
    T = torch.zeros((4, 3, 3), dtype=torch.complex64, device=cuda_device)
    U = torch.zeros((4, 2, 3, 3), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="complex64"):
        K.ipa_congruence(T.to(torch.complex128), U.to(torch.complex128), T.to(torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        K.ipa_congruence(T.mT, U, T)
    with pytest.raises(ValueError, match="all CUDA tensors"):
        K.ipa_congruence(T, U.cpu(), T)


@pytest.mark.cuda
def test_fast_auxiva_ipa_runs_through_the_kernels(cuda_device):
    """Five iterations of ``fast_auxiva(algorithm="IPA")`` on the card: K1 once, K7 and K6 once per source, per iteration."""
    from ssspy_tpu_torch.fast import fast_auxiva
    from ssspy_tpu_torch.ops.iva_steps import iva_laplace_loss

    rng = np.random.default_rng(14)
    X = (rng.standard_normal((4, 65, 120)) + 1j * rng.standard_normal((4, 65, 120))).astype(np.complex64)
    X[1] += 0.5 * X[0]
    before = {name: getattr(K, name).launches for name in ("weighted_covariance", "jacobi_eigh", "ipa_congruence")}
    Y, W = fast_auxiva(X, n_iter=5, algorithm="IPA", scale_restoration=False)
    torch.cuda.synchronize()
    after = {name: getattr(K, name).launches - count for name, count in before.items()}
    assert after == {"weighted_covariance": 5, "jacobi_eigh": 20, "ipa_congruence": 20}
    assert W is None and Y.device.type == "cuda" and Y.dtype == torch.complex64
    assert torch.isfinite(torch.view_as_real(Y)).all()
    Xt = torch.from_numpy(X).to(cuda_device)
    assert float(iva_laplace_loss(Xt, Y=Y)) < float(iva_laplace_loss(Xt, Y=Xt))
