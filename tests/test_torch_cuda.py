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
