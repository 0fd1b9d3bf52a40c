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
@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
@pytest.mark.parametrize(
    "shape",
    [(8, 257, 1, 8), (8, 257, 129, 8), (8, 257, 1000, 8), (2, 9, 129, 2), (3, 9, 129, 5), (47, 3, 129, 1),
     (1, 5, 129, 93), (42, 3, 129, 9)],
    ids=["T1", "T129", "T1000", "M2_N2", "M3_N5", "largest_M", "largest_N", "most_items"],
)
def test_weighted_covariance_kernel_at_the_edges_of_its_geometry(cuda_device, shape, per_bin):
    """Chunks that do not divide T, the generic instance, the size contract's largest (M, N); two launches bit-equal."""
    rng = np.random.default_rng(9)
    M, I, T, N = shape
    assert K.weighted_covariance_takes(M, N)
    X = _complex(rng, (M, I, T), cuda_device)
    phi = torch.from_numpy(rng.random((N, I, T) if per_bin else (N, T), dtype=np.float32) + 0.1).to(cuda_device)
    U = K.weighted_covariance(X, phi)
    U_2 = K.weighted_covariance(X, phi)
    ref = K.weighted_covariance_plain(X, phi)
    torch.cuda.synchronize()
    assert (U - ref).abs().max() / ref.abs().max() <= 1e-5
    assert torch.equal(U, U.transpose(-2, -1).conj())
    assert torch.equal(U, U_2)


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


# (N, I, T): the main path, the streamed long case, and N in {1, 2, 3, 8, 9, 16} x frame counts around the
# register variant's limit at N = 8 (1,280), the resident one's (2,388 per-bin, 3,582 (N, T) weights) and past both
ISS1_FRAMES = (1, 31, 255, 256, 257, 626, 1280, 1281, 2388, 2389, 3582, 3583, 4000)
ISS1_SHAPES = [(8, 257, 626), (8, 16, 4000)] + [(N, 3, T) for N in (1, 2, 3, 8, 9, 16) for T in ISS1_FRAMES]


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
@pytest.mark.parametrize("shape", ISS1_SHAPES, ids=["main_path", "streamed"] + [f"{N}-{I}-{T}" for N, I, T in ISS1_SHAPES[2:]])
def test_iss1_sweep_kernel_matches_plain(cuda_device, shape, per_bin):
    """Every variant within 1e-4 of plain, silent bins exactly zero, two launches bit-equal; at T = 1 (where the
    update cancels to rounding noise that later sources scale up) the register variant is plain bit for bit."""
    rng = np.random.default_rng(10)
    N, I, T = shape
    silent = [0, 5] if I > 5 else [1]
    Y = _complex(rng, (N, I, T), cuda_device)
    Y[:, silent] = 0  # silent bins
    phi_shape = (N, I, T) if per_bin else (N, T)
    phi = torch.from_numpy(rng.random(phi_shape, dtype=np.float32) + 0.1).to(cuda_device)
    variant = K.iss1_sweep_variant(N, T, per_bin)
    assert variant == {(8, 257, 626): "registers", (8, 16, 4000): "streamed"}.get(shape, variant)
    assert variant in ("registers", "resident", "streamed") and (T > 256 or variant == "registers")
    assert variant != "streamed" or not K.iss1_sweep_resident(N, T, per_bin)
    before = K.iss1_sweep.launches
    got, got_2 = K.iss1_sweep(Y, phi, eps=1e-6), K.iss1_sweep(Y, phi, eps=1e-6)
    ref = K.iss1_sweep_plain(Y, phi, eps=1e-6)
    torch.cuda.synchronize()
    assert K.iss1_sweep.launches == before + 2
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert torch.equal(got[:, silent], Y[:, silent])
    assert torch.equal(got, got_2)
    # both sides sum T f32 terms in different orders over N sequential updates
    assert (got - ref).abs().max() / ref.abs().max() <= 1e-4
    if T == 1:
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("I", [1, 33, 257])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 16, 17])
def test_ip1_sweep_kernel_variants_match_the_exact_twin(cuda_device, M, I):
    """The warp variant (M <= 8, odd M leaving lanes of a group idle, blocks part-full) and the block variant above it:
    within 1e-4 of the gjnp twin, silent bins frozen, two launches bit-equal."""
    rng = np.random.default_rng(12)
    X = _complex(rng, (M, I, 64), cuda_device)
    U = K.weighted_covariance_plain(X, torch.ones((M, 64), device=cuda_device))
    silent = [] if I == 1 else [0, I // 2]
    U[silent] = 0
    W = torch.eye(M, dtype=U.dtype, device=cuda_device) + 0.1 * _complex(rng, (I, M, M), cuda_device)
    before = K.ip1_sweep.launches
    got, got_2 = K.ip1_sweep(W, U), K.ip1_sweep(W, U)
    ref = K.ip1_sweep_plain(W, U, solve_impl="gjnp")
    torch.cuda.synchronize()
    assert K.ip1_sweep.launches == before + 2
    assert K.ip1_sweep_variant(M) == ("warp" if M <= 8 else "block")
    assert all(torch.equal(got[i], W[i]) for i in silent)
    assert torch.equal(got, got_2)
    assert torch.isfinite(torch.view_as_real(got)).all()
    live = [i for i in range(I) if i not in silent]
    assert (got[live] - ref[live]).abs().max() / ref[live].abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 5, 8])
def test_ip1_sweep_kernel_takes_a_pivot_near_the_largest_float(cuda_device, M):
    """Pivots above 2^126, whose reciprocals are subnormal: the warp variant updates the rows as its exact twin does
    (a reciprocal flushed to zero would make them NaN, and the sweep would freeze them)."""
    rng = np.random.default_rng(14)
    I = 33
    H = rng.standard_normal((I, M, M, M)) + 1j * rng.standard_normal((I, M, M, M))
    U = 1.5 * 2.0**127 * (np.eye(M) + 0.005 * (H + np.conj(np.swapaxes(H, -1, -2))))
    W = 0.5 * (np.eye(M) + 0.05 * (rng.standard_normal((I, M, M)) + 1j * rng.standard_normal((I, M, M))))
    U = torch.from_numpy(U.astype(np.complex64)).to(cuda_device)
    W = torch.from_numpy(W.astype(np.complex64)).to(cuda_device)
    assert K.ip1_sweep_variant(M) == "warp"
    got, got_2 = K.ip1_sweep(W, U, eps=1e-30), K.ip1_sweep(W, U, eps=1e-30)
    ref = K.ip1_sweep_plain(W, U, eps=1e-30, solve_impl="gjnp")
    torch.cuda.synchronize()
    assert torch.isfinite(torch.view_as_real(ref)).all() and not torch.equal(ref[:, 0], W[:, 0])
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert not torch.equal(got[:, 0], W[:, 0])
    assert torch.equal(got, got_2)
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
@pytest.mark.parametrize("B", [1, 5, 257, 4099])
@pytest.mark.parametrize("n", [2, 3, 7, 8, 10, 14, 16, 17, 31, 32])
def test_jacobi_eigh_kernel_is_the_plain_version_bit_for_bit(cuda_device, n, B):
    """Every templated n (8, 10, 14, 16, 32) and the generic instance, at batches that leave the last block ragged."""
    A = _symmetric(np.random.default_rng(100 * n + B), B, n, cuda_device)
    lamb, V = K.jacobi_eigh(A)
    lamb_2, V_2 = K.jacobi_eigh(A)
    lamb_ref, V_ref = K.jacobi_eigh_plain(A)
    torch.cuda.synchronize()
    assert torch.equal(lamb, lamb_ref) and torch.equal(V, V_ref)
    assert torch.equal(lamb, lamb_2) and torch.equal(V, V_2)


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


IPA_SOURCES = (1, 2, 3, 7, 8, 9, 16)  # powers of two and not, the limit


@pytest.mark.cuda
@pytest.mark.parametrize("S", IPA_SOURCES)
@pytest.mark.parametrize("N", range(1, 17))
def test_ipa_congruence_kernel_at_every_size(cuda_device, N, S):
    """The kernel's instance at every N: within 1e-5 of plain, zero bins exactly zero and two launches bit-equal,
    at I = 1, 5 and 257 bins (a part-full last block, and groups of a warp past the last item)."""
    rng = np.random.default_rng(20 + N * 17 + S)
    for I in (1, 5, 257):
        T, U, G = _complex(rng, (I, N, N), cuda_device), _complex(rng, (I, S, N, N), cuda_device), _complex(rng, (I, N, N), cuda_device)
        U[[0, I // 2]] = 0
        U_new, G_new = K.ipa_congruence(T, U, G)
        U_2, G_2 = K.ipa_congruence(T, U, G)
        U_ref, G_ref = K.ipa_congruence_plain(T, U, G)
        torch.cuda.synchronize()
        assert torch.equal(U_new, U_2) and torch.equal(G_new, G_2)
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


def _psd(rng, shape, device):
    """Hermitian positive definite complex64 ``shape = (..., m, m)`` on ``device``."""
    A = _complex(rng, shape, device)
    return (A @ A.mH / shape[-1] + 0.1 * torch.eye(shape[-1], device=device)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(257, 626, 8), (5, 37, 4), (7, 50, 16), (3, 41, 3)], ids=["main_path", "m4", "m16", "m3"])
def test_inv_sandwich_kernel_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(15)
    R, C = _psd(rng, shape + shape[-1:], cuda_device), _psd(rng, shape + shape[-1:], cuda_device)
    before = K.inv_sandwich.launches
    R_inv, S = K.inv_sandwich(R, C)
    R_inv_ref, S_ref = K.inv_sandwich_plain(R, C)
    torch.cuda.synchronize()
    assert K.inv_sandwich.launches == before + 1
    # the same elimination on both sides, sums in another order
    assert (R_inv - R_inv_ref).abs().max() <= 1e-5 * R_inv_ref.abs().max()
    assert (S - S_ref).abs().max() <= 1e-5 * S_ref.abs().max()


@pytest.mark.cuda
def test_inv_sandwich_kernel_floors_the_pivot_of_a_zero_system(cuda_device):
    rng = np.random.default_rng(16)
    R, C = _psd(rng, (20, 8, 8), cuda_device), _psd(rng, (20, 8, 8), cuda_device)
    R[[3, 11]] = 0
    C[[3, 11]] = 0
    R_inv, S = K.inv_sandwich(R, C)
    R_inv_ref, S_ref = K.inv_sandwich_plain(R, C)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.view_as_real(R_inv)).all() and torch.isfinite(torch.view_as_real(S)).all()
    # every pivot floors to 1e-20, divided as PyTorch divides
    assert torch.equal(R_inv[[3, 11]], R_inv_ref[[3, 11]])
    assert torch.equal(R_inv[3], torch.eye(8, dtype=R.dtype, device=cuda_device) / torch.tensor(1e-20, device=cuda_device))
    assert not S[[3, 11]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 16])
def test_inv_sandwich_kernel_equals_plain_at_every_variant_and_size(cuda_device, m):
    """Bit for bit with plain (the same elimination, the products in torch.matmul's order), two launches bit-equal,
    a zero system floored to 1e20 I with a zero sandwich, and a zero C's sandwich zero, at B = 1 .. 160,882."""
    rng = np.random.default_rng(40 + m)
    for B in (1, 31, 33, 4099, 160882):
        R, C = _psd(rng, (B, m, m), cuda_device), _psd(rng, (B, m, m), cuda_device)
        if B > 2:
            R[1], C[1], C[2] = 0, 0, 0
        R_inv, S = K.inv_sandwich(R, C)
        R_inv_2, S_2 = K.inv_sandwich(R, C)
        R_inv_ref, S_ref = K.inv_sandwich_plain(R, C)
        torch.cuda.synchronize()
        assert torch.equal(R_inv, R_inv_ref) and torch.equal(S, S_ref)
        assert torch.equal(R_inv, R_inv_2) and torch.equal(S, S_2)
        if B > 2:
            floor = torch.eye(m, dtype=R.dtype, device=cuda_device) / torch.tensor(1e-20, device=cuda_device)
            assert torch.equal(R_inv[1], floor) and not S[[1, 2]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 257, 626, 8), (3, 5, 37, 4), (2, 4, 130, 8), (3, 7, 50, 16)],
                         ids=["main_path", "m4", "m8_short", "m16"])
def test_model_traces_kernel_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(17)
    N, I, T, m = shape
    H, XX = _psd(rng, (N, I, m, m), cuda_device), _psd(rng, (I, T, m, m), cuda_device)
    Lamb = torch.from_numpy(rng.random((N, I, T), dtype=np.float32) + 0.05).to(cuda_device)
    before = K.model_traces.launches
    out = K.model_traces(Lamb, H, XX, 1e-6)
    ref = K.model_traces_plain(Lamb, H, XX, 1e-6)
    torch.cuda.synchronize()
    assert K.model_traces.launches == before + 1
    # relative to max, as tests/ops/test_pallas_kernels.py:101-105 holds the TPU kernel
    for got, want in zip(out, ref):
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(8, 257, 1, 8), (3, 6, 20, 8), (3, 6, 97, 8), (4, 1, 300, 8), (3, 4, 41, 1), (3, 4, 70, 4), (3, 4, 70, 5),
     (2, 3, 50, 16), (21, 3, 40, 16)],
    ids=["T1", "T_below_a_tile", "T_ragged", "I1", "m1", "m4", "m5", "m16", "m16_largest_N"],
)
def test_model_traces_kernel_at_the_edges_of_its_geometry(cuda_device, shape):
    """Within 2e-4 of plain, two launches equal to the bit, and each output mode equal to the full form."""
    N, I, T, m = shape
    assert K.model_traces_takes(N, m)
    rng = np.random.default_rng(sum(shape))
    H, XX = _psd(rng, (N, I, m, m), cuda_device), _psd(rng, (I, T, m, m), cuda_device)
    Lamb = torch.from_numpy(rng.random((N, I, T), dtype=np.float32) + 0.05).to(cuda_device)
    out = K.model_traces(Lamb, H, XX, 1e-6)
    out_2 = K.model_traces(Lamb, H, XX, 1e-6)
    ref = K.model_traces_plain(Lamb, H, XX, 1e-6)
    traces = K.model_traces(Lamb, H, XX, 1e-6, outputs="traces")
    sums = K.model_traces(Lamb, H, XX, 1e-6, outputs="sums")
    torch.cuda.synchronize()
    for got, again, want in zip(out, out_2, ref):
        assert got.shape == want.shape and torch.equal(got, again)
        assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    assert all(torch.equal(a, b) for a, b in zip(traces + sums, out))


@pytest.mark.cuda
def test_model_traces_kernel_stays_finite_on_zero_bins_and_a_tiny_lamb(cuda_device):
    rng = np.random.default_rng(18)
    H, XX = _psd(rng, (8, 12, 8, 8), cuda_device), _psd(rng, (12, 70, 8, 8), cuda_device)
    Lamb = torch.from_numpy(rng.random((8, 12, 70), dtype=np.float32) + 0.05).to(cuda_device)
    XX[[2, 9]] = 0
    Lamb[:, 5] = 1e-30
    out = K.model_traces(Lamb, H, XX, 1e-10)
    ref = K.model_traces_plain(Lamb, H, XX, 1e-10)
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        got = torch.view_as_real(got) if got.is_complex() else got
        want = torch.view_as_real(want) if want.is_complex() else want
        assert torch.isfinite(got).all()
        keep = [i for i in range(12) if i != 5]
        assert (got[:, keep] - want[:, keep]).abs().max() <= 2e-4 * want[:, keep].abs().max()
        assert (got[:, 5] - want[:, 5]).abs().max() <= 2e-4 * want[:, 5].abs().max()
    assert not out[0][:, [2, 9]].any() and not out[3][:, [2, 9]].any()


@pytest.mark.cuda
def test_mnmf_kernels_reject_what_they_do_not_take(cuda_device):
    R = torch.zeros((4, 3, 3), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="complex64"):
        K.inv_sandwich(R.to(torch.complex128), R.to(torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        K.inv_sandwich(R.mT, R)
    with pytest.raises(ValueError, match="all CUDA tensors"):
        K.inv_sandwich(R, R.cpu())
    Lamb = torch.ones((2, 4, 5), device=cuda_device)
    H = torch.zeros((2, 4, 3, 3), dtype=torch.complex64, device=cuda_device)
    XX = torch.zeros((4, 5, 3, 3), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="float32 Lamb"):
        K.model_traces(Lamb.double(), H, XX)
    with pytest.raises(ValueError, match="contiguous"):
        K.model_traces(Lamb, H, XX.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="all CUDA tensors"):
        K.model_traces(Lamb, H.cpu(), XX)


@pytest.mark.cuda
def test_dense_mnmf_runs_through_the_kernels(cuda_device):
    """Five iterations of ``fast_gauss_mnmf_dense`` on the card: K5 three times, K7 twice per iteration; the eigh model K4."""
    from ssspy_tpu_torch.fast import fast_gauss_mnmf_dense
    from ssspy_tpu_torch.ops.mnmf_steps import gauss_mnmf_loss, gauss_mnmf_step, instant_covariance

    rng = np.random.default_rng(19)
    X = (rng.standard_normal((4, 65, 120)) + 1j * rng.standard_normal((4, 65, 120))).astype(np.complex64)
    X[1] += 0.5 * X[0]
    names = ("model_traces", "jacobi_eigh", "inv_sandwich")
    before = {name: getattr(K, name).launches for name in names}
    Y, (T, V, H) = fast_gauss_mnmf_dense(X, n_basis=2, n_iter=5, rng=np.random.default_rng(20))
    torch.cuda.synchronize()
    assert {name: getattr(K, name).launches - before[name] for name in names} == {
        "model_traces": 15, "jacobi_eigh": 10, "inv_sandwich": 0}
    assert Y.device.type == "cuda" and Y.dtype == torch.complex64 and Y.shape == X.shape
    assert torch.isfinite(torch.view_as_real(Y)).all()
    XX = instant_covariance(torch.from_numpy(X).to(cuda_device))
    start = (torch.ones_like(T), torch.ones_like(V), torch.eye(4, dtype=H.dtype, device=cuda_device).expand_as(H) / 4)
    assert float(gauss_mnmf_loss(XX, T, V, H)) < float(gauss_mnmf_loss(XX, *start))
    before = K.inv_sandwich.launches
    gauss_mnmf_step(XX, T, V, H, psd_impl="eigh")
    torch.cuda.synchronize()
    assert K.inv_sandwich.launches == before + 3


@pytest.mark.cuda
def test_complex128_psd_projection_takes_the_dense_mnmf_model_batch(cuda_device):
    """``to_psd`` on 160,882 complex128 8 x 8 matrices, dense GaussMNMF's model at full width.

    cuSOLVER's batched eigh refuses that batch in one call;
    ``special.psd.spectral`` hands it over in batches of ``CUDA_EIGH_BATCH``.
    """
    from ssspy_tpu_torch.special.psd import CUDA_EIGH_BATCH, to_psd

    rng = np.random.default_rng(21)
    A = torch.from_numpy(rng.standard_normal((257, 626, 8, 8)) + 1j * rng.standard_normal((257, 626, 8, 8)))
    A = A.to(cuda_device)
    assert A.shape[:-2].numel() > CUDA_EIGH_BATCH
    out = to_psd(A)
    head = to_psd(A[:2])
    torch.cuda.synchronize()
    assert torch.isfinite(torch.view_as_real(out)).all()
    assert torch.linalg.eigvalsh(out[:2]).min() >= -1e-12
    assert (out[:2] - head).abs().max() <= 1e-12 * head.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(8 * 626 * 63, 4), (8 * 626, 5), (37, 1), (50, 16), (41, 17), (23, 32)],
    ids=["ipsdta_timing_part", "ipsdta_remainder_part", "m1", "m16", "m17", "m32"],
)
def test_gj_inverse_kernel_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(22)
    B, m = shape
    R = torch.eye(m, dtype=torch.complex64, device=cuda_device) + _psd(rng, (B, m, m), cuda_device)
    before = K.gj_inverse.launches
    R_inv = K.gj_inverse(R)
    R_inv_ref = K.gj_inverse_plain(R)
    torch.cuda.synchronize()
    assert K.gj_inverse.launches == before + 1
    # the same elimination on both sides; only the rounding of fused products may differ
    assert (R_inv - R_inv_ref).abs().max() <= 1e-5 * R_inv_ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 33, 315504])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 16, 17, 32])
def test_gj_inverse_kernel_is_the_plain_version_bit_for_bit(cuda_device, m, B):
    """Both instances (one thread per system up to m = 8, a group of m threads above) keep the plain version's bits."""
    generator = torch.Generator(device=cuda_device).manual_seed(1000 * m + B)
    A = torch.randn((B, m, m), dtype=torch.complex64, device=cuda_device, generator=generator)
    R = (A @ A.mH / m + 0.1 * torch.eye(m, device=cuda_device)).contiguous()
    R_inv = K.gj_inverse(R)
    R_inv_ref = K.gj_inverse_plain(R)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.view_as_real(R_inv)).all()
    assert torch.equal(R_inv, R_inv_ref)


@pytest.mark.cuda
def test_gj_inverse_kernel_floors_the_pivot_of_a_zero_system(cuda_device):
    rng = np.random.default_rng(23)
    R = _psd(rng, (40, 5, 5), cuda_device)
    R[[0, 17]] = 0
    R_inv = K.gj_inverse(R)
    R_inv_ref = K.gj_inverse_plain(R)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.view_as_real(R_inv)).all()
    assert torch.equal(R_inv[[0, 17]], R_inv_ref[[0, 17]])
    assert torch.equal(R_inv[0], torch.eye(5, dtype=R.dtype, device=cuda_device) / torch.tensor(1e-20, device=cuda_device))


@pytest.mark.cuda
def test_gj_inverse_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="1 <= m <= 32"):
        K.gj_inverse(torch.zeros((4, 33, 33), dtype=torch.complex64, device=cuda_device))
    with pytest.raises(ValueError, match="complex64"):
        K.gj_inverse(torch.zeros((4, 3, 3), dtype=torch.complex128, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        K.gj_inverse(torch.zeros((4, 3, 3), dtype=torch.complex64, device=cuda_device).mT)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gauss", "t"])
def test_fast_ipsdta_runs_through_the_kernels(cuda_device, model):
    """One complex64 step of ``fast_gauss_ipsdta`` / ``fast_t_ipsdta`` on the card, two parts (J = 4 and 5): K3 three
    times per part; K7 once per part (Gauss) or twice (t)."""
    from ssspy_tpu_torch.fast import fast_gauss_ipsdta, fast_t_ipsdta

    rng = np.random.default_rng(24)
    X = (rng.standard_normal((4, 65, 120)) + 1j * rng.standard_normal((4, 65, 120))).astype(np.complex64)
    X[1] += 0.5 * X[0]
    names = ("gj_inverse", "jacobi_eigh")
    before = {name: getattr(K, name).launches for name in names}
    fast = fast_gauss_ipsdta if model == "gauss" else (lambda *a, **kw: fast_t_ipsdta(*a, dof=5, **kw))
    Y, (T_parts, V), W = fast(X, n_basis=2, n_blocks=16, n_iter=1, rng=np.random.default_rng(25))
    torch.cuda.synchronize()
    assert {name: getattr(K, name).launches - before[name] for name in names} == {
        "gj_inverse": 6, "jacobi_eigh": 2 if model == "gauss" else 4}
    assert Y.device.type == "cuda" and Y.dtype == torch.complex64 and Y.shape == X.shape
    assert [tuple(p.shape) for p in T_parts] == [(4, 2, 15, 4, 4), (4, 2, 1, 5, 5)]
    for t in (Y, W, *T_parts, V):
        assert torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all()


@pytest.mark.cuda
def test_vcd_sweep_freezes_only_the_rows_of_a_silent_bin(cuda_device):
    """A silent bin (x = 0) makes its VCD solves singular: ``solve_ex`` reports it on the card as on the CPU, the bin's
    rows keep their value and the other bins of its block are updated and finite."""
    from ssspy_tpu_torch.ops.ipsdta_steps import vcd_covariance, vcd_sweep

    rng = np.random.default_rng(26)
    B, J, M, T = 3, 4, 3, 50
    X = _complex(rng, (M, B, J, T), cuda_device)
    X[:, 1, 2] = 0
    A = _complex(rng, (M, T, B, J, J), cuda_device)
    R_inv = A @ A.conj().transpose(-1, -2) + torch.eye(J, dtype=A.dtype, device=cuda_device)
    W0 = torch.eye(M, dtype=torch.complex64, device=cuda_device).expand(B, J, M, M).contiguous()
    W = vcd_sweep(W0, vcd_covariance(R_inv, X))
    assert torch.isfinite(torch.view_as_real(W)).all()
    assert torch.equal(W[1, 2], W0[1, 2])
    assert not torch.equal(W[1, 1], W0[1, 1]) and not torch.equal(W[0, 2], W0[0, 2])


# ---- the routers of K1, K1b, K2 and K6: complex128 and oversized inputs take the plain versions ----------------


def _mixture_spectrogram(n_channels, seed, duration_s=0.5, n_fft=256):
    from ssspy_tpu_torch.utils import host_stft, make_mixture

    return host_stft(make_mixture(seed=seed, n_channels=n_channels, duration_s=duration_s), n_fft=n_fft, hop=n_fft // 2)


def _launches():
    return {name: getattr(K, name).launches for name in ("weighted_covariance", "ip1_sweep", "iss1_sweep", "ipa_congruence")}


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["AuxIVA-IP1", "GaussILRMA-ISS1", "AuxIVA-IPA"])
def test_complex128_classes_run_on_the_plain_routes(cuda_device, label):
    """A complex128 class on the card launches none of the four kernels and ends within 1e-6 of the same class on the CPU."""
    from ssspy_tpu_torch.bss import AuxLaplaceIVA, GaussILRMA

    def make(device):
        if label == "GaussILRMA-ISS1":
            return GaussILRMA(n_basis=2, spatial_algorithm="ISS1", rng=np.random.default_rng(30), device=device)
        return AuxLaplaceIVA(spatial_algorithm="IPA" if label.endswith("IPA") else "IP", device=device)

    X = torch.from_numpy(_mixture_spectrogram(3, seed=29))
    before = _launches()
    card = make("cuda")
    Y = card(X, n_iter=5)
    torch.cuda.synchronize()
    assert _launches() == before
    host = make("cpu")
    host(X, n_iter=5)
    assert Y.device.type == "cuda" and Y.dtype == torch.complex128
    assert torch.isfinite(torch.view_as_real(Y)).all()
    assert abs(card.loss[-1] - host.loss[-1]) <= 1e-6 * abs(host.loss[-1])


@pytest.mark.cuda
def test_separate_on_a_float64_waveform_runs_on_the_card(cuda_device):
    """The pipeline's docstring example: a float64 numpy mixture through GaussILRMA-ISS1, complex128 on the plain route."""
    from ssspy_tpu_torch import separate
    from ssspy_tpu_torch.bss import GaussILRMA
    from ssspy_tpu_torch.utils import make_mixture

    x = make_mixture(seed=31, n_channels=2, duration_s=0.5)
    before = _launches()
    y = separate(x, GaussILRMA(n_basis=2, spatial_algorithm="ISS1", rng=np.random.default_rng(32)), n_iter=5)
    torch.cuda.synchronize()
    assert _launches() == before
    assert y.device.type == "cuda" and y.dtype == torch.float64 and tuple(y.shape) == x.shape
    assert torch.isfinite(y).all()


@pytest.mark.cuda
def test_fast_auxiva_past_the_ip1_limit_takes_the_plain_sweep(cuda_device):
    """18 channels: K1 takes the covariance, the IP1 sweep (K1b to 17) runs plain."""
    from ssspy_tpu_torch.fast import fast_auxiva

    X = _mixture_spectrogram(18, seed=33, duration_s=0.3, n_fft=128)
    before = _launches()
    Y, W = fast_auxiva(X, n_iter=2)
    torch.cuda.synchronize()
    after = {name: count - before[name] for name, count in _launches().items()}
    assert after == {"weighted_covariance": 2, "ip1_sweep": 0, "iss1_sweep": 0, "ipa_congruence": 0}
    assert torch.isfinite(torch.view_as_real(Y)).all() and torch.isfinite(torch.view_as_real(W)).all()


# ---- FastGaussMNMF and cACGMM -----------------------------------------------------------------


@pytest.mark.cuda
def test_fast_gauss_mnmf_runs_through_k1_and_k1b_and_equals_its_class(cuda_device):
    from ssspy_tpu_torch.bss import FastGaussMNMF
    from ssspy_tpu_torch.fast import fast_gauss_mnmf

    X = _mixture_spectrogram(4, seed=34).astype(np.complex64)
    before = _launches()
    Y, (T, V, Q, D) = fast_gauss_mnmf(X, n_basis=2, n_iter=5, rng=np.random.default_rng(35))
    torch.cuda.synchronize()
    after = {name: count - before[name] for name, count in _launches().items()}
    assert after == {"weighted_covariance": 5, "ip1_sweep": 5, "iss1_sweep": 0, "ipa_congruence": 0}
    assert Y.device.type == "cuda" and torch.isfinite(torch.view_as_real(Y)).all()
    mnmf = FastGaussMNMF(n_basis=2, rng=np.random.default_rng(35))
    assert torch.equal(mnmf(X, n_iter=5), Y)
    assert torch.equal(mnmf.diagonalizer, Q) and torch.equal(mnmf.spatial, D)


@pytest.mark.cuda
def test_fast_cacgmm_runs_through_k7_and_equals_its_class(cuda_device):
    from ssspy_tpu_torch.bss import CACGMM
    from ssspy_tpu_torch.fast import fast_cacgmm

    X = _mixture_spectrogram(3, seed=36).astype(np.complex64)
    before = K.jacobi_eigh.launches
    Y = fast_cacgmm(X, n_iter=5, permutation_alignment=False, rng=np.random.default_rng(37))
    torch.cuda.synchronize()
    assert K.jacobi_eigh.launches - before == 2 * 5 + 1
    gmm = CACGMM(permutation_alignment=False, rng=np.random.default_rng(37))
    assert torch.equal(gmm(X, n_iter=5), Y)
    for impl in ("eigh", "chol"):
        before = K.weighted_covariance.launches
        Y_route = CACGMM(impl=impl, covariance_impl="kernel", rng=np.random.default_rng(37))(X, n_iter=5)
        torch.cuda.synchronize()
        assert K.weighted_covariance.launches - before == 5
        assert Y_route.device.type == "cuda" and torch.isfinite(torch.view_as_real(Y_route)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [2, 3, 4])
def test_permutation_solvers_choose_on_the_card_what_they_choose_on_the_cpu(cuda_device, N):
    from ssspy_tpu_torch.algorithm import (
        correlation_based_permutation_solver,
        permutation_align,
        score_based_permutation_solver,
    )

    rng = np.random.default_rng(38 + N)
    env = rng.random((N, 40)) ** 3
    seq = np.stack([env[rng.permutation(N)] * (1 + 0.3 * rng.random((N, 40))) for _ in range(33)])
    index = torch.from_numpy(np.tile(np.arange(N), (33, 1)))
    for solve in (correlation_based_permutation_solver, score_based_permutation_solver, permutation_align):
        _, on_cpu = solve(torch.from_numpy(seq), index)
        _, on_card = solve(torch.from_numpy(seq).to(cuda_device), index.to(cuda_device))
        assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.cuda
def test_waveform_entry_points_equal_the_spectrogram_path(cuda_device):
    from ssspy_tpu_torch.fast import fast_auxiva, fast_auxiva_wave, fast_gauss_ilrma, fast_gauss_ilrma_wave
    from ssspy_tpu_torch.transform import istft, stft
    from ssspy_tpu_torch.utils import make_mixture

    x = make_mixture(seed=39, n_channels=2, duration_s=0.5)
    xt = torch.from_numpy(x).to(cuda_device, torch.float32)
    y = fast_auxiva_wave(x, n_iter=5)
    ref = istft(fast_auxiva(stft(xt, device=cuda_device), n_iter=5)[0], length=x.shape[-1], device=cuda_device)
    assert y.device.type == "cuda" and (y - ref).abs().max() <= 1e-4 * ref.abs().max()
    y = fast_gauss_ilrma_wave(x, n_basis=2, n_iter=5, rng=np.random.default_rng(40))
    ref = istft(fast_gauss_ilrma(stft(xt, device=cuda_device), n_basis=2, n_iter=5, rng=np.random.default_rng(40))[0],
                length=x.shape[-1], device=cuda_device)
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


# ---- IP2, ISS2, the fixed-point and gradient IVA classes, time-domain ICA --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
def test_weighted_covariance_kernel_at_two_sources(cuda_device, per_bin):
    """K1 at IP2's pair weights: N = 2 over the main path's mixture, within 1e-5, Hermitian and two launches to the bit."""
    rng = np.random.default_rng(41)
    M, I, T, _ = MAIN_PATH
    X = _complex(rng, (M, I, T), cuda_device)
    phi = torch.from_numpy(rng.random((2, I, T) if per_bin else (2, T), dtype=np.float32) + 0.1).to(cuda_device)
    before = K.weighted_covariance.launches
    U, U2 = K.weighted_covariance(X, phi), K.weighted_covariance(X, phi)
    ref = K.weighted_covariance_plain(X, phi)
    torch.cuda.synchronize()
    assert K.weighted_covariance.launches == before + 2
    assert U.shape == (I, 2, M, M)
    assert (U - ref).abs().max() / ref.abs().max() <= 1e-5
    assert torch.equal(U, U.transpose(-2, -1).conj()) and torch.equal(U, U2)


@pytest.mark.cuda
def test_jacobi_eigh_kernel_at_the_faster_iva_top_eigenvector_input(cuda_device):
    """K7 on FasterIVA's embedded per-source covariances, (I N, 2M, 2M) = (2056, 16, 16): the plain version's bits."""
    from ssspy_tpu_torch.ops.prox_steps import _symmetrised, block_embed

    rng = np.random.default_rng(42)
    M, I, T, N = MAIN_PATH
    X = _complex(rng, (M, I, T), cuda_device)
    phi = torch.from_numpy(rng.random((N, T), dtype=np.float32) + 0.1).to(cuda_device)
    U = K.weighted_covariance_plain(X, phi)
    A = _symmetrised(block_embed(U)).reshape(-1, 2 * M, 2 * M).contiguous()
    assert A.shape == (2056, 16, 16)
    lamb, V = K.jacobi_eigh(A)
    lamb_ref, V_ref = K.jacobi_eigh_plain(A)
    assert torch.equal(lamb, lamb_ref) and torch.equal(V, V_ref)


def _new_path_launches():
    return {name: getattr(K, name).launches for name in ("weighted_covariance", "ip1_sweep", "iss1_sweep",
                                                         "ipa_congruence", "jacobi_eigh")}


def _launched(before):
    torch.cuda.synchronize()
    return {name: count - before[name] for name, count in _new_path_launches().items()}


@pytest.mark.cuda
def test_ip2_and_iss2_paths_run_through_their_kernels_and_equal_their_classes(cuda_device):
    """AuxIVA-IP2: K1 once a pair, no K1b; ISS2: no kernel; FastGaussMNMF-IP2: K1 once a step, no K1b; each class
    equals its fast path."""
    from ssspy_tpu_torch.bss import AuxLaplaceIVA, FastGaussMNMF
    from ssspy_tpu_torch.fast import fast_auxiva, fast_gauss_mnmf

    X = _mixture_spectrogram(4, seed=43).astype(np.complex64)
    zero = dict.fromkeys(("weighted_covariance", "ip1_sweep", "iss1_sweep", "ipa_congruence", "jacobi_eigh"), 0)
    for algorithm, k1 in (("IP2", 4 * 3), ("ISS2", 0)):
        before = _new_path_launches()
        Y, _ = fast_auxiva(X, n_iter=3, algorithm=algorithm, scale_restoration=False)
        assert _launched(before) == {**zero, "weighted_covariance": k1}
        iva = AuxLaplaceIVA(spatial_algorithm=algorithm, flooring_fn="f64", scale_restoration=False)
        assert torch.equal(iva(X, n_iter=3), Y)
        assert Y.device.type == "cuda" and torch.isfinite(torch.view_as_real(Y)).all()
    before = _new_path_launches()
    Y, (T, V, Q, D) = fast_gauss_mnmf(X, n_basis=2, n_iter=3, diagonalizer_algorithm="IP2", rng=np.random.default_rng(44))
    assert _launched(before) == {**zero, "weighted_covariance": 3}
    mnmf = FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2", rng=np.random.default_rng(44))
    assert torch.equal(mnmf(X, n_iter=3), Y) and torch.equal(mnmf.diagonalizer, Q)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["AuxIVA-IP2", "AuxIVA-ISS2", "GaussILRMA-IP2", "GaussILRMA-ISS2", "FastGaussMNMF-IP2"])
def test_complex128_ip2_and_iss2_classes_on_the_card_equal_the_cpu(cuda_device, label):
    from ssspy_tpu_torch.bss import AuxLaplaceIVA, FastGaussMNMF, GaussILRMA

    def make(device):
        family, algorithm = label.split("-")
        if family == "AuxIVA":
            return AuxLaplaceIVA(spatial_algorithm=algorithm, device=device)
        if family == "GaussILRMA":
            return GaussILRMA(n_basis=2, spatial_algorithm=algorithm, rng=np.random.default_rng(45), device=device)
        return FastGaussMNMF(n_basis=2, diagonalizer_algorithm="IP2", rng=np.random.default_rng(45), device=device)

    X = torch.from_numpy(_mixture_spectrogram(3, seed=46))
    before = _new_path_launches()
    card = make("cuda")
    Y = card(X, n_iter=5)
    assert all(count == 0 for count in _launched(before).values())  # complex128: every router's plain route
    host = make("cpu")
    Y_host = host(X, n_iter=5)
    assert Y.device.type == "cuda" and Y.dtype == torch.complex128
    assert abs(card.loss[-1] - host.loss[-1]) <= 1e-6 * abs(host.loss[-1])
    assert (Y.cpu() - Y_host).abs().max() <= 1e-6 * Y_host.abs().max()


@pytest.mark.cuda
def test_fixed_point_and_gradient_paths_run_through_their_kernels_and_equal_their_classes(cuda_device):
    """FastIVA: K7 once for the whitening and once a step; FasterIVA: K1 and K7 twice a step; gradient IVA: none."""
    from ssspy_tpu_torch.bss import FasterIVA, FastIVA, GradLaplaceIVA, NaturalGradLaplaceIVA
    from ssspy_tpu_torch.fast import fast_fast_iva, fast_faster_iva, fast_grad_iva

    def contrast(y):
        return 2 * torch.linalg.vector_norm(y, dim=1)

    def d_contrast(y):
        return 2 * torch.ones_like(y)

    X = _mixture_spectrogram(4, seed=47).astype(np.complex64)
    zero = dict.fromkeys(("weighted_covariance", "ip1_sweep", "iss1_sweep", "ipa_congruence", "jacobi_eigh"), 0)
    before = _new_path_launches()
    Y = fast_fast_iva(X, n_iter=3)
    assert _launched(before) == {**zero, "jacobi_eigh": 4}
    fast = FastIVA(contrast_fn=contrast, d_contrast_fn=d_contrast, dd_contrast_fn=lambda y: torch.zeros_like(y),
                   flooring_fn="f64")
    assert torch.equal(fast(X, n_iter=3), Y)
    before = _new_path_launches()
    Y = fast_faster_iva(X, n_iter=3)
    assert _launched(before) == {**zero, "weighted_covariance": 3, "jacobi_eigh": 7}
    assert torch.equal(FasterIVA(contrast_fn=contrast, d_contrast_fn=d_contrast, flooring_fn="f64")(X, n_iter=3), Y)
    assert torch.isfinite(torch.view_as_real(Y)).all()
    for natural, cls in ((False, GradLaplaceIVA), (True, NaturalGradLaplaceIVA)):
        before = _new_path_launches()
        Y, _ = fast_grad_iva(X, n_iter=3, natural=natural)
        assert _launched(before) == zero
        assert torch.equal(cls(flooring_fn="f64")(X, n_iter=3), Y)


@pytest.mark.cuda
def test_natural_grad_laplace_ica_meets_its_fixture_on_the_card(cuda_device):
    """tests/regression/test_regression.py:179-186 on the card, float64: within 1e-6, no kernel."""
    import os

    from ssspy_tpu_torch.bss import NaturalGradLaplaceICA

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "regression", "fixtures")
    waveform = np.load(os.path.join(fixtures, "input_time.npz"))["waveform"]
    target = np.load(os.path.join(fixtures, "natural_grad_laplace_ica.npz"))["target"]
    before = _new_path_launches()
    Y = NaturalGradLaplaceICA(step_size=0.05)(waveform, n_iter=20)
    assert all(count == 0 for count in _launched(before).values())
    assert Y.device.type == "cuda" and Y.dtype == torch.float64
    np.testing.assert_allclose(Y.cpu().numpy(), target, atol=1e-6)


def _transform_layout(kind, rng):
    """A mixed float64/complex128 input in one of the reference's four layouts, with its channel axis."""
    A = rng.standard_normal((3, 3))
    if kind == "2d-real":
        return np.einsum("mn,nt->mt", A, rng.laplace(size=(3, 500))), 0
    if kind == "3d-real":
        return np.einsum("mn,bnt->bmt", A, rng.laplace(size=(4, 3, 500))), 1
    s = rng.standard_normal((3, 5, 200)) + 1j * rng.standard_normal((3, 5, 200))
    if kind == "3d-complex":
        return np.einsum("mn,nit->mit", A, s), 0
    return np.einsum("mn,bnit->bmit", A, np.stack([s, 2 * s[::-1]])), 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pca", "whiten"])
@pytest.mark.parametrize("kind", ["2d-real", "3d-complex", "3d-real", "4d-complex"])
def test_pca_and_whiten_run_on_the_card_and_equal_the_cpu(cuda_device, name, kind):
    """The transforms' default device is the card; there they equal the CPU up to each eigenvector's sign or phase."""
    from ssspy_tpu_torch import transform

    fn = getattr(transform, name)
    x, ch_axis = _transform_layout(kind, np.random.default_rng(11))
    Y = fn(x)
    assert Y.device.type == "cuda" and Y.shape == x.shape
    got, ref = Y.cpu().numpy(), fn(x, device="cpu").numpy()
    inner = np.sum(got * ref.conj(), axis=-1, keepdims=True)  # one sign or phase a slice and component
    np.testing.assert_allclose(got * (inner / np.abs(inner)).conj(), ref, atol=1e-10 * np.abs(ref).max())
    if name == "whiten":
        Z = np.moveaxis(got, ch_axis, -1)
        cov = np.einsum("...tm,...tn->...mn", Z, Z.conj()) / Z.shape[-2]
        np.testing.assert_allclose(cov, np.broadcast_to(np.eye(3), cov.shape), atol=1e-10)


# ---- stft/istft on the card, FDICA, the eigendecomposition-free routes ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stft_and_istft_on_the_card_equal_the_cpu(cuda_device, dtype):
    from ssspy_tpu_torch.transform import istft, stft
    from ssspy_tpu_torch.utils import make_mixture

    x = make_mixture(seed=48, n_channels=3, duration_s=0.5).astype(dtype)
    X = stft(x, n_fft=256)
    X_host = stft(x, n_fft=256, device="cpu")
    assert X.device.type == "cuda" and X.dtype == X_host.dtype
    assert (X.cpu() - X_host).abs().max() <= 1e-6 * X_host.abs().max()
    y, y_host = istft(X_host.numpy(), n_fft=256, length=x.shape[-1]), istft(X_host, n_fft=256, length=x.shape[-1],
                                                                          device="cpu")
    assert y.device.type == "cuda" and (y.cpu() - y_host).abs().max() <= 1e-6 * y_host.abs().max()


FDICA_LABELS = ("AuxFDICA-IP1", "AuxFDICA-IP2", "GradFDICA", "NaturalGradFDICA")


def _fdica_class(label, device, **kwargs):
    from ssspy_tpu_torch.bss import AuxLaplaceFDICA, GradLaplaceFDICA, NaturalGradLaplaceFDICA

    if label.startswith("AuxFDICA"):
        return AuxLaplaceFDICA(spatial_algorithm=label.split("-")[1], device=device, **kwargs)
    if label == "GradFDICA":
        return GradLaplaceFDICA(device=device, **kwargs)
    return NaturalGradLaplaceFDICA(is_holonomic=True, device=device, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("label", FDICA_LABELS)
def test_complex128_fdica_classes_on_the_card_equal_the_cpu(cuda_device, label):
    """complex128 on the card: no kernel launches, and the loss and (aligned, rescaled) output end within 1e-6 of the CPU's."""
    X = torch.from_numpy(_mixture_spectrogram(3, seed=49))
    before = _new_path_launches()
    card = _fdica_class(label, "cuda")
    Y = card(X, n_iter=5)
    assert all(count == 0 for count in _launched(before).values())
    host = _fdica_class(label, "cpu")
    Y_host = host(X, n_iter=5)
    assert Y.device.type == "cuda" and Y.dtype == torch.complex128
    assert abs(card.loss[-1] - host.loss[-1]) <= 1e-6 * abs(host.loss[-1])
    assert (Y.cpu() - Y_host).abs().max() <= 1e-6 * Y_host.abs().max()


@pytest.mark.cuda
def test_fdica_paths_run_through_their_kernels_and_equal_their_classes(cuda_device):
    """IP1: K1 and K1b once a step; IP2: K1 once a pair; the gradient: none; each class (unaligned, unscaled, at the
    fast path's floor) equals its fast path to the bit."""
    from ssspy_tpu_torch.fast import fast_aux_fdica, fast_grad_fdica

    X = _mixture_spectrogram(4, seed=50).astype(np.complex64)
    zero = dict.fromkeys(("weighted_covariance", "ip1_sweep", "iss1_sweep", "ipa_congruence", "jacobi_eigh"), 0)
    raw = dict(permutation_alignment=False, scale_restoration=False)
    cases = (
        ("AuxFDICA-IP1", lambda: fast_aux_fdica(X, n_iter=3, **raw), {"weighted_covariance": 3, "ip1_sweep": 3}, {}),
        ("AuxFDICA-IP2", lambda: fast_aux_fdica(X, n_iter=3, algorithm="IP2", **raw), {"weighted_covariance": 12}, {}),
        ("GradFDICA", lambda: fast_grad_fdica(X, n_iter=3, **raw), {}, {"flooring_fn": "f64"}),
        ("NaturalGradFDICA", lambda: fast_grad_fdica(X, n_iter=3, natural=True, is_holonomic=True, **raw), {},
         {"flooring_fn": "f64"}),
    )
    for label, fast, launches, floor in cases:
        before = _new_path_launches()
        Y, W = fast()
        assert _launched(before) == {**zero, **launches}, label
        method = _fdica_class(label, "cuda", **raw, **floor)
        assert torch.equal(method(X, n_iter=3), Y) and torch.equal(method.demix_filter, W), label
        assert torch.isfinite(torch.view_as_real(Y)).all()
    Y, W = fast_aux_fdica(X, n_iter=3)  # aligned and rescaled on the card
    assert Y.device.type == W.device.type == "cuda" and torch.isfinite(torch.view_as_real(Y)).all()


@pytest.mark.cuda
def test_free_routes_agree_with_their_eigh_routes_on_the_card(cuda_device):
    """At chip_smoke's tolerances: QDWH polar unitary within 1e-5 and within 1e-4 of the eigh polar; the shift-invert
    top eigenvector's Rayleigh quotient within 1e-5 of K7's top eigenvalue; the solve route's secular roots within
    1.2e-3 of the roots on K7's spectrum (splitc.py:1541-1546); neither free route launches K7."""
    from ssspy_tpu_torch.linalg.eig_free import secular_root_solve, top_eigvec_shift_invert
    from ssspy_tpu_torch.ops.fixed_point_iva_steps import polar
    from ssspy_tpu_torch.ops.ipa_steps import _pencil_spectrum
    from ssspy_tpu_torch.ops.prox_steps import herm_eigh_embed

    rng = np.random.default_rng(51)
    W = torch.eye(8, device=cuda_device) + 0.1 * _complex(rng, (257, 8, 8), cuda_device)  # near unitary, as FastIVA's
    before = _new_path_launches()
    P = polar(W, impl="qdwh")
    A = _complex(rng, (514, 8, 12), cuda_device)
    U = A @ A.mH / 12
    v = top_eigvec_shift_invert(U)
    H = U[:, :7, :7]
    z = torch.from_numpy(rng.random(514, dtype=np.float32) + 0.1).to(cuda_device)
    b = _complex(rng, (514, 7), cuda_device)
    root, _ = secular_root_solve(H, b, z, trips=12)
    assert _launched(before)["jacobi_eigh"] == 0
    eye = torch.eye(8, device=cuda_device)
    assert (P.mH @ P - eye).abs().max() <= 1e-5
    P_eigh = polar(W)
    assert (P - P_eigh).abs().max() <= 1e-4 * P_eigh.abs().max()
    top = herm_eigh_embed(U)[0][..., -1]
    rayleigh = torch.sum(v.conj() * (U @ v[..., None])[..., 0], dim=-1).real
    assert ((rayleigh - top).abs() / top).max() <= 1e-5
    phi, vsq, _ = _pencil_spectrum(H, b)
    phi, vsq, z64 = phi.double(), vsq.double(), z.double()
    lo, hi = phi[..., -1], torch.maximum(2 * phi[..., -1], z64 + 4 * torch.sum(phi * vsq, dim=-1))
    for _ in range(200):  # the true root on K7's spectrum, by bisection in float64
        mid = (lo + hi) / 2
        f = mid * mid * torch.sum(phi * vsq / (mid[..., None] - phi) ** 2, dim=-1) - mid + z64
        lo, hi = torch.where(f > 0, mid, lo), torch.where(f > 0, hi, mid)
    assert ((root.double() - lo).abs() / lo).max() <= 1.2e-3


# ---- the (dp, bin) runners at world size 1 and dense GaussMNMF's bin mask ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ip1", "iss1", "ilrma", "mnmf", "cacgmm", "ipsdta", "ip2", "iss2", "ipa", "wave",
                                  "mnmf_partitioning", "fast_iva", "faster_iva", "fdica_ip1", "fdica_ip2", "grad_iva",
                                  "grad_fdica", "fast_mnmf", "pds_iva", "admm_iva", "hva", "ica"])
def test_runner_at_world_size_one_on_the_card(cuda_device, name):
    """Each runner with no process group on the card (float32, the dry run's shapes at 257 bins) against the same
    runner on the CPU: the outputs within a relative 1e-3 (the card's kernels against the CPU's plain versions after
    two steps), IPA and ISS2 on their loss within its case's 3e-4 (one float32 sweep of IPA turns input noise into
    O(1) output changes) and FasterIVA on its whitened loss within its case's tolerance (a top eigenvector's phase
    may flip in a bin whose components nearly tie); and the kernels of its path launched on the card, each as often
    as its case counts."""
    from ssspy_tpu_torch.parallel import make_layout
    from ssspy_tpu_torch.parallel.dryrun import CASES, KERNELS, N_STEPS, error, make_inputs, run_case

    inputs = make_inputs(name, n_batch=2)
    before = {k: getattr(K, k).launches for k in KERNELS}
    out = run_case(name, make_layout(device=cuda_device), inputs)
    torch.cuda.synchronize()
    launched = {k: getattr(K, k).launches - before[k] for k in KERNELS}
    ref = run_case(name, make_layout(device="cpu"), inputs)
    for o, r in zip(out, ref):
        assert o.device.type == "cuda" and torch.isfinite(torch.view_as_real(o) if o.is_complex() else o).all()
        if CASES[name].measure in ("loss", "whitened_loss"):
            assert error(name, inputs, o.cpu(), r) <= CASES[name].tol
        else:
            assert (o.cpu() - r).abs().max() <= 1e-3 * r.abs().max()
    assert launched == {k: N_STEPS * CASES[name].launches.get(k, 0) for k in KERNELS}


@pytest.mark.cuda
def test_gauss_mnmf_masked_fused_route_equals_its_plain_route(cuda_device, monkeypatch):
    """K5's fused route with a bin mask against the plain model pass with the same mask (K5's 2e-4): the masked bins
    frozen at zero on both, their K5 outputs discarded."""
    from ssspy_tpu_torch.ops.mnmf_steps import gauss_mnmf_step

    rng = np.random.default_rng(61)
    n_bins, pad, M, N, K_, T_ = 33, 3, 4, 4, 2, 16
    Xc = _complex(rng, (M, n_bins, T_), cuda_device)
    XX = torch.einsum("mit,nit->itmn", Xc, Xc.conj())
    XX = torch.cat([XX, torch.zeros((pad,) + XX.shape[1:], dtype=XX.dtype, device=cuda_device)]).contiguous()
    T = torch.from_numpy(rng.random((N, n_bins + pad, K_), dtype=np.float32) + 0.1).to(cuda_device)
    T[:, n_bins:] = 0
    V = torch.from_numpy(rng.random((N, K_, T_), dtype=np.float32) + 0.1).to(cuda_device)
    H = (torch.eye(M, device=cuda_device) + 0.1).to(torch.complex64).expand(N, n_bins + pad, M, M).clone()
    H[:, n_bins:] = 0
    mask = torch.arange(n_bins + pad, device=cuda_device) < n_bins
    before = K.model_traces.launches
    fused = (T, V, H)
    for _ in range(2):
        fused = gauss_mnmf_step(XX, *fused, bin_mask=mask)
    assert K.model_traces.launches == before + 6
    monkeypatch.setattr(K, "model_traces", K.model_traces_plain)
    plain = (T, V, H)
    for _ in range(2):
        plain = gauss_mnmf_step(XX, *plain, bin_mask=mask)
    for f, p in zip(fused, plain):
        assert torch.isfinite(torch.view_as_real(f) if f.is_complex() else f).all()
        assert (f - p).abs().max() <= 2e-4 * p.abs().max()
    assert torch.all(fused[0][:, n_bins:] == 0) and torch.all(fused[2][:, n_bins:] == 0)


# ---- the update_by_* spatial updates and a flooring_fn that is not max(., eps) -------------------------------------


def _update_by_inputs(device, dtype=torch.complex64, seed=62):
    """A 4-channel mixture's spectrogram, filters near the identity, its Laplace weights and weighted covariances."""
    from ssspy_tpu_torch.ops import iva_steps

    X = torch.from_numpy(_mixture_spectrogram(4, seed=seed)).to(device=device, dtype=dtype)
    M, I, _ = X.shape
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((2, I, M, M))
    W = (torch.eye(M, dtype=dtype) + 0.1 * torch.complex(*torch.from_numpy(noise)).to(dtype)).to(device)
    Y = iva_steps.separate(X, W)
    weight = (1 / torch.linalg.vector_norm(Y, dim=1).clamp(min=1e-10))[:, None, :]  # (N, 1, T)
    U = K.weighted_covariance_plain(X, weight[:, 0])
    return X, W, Y, weight, U


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ip1", "iss1", "ipa", "ip2", "iss2"])
def test_update_by_on_the_card_launches_its_kernels_and_equals_the_cpu(cuda_device, name):
    """The default floor: in complex64 K1b (ip1), K2 (iss1), K1 + K7 + K6 (ipa, once a source), the output within the
    kernel's gate of the same update on the CPU (IPA: its loss, as the paths hold it); no kernel (ip2, iss2) in
    complex128 within 1e-6 of the CPU (in float32 one pair update moves by its summation order on a near-degenerate
    pencil, as the IP2 and ISS2 paths do)."""
    from ssspy_tpu_torch.bss import _update_spatial_model as usm
    from ssspy_tpu_torch.ops.iva_steps import iva_laplace_loss

    updates = {
        "ip1": (lambda W, Y, w, U: usm.update_by_ip1(W, U), {"ip1_sweep": 1}),
        "iss1": (lambda W, Y, w, U: usm.update_by_iss1(Y, w), {"iss1_sweep": 1}),
        "ipa": (lambda W, Y, w, U: usm.update_by_ipa(Y, w), {"weighted_covariance": 1, "jacobi_eigh": 4,
                                                              "ipa_congruence": 4}),
        "ip2": (lambda W, Y, w, U: usm.update_by_ip2(W, U), {}),
        "iss2": (lambda W, Y, w, U: usm.update_by_iss2(Y, w), {}),
    }
    update, expected = updates[name]
    kernel_free = name in ("ip2", "iss2")
    X, W, Y, weight, U = _update_by_inputs(cuda_device, torch.complex128 if kernel_free else torch.complex64)
    before = _new_path_launches()
    out = update(W, Y, weight, U)
    launched = _launched(before)
    assert {k: v for k, v in launched.items() if v} == expected
    host = update(*(t.cpu() for t in (W, Y, weight, U)))
    assert out.device.type == cuda_device.type and torch.isfinite(torch.view_as_real(out)).all()
    if name == "ipa":
        loss, loss_host = float(iva_laplace_loss(X, Y=out)), float(iva_laplace_loss(X.cpu(), Y=host))
        assert abs(loss - loss_host) <= 3e-4 * abs(loss_host)
    else:
        assert (out.cpu() - host).abs().max() <= (1e-6 if kernel_free else 1e-4) * host.abs().max()


@pytest.mark.cuda
def test_update_by_with_a_callable_floor_takes_the_plain_sweeps_on_the_card(cuda_device):
    """complex64 with ``v + 1e-6``: no K1b and no K2, and the CPU's result; update_by_ip1 with the default floor equals
    ip1_update to the bit."""
    from ssspy_tpu_torch.bss import _update_spatial_model as usm
    from ssspy_tpu_torch.ops.iva_steps import ip1_update

    def shifted(v):
        return v + 1e-6

    X, W, Y, weight, U = _update_by_inputs(cuda_device, seed=63)
    before = _new_path_launches()
    W_new = usm.update_by_ip1(W, U, flooring_fn=shifted)
    Y_new = usm.update_by_iss1(Y, weight, flooring_fn=shifted)
    assert all(count == 0 for count in _launched(before).values())
    W_host = usm.update_by_ip1(W.cpu(), U.cpu(), flooring_fn=shifted)
    Y_host = usm.update_by_iss1(Y.cpu(), weight.cpu(), flooring_fn=shifted)
    assert (W_new.cpu() - W_host).abs().max() <= 1e-4 * W_host.abs().max()
    assert (Y_new.cpu() - Y_host).abs().max() <= 1e-4 * Y_host.abs().max()
    assert torch.equal(usm.update_by_ip1(W, U), ip1_update(W, U, eps=1e-10))


FLOORING_FAMILIES = ("AuxLaplaceIVA-ISS2", "GaussILRMA-IP1", "AuxLaplaceFDICA-IP2", "GaussMNMF", "FastGaussMNMF-IP2",
                     "GaussIPSDTA", "CACGMM")


def _flooring_class(label, device):
    from ssspy_tpu_torch import bss

    def shifted(v):
        return v + 1e-10

    rng = {"rng": np.random.default_rng(64)}
    family, _, algorithm = label.partition("-")
    if family == "AuxLaplaceIVA":
        return bss.AuxLaplaceIVA(spatial_algorithm=algorithm, flooring_fn=shifted, device=device)
    if family == "GaussILRMA":
        return bss.GaussILRMA(n_basis=2, spatial_algorithm=algorithm, flooring_fn=shifted, device=device, **rng)
    if family == "AuxLaplaceFDICA":
        return bss.AuxLaplaceFDICA(spatial_algorithm=algorithm, flooring_fn=shifted, device=device)
    if family == "GaussMNMF":
        return bss.GaussMNMF(n_basis=2, flooring_fn=shifted, device=device, **rng)
    if family == "FastGaussMNMF":
        return bss.FastGaussMNMF(n_basis=2, diagonalizer_algorithm=algorithm, flooring_fn=shifted, device=device, **rng)
    if family == "GaussIPSDTA":
        return bss.GaussIPSDTA(n_basis=2, n_blocks=8, flooring_fn=shifted, device=device, **rng)
    return bss.CACGMM(flooring_fn=shifted, device=device, **rng)


@pytest.mark.cuda
@pytest.mark.parametrize("label", FLOORING_FAMILIES)
def test_complex128_classes_with_a_callable_floor_on_the_card_equal_the_cpu(cuda_device, label):
    """One class of each family with ``v + 1e-10`` in complex128: no kernel launches, the loss within 1e-6 of the CPU's."""
    X = torch.from_numpy(_mixture_spectrogram(3, seed=65))
    before = _new_path_launches()
    card = _flooring_class(label, cuda_device)
    Y = card(X, n_iter=5)
    assert all(count == 0 for count in _launched(before).values())
    host = _flooring_class(label, "cpu")
    host(X, n_iter=5)
    assert Y.device.type == cuda_device.type and Y.dtype == torch.complex128 and torch.isfinite(torch.view_as_real(Y)).all()
    assert abs(card.loss[-1] - host.loss[-1]) <= 1e-6 * abs(host.loss[-1])
