"""ssspy_tpu_torch kernels: plain versions against the JAX package, dispatch, routes by shape and build.

On the CPU the kernel wrappers take their plain PyTorch versions; these
are checked against the JAX functions they port (the Pallas covariance
in interpret mode and its einsum, the split-complex IP1 sweep with both
solvers, the ISS1 sweep in its XLA form and its Pallas body in interpret
mode, the batched Hermitian inverse in its Pallas body in interpret mode
and its XLA form) on the same numpy inputs. The CUDA kernels themselves are
compared with the plain versions on the card by tests/test_torch_cuda.py
and by ``chip_smoke.py``.
"""

import os
import re
import stat
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.ops.pallas_kernels import planar_inverse_sc, weighted_covariance_sc
from ssspy_tpu.ops.splitc import _cinv, ip1_sweep_sc, iss1_sweep_sc
from ssspy_tpu_torch.ops import _build, ipsdta_steps, mnmf_steps, prox_steps
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.utils import complex_to_planar, planar_to_complex

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(3, 17, 50, 3), (8, 16, 40, 8)]  # (M, I, T, N)


def _planar(rng, shape):
    return rng.standard_normal((2,) + shape).astype(np.float32)


def _weights(rng, N, I, T, per_bin):
    return (rng.random((N, I, T) if per_bin else (N, T)) + 0.1).astype(np.float32)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


# ---- weighted covariance -----------------------------------------------------


@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["interpret", "einsum"])
def test_weighted_covariance_plain_matches_jax(shape, per_bin, impl):
    M, I, T, N = shape
    rng = np.random.default_rng(0)
    Xs = _planar(rng, (M, I, T))
    phi = _weights(rng, N, I, T, per_bin)

    Ur, Ui = weighted_covariance_sc(
        jnp.asarray(Xs[0]), jnp.asarray(Xs[1]), jnp.asarray(phi), impl=impl
    )
    U = K.weighted_covariance_plain(planar_to_complex(Xs), torch.from_numpy(phi))

    assert U.shape == (I, N, M, M) and U.dtype == torch.complex64
    got = complex_to_planar(U)
    np.testing.assert_allclose(got[0], np.asarray(Ur), atol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(Ui), atol=1e-5)
    # Hermitian per (bin, source)
    np.testing.assert_allclose(U.numpy(), np.swapaxes(U.numpy(), -2, -1).conj(), atol=1e-5)


@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
def test_weighted_covariance_wrapper_takes_plain_on_cpu(per_bin):
    rng = np.random.default_rng(1)
    M, I, T, N = SHAPES[0]
    X = planar_to_complex(_planar(rng, (M, I, T)))
    phi = torch.from_numpy(_weights(rng, N, I, T, per_bin))
    before = K.weighted_covariance.launches
    torch.testing.assert_close(K.weighted_covariance(X, phi), K.weighted_covariance_plain(X, phi))
    assert K.weighted_covariance.launches == before  # plain calls are not launches


# ---- IP1 sweep ---------------------------------------------------------------


def _sweep_inputs(rng, M, I, T):
    """Near-identity W and Hermitian PSD U with bin 5 zeroed (a silent bin).

    W stays near the identity, as on the IP trajectory (which starts at
    W = I): pivot-free elimination is only as stable as its leading pivots.
    """
    Xs = _planar(rng, (M, I, T))
    phi = _weights(rng, M, I, T, per_bin=False)
    U = K.weighted_covariance_plain(planar_to_complex(Xs), torch.from_numpy(phi))
    U[5] = 0
    W = np.eye(M)[None] + 0.1 * (rng.standard_normal((I, M, M)) + 1j * rng.standard_normal((I, M, M)))
    return torch.from_numpy(W.astype(np.complex64)), U


@pytest.mark.parametrize("solve_impl", ["lu", "gjnp"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ip1_sweep_plain_matches_jax(shape, solve_impl):
    M, I, T, _ = shape
    W, U = _sweep_inputs(np.random.default_rng(2), M, I, T)
    Ws, Us = complex_to_planar(W), complex_to_planar(U)

    Wr, Wi = ip1_sweep_sc(
        jnp.asarray(Ws[0]), jnp.asarray(Ws[1]), jnp.asarray(Us[0]), jnp.asarray(Us[1]),
        eps=1e-10, solve_impl=solve_impl,
    )
    got = K.ip1_sweep_plain(W, U, eps=1e-10, solve_impl=solve_impl)

    ref = np.stack([np.asarray(Wr), np.asarray(Wi)])
    assert _rel_err(complex_to_planar(got), ref) <= 1e-4
    assert torch.isfinite(torch.view_as_real(got)).all()
    # the zero bin: every row frozen, nothing NaN
    torch.testing.assert_close(got[5], W[5], rtol=0, atol=0)


def test_ip1_sweep_wrapper_takes_lu_on_cpu():
    W, U = _sweep_inputs(np.random.default_rng(3), 3, 17, 50)
    before = K.ip1_sweep.launches
    torch.testing.assert_close(K.ip1_sweep(W, U), K.ip1_sweep_plain(W, U, solve_impl="lu"))
    assert K.ip1_sweep.launches == before


def test_gauss_jordan_nopivot_solves_and_floors_complex128():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 4, 4)) + 1j * rng.standard_normal((6, 4, 4)) + 4 * np.eye(4)
    b = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    x = K.gauss_jordan_solve_nopivot(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b[..., None])[..., 0], rtol=1e-10)
    # a zero system gives large but finite values, never NaN
    x0 = K.gauss_jordan_solve_nopivot(torch.zeros(2, 3, 3, dtype=torch.complex128), torch.from_numpy(b[:2, :3]))
    assert torch.isfinite(torch.view_as_real(x0)).all() and x0.abs().max() > 1e15


def test_ip1_sweep_plain_rejects_unknown_solver():
    W, U = _sweep_inputs(np.random.default_rng(5), 3, 17, 50)
    with pytest.raises(ValueError, match="solve_impl"):
        K.ip1_sweep_plain(W, U, solve_impl="cholesky")


# ---- ISS1 sweep --------------------------------------------------------------


def _iss1_inputs(rng, N, I, T, per_bin):
    """Y with bin 3 zeroed (a silent bin) and positive weights ``(N, T)`` or ``(N, I, T)``."""
    Ys = _planar(rng, (N, I, T))
    Ys[:, :, 3] = 0
    return Ys, _weights(rng, N, I, T, per_bin)


@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
@pytest.mark.parametrize("shape", [(3, 17, 50), (8, 16, 40)])  # (N, I, T)
@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_iss1_sweep_plain_matches_jax(shape, per_bin, impl):
    N, I, T = shape
    Ys, phi = _iss1_inputs(np.random.default_rng(20), N, I, T, per_bin)
    # the JAX sweep takes the IVA weights broadcastable, as (N, 1, T)
    phi_jax = phi if per_bin else phi[:, None, :]
    Yr, Yi = iss1_sweep_sc(
        jnp.asarray(Ys[0]), jnp.asarray(Ys[1]), jnp.asarray(phi_jax), eps=1e-6, impl=impl
    )
    got = K.iss1_sweep_plain(planar_to_complex(Ys), torch.from_numpy(phi), eps=1e-6)

    assert got.shape == (N, I, T) and got.dtype == torch.complex64
    assert _rel_err(complex_to_planar(got), np.stack([np.asarray(Yr), np.asarray(Yi)])) <= 1e-5
    # the silent bin stays zero and finite
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert torch.count_nonzero(got[:, 3]) == 0


@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
def test_iss1_sweep_wrapper_takes_plain_on_cpu(per_bin):
    Ys, phi = _iss1_inputs(np.random.default_rng(21), 3, 17, 50, per_bin)
    Y, phi = planar_to_complex(Ys), torch.from_numpy(phi)
    before = K.iss1_sweep.launches
    torch.testing.assert_close(K.iss1_sweep(Y, phi, eps=1e-6), K.iss1_sweep_plain(Y, phi, eps=1e-6))
    assert K.iss1_sweep.launches == before


def test_iss1_sweep_plain_is_the_sequential_rank_one_update_complex128():
    """Source by source against a numpy loop over bins, in complex128."""
    rng = np.random.default_rng(22)
    N, I, T = 3, 5, 30
    Y0 = rng.standard_normal((N, I, T)) + 1j * rng.standard_normal((N, I, T))
    phi = rng.random((N, I, T)) + 0.1
    Y = Y0.copy()
    for n in range(N):
        y_n = Y[n].copy()
        for i in range(I):
            denom = np.maximum(np.mean(phi[:, i] * np.abs(y_n[i]) ** 2, axis=-1), 1e-10)
            v = np.mean(phi[:, i] * Y[:, i] * y_n[i].conj(), axis=-1) / denom
            v[n] = 1 - 1 / np.sqrt(denom[n])
            Y[:, i] -= v[:, None] * y_n[i]
    got = K.iss1_sweep_plain(torch.from_numpy(Y0), torch.from_numpy(phi))
    np.testing.assert_allclose(got.numpy(), Y, rtol=1e-12, atol=1e-12)


def test_iss1_sweep_kernel_rejects_what_it_does_not_take():
    Y = torch.zeros((3, 17, 50), dtype=torch.complex64, device="meta")
    phi = torch.zeros((3, 50), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="complex64"):
        K.iss1_sweep(Y.to(torch.complex128), phi)
    with pytest.raises(ValueError, match="float32"):
        K.iss1_sweep(Y, phi.to(torch.float64))
    with pytest.raises(ValueError, match="does not match"):
        K.iss1_sweep(Y, torch.zeros((3, 16, 50), dtype=torch.float32, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        K.iss1_sweep(Y.transpose(1, 2), torch.zeros((3, 17), dtype=torch.float32, device="meta"))
    with pytest.raises(ValueError, match="sources"):
        K.iss1_sweep(
            torch.zeros((17, 2, 5), dtype=torch.complex64, device="meta"),
            torch.zeros((17, 5), dtype=torch.float32, device="meta"),
        )


def test_iss1_sweep_keeps_a_bin_resident_while_it_fits():
    # main path: 8 x 626 frames with per-bin weights is 60 KB of the 227 KB;
    # 3,200 bytes of header, then 12 bytes (per-bin) or 8 per source and frame
    assert K.iss1_sweep_resident(8, 626, per_bin=True)
    assert K.iss1_sweep_resident(8, 2388, per_bin=True)
    assert not K.iss1_sweep_resident(8, 2389, per_bin=True)
    assert K.iss1_sweep_resident(8, 3582, per_bin=False)
    assert not K.iss1_sweep_resident(8, 3583, per_bin=False)


# ---- batched Hermitian inverse (K3) ------------------------------------------


def _hermitian_pd(rng, batch, m, dtype=np.complex64):
    """Well-conditioned Hermitian positive definite ``(batch, m, m)``: ``A A^H / m + I``."""
    A = rng.standard_normal((batch, m, m)) + 1j * rng.standard_normal((batch, m, m))
    return (A @ A.conj().swapaxes(-1, -2) / m + np.eye(m)).astype(dtype)


@pytest.mark.parametrize("impl", ["interpret", "cinv"])
@pytest.mark.parametrize("m", [4, 5, 17])
def test_gj_inverse_plain_matches_jax(m, impl):
    """The plain version against the Pallas kernel in interpret mode and the XLA ``_cinv``, float32.

    Both JAX forms eliminate on the real 2m x 2m embedding, the plain
    version on the complex m x m system, in the same pivot-free order: the
    sums differ in order and rounding only, well inside 1e-6 relative to
    max |R^-1| on these well-conditioned systems.
    """
    rng = np.random.default_rng(30 + m)
    R = _hermitian_pd(rng, 6, m)
    Rr, Ri = jnp.asarray(R.real), jnp.asarray(R.imag)
    if impl == "interpret":
        ref = planar_inverse_sc(Rr, Ri, impl="interpret")
    else:
        ref = _cinv(Rr, Ri, impl="gjnp")
    ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    got = K.gj_inverse_plain(torch.from_numpy(R))
    assert got.dtype == torch.complex64 and got.shape == R.shape
    assert _rel_err(got.numpy(), ref) <= 1e-6
    before = K.gj_inverse.launches
    assert torch.equal(K.gj_inverse(torch.from_numpy(R)), got)
    assert K.gj_inverse.launches == before


def test_gj_inverse_plain_floors_a_zero_system_as_the_kernel_does():
    """Every pivot of a zero system floors to 1e-20: the inverse is 1e20 I, finite."""
    out = K.gj_inverse_plain(torch.zeros((3, 5, 5), dtype=torch.complex64))
    assert torch.equal(out, (1 / torch.tensor(1e-20, dtype=torch.float32)) * torch.eye(5, dtype=torch.complex64).expand(3, 5, 5))


@pytest.mark.parametrize("m", [1, 17, 32])
def test_gj_inverse_kernel_takes_m_up_to_32(m):
    """At m <= 32 every check of the wrapper passes but the device's (the CPU tensor is the last check)."""
    R = torch.zeros((4, m, m), dtype=torch.complex64)
    assert K.gj_inverse_takes(m)
    with pytest.raises(ValueError, match="all CUDA tensors"):
        K._check_gj_inverse(R)


def test_gj_inverse_kernel_rejects_what_it_does_not_take():
    R = torch.zeros((4, 33, 33), dtype=torch.complex64)
    assert not K.gj_inverse_takes(33) and not K.gj_inverse_takes(0)
    with pytest.raises(ValueError, match="1 <= m <= 32, got m=33"):
        K._check_gj_inverse(R)
    R4 = torch.zeros((4, 4, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        K._check_gj_inverse(R4.to(torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        K._check_gj_inverse(R4.mT)
    with pytest.raises(ValueError, match=r"\(\.\.\., m, m\)"):
        K._check_gj_inverse(R4[:, :3])
    with pytest.raises(ValueError, match="CUDA"):
        K.gj_inverse(R4.to("meta"))


# ---- routes by shape beyond the kernels' sizes ---------------------------------------


@pytest.fixture
def no_kernel(monkeypatch):
    """Every kernel wrapper raises if it is called: a route by shape must not reach them."""
    for name in ("jacobi_eigh", "gj_inverse", "inv_sandwich", "model_traces"):

        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} called beyond its size")

        monkeypatch.setattr(K, name, refuse)


@pytest.mark.parametrize("n", [34, 66])
def test_symm_eigh_above_the_jacobi_kernel_takes_torch_eigh(n, no_kernel):
    """float32 above n = 32 goes to ``torch.linalg.eigh`` (in batches), never to K7, whose checks refuse it."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((3, n, n)).astype(np.float32)
    S = torch.from_numpy(A + A.swapaxes(-1, -2))
    assert not K.jacobi_eigh_takes(n)
    with pytest.raises(ValueError, match="2 <= n <= 32"):
        K._check_jacobi_eigh(S)
    lamb, V = prox_steps.symm_eigh(S)
    assert lamb.shape == (3, n) and V.shape == (3, n, n) and lamb.dtype == torch.float32
    recon = (V * lamb[..., None, :]) @ V.mT
    assert float((recon - S).abs().max()) <= 1e-4 * float(lamb.abs().max())
    # the embedded complex eigh at m = n / 2 takes the same route
    Ac = rng.standard_normal((2, n // 2, n // 2)) + 1j * rng.standard_normal((2, n // 2, n // 2))
    H = torch.from_numpy((Ac @ Ac.conj().swapaxes(-1, -2)).astype(np.complex64))
    lamb2, _ = prox_steps.herm_eigh_embed(H)
    want = np.linalg.eigvalsh(H.numpy().astype(np.complex128))
    np.testing.assert_allclose(lamb2.numpy()[:, 0::2], want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_sandwich_and_fused_pass_above_their_kernels_take_inv_ex(no_kernel):
    """K4 and K5 take m <= 16 (and K5 one block's shared memory): above, the step's routes are ``inv_ex`` and ``matmul``."""
    rng = np.random.default_rng(40)
    R, C = _hermitian_pd(rng, 5, 17), _hermitian_pd(rng, 5, 17)
    assert not K.inv_sandwich_takes(17) and K.inv_sandwich_takes(16)
    R_inv, S = mnmf_steps._inv_sandwich(torch.from_numpy(R), torch.from_numpy(C))
    R_inv_ref = np.linalg.inv(R.astype(np.complex128))
    assert _rel_err(R_inv.numpy(), R_inv_ref) <= 1e-5
    assert _rel_err(S.numpy(), R_inv_ref @ C @ R_inv_ref) <= 1e-5
    assert not mnmf_steps._fused(torch.complex64, "ridge", 8, 17)
    assert not mnmf_steps._fused(torch.complex64, "ridge", 40, 16)  # one block's shared memory
    assert mnmf_steps._fused(torch.complex64, "ridge", 8, 16) and K.model_traces_takes(8, 16)
    assert not mnmf_steps._fused(torch.complex128, "ridge", 8, 8)


def test_hermitian_inverse_takes_k3_up_to_32_then_inv_ex(monkeypatch):
    rng = np.random.default_rng(41)
    calls = []
    monkeypatch.setattr(K, "gj_inverse", lambda R: calls.append(R.shape[-1]) or K.gj_inverse_plain(R))
    for m in (4, 17, 32, 33):
        R = _hermitian_pd(rng, 3, m)
        got = ipsdta_steps.hermitian_inverse(torch.from_numpy(R))
        assert _rel_err(got.numpy(), np.linalg.inv(R.astype(np.complex128))) <= 1e-5
    got = ipsdta_steps.hermitian_inverse(torch.from_numpy(_hermitian_pd(rng, 3, 4, np.complex128)))
    assert got.dtype == torch.complex128
    assert calls == [4, 17, 32]


# ---- dispatch: no silent fallback -------------------------------------------


def test_cuda_tensor_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the kernel path is tested by the cuda tests")
    rng = np.random.default_rng(6)
    X = planar_to_complex(_planar(rng, (3, 17, 50)))
    phi = torch.from_numpy(_weights(rng, 3, 17, 50, per_bin=False))
    with pytest.raises((RuntimeError, AssertionError)):
        K.weighted_covariance(X.to("cuda"), phi.to("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        K.iss1_sweep(X.to("cuda"), phi.to("cuda"))


@pytest.mark.parametrize("wrapper", ["weighted_covariance", "ip1_sweep", "iss1_sweep"])
def test_non_cpu_tensor_goes_to_the_kernel_checks_not_the_plain_version(wrapper):
    rng = np.random.default_rng(7)
    if wrapper == "ip1_sweep":
        args = _sweep_inputs(rng, 3, 17, 50)
    else:
        args = (
            planar_to_complex(_planar(rng, (3, 17, 50))),
            torch.from_numpy(_weights(rng, 3, 17, 50, per_bin=False)),
        )
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(K, wrapper)(*meta)
    mixed = [args[0].to("meta"), args[1]]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(K, wrapper)(*mixed)


@pytest.mark.parametrize(
    "X_dtype,phi_shape,message",
    [
        (torch.complex128, (3, 50), "complex64"),
        (torch.complex64, (3, 49), "does not match"),
        (torch.complex64, (3, 16, 50), "does not match"),
    ],
)
def test_weighted_covariance_kernel_rejects_what_it_does_not_take(X_dtype, phi_shape, message):
    X = torch.zeros((3, 17, 50), dtype=X_dtype, device="meta")
    phi = torch.zeros(phi_shape, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match=message):
        K.weighted_covariance(X, phi)


def test_ip1_sweep_kernel_rejects_what_it_does_not_take():
    W = torch.zeros((17, 3, 3), dtype=torch.complex64, device="meta")
    U = torch.zeros((17, 3, 3, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="square"):
        K.ip1_sweep(torch.zeros((17, 2, 3), dtype=torch.complex64, device="meta"), U)
    with pytest.raises(ValueError, match="contiguous"):
        K.ip1_sweep(W.transpose(1, 2), U)
    with pytest.raises(ValueError, match="shared memory"):
        K.ip1_sweep(
            torch.zeros((4, 32, 32), dtype=torch.complex64, device="meta"),
            torch.zeros((4, 32, 32, 32), dtype=torch.complex64, device="meta"),
        )


# ---- build ---------------------------------------------------------------------


def test_build_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("weighted_covariance")


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: deliberately broken toolchain' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="deliberately broken toolchain"):
        _build.load("ip1_sweep")
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_every_kernel_source_exists_for_its_wrapper():
    assert set(K._SIGNATURES) == {
        "weighted_covariance", "ip1_sweep", "iss1_sweep", "jacobi_eigh", "ipa_congruence", "gj_inverse",
        "inv_sandwich", "model_traces"
    }
    for name in K._SIGNATURES:
        assert hasattr(getattr(K, name), "launches")
        assert os.path.isfile(os.path.join(_build.SOURCE_DIR, f"{K.source_of(name)}.cu"))
    assert K.source_of("model_traces") == "mnmf_model_traces"


def test_an_edited_shared_header_rebuilds_every_kernel(monkeypatch, tmp_path):
    """The build hash covers csrc/*.cuh, which the sources include, as well as the source itself."""
    source = tmp_path / "k.cu"
    source.write_text("// kernel\n")
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", str(tmp_path))
    first = _build._digest(str(source))
    header.write_text("// two\n")
    assert _build._digest(str(source)) != first


def test_import_pulls_in_no_jax():
    code = (
        "import sys, ssspy_tpu_torch, ssspy_tpu_torch.bss.iva, ssspy_tpu_torch.fast, "
        "ssspy_tpu_torch.pipeline, ssspy_tpu_torch.utils.convert, ssspy_tpu_torch.bss.hva, "
        "ssspy_tpu_torch.ops.prox_steps, ssspy_tpu_torch.linalg.prox, ssspy_tpu_torch.ops.ipa_steps, "
        "ssspy_tpu_torch.linalg.lqpqm, ssspy_tpu_torch.special.psd, ssspy_tpu_torch.bss.mnmf, "
        "ssspy_tpu_torch.ops.mnmf_steps, ssspy_tpu_torch.ops.ipsdta_steps, ssspy_tpu_torch.bss.ipsdta, "
        "ssspy_tpu_torch.parallel, ssspy_tpu_torch.parallel.collectives, ssspy_tpu_torch.parallel.dryrun, "
        "ssspy_tpu_torch.io, ssspy_tpu_torch.native, ssspy_tpu_torch.bss._update_spatial_model, ssspy_tpu_torch.linalg, "
        "ssspy_tpu_torch.utils.checkpoint, ssspy_tpu_torch.utils.profiling\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ssspy_tpu.')) "
        "or m == 'ssspy_tpu')\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


# ---- the launch geometry and sizes of K5 and K7 ------------------------------------------


def _pr6_model_traces_smem(n_sources, m):
    """Shared memory of one K5 block as the one-block-per-bin kernel sized it, the bound of its size contract."""
    frames = 8 * (32 // m)
    return (n_sources * (3 * m * m + 1) + frames * m * (3 * m + 1)) * 8 + 4 * n_sources * frames


@pytest.mark.parametrize("m", range(1, 17))
def test_model_traces_takes_every_size_it_took(m):
    """``model_traces_takes`` accepts exactly the (N, m) that fit one block of the single-buffered kernel."""
    for n_sources in range(1, 65):
        assert K.model_traces_takes(n_sources, m) == (_pr6_model_traces_smem(n_sources, m) <= 232448)
    assert not K.model_traces_takes(1, 17) and not K.model_traces_takes(1, 0)


def test_jacobi_eigh_takes_every_n_from_2_to_32():
    assert [n for n in range(0, 40) if K.jacobi_eigh_takes(n)] == list(range(2, 33))


def test_model_traces_geometry_at_the_main_path():
    """(N, I, T, m) = (8, 257, 626, 8): tiles of 32 frames, chunks of 3 tiles, 257 x 7 blocks, two buffers."""
    geometry = K.model_traces_geometry(8, 257, 626, 8)
    # per source H in 8 rows of 9 (+1), P and Q; per frame R^-1 in 8 rows of 9 (+1); two buffers of XX (64 + 1)
    # per frame and Lamb
    smem = (8 * (8 * 9 + 1 + 2 * 64) + 32 * (8 * 9 + 1) + 2 * 32 * 65) * 8 + 2 * 8 * 32 * 4
    assert geometry == {
        "frames_per_tile": 32, "chunk": 96, "chunks": 7, "stages": 2, "smem_bytes": smem,
        "workspace": (2, 8, 257, 7, 8, 8),
    }
    assert smem == 66880 and 2 * smem <= 228 * 1024  # two blocks fit an SM


@pytest.mark.parametrize("m", range(1, 17))
def test_model_traces_kernel_fits_every_size_it_takes(m):
    """The single-buffered layout is never larger than the size contract, so whatever ``takes`` accepts fits."""
    for n_sources in range(1, 400):
        if K.model_traces_takes(n_sources, m):
            assert K.model_traces_smem_bytes(n_sources, m, 1) <= 232448


@pytest.mark.parametrize(
    "shape,chunk,chunks,stages",
    [
        ((8, 257, 1, 8), 32, 1, 2),  # one frame: one chunk of one tile
        ((8, 1, 626, 8), 32, 20, 2),  # one bin: a chunk per tile
        ((3, 5, 37, 4), 64, 1, 2),  # fewer frames than a tile
        ((21, 3, 40, 16), 16, 3, 1),  # the largest N at m = 16: two buffers do not fit
        ((2, 4, 130, 5), 48, 3, 2),  # 6 groups of 5 threads to a warp
    ],
)
def test_model_traces_geometry_edges(shape, chunk, chunks, stages):
    N, I, T, m = shape
    geometry = K.model_traces_geometry(N, I, T, m)
    assert (geometry["chunk"], geometry["chunks"], geometry["stages"]) == (chunk, chunks, stages)
    assert geometry["chunk"] % geometry["frames_per_tile"] == 0 and (chunks - 1) * chunk < T <= chunks * chunk
    assert geometry["smem_bytes"] == K.model_traces_smem_bytes(N, m, stages) <= 232448
    assert geometry["workspace"] == (2, N, I, chunks, m, m)


@pytest.mark.parametrize("outputs", ["traces", "sums"])
def test_model_traces_outputs_are_the_full_form_halves(outputs):
    rng = np.random.default_rng(31)
    N, I, T, m = 3, 4, 21, 4
    A = rng.standard_normal((2, N, I, m, m)) + 1j * rng.standard_normal((2, N, I, m, m))
    H = torch.from_numpy((A[0] @ A[0].conj().swapaxes(-1, -2)).astype(np.complex64))
    B = rng.standard_normal((I, T, m)) + 1j * rng.standard_normal((I, T, m))
    XX = torch.from_numpy((B[..., :, None] * B[..., None, :].conj()).astype(np.complex64))
    Lamb = torch.from_numpy(rng.random((N, I, T)).astype(np.float32) + 0.1)
    full = K.model_traces_plain(Lamb, H, XX, 1e-6)
    part = K.model_traces_plain(Lamb, H, XX, 1e-6, outputs=outputs)
    want = full[:2] if outputs == "traces" else full[2:]
    assert len(part) == 2 and all(torch.equal(g, w) for g, w in zip(part, want))
    # on the CPU the wrapper takes the plain version, outputs and all, and launches nothing
    before = K.model_traces.launches
    assert all(torch.equal(g, w) for g, w in zip(K.model_traces(Lamb, H, XX, 1e-6, outputs=outputs), want))
    assert K.model_traces.launches == before
    with pytest.raises(ValueError, match="unknown outputs"):
        K.model_traces_plain(Lamb, H, XX, outputs="t1")


def _rr_position(span, r, x):
    """csrc/jacobi_eigh.cu:rr_position."""
    return 0 if x == 0 else 1 + (x - 1 + r) % span


def _rr_player(span, r, k):
    """csrc/jacobi_eigh.cu:rr_player (Python's % is C's for the non-negative operands it gets)."""
    return 0 if k == 0 else 1 + (k - 1 - r) % span


@pytest.mark.parametrize("n", range(2, 33))
def test_jacobi_kernel_schedule_is_the_partner_table(n):
    """The kernel's closed-form round robin (positions, players, partners) against ``partner_table``."""
    span = n + n % 2 - 1
    table = K.partner_table(n).tolist()
    assert len(table) == span
    for r, partners in enumerate(table):
        assert sorted(_rr_player(span, r, k) for k in range(span + 1)) == list(range(span + 1))
        for x in range(n):
            pos = _rr_position(span, r, x)
            assert _rr_player(span, r, pos) == x
            y = _rr_player(span, r, span - pos)
            assert (x if y >= n else y) == partners[x]
        # the registers of the even-n kernel move one position per round, back in order after a sweep
        order = [_rr_player(span, r, k) for k in range(span + 1)]
        nxt = [_rr_player(span, (r + 1) % span, k) for k in range(span + 1)]
        assert nxt == [order[0], order[-1]] + order[1:-1]


# ---- the launch geometry and sizes of K1 and K3 ------------------------------------------

SMEM_BLOCK_MAX = 232448  # dynamic shared memory of one block on sm_90


def _first_weighted_covariance_takes(M, N):
    """The size contract of the first covariance kernel: one thread per entry (8 at most), 128 padded frames in 48 KB."""
    return N * M * (M + 1) // 2 <= 1024 * 8 and (2 * M + N) * 129 * 4 <= 48 * 1024


def _cu_constants(name):
    """``constexpr int kName = value;`` of ``csrc/<name>.cu``, as a dict."""
    with open(os.path.join(_build.SOURCE_DIR, f"{name}.cu")) as f:
        source = f.read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}


@pytest.mark.parametrize("M", range(1, 49))
def test_weighted_covariance_takes_every_size_it_took(M):
    """``weighted_covariance_takes`` accepts exactly the (M, N) of the first kernel's contract."""
    for N in range(1, 129):
        assert K.weighted_covariance_takes(M, N) == _first_weighted_covariance_takes(M, N)
    assert not K.weighted_covariance_takes(M, 0) and not K.weighted_covariance_takes(0, 1)


def test_weighted_covariance_geometry_mirrors_the_kernel():
    """The Python geometry reads the kernel's constants."""
    cu = _cu_constants("weighted_covariance")
    assert (cu["kSources"], cu["kPairs"], cu["kTileFrames"], cu["kStages"], cu["kMaxWarps"], cu["kWarpSize"],
            cu["kSmemMax"]) == (K._WCOV_SOURCES, K._WCOV_PAIRS, K._WCOV_TILE_FRAMES, K._WCOV_STAGES,
                                K._WCOV_MAX_WARPS, 32, SMEM_BLOCK_MAX)
    assert cu["kMainWarps"] == K.weighted_covariance_geometry(8, 8, 257, 626)["warps"]


def test_weighted_covariance_geometry_at_the_main_path():
    """(M, N, I, T) = (8, 8, 257, 626): 10 tiles of 2 x 2 pairs, a warp each, one block per bin, 5 frame tiles."""
    geometry = K.weighted_covariance_geometry(8, 8, 257, 626)
    # three buffers of 128 frames: X in 10 complex64 (8 and a 16-byte pad), phi in 12 float32 (8 and a pad)
    smem = 3 * 128 * (10 * 8 + 12 * 4)
    assert geometry == {
        "tiles": 10, "items": 10, "warps": 10, "passes": 1, "threads": 320, "grid": (257,),
        "frame_tiles": 5, "x_row": 10, "w_row": 12, "smem_bytes": smem,
    }
    assert smem == 49152 and 2 * smem <= 228 * 1024  # two blocks fit an SM


def _tile_pairs(M):
    """The channel pairs (p, q), p <= q < M, that the kernel's 2 x 2 tiles write, tile by tile."""
    half = -(-M // 2)
    tiles = [(a, b) for a in range(half) for b in range(a, half)]
    return [(2 * a + j // 2, 2 * b + j % 2) for a, b in tiles for j in range(4)
            if 2 * b + j % 2 < M and 2 * a + j // 2 <= 2 * b + j % 2]


@pytest.mark.parametrize("M", range(1, 48))
def test_weighted_covariance_tiles_write_every_pair_once(M):
    """The 2 x 2 tiles cover the upper triangle (diagonal included) exactly once; padded and mirrored pairs are skipped."""
    pairs = _tile_pairs(M)
    assert sorted(pairs) == [(p, q) for p in range(M) for q in range(p, M)]
    assert K.weighted_covariance_geometry(M, 1, 1, 1)["tiles"] == -(-M // 2) * (-(-M // 2) + 1) // 2


@pytest.mark.parametrize("M", range(1, 17))
def test_weighted_covariance_kernel_fits_every_size_it_takes(M):
    """Every (M, N) the contract takes fits one block: shared memory, warps, passes over the items."""
    for N in range(1, 17):
        if not K.weighted_covariance_takes(M, N):
            continue
        geometry = K.weighted_covariance_geometry(M, N, 257, 626)
        assert geometry["smem_bytes"] <= SMEM_BLOCK_MAX
        assert 1 <= geometry["warps"] <= K._WCOV_MAX_WARPS and geometry["threads"] == 32 * geometry["warps"]
        assert geometry["warps"] * geometry["passes"] >= geometry["items"] > geometry["warps"] * (geometry["passes"] - 1)
        assert geometry["items"] == geometry["tiles"] * -(-N // 8)
        # odd counts of 16-byte words per staged frame: a quarter-warp's eight frames in distinct banks
        assert (geometry["x_row"] // 2) % 2 == 1 and (geometry["w_row"] // 4) % 2 == 1
        assert geometry["x_row"] >= M and geometry["w_row"] >= N


def test_weighted_covariance_kernel_fits_the_whole_contract():
    """Over every (M, N) the contract takes (M <= 47, N <= 93): the largest block still fits."""
    sizes = [(M, N) for M in range(1, 60) for N in range(1, 120) if K.weighted_covariance_takes(M, N)]
    geometries = {size: K.weighted_covariance_geometry(*size, 3, 129) for size in sizes}
    assert max(M for M, _ in sizes) == 47 and max(N for _, N in sizes) == 93
    assert max(g["smem_bytes"] for g in geometries.values()) <= SMEM_BLOCK_MAX
    # the most work items: 231 tiles x 2 source groups, 29 passes of 16 warps
    assert max(geometries, key=lambda s: geometries[s]["items"]) == (41, 9)
    assert geometries[(41, 9)]["items"] == 462 and geometries[(41, 9)]["passes"] == 29


@pytest.mark.parametrize("T", [1, 127, 128, 129, 626, 5000])
def test_weighted_covariance_frame_schedule_covers_the_frames(T):
    """The frame tiles and, within each, the 32 lanes' frames cover the T frames with no gap or overlap."""
    geometry = K.weighted_covariance_geometry(8, 8, 257, T)
    tile = K._WCOV_TILE_FRAMES
    frames = [k * tile + tt for k in range(geometry["frame_tiles"]) for lane in range(32)
              for tt in range(lane, min(tile, T - k * tile), 32)]
    assert sorted(frames) == list(range(T))
    assert (geometry["frame_tiles"] - 1) * tile < T <= geometry["frame_tiles"] * tile


def test_gj_inverse_takes_every_m_it_took():
    assert [m for m in range(0, 40) if K.gj_inverse_takes(m)] == list(range(1, 33))


@pytest.mark.parametrize("m", range(1, 33))
def test_gj_inverse_instance_serving_each_m(m):
    """m <= 8: one thread per system, staged at an odd stride; 9 <= m <= 32: a group of m threads per system."""
    geometry = K.gj_inverse_geometry(315504, m)
    assert geometry["smem_bytes"] <= 48 * 1024  # static shared memory, or dynamic without the opt-in
    assert geometry["blocks"] * geometry["systems_per_block"] >= 315504 > (geometry["blocks"] - 1) * geometry["systems_per_block"]
    if m <= 8:
        assert geometry["instance"] == "system"
        assert geometry["threads"] == geometry["systems_per_block"] == (128 if m <= 6 else 64)
        # each thread's system at an odd stride of complex64: a half-warp's 16 systems in 16 bank pairs
        stride = m * m | 1
        assert stride % 2 == 1 and len({(2 * stride * t) % 32 for t in range(16)}) == 16
        assert geometry["smem_bytes"] == geometry["systems_per_block"] * stride * 8
    else:
        assert geometry["instance"] == "rows"
        warps = 2 if m > 16 else 4
        assert geometry["threads"] == 32 * warps and geometry["systems_per_block"] == warps * (32 // m)
    with pytest.raises(ValueError, match="1 <= m <= 32"):
        K.gj_inverse_geometry(4, 33)


def test_gj_inverse_geometry_at_the_ipsdta_timing_shape():
    """IPSDTA's two parts: 315,504 systems of 4 x 4 and 5,008 of 5 x 5, 128 systems a block."""
    assert K.gj_inverse_geometry(8 * 626 * 63, 4) == {
        "instance": "system", "systems_per_block": 128, "threads": 128, "blocks": 2465, "smem_bytes": 128 * 17 * 8}
    assert K.gj_inverse_geometry(8 * 626, 5) == {
        "instance": "system", "systems_per_block": 128, "threads": 128, "blocks": 40, "smem_bytes": 128 * 25 * 8}


# ---- the sweep kernels' variants (K1b, K2) -------------------------------------

# frame counts around every boundary: the register variant's (1,280 at N = 8), the
# resident variant's (2,388 per-bin and 3,582 (N, T) weights at N = 8) and the streamed case
ISS1_FRAMES = (1, 31, 255, 256, 257, 626, 1280, 1281, 2388, 2389, 3582, 3583, 4000)


def _first_ip1_sweep_takes(M):
    """The size contract of the first IP1 sweep kernel: a bin's U, W and [A | e_n] in 48 KB of shared memory."""
    L = M + 1
    return M >= 1 and (M**3 + M * M + M * L + L + 2 * M) * 8 <= 48 * 1024


def test_ip1_sweep_takes_every_size_it_took():
    took = [M for M in range(0, 40) if _first_ip1_sweep_takes(M)]
    assert [M for M in range(0, 40) if K.ip1_sweep_takes(M)] == took == list(range(1, 18))
    with pytest.raises(ValueError, match="1 <= M <= 17"):
        K.ip1_sweep_variant(18)


@pytest.mark.parametrize("M", range(1, 18))
def test_ip1_sweep_variant_serving_each_m(M):
    """M <= 8: a group of lanes per bin (a power of two), its U staged so that a half-warp's groups hit distinct banks."""
    cu = _cu_constants("ip1_sweep")
    assert cu["kWarpMaxM"] == K._IP1_WARP_MAX_M == 8
    variant = K.ip1_sweep_variant(M)
    assert variant == ("warp" if M <= 8 else "block")
    if variant == "warp":
        width = 1 << (M - 1).bit_length()
        assert M <= width <= 8
        stride = M**3 + 2 if M % 2 == 0 else M**3  # complex64; even where 16-byte copies stage it
        assert (32 // width) * stride * 8 <= 48 * 1024  # static shared memory of one block
        groups = 16 // width  # in a half-warp, each reading one complex64 (a pair of banks)
        assert len({(g * stride) % 16 for g in range(groups)}) == groups


@pytest.mark.parametrize("solve_impl", ["lu", "gjnp"])
@pytest.mark.parametrize("shape", [(1, 9, 7), (5, 9, 31)], ids=["M1", "M5_T31"])  # (M, I, T)
def test_ip1_sweep_plain_matches_jax_at_the_edges(shape, solve_impl):
    """One source, and an odd M whose group leaves lanes idle; bin 5 silent."""
    M, I, T = shape
    W, U = _sweep_inputs(np.random.default_rng(23), M, I, T)
    Ws, Us = complex_to_planar(W), complex_to_planar(U)
    Wr, Wi = ip1_sweep_sc(
        jnp.asarray(Ws[0]), jnp.asarray(Ws[1]), jnp.asarray(Us[0]), jnp.asarray(Us[1]),
        eps=1e-10, solve_impl=solve_impl,
    )
    got = K.ip1_sweep_plain(W, U, eps=1e-10, solve_impl=solve_impl)
    assert _rel_err(complex_to_planar(got), np.stack([np.asarray(Wr), np.asarray(Wi)])) <= 1e-4
    torch.testing.assert_close(got[5], W[5], rtol=0, atol=0)


def test_iss1_sweep_register_variant_mirrors_the_kernel():
    """Frames a thread and most warps a bin of the register variant, and the resident variant's header."""
    cu = _cu_constants("iss1_sweep")
    for width in (2, 4, 8, 16):
        assert (K._ISS1_REG_FRAMES[width], K._ISS1_REG_WARPS[width]) == (cu[f"kRegFrames{width}"], cu[f"kRegWarps{width}"])
    assert K._ISS1_HEADER_BYTES == cu["kMaxSources"] * 8 + cu["kMaxThreads"] // 32 * 3 * cu["kMaxSources"] * 4
    assert K._ISS1_MAX_SOURCES == cu["kMaxSources"]


@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
@pytest.mark.parametrize("N", range(1, 17))
def test_iss1_sweep_takes_every_shape_it_took(N, per_bin):
    """Every (N <= 16, T) of the first kernel runs a variant: registers while the template's warps hold the frames,
    then resident while the bin fits 227 KB, then streamed; the register variant's frames cover the bin."""
    width = 2 if N <= 2 else 4 if N <= 4 else 8 if N <= 8 else 16
    frames = K._ISS1_REG_FRAMES[width]
    for T in ISS1_FRAMES:
        variant = K.iss1_sweep_variant(N, T, per_bin)
        warps = K.iss1_sweep_register_warps(N, T)
        assert (warps - 1) * 32 * frames < T <= warps * 32 * frames
        if warps <= K._ISS1_REG_WARPS[width]:
            assert variant == "registers"
        else:
            assert variant == ("resident" if K.iss1_sweep_resident(N, T, per_bin) else "streamed")
        assert variant in K._ISS1_VARIANTS


def test_iss1_sweep_variant_boundaries():
    # N = 8: 10 warps of 4 frames hold T <= 1,280; then the first kernel's boundaries
    assert K.iss1_sweep_variant(8, 1280, True) == "registers" and K.iss1_sweep_variant(8, 1281, True) == "resident"
    assert K.iss1_sweep_variant(8, 2388, True) == "resident" and K.iss1_sweep_variant(8, 2389, True) == "streamed"
    assert K.iss1_sweep_variant(8, 3582, False) == "resident" and K.iss1_sweep_variant(8, 3583, False) == "streamed"
    # N = 9 .. 16: 12 warps of one frame; N <= 4: 16 warps of 4 frames
    assert K.iss1_sweep_variant(16, 384, True) == "registers" and K.iss1_sweep_variant(16, 385, True) == "resident"
    assert K.iss1_sweep_variant(4, 2048, False) == "registers" and K.iss1_sweep_variant(4, 2049, False) == "resident"
    # the main path: 5 warps of 4 frames (640 for 626), either weight layout; chip_smoke's streamed case
    assert K.iss1_sweep_variant(8, 626, False) == K.iss1_sweep_variant(8, 626, True) == "registers"
    assert K.iss1_sweep_register_warps(8, 626) == 5
    assert K.iss1_sweep_variant(8, 4000, False) == K.iss1_sweep_variant(8, 4000, True) == "streamed"


@pytest.mark.parametrize("per_bin", [False, True], ids=["scalar", "per_bin"])
@pytest.mark.parametrize("shape", [(1, 5, 31), (3, 5, 33)], ids=["N1_T31", "N3_T33"])  # (N, I, T)
@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_iss1_sweep_plain_matches_jax_at_the_edges(shape, per_bin, impl):
    """One source and odd frame counts; bin 3 silent."""
    N, I, T = shape
    Ys, phi = _iss1_inputs(np.random.default_rng(24), N, I, T, per_bin)
    Yr, Yi = iss1_sweep_sc(
        jnp.asarray(Ys[0]), jnp.asarray(Ys[1]), jnp.asarray(phi if per_bin else phi[:, None, :]), eps=1e-6, impl=impl
    )
    got = K.iss1_sweep_plain(planar_to_complex(Ys), torch.from_numpy(phi), eps=1e-6)
    assert _rel_err(complex_to_planar(got), np.stack([np.asarray(Yr), np.asarray(Yi)])) <= 1e-5
    assert torch.count_nonzero(got[:, 3]) == 0


# ---- the congruence round (K6) and the inverse sandwich (K4): variants and launch ----------------


# csrc/ipa_congruence.cu's layout functions, as the source writes them; _ipa_layout copies them into Python
_IPA_LAYOUT_SOURCE = (
    "constexpr int row_lanes_most(int n) { return n < kWarpSize / n ? n : kWarpSize / n; }",
    "const int columns = (n + row_lanes_most(n) - 1) / row_lanes_most(n);",
    "return n % 2 == 0 && columns % 2 == 1 && columns > 1 ? columns + 1 : columns;",
    "constexpr int row_lanes(int n) { return (n + lane_columns(n) - 1) / lane_columns(n); }",
    "constexpr bool paired(int n) { return n % 2 == 0 && lane_columns(n) % 2 == 0; }",
    "constexpr int row_stride(int n) { return paired(n) ? (n % 4 == 0 ? n + 2 : n + 4) : (n | 1); }",
    "constexpr int group_lanes(int n) { return n * row_lanes(n); }",
    "constexpr int warp_groups(int n) { return kWarpSize / group_lanes(n); }",
    "__shared__ __align__(16) float2 stage[kBlockWarps][GW * kRegion];",
)


def _ipa_layout(N):
    """csrc/ipa_congruence.cu's layout at ``N``: lanes a row, columns a lane, items a warp, the staged row stride,
    whether a lane's columns go in 16-byte pairs, and a block's static shared memory (T, U and A of each item)."""
    most = min(N, 32 // N)
    columns = -(-N // most)
    columns += N % 2 == 0 and columns % 2 == 1 and columns > 1
    lanes = -(-N // columns)
    paired = N % 2 == 0 and columns % 2 == 0
    stride = (N + 2 if N % 4 == 0 else N + 4) if paired else N | 1
    groups = 32 // (N * lanes)
    return {"row_lanes": lanes, "lane_columns": columns, "items_per_warp": groups, "paired": paired,
            "row_stride": stride, "smem_bytes": _cu_constants("ipa_congruence")["kBlockWarps"] * groups * 3 * N * stride * 8}


def test_ipa_congruence_layout_mirrors_the_kernel():
    """The wrapper's size limit is the kernel's, and the layout functions copied into _ipa_layout are the source's."""
    cu = _cu_constants("ipa_congruence")
    assert (cu["kMaxN"], cu["kWarpSize"], cu["kBlockWarps"]) == (K._IPA_MAX_N, 32, 4)
    with open(os.path.join(_build.SOURCE_DIR, "ipa_congruence.cu")) as f:
        source = f.read()
    assert all(line in source for line in _IPA_LAYOUT_SOURCE)
    assert all(f"case {N}: return launch<{N}>(" in source for N in range(1, K._IPA_MAX_N + 1))


@pytest.mark.parametrize("N", range(1, 17))
def test_ipa_congruence_takes_every_size_it_took(N):
    """Every ``N <= 16`` the first kernel took has an instance whose item lies in one warp, whose lanes cover each
    row once, and whose block's static shared memory fits without an opt-in; at N = 8 four lanes a row."""
    layout = _ipa_layout(N)
    lanes, columns = layout["row_lanes"], layout["lane_columns"]
    assert N * lanes * layout["items_per_warp"] <= 32 and layout["items_per_warp"] >= 1
    assert lanes * columns >= N > (lanes - 1) * columns
    assert layout["row_stride"] >= N and layout["smem_bytes"] <= 48 * 1024
    if layout["paired"]:
        assert columns % 2 == 0 and layout["row_stride"] % 2 == 0  # 16-byte accesses stay aligned
    if N == 8:
        assert (lanes, columns, layout["items_per_warp"], layout["row_stride"]) == (4, 2, 1, 10)


def _quads(rows, stride, column):
    """16-byte bank quads (of 8) of the complex64 pair at ``column`` of each staged row."""
    return [((row * stride + column) * 8 // 16) % 8 for row in rows]


def test_ipa_congruence_reads_on_distinct_banks():
    """The staged rows spread over the banks: where lanes read in 16-byte pairs, eight consecutive rows start on
    eight distinct bank quads (at N = 8, a quarter-warp's reads of rows of T or A, the rows j of T and the column
    pairs of a row of U each on distinct quads); where they read 8 bytes, sixteen consecutive rows start on
    distinct bank pairs."""
    for N in range(1, 17):
        layout = _ipa_layout(N)
        stride = layout["row_stride"]
        if layout["paired"]:
            assert len(set(_quads(range(8), stride, 0))) == 8
        else:
            assert stride % 2 == 1 and len({(row * stride) % 16 for row in range(16)}) == 16
    stride = _ipa_layout(8)["row_stride"]
    for p in range(4):
        for column in range(0, 8, 2):
            assert len(set(_quads((2 * p, 2 * p + 1), stride, column))) == 2
    for column in range(0, 8, 2):
        assert len(set(_quads(range(0, 8, 2), stride, column))) == 4
        assert len(set(_quads(range(1, 8, 2), stride, column))) == 4
    for k in range(8):
        assert len({((k * stride + 2 * q) * 8 // 16) % 8 for q in range(4)}) == 4


# csrc/inv_sandwich.cu's layout functions, as the source writes them; the tests below copy them into Python
_SANDWICH_LAYOUT_SOURCE = (
    "constexpr int group_width(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }",
    "constexpr int stage_stride(int M) { return M * M + ((M - M * M) % 16 + 16) % 16; }",
)


def _sandwich_layout(m):
    """The block csrc/inv_sandwich.cu launches for ``m x m`` systems, from its constants and (in Python) its layout
    functions: lanes a system, systems a warp, the staged stride, threads and shared memory a block."""
    cu = _cu_constants("inv_sandwich")
    if m <= cu["kColumnsMaxM"]:
        lanes = 1 << (m - 1).bit_length()  # group_width
        stride = m * m + (m - m * m) % 16  # stage_stride
        per_warp = 32 // lanes
        smem = cu["kColumnsWarps"] * cu["kStages"] * 2 * per_warp * stride * 8  # R and C of each stage of each warp
        return {"variant": "columns", "lanes": lanes, "systems_per_warp": per_warp, "stage_stride": stride,
                "threads": 32 * cu["kColumnsWarps"], "smem_bytes": smem}
    groups = cu["kRowsWarps"] * (32 // m)
    # each group's [R | I] at gj::stride(m) = 2m + 1 a row, and its C
    return {"variant": "rows", "threads": 32 * cu["kRowsWarps"], "smem_bytes": groups * m * (3 * m + 1) * 8}


def test_inv_sandwich_variant_mirrors_the_kernel():
    """The predicate's boundary is the kernel's, and the layout functions copied here are the source's."""
    cu = _cu_constants("inv_sandwich")
    assert (cu["kMaxM"], cu["kColumnsMaxM"], cu["kWarpSize"]) == (K._SANDWICH_MAX_M, K._SANDWICH_COLUMNS_MAX_M, 32)
    with open(os.path.join(_build.SOURCE_DIR, "inv_sandwich.cu")) as f:
        source = f.read()
    assert all(line in source for line in _SANDWICH_LAYOUT_SOURCE)
    with open(os.path.join(_build.SOURCE_DIR, "gj_inverse.cuh")) as f:
        assert "return 2 * m + 1;" in f.read()  # gj::stride


def test_inv_sandwich_takes_every_m_it_took():
    assert [m for m in range(0, 20) if K.inv_sandwich_takes(m)] == list(range(1, 17))
    assert [K.inv_sandwich_variant(m) for m in range(1, 17)] == ["columns"] * 8 + ["rows"] * 8
    with pytest.raises(ValueError, match="1 <= m <= 16"):
        K.inv_sandwich_variant(17)


def _column_read_wavefronts(m, lanes, stride):
    """Bank wavefronts of a warp's read of row k of every staged system (lane c of group g reads column min(c, m - 1)),
    and the least any layout needs: the most distinct 4-byte words on one bank, and the words over 32."""
    result = []
    for k in range(m):
        words = set()
        for g in range(32 // lanes):
            for c in range(lanes):
                address = 2 * (g * stride + k * m + min(c, m - 1))
                words |= {address, address + 1}
        banks = {}
        for word in words:
            banks.setdefault(word % 32, set()).add(word)
        result.append((max(map(len, banks.values())), -(-len(words) // 32)))
    return result


@pytest.mark.parametrize("m", range(1, 17))
def test_inv_sandwich_variant_serving_each_m(m):
    """m <= 8: the columns variant, its staged systems read on the fewest bank wavefronts; 9 <= m <= 16: the rows
    variant. Either way the block's threads and static or dynamic shared memory fit without an opt-in."""
    layout = _sandwich_layout(m)
    assert layout["variant"] == K.inv_sandwich_variant(m)
    assert layout["threads"] <= 1024 and layout["smem_bytes"] <= 48 * 1024
    if layout["variant"] == "columns":
        lanes, stride = layout["lanes"], layout["stage_stride"]
        assert m <= lanes <= 8 and lanes & (lanes - 1) == 0
        assert stride >= m * m and stride % 16 == m % 16 and stride < m * m + 16
        assert stride % 2 == 0 or m % 2 == 1  # 16-byte copies keep an even stride
        assert all(seen == least for seen, least in _column_read_wavefronts(m, lanes, stride))


# ---- the timing scripts: the profiler helper and chip_smoke's sweep edges ------------------


def _script_tree(path):
    import ast

    with open(os.path.join(REPO, path)) as f:
        source = f.read()
    return source, ast.parse(source)


def _function_source(path, name):
    import ast

    source, tree = _script_tree(path)
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(source, node)


def _constant(path, name):
    import ast

    _, tree = _script_tree(path)
    node = next(n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == name)
    return ast.literal_eval(node.value)


# the readers of device time (chain, profile, profiled_us) live in the package; chip_smoke.py imports them
PROFILING = "ssspy_tpu_torch/utils/profiling.py"


def test_profiled_us_is_one_helper_in_both_scripts():
    """The A/B script keeps its own copy (it imports the package of another tree, which may predate the module)."""
    assert _function_source(PROFILING, "profiled_us") == _function_source("scripts/torch_kernel_ab.py", "profiled_us")


def test_chip_smoke_defines_no_copy_of_the_readers():
    import ast

    _, tree = _script_tree("chip_smoke.py")
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert not defined & {"chain", "profile", "profiled_us"}
    imported = {(n.module, a.name) for n in tree.body if isinstance(n, ast.ImportFrom) for a in n.names}
    assert {("ssspy_tpu_torch.utils.profiling", name) for name in ("chain", "profile", "profiled_us")} <= imported


class _FakeProfiler:
    """``torch.profiler`` and ``torch.cuda`` as ``profiled_us`` uses them: each call of the timed function makes
    ``per_call`` device events, the k-th of them named ``ssspy_sweep_kernel_<k>`` and lasting k + 1 us, and one
    event of another kernel; the spin kernel makes one event; session s loses its first ``drops[s]`` events."""

    def __init__(self, per_call, drops):
        self.per_call, self.drops, self.sessions, self.pending = per_call, list(drops), 0, []

    def call(self):
        self.pending += [(f"ssspy_sweep_kernel_{k}", k + 1.0) for k in range(self.per_call)] + [("other", 50.0)]

    def torch(self):
        from types import SimpleNamespace

        fake = self

        class Session:
            def __enter__(self):
                fake.pending = []
                return self

            def __exit__(self, *exc):
                drop = fake.drops[fake.sessions] if fake.sessions < len(fake.drops) else 0
                fake.sessions += 1
                self.seen = fake.pending[drop:]

            def events(self):
                return [SimpleNamespace(name=name, device_type="cuda",
                                        time_range=SimpleNamespace(elapsed_us=lambda us=us: us))
                        for name, us in self.seen]

        return SimpleNamespace(
            profiler=SimpleNamespace(profile=lambda activities: Session(),
                                     ProfilerActivity=SimpleNamespace(CUDA="cuda")),
            autograd=SimpleNamespace(DeviceType=SimpleNamespace(CUDA="cuda")),
            cuda=SimpleNamespace(synchronize=lambda: None, _sleep=lambda cycles: fake.pending.append(("spin", 0.6))),
        )


@pytest.mark.parametrize(
    "per_call, drops, expected",
    [
        (1, [], (1.0, 10, 10)),  # every session whole
        (2, [], (3.0, 20, 20)),  # two kernels a call (K5's pass and its sums)
        (2, [1], (3.0, 20, 20)),  # the session lost only its spin kernel
        (2, [3, 3, 3], (3.0, 54, 60)),  # every session loses the first call's two launches: the means of the 54 events seen
        (1, [100, 100, 100], (None, 0, 0)),  # no session saw the kernel
    ],
)
def test_profiled_us_reads_the_events_its_session_saw(per_call, drops, expected):
    fake = _FakeProfiler(per_call, drops)
    namespace = {"torch": fake.torch(), "statistics": __import__("statistics"), "N_TIMED": 30}
    exec(_function_source(PROFILING, "profiled_us"), namespace)
    assert namespace["profiled_us"](fake.call, "ssspy_sweep", n_runs=10) == expected


class _FakeStepProfiler(_FakeProfiler):
    """As :class:`_FakeProfiler`, for ``utils.profiling.profile`` (chip_smoke's path profile): each step makes one
    ``gemm`` event of 4 us and two ``ssspy_sweep_kernel_k`` events (k + 1 us), and with ``alternate`` a ``reduce``
    event of 6 us every other step; the spin kernel is named as PyTorch names it."""

    def __init__(self, per_call, drops, alternate=False):
        super().__init__(per_call, drops)
        self.alternate, self.steps = alternate, 0

    def call(self):
        self.pending += [("gemm", 4.0)] + [(f"ssspy_sweep_kernel_{k}", k + 1.0) for k in range(self.per_call)]
        self.steps += 1
        if self.alternate and self.steps % 2:
            self.pending.append(("reduce", 6.0))

    def torch(self):
        fake = super().torch()
        fake.cuda._sleep = lambda cycles: self.pending.append(("at::cuda::(anonymous namespace)::spin_kernel(long)", 0.6))
        return fake


@pytest.mark.parametrize(
    "drops, alternate, expected",
    [
        ([], False, (7.0, 3, 30, 30, 1, {})),  # whole: three operations a step, 7 us
        ([1], False, (7.0, 3, 30, 30, 1, {})),  # the session lost only its spin kernel
        # two sessions lose the spin and the first step's gemm: three pooled, the gemm's 28 events of 30 steps
        # rounded up to one a step and given apart
        ([2, 2], False, (7.0, 3, 88, 90, 3, {"gemm": (28, 30, 28 * 4.0 / 30)})),
        ([100, 100, 100], False, ({}, 0, 0, 0, 3, {})),  # no session saw an event
        # a kernel launched every other step: rounded up to one a step, never whole, and given apart as seen
        ([], True, (13.0, 4, 105, 120, 3, {"reduce": (15, 30, 3.0)})),
    ],
)
def test_path_profile_reads_the_events_its_session_saw(drops, alternate, expected):
    """The path profile (``utils.profiling.profile``, as chip_smoke reads it): per kernel name its mean over the
    events seen times its launches a step, summed; the spin kernel left out; the events seen beside those the steps
    make; sessions pooled until one is whole; the names whose events do not divide by the steps given apart, with
    their time a step as seen."""
    fake = _FakeStepProfiler(2, drops, alternate)
    namespace = {"torch": fake.torch(), "statistics": __import__("statistics"), "N_ITER": 100}
    exec(_function_source(PROFILING, "chain"), namespace)
    exec(_function_source(PROFILING, "profile"), namespace)

    def step(state):
        fake.call()
        return state

    per_kernel, ops, seen, made, sessions, uneven = namespace["profile"](step, None, n_iter=10)
    device_us = sum(per_kernel.values()) if per_kernel else per_kernel
    assert (device_us, ops, seen, made, sessions, uneven) == pytest.approx(expected)
    assert all("spin_kernel" not in name for name in per_kernel)


def test_chip_smoke_sweep_edges_run_the_variants_they_name():
    """Each edge case of chip_smoke's K1b and K2 phases names the variant the predicates choose for it, and together
    with the main path (registers / warp) and the long case (streamed) they run every variant."""
    ip1 = _constant("chip_smoke.py", "IP1_EDGES")
    assert all(K.ip1_sweep_variant(M) == variant for M, _, variant in ip1)
    assert {variant for *_, variant in ip1} | {K.ip1_sweep_variant(8)} == {"warp", "block"}
    iss1 = _constant("chip_smoke.py", "ISS1_EDGES")
    assert all(K.iss1_sweep_variant(N, T, True) == variant for N, _, T, variant in iss1)
    long_N, _, long_T = _constant("chip_smoke.py", "LONG_SHAPE")
    assert K.iss1_sweep_variant(long_N, long_T, False) == K.iss1_sweep_variant(long_N, long_T, True) == "streamed"
    assert {variant for *_, variant in iss1} | {"streamed", K.iss1_sweep_variant(8, 626, True)} == set(K._ISS1_VARIANTS)


def test_chip_smoke_sandwich_and_congruence_edges_run_what_they_name():
    """chip_smoke's K4 edges name the variant the predicate chooses for each, and with the main path (m = 8) they
    run both; its K6 edges are sizes the kernel takes, at N other than the main path's 8."""
    sandwich = _constant("chip_smoke.py", "SANDWICH_EDGES")
    assert all(K.inv_sandwich_variant(m) == variant for m, _, variant in sandwich)
    assert {variant for *_, variant in sandwich} | {K.inv_sandwich_variant(8)} == set(K._SANDWICH_VARIANTS)
    congruence = _constant("chip_smoke.py", "IPA_EDGES")
    assert all(1 <= N <= K._IPA_MAX_N and 1 <= S <= K._IPA_MAX_N and N != 8 for N, S, _ in congruence)
