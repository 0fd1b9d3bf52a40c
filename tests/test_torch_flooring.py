"""Every port class that takes ``flooring_fn`` with one that is not ``max(., eps)``, against the JAX class.

The JAX complex-engine classes apply their ``flooring_fn`` wherever they
floor (the spatial updates, the NMF and PSDTF updates, the PSD projections,
the cACGMM E-step); the port applies it at the same places on its plain
routes. Each class runs 3 iterations in complex128 on the CPU from the same
numpy inputs and seeds as its JAX twin (x64), with ``add_flooring`` at
``eps = 1e-3``: large enough that a place left at ``max(., eps)`` moves the
result past the tolerance. A max-type floor keeps its eps and its routes:
the routers still hand it to the kernels, and the steps give the bits they
gave before the callable was threaded through.
"""

import functools

import numpy as np
import pytest
import torch

from ssspy_tpu.bss.cacgmm import CACGMM as JaxCACGMM
from ssspy_tpu.bss.fdica import AuxLaplaceFDICA as JaxAuxLaplaceFDICA
from ssspy_tpu.bss.ilrma import GaussILRMA as JaxGaussILRMA
from ssspy_tpu.bss.ilrma import GGDILRMA as JaxGGDILRMA
from ssspy_tpu.bss.ilrma import TILRMA as JaxTILRMA
from ssspy_tpu.bss.ipsdta import GaussIPSDTA as JaxGaussIPSDTA
from ssspy_tpu.bss.ipsdta import TIPSDTA as JaxTIPSDTA
from ssspy_tpu.bss.iva import AuxGaussIVA as JaxAuxGaussIVA
from ssspy_tpu.bss.iva import AuxLaplaceIVA as JaxAuxLaplaceIVA
from ssspy_tpu.bss.mnmf import FastGaussMNMF as JaxFastGaussMNMF
from ssspy_tpu.bss.mnmf import GaussMNMF as JaxGaussMNMF
from ssspy_tpu.special import add_flooring as jax_add_flooring
from ssspy_tpu_torch.bss import (
    CACGMM,
    AuxGaussIVA,
    AuxLaplaceFDICA,
    AuxLaplaceIVA,
    FastGaussMNMF,
    GaussILRMA,
    GaussIPSDTA,
    GaussMNMF,
    GGDILRMA,
    TILRMA,
    TIPSDTA,
)
from ssspy_tpu_torch.ops import iva_steps, kernels
from ssspy_tpu_torch.special import add_flooring, dtype_flooring, identity, max_flooring
from ssspy_tpu_torch.special.flooring import step_flooring, sweep_eps
from ssspy_tpu_torch.utils import host_stft, make_mixture

torch.set_num_threads(1)

SHIFT = 1e-3
N_ITER = 3


def _spectrogram(n_channels=3, n_fft=32, n_frames=24, seed=0):
    """Small convolutive mixture STFT: ``(n_channels, n_fft // 2 + 1, n_frames)`` complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _pair(jax_cls, torch_cls, seeded=False, **kwargs):
    """The JAX class and the port class with ``add_flooring`` at ``SHIFT``, each from its own package."""
    rng = (lambda: {"rng": np.random.default_rng(7)}) if seeded else dict
    ref = jax_cls(flooring_fn=functools.partial(jax_add_flooring, eps=SHIFT), **rng(), **kwargs)
    got = torch_cls(flooring_fn=functools.partial(add_flooring, eps=SHIFT), device="cpu", **rng(), **kwargs)
    return ref, got


# class, JAX class, constructor keywords, whether it draws from an rng, tolerance on the output
CASES = {
    **{
        f"AuxLaplaceIVA-{algorithm}": (AuxLaplaceIVA, JaxAuxLaplaceIVA, {"spatial_algorithm": algorithm}, False)
        for algorithm in ("IP1", "IP2", "ISS1", "ISS2", "IPA")
    },
    **{
        f"AuxGaussIVA-{algorithm}": (AuxGaussIVA, JaxAuxGaussIVA, {"spatial_algorithm": algorithm}, False)
        for algorithm in ("IP1", "ISS1")
    },
    **{
        f"{name}-{algorithm}": (cls, jax_cls, {"n_basis": 2, "spatial_algorithm": algorithm, **kw}, True)
        for name, cls, jax_cls, kw in (
            ("GaussILRMA", GaussILRMA, JaxGaussILRMA, {}),
            ("TILRMA", TILRMA, JaxTILRMA, {"dof": 100}),
            ("GGDILRMA", GGDILRMA, JaxGGDILRMA, {"beta": 1.5}),
        )
        for algorithm in ("IP1", "ISS1")
    },
    **{
        f"AuxLaplaceFDICA-{algorithm}": (
            AuxLaplaceFDICA, JaxAuxLaplaceFDICA, {"spatial_algorithm": algorithm, "permutation_alignment": False}, False,
        )
        for algorithm in ("IP1", "IP2")
    },
    "GaussMNMF": (GaussMNMF, JaxGaussMNMF, {"n_basis": 2}, True),
    **{
        f"FastGaussMNMF-{algorithm}": (
            FastGaussMNMF, JaxFastGaussMNMF, {"n_basis": 2, "diagonalizer_algorithm": algorithm}, True,
        )
        for algorithm in ("IP1", "IP2")
    },
    "GaussIPSDTA": (GaussIPSDTA, JaxGaussIPSDTA, {"n_basis": 2, "n_blocks": 2}, True),
    "TIPSDTA": (TIPSDTA, JaxTIPSDTA, {"n_basis": 2, "n_blocks": 2, "dof": 100}, True),
    "CACGMM": (CACGMM, JaxCACGMM, {}, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_a_callable_flooring_matches_the_jax_class(name):
    cls, jax_cls, kwargs, seeded = CASES[name]
    X = _spectrogram(seed=3)
    ref, got = _pair(jax_cls, cls, seeded=seeded, **kwargs)
    Y_ref = np.asarray(ref(X.copy(), n_iter=N_ITER))
    Y = got(torch.from_numpy(X.copy()), n_iter=N_ITER)
    assert Y.dtype == torch.complex128 and np.isfinite(Y.numpy()).all()
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-9 * np.abs(Y_ref).max())
    np.testing.assert_allclose(np.asarray(got.loss), np.asarray(ref.loss), rtol=1e-9)


def test_a_complex64_class_with_a_callable_runs_finite_and_falls():
    """complex64 takes the plain sweeps (IP1, ISS1) and the direct IPA with the callable: finite, the loss falling."""
    X = torch.from_numpy(_spectrogram(seed=4).astype(np.complex64))
    for algorithm in ("IP1", "ISS1", "IPA"):
        iva = AuxLaplaceIVA(spatial_algorithm=algorithm, flooring_fn=lambda v: v + 1e-6, device="cpu")
        Y = iva(X, n_iter=5)
        assert Y.dtype == torch.complex64 and torch.isfinite(Y).all()
        assert iva.loss[-1] < iva.loss[0]


# ---- which floors are max-type, and where a callable goes ----------------------------------------------------


def test_max_type_floors_keep_their_eps_and_any_other_callable_is_passed_on():
    c64, c128 = torch.complex64, torch.complex128
    assert sweep_eps(dtype_flooring, c64) == 1e-6 and sweep_eps(dtype_flooring, c128) == 1e-10
    assert sweep_eps(max_flooring, c64) == 1e-10
    assert sweep_eps(functools.partial(max_flooring, eps=1e-4), c64) == 1e-4
    assert sweep_eps(identity, c128) == 0.0
    shifted = functools.partial(add_flooring, eps=1e-4)
    for fn in (shifted, lambda v: v + 1e-10, functools.partial(dtype_flooring, eps64=1e-3)):
        assert sweep_eps(fn, c128) is None
        assert step_flooring(fn, c64) == (1e-6, fn) and step_flooring(fn, c128) == (1e-10, fn)
    assert step_flooring(dtype_flooring, c64) == (1e-6, None)
    assert step_flooring(dtype_flooring, c128, eps=1e-10) == (1e-10, None)


class Launched(Exception):
    """Raised where a wrapper would launch its kernel."""


def test_the_routers_take_the_plain_sweeps_for_a_callable(monkeypatch):
    """complex64 at the kernels' sizes: with ``eps`` the routers reach K1b and K2; with a callable, the plain sweeps."""
    rng = np.random.default_rng(11)
    X = torch.from_numpy((rng.standard_normal((3, 5, 12)) + 1j * rng.standard_normal((3, 5, 12))).astype(np.complex64))
    varphi = torch.from_numpy(rng.random((3, 12)).astype(np.float32) + 0.1)
    U = kernels.weighted_covariance_plain(X, varphi)
    W = torch.eye(3, dtype=torch.complex64).expand(5, 3, 3).contiguous()
    shifted = functools.partial(add_flooring, eps=1e-3)
    expected_ip1 = kernels.ip1_sweep_plain(W, U, flooring_fn=shifted)
    expected_iss1 = kernels.iss1_sweep_plain(X, varphi, flooring_fn=shifted)

    monkeypatch.setattr(kernels, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(kernels, "_check_cuda", lambda name, *tensors: None)
    monkeypatch.setattr(kernels, "_entry", lambda name: (_ for _ in ()).throw(Launched(name)))
    with pytest.raises(Launched, match="ip1_sweep"):
        iva_steps.ip1_update(W, U, eps=1e-3)
    with pytest.raises(Launched, match="iss1_sweep"):
        iva_steps.iss1_update(X, varphi, eps=1e-3)
    assert torch.equal(iva_steps.ip1_update(W, U, eps=1e-3, flooring_fn=shifted), expected_ip1)
    assert torch.equal(iva_steps.iss1_update(X, varphi, eps=1e-3, flooring_fn=shifted), expected_iss1)
    # a batch folds into the bins and keeps the route
    batched = iva_steps.ip1_update(torch.stack([W, W]), torch.stack([U, U]), eps=1e-3, flooring_fn=shifted)
    assert torch.equal(batched[1], expected_ip1)


def _steps(floor_kw):
    """Each step that takes ``flooring_fn``, in complex128 on one seeded input, with ``floor_kw`` passed to it."""
    from ssspy_tpu_torch.ops import cacgmm_steps, fast_mnmf_steps, ipa_steps, ipsdta_steps, mnmf_steps

    X = torch.from_numpy(_spectrogram(seed=5, n_fft=16, n_frames=16))
    M, I, T = X.shape
    rng = np.random.default_rng(6)
    W = torch.from_numpy(np.eye(M) + 0.2 * (rng.standard_normal((I, M, M)) + 1j * rng.standard_normal((I, M, M))))
    Y = iva_steps.separate(X, W)
    varphi = torch.from_numpy(rng.random((M, I, T)) + 0.1)
    U = iva_steps.covariance(X, varphi)
    nmf_T, nmf_V = torch.from_numpy(rng.random((M, I, 2))), torch.from_numpy(rng.random((M, 2, T)))
    H = torch.eye(M, dtype=X.dtype).expand(M, I, M, M) / M
    XX = mnmf_steps.instant_covariance(X, **floor_kw)
    D = torch.from_numpy(rng.random((I, M, M)))
    Z = X / torch.linalg.vector_norm(X, dim=0)
    alpha = torch.full((M, I), 1 / M, dtype=torch.float64)
    B = torch.eye(M, dtype=X.dtype).expand(M, I, M, M) / M
    parts = [
        torch.from_numpy(rng.random((M, 2, b, j))[..., None] * np.eye(j)).to(X.dtype)
        for b, j in ipsdta_steps.part_shapes(I, 2)
    ]
    return {
        "ip1_update": lambda: iva_steps.ip1_update(W, U, **floor_kw),
        "iss1_update": lambda: iva_steps.iss1_update(Y, varphi, **floor_kw),
        "ip2_update": lambda: iva_steps.ip2_update(W, U, **floor_kw),
        "iss2_sweep": lambda: iva_steps.iss2_sweep(Y, varphi, **floor_kw),
        "ipa_sweep": lambda: ipa_steps.ipa_sweep(Y, varphi, **floor_kw),
        "gauss_mnmf_step": lambda: mnmf_steps.gauss_mnmf_step(XX, nmf_T, nmf_V, H, **floor_kw),
        "gauss_mnmf_loss": lambda: mnmf_steps.gauss_mnmf_loss(XX, nmf_T, nmf_V, H, **floor_kw),
        "fast_gauss_mnmf_step": lambda: fast_mnmf_steps.fast_gauss_mnmf_step(X, W, nmf_T, nmf_V, D, **floor_kw),
        "cacgmm_step": lambda: cacgmm_steps.step(Z, alpha, B, **floor_kw),
        # the Gaussian model: the t model's inverse square root floors the eigenvalues at eps, a deliberate
        # departure, and the root with a callable, as the JAX class (ipsdta_steps._basis_update)
        "ipsdta_step": lambda: ipsdta_steps.ipsdta_vcd_step(X, W, parts, nmf_V, **floor_kw),
    }


@pytest.mark.parametrize("name", list(_steps({"eps": 1e-10})))
def test_a_max_flooring_callable_gives_the_bits_of_its_eps(name):
    """Each step floors with the callable exactly where it floored with ``max(., eps)``: ``max_flooring`` at ``eps`` gives
    the bits of ``eps``, and a shifted floor moves the result."""
    eps = 1e-2  # far above the data's small values, so that every floor the step takes binds somewhere
    with_eps = _flat(_steps({"eps": eps})[name]())
    with_fn = _flat(_steps({"eps": eps, "flooring_fn": functools.partial(max_flooring, eps=eps)})[name]())
    shifted = _flat(_steps({"eps": eps, "flooring_fn": functools.partial(add_flooring, eps=eps)})[name]())
    assert len(with_eps) == len(with_fn) == len(shifted)
    assert all(torch.equal(a, b) for a, b in zip(with_eps, with_fn))
    assert any(not torch.allclose(a, b, rtol=1e-6, atol=0) for a, b in zip(with_eps, shifted))


def _flat(out):
    """The tensors of a step's result, nested tuples and lists flattened."""
    if isinstance(out, (tuple, list)):
        return [t for part in out for t in _flat(part)]
    return [out]
