"""ssspy_tpu_torch FastIVA, FasterIVA, gradient IVA and AuxGaussIVA against the JAX package and the fixtures.

Same numpy inputs through the JAX function and its port: the spectrogram
whitening (identity covariance; the JAX ``whiten_sc`` up to a phase per
component, since the two eigensolvers fix different phases), the polar
factor against ``splitc._polar_sc``'s eigh route, the FastIVA and
FasterIVA steps after projection back and their loss, the gradient step;
``fast_iva.npz`` through the class and the four ``grad_iva_*`` /
``natural_grad_iva_*`` fixtures in complex128 (the reference's 1e-7);
``AuxGaussIVA``, the Gauss and Laplace gradient classes and the
fixed-point classes against the JAX classes; the fast paths against the
JAX fast paths, the classes and the easy tier's fidelity pins; the kernels
each complex64 path hands its inputs to. All on the CPU
(``device="cpu"``), where the kernel wrappers take their plain versions.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.algorithm import projection_back as jax_projection_back
from ssspy_tpu.bss import iva as jax_iva
from ssspy_tpu.fast import fast_fast_iva as jax_fast_fast_iva
from ssspy_tpu.fast import fast_faster_iva as jax_fast_faster_iva
from ssspy_tpu.fast import fast_grad_iva as jax_fast_grad_iva
from ssspy_tpu.ops import splitc
from ssspy_tpu_torch.algorithm import projection_back
from ssspy_tpu_torch.bss import (
    AuxGaussIVA,
    FasterIVA,
    FastIVA,
    FastIVABase,
    GradGaussIVA,
    GradIVA,
    GradIVABase,
    GradLaplaceIVA,
    NaturalGradGaussIVA,
    NaturalGradIVA,
    NaturalGradLaplaceIVA,
)
from ssspy_tpu_torch.fast import fast_fast_iva, fast_faster_iva, fast_grad_iva
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops.fixed_point_iva_steps import (
    fast_iva_laplace_loss,
    fast_iva_step,
    faster_iva_step,
    polar,
    top_eigvec,
    whiten_spectrogram,
)
from ssspy_tpu_torch.ops.iva_steps import grad_laplace_iva_step, separate
from ssspy_tpu_torch.utils import from_jax_state, host_stft, make_mixture
from tests.regression.test_regression import N_ITER, _input, _load

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _complex(dtype):
    return np.complex128 if dtype == np.float64 else np.complex64


def _planar(a, dtype):
    return jnp.asarray(np.stack([a.real, a.imag]).astype(dtype))


def _from_planar(a):
    a = np.asarray(a)
    return a[0] + 1j * a[1]


def _spectrogram(n_channels=3, n_fft=16, n_frames=48, seed=0):
    """Small convolutive mixture STFT: ``(n_channels, n_fft // 2 + 1, n_frames)`` complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _near_identity(rng, n_bins, n_channels, scale=0.3):
    noise = rng.standard_normal((n_bins, n_channels, n_channels)) + 1j * rng.standard_normal((n_bins, n_channels, n_channels))
    return np.eye(n_channels)[None] + scale * noise


def _si_sdr_db(est, ref):
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    return 10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err)))


# ---- whitening, polar factor, top eigenvector ------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_whitening_gives_identity_covariance_and_jax_up_to_a_phase(dtype):
    X = _spectrogram(seed=1)
    Z = whiten_spectrogram(torch.from_numpy(X.astype(_complex(dtype))))
    assert Z.dtype == torch.from_numpy(X.astype(_complex(dtype))).dtype and Z.shape == X.shape
    C = torch.einsum("mit,nit->imn", Z, Z.conj()) / X.shape[-1]
    eye = torch.eye(3, dtype=C.dtype)
    # the graded jitter (1e-12 / 1e-5 of the mean diagonal) leaves its trace on the smallest eigenvalues
    assert float((C - eye).abs().max()) <= (1e-8 if dtype == np.float64 else 5e-2)
    Z_jax = _from_planar(splitc.whiten_sc(_planar(X, dtype)))
    Zn = Z.numpy()
    phase = np.sum(Zn * Z_jax.conj(), axis=-1)
    phase = phase / np.abs(phase)  # (M, I): one phase per component and bin
    assert _rel_err(Zn, phase[..., None] * Z_jax) <= (1e-10 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_polar_factor_matches_jax_eigh_route(dtype):
    rng = np.random.default_rng(2)
    W = _near_identity(rng, 9, 3)
    O = polar(torch.from_numpy(W.astype(_complex(dtype))))
    Or, Oi = splitc._polar_sc(*_planar(W, dtype), impl="eigh")
    assert _rel_err(O.numpy(), np.asarray(Or) + 1j * np.asarray(Oi)) <= TOL[dtype]
    eye = torch.eye(3, dtype=O.dtype)
    assert float((O.mH @ O - eye).abs().max()) <= (1e-12 if dtype == np.float64 else 1e-5)
    if dtype == np.float64:  # the SVD's u v^H of the JAX class path
        u, _, vh = np.linalg.svd(W)
        np.testing.assert_allclose(O.numpy(), u @ vh, atol=1e-12)


def test_top_eigenvector_is_canonical_and_the_largest():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 2, 3, 3)) + 1j * rng.standard_normal((5, 2, 3, 3))
    U = torch.from_numpy(a @ a.conj().swapaxes(-1, -2))
    v = top_eigvec(U)
    lamb, P = torch.linalg.eigh(U)
    Uv = (U @ v[..., None])[..., 0]
    torch.testing.assert_close(Uv, lamb[..., -1:] * v, rtol=0, atol=1e-10 * float(lamb.max()))
    k = torch.argmax(v.abs(), dim=-1, keepdim=True)
    anchor = torch.gather(v, -1, k)
    assert float(anchor.imag.abs().max()) < 1e-14 and bool((anchor.real > 0).all())
    # the same vector, whatever phase the input's eigenvector had
    torch.testing.assert_close(top_eigvec(U * (1 + 0j)), v, rtol=0, atol=0)


# ---- the steps ---------------------------------------------------------------------------------------


def _steps_problem(seed=4):
    X = _spectrogram(seed=seed)
    return X


@pytest.mark.parametrize("variant", ["fast", "faster"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fixed_point_steps_match_jax_after_projection_back(dtype, variant):
    """Each side whitens on its own (their phases differ), runs three steps and projects back onto the mixture."""
    X = _steps_problem()
    jax_step = splitc.fast_iva_step_sc if variant == "fast" else functools.partial(
        splitc.faster_iva_step_sc, eig_impl="eigh")
    step = fast_iva_step if variant == "fast" else faster_iva_step
    Zs = splitc.whiten_sc(_planar(X, dtype))
    Ws = _planar(np.tile(np.eye(3), (X.shape[1], 1, 1)), dtype)
    for _ in range(3):
        Ws = jax_step(Zs, Ws)
    Y_jax = np.einsum("inm,mit->nit", _from_planar(Ws), _from_planar(Zs))
    Y_jax = np.asarray(jax_projection_back(Y_jax.astype(np.complex128), reference=X))

    Xt = torch.from_numpy(X.astype(_complex(dtype)))
    Z = whiten_spectrogram(Xt)
    W = torch.eye(3, dtype=Xt.dtype).expand(X.shape[1], 3, 3)
    for _ in range(3):
        W = step(Z, W)
    Y = projection_back(separate(Z, W), reference=Xt).numpy()
    assert _rel_err(Y, Y_jax) <= (1e-9 if dtype == np.float64 else 1e-3)

    # the loss is phase-blind: the same value on the JAX side's whitened input and filters
    loss_ref = float(splitc.fast_iva_laplace_loss_sc(Zs, Ws))
    loss = float(fast_iva_laplace_loss(Z, W))
    assert abs(loss - loss_ref) <= (1e-10 if dtype == np.float64 else 1e-4) * abs(loss_ref)


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("is_holonomic", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_grad_laplace_iva_step_matches_jax(dtype, is_holonomic, natural):
    X = _spectrogram(seed=5)
    W = _near_identity(np.random.default_rng(6), X.shape[1], 3)
    ref = _from_planar(splitc.grad_laplace_iva_step_sc(
        _planar(X, dtype), _planar(W, dtype), is_holonomic=is_holonomic, natural=natural))
    state = from_jax_state({"X": np.asarray(_planar(X, dtype)), "W": np.asarray(_planar(W, dtype))})
    got = grad_laplace_iva_step(state["X"], state["W"], is_holonomic=is_holonomic, natural=natural)
    assert _rel_err(got.numpy(), ref) <= TOL[dtype]


# ---- the classes on the regression fixtures (complex128) --------------------------------------------


def _laplace_contrast(y):
    return 2 * torch.linalg.vector_norm(y, dim=1)


def _laplace_d_contrast(y):
    return 2 * torch.ones_like(y)


def _laplace_score(y):
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=1, keepdim=True), min=1e-10)


def test_fast_iva_class_matches_regression_fixture():
    """tests/regression/test_regression.py:218-230 on the port: the whitening's phases go out with projection back."""
    iva = FastIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast,
                  dd_contrast_fn=lambda y: 2 * torch.zeros_like(y), device="cpu")
    assert isinstance(iva, FastIVABase)
    Y = iva(torch.from_numpy(_input()), n_iter=5)
    target = _load("fast_iva")
    assert Y.dtype == torch.complex128 and Y.shape == target.shape
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert len(iva.loss) == 6 and all(np.isfinite(iva.loss))


@pytest.mark.parametrize(
    "name,natural,is_holonomic",
    [
        ("grad_iva_holonomic", False, True),
        ("grad_iva_nonholonomic", False, False),
        ("natural_grad_iva_holonomic", True, True),
        ("natural_grad_iva_nonholonomic", True, False),
    ],
)
def test_grad_iva_class_matches_regression_fixture(name, natural, is_holonomic):
    cls = NaturalGradIVA if natural else GradIVA
    iva = cls(contrast_fn=_laplace_contrast, score_fn=_laplace_score, is_holonomic=is_holonomic, device="cpu")
    assert isinstance(iva, GradIVABase)
    Y = iva(torch.from_numpy(_input()), n_iter=N_ITER)
    target = _load(name)
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert min(_si_sdr_db(Y[n].numpy(), target[n]) for n in range(Y.shape[0])) > 50


# ---- the classes against the JAX classes (complex128) ---------------------------------------------------


def _jax_laplace_contrast(y):
    return 2 * jnp.linalg.norm(y, axis=1)


def _jax_laplace_d_contrast(y):
    return 2 * jnp.ones_like(y)


@pytest.mark.parametrize("spatial", ["IP1", "IP2", "ISS1", "ISS2", "IPA"])
def test_aux_gauss_iva_matches_the_jax_class(spatial):
    X = _spectrogram(seed=7)
    ref = jax_iva.AuxGaussIVA(spatial_algorithm=spatial)
    Y_jax = np.asarray(ref(X.copy(), n_iter=3))
    iva = AuxGaussIVA(spatial_algorithm=spatial, device="cpu")
    Y = iva(torch.from_numpy(X.copy()), n_iter=3)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(iva.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(iva.variance.numpy(), np.asarray(ref.variance), rtol=1e-9)
    assert "AuxGaussIVA(spatial_algorithm=" in repr(iva)


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("prior", ["gauss", "laplace"])
def test_gradient_classes_match_the_jax_classes(prior, natural):
    X = _spectrogram(seed=8)
    names = {("gauss", False): "GradGaussIVA", ("gauss", True): "NaturalGradGaussIVA",
             ("laplace", False): "GradLaplaceIVA", ("laplace", True): "NaturalGradLaplaceIVA"}
    name = names[prior, natural]
    ref = getattr(jax_iva, name)()
    Y_jax = np.asarray(ref(X.copy(), n_iter=4))
    cls = {"GradGaussIVA": GradGaussIVA, "NaturalGradGaussIVA": NaturalGradGaussIVA,
           "GradLaplaceIVA": GradLaplaceIVA, "NaturalGradLaplaceIVA": NaturalGradLaplaceIVA}[name]
    iva = cls(device="cpu")
    assert iva._natural == natural and isinstance(iva, GradIVA if prior == "gauss" else GradIVABase)
    assert isinstance(iva, NaturalGradIVA) == (natural and prior == "laplace")  # as the JAX class tree has it
    Y = iva(torch.from_numpy(X.copy()), n_iter=4)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(iva.loss, ref.loss, rtol=1e-9)


@pytest.mark.parametrize("variant", ["fast", "faster"])
def test_fixed_point_classes_match_the_jax_classes(variant):
    """complex128 classes from the same input: the outputs after projection back, and the loss trace."""
    X = _spectrogram(seed=9)
    if variant == "fast":
        ref = jax_iva.FastIVA(contrast_fn=_jax_laplace_contrast, d_contrast_fn=_jax_laplace_d_contrast,
                              dd_contrast_fn=lambda y: jnp.zeros_like(y))
        iva = FastIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast,
                      dd_contrast_fn=lambda y: torch.zeros_like(y), device="cpu")
    else:
        ref = jax_iva.FasterIVA(contrast_fn=_jax_laplace_contrast, d_contrast_fn=_jax_laplace_d_contrast)
        iva = FasterIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast, device="cpu")
    Y_jax = np.asarray(ref(X.copy(), n_iter=4))
    Y = iva(torch.from_numpy(X.copy()), n_iter=4)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-8 * np.abs(Y_jax).max())
    np.testing.assert_allclose(iva.loss, ref.loss, rtol=1e-9)
    # without scale restoration the output is the whitened separation
    quiet = FasterIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast, scale_restoration=False,
                      device="cpu")
    Y_quiet = quiet(torch.from_numpy(X.copy()), n_iter=2)
    torch.testing.assert_close(Y_quiet, separate(quiet.whitened_input, quiet.demix_filter), rtol=0, atol=0)


# ---- the fast paths -----------------------------------------------------------------------------------


def _small_mixture():
    return _spectrogram(n_channels=3, n_fft=32, n_frames=48, seed=10)


@functools.lru_cache(maxsize=None)
def _jax_fast(name):
    """The JAX fast path's separated output on :func:`_small_mixture`, run once per module."""
    X = _small_mixture()
    runs = {
        "fast": lambda: jax_fast_fast_iva(X, n_iter=5),
        "faster": lambda: jax_fast_faster_iva(X, n_iter=5),
        "grad": lambda: jax_fast_grad_iva(X, n_iter=5)[0],
        "natural-grad": lambda: jax_fast_grad_iva(X, n_iter=5, natural=True)[0],
    }
    return np.asarray(runs[name]())


PORT_FAST = {
    "fast": lambda X: fast_fast_iva(X, n_iter=5, device="cpu"),
    "faster": lambda X: fast_faster_iva(X, n_iter=5, device="cpu"),
    "grad": lambda X: fast_grad_iva(X, n_iter=5, device="cpu")[0],
    "natural-grad": lambda X: fast_grad_iva(X, n_iter=5, natural=True, device="cpu")[0],
}


@pytest.mark.parametrize("name", sorted(PORT_FAST))
def test_fast_path_matches_the_jax_fast_path(name):
    X = _small_mixture()
    Y = PORT_FAST[name](X)
    assert Y.dtype == torch.complex64 and Y.shape == X.shape
    ref = _jax_fast(name)
    sdr = min(_si_sdr_db(Y[n].numpy().astype(np.complex128), ref[n]) for n in range(3))
    assert sdr >= 40.0, f"{name}: {sdr:.1f} dB"


def test_classes_equal_their_fast_paths_at_the_fast_floor():
    """At ``flooring_fn="f64"`` (the fast paths' 1e-10) the complex64 classes run the fast paths' trajectory to the bit."""
    X = _small_mixture().astype(np.complex64)
    Xt = torch.from_numpy(X)
    fast = FastIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast,
                   dd_contrast_fn=lambda y: torch.zeros_like(y), flooring_fn="f64", device="cpu")
    torch.testing.assert_close(fast(Xt, n_iter=3), fast_fast_iva(X, n_iter=3, device="cpu"), rtol=0, atol=0)
    faster = FasterIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast, flooring_fn="f64",
                       device="cpu")
    torch.testing.assert_close(faster(Xt, n_iter=3), fast_faster_iva(X, n_iter=3, device="cpu"), rtol=0, atol=0)
    for natural, cls in ((False, GradLaplaceIVA), (True, NaturalGradLaplaceIVA)):
        Y, W = fast_grad_iva(X, n_iter=3, natural=natural, device="cpu")
        grad = cls(flooring_fn="f64", device="cpu")
        torch.testing.assert_close(grad(Xt, n_iter=3), Y, rtol=0, atol=0)
        torch.testing.assert_close(grad.demix_filter, W, rtol=0, atol=0)


@pytest.fixture(scope="module")
def easy_tier():
    """tests/test_fast_fidelity.py's mixture, STFT and quality measure on the port."""
    from tests.test_fast_fidelity import HOP, N_FFT, _best_perm_si_sdr
    from ssspy_tpu_torch.transform import istft, stft
    from ssspy_tpu_torch.utils import sample_speech_mixture

    images, _ = sample_speech_mixture(n_sources=2, max_duration=2.0, conv=True, seed=0)
    mix = images.sum(axis=0)
    X = stft(torch.from_numpy(mix), n_fft=N_FFT, hop_length=HOP, device="cpu").numpy()

    def quality(Y):
        y = istft(torch.as_tensor(Y).to(torch.complex128), n_fft=N_FFT, hop_length=HOP, length=mix.shape[-1],
                  device="cpu")
        return _best_perm_si_sdr(y.numpy(), images[:, 0])

    with open(os.path.join(TESTS, "fidelity_pins.json")) as f:
        pins = json.load(f)
    return X, quality, pins


PINNED = {
    "fixed_point_iva_fast": lambda X: fast_fast_iva(X, n_iter=30, device="cpu"),
    "fixed_point_iva_faster": lambda X: fast_faster_iva(X, n_iter=30, device="cpu"),
    "grad_iva_natural=False": lambda X: fast_grad_iva(X, n_iter=100, device="cpu")[0],
    "grad_iva_natural=True": lambda X: fast_grad_iva(X, n_iter=100, natural=True, device="cpu")[0],
}


@pytest.mark.parametrize("pin", sorted(PINNED))
def test_fast_path_meets_the_fidelity_pin(pin, easy_tier):
    """tests/test_fast_fidelity.py:209-284 on the port: within 0.1 dB of the pinned reference SI-SDR."""
    X, quality, pins = easy_tier
    got = quality(PINNED[pin](X))
    assert abs(got - pins[pin]) <= 0.1, f"{pin}: {got:.3f} vs {pins[pin]:.3f} dB"


# ---- the kernels each complex64 path hands its inputs to, the state bridge, the card ------------------------


def test_complex64_paths_hand_the_kernels_what_they_take(monkeypatch):
    """FastIVA: K7 once for the whitening and once a step; FasterIVA: K1 ``(N, T)`` and K7 twice a step; gradient: none."""
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    seen = []

    def checking_eigh(A, *args, **kwargs):
        K._check_jacobi_eigh(A)
        seen.append(("jacobi_eigh", tuple(A.shape)))
        return K.jacobi_eigh_plain(A, *args, **kwargs)

    def checking_covariance(X, varphi):
        K._check_weighted_covariance(X, varphi)
        seen.append(("weighted_covariance", tuple(varphi.shape)))
        return K.weighted_covariance_plain(X, varphi)

    def refuse(*args, **kwargs):
        raise AssertionError("no path here runs this kernel")

    monkeypatch.setattr(K, "jacobi_eigh", checking_eigh)
    monkeypatch.setattr(K, "weighted_covariance", checking_covariance)
    for name in ("ip1_sweep", "iss1_sweep", "ipa_congruence"):
        monkeypatch.setattr(K, name, refuse)
    X = _small_mixture().astype(np.complex64)
    I, T = X.shape[1:]
    fast_fast_iva(X, n_iter=2, device="cpu")
    assert seen == [("jacobi_eigh", (I, 6, 6))] * 3
    seen.clear()
    fast_faster_iva(X, n_iter=2, device="cpu")
    step = [("weighted_covariance", (3, T)), ("jacobi_eigh", (I * 3, 6, 6)), ("jacobi_eigh", (I, 6, 6))]
    assert seen == [("jacobi_eigh", (I, 6, 6))] + step * 2
    seen.clear()
    fast_grad_iva(X, n_iter=2, device="cpu")
    GradGaussIVA(device="cpu")(torch.from_numpy(X), n_iter=2)
    assert seen == []


def test_state_bridge_carries_the_fixed_point_and_gauss_states():
    rng = np.random.default_rng(11)
    Xw = (rng.standard_normal((2, 3, 4, 5)).astype(np.float32))
    W = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    variance = rng.random((3, 5))
    state = from_jax_state({"Xw": Xw, "W": W, "variance": variance})
    assert state["Xw"].dtype == torch.complex64 and state["Xw"].shape == (3, 4, 5)
    assert state["W"].shape == (4, 3, 3)
    assert state["variance"].dtype == torch.float64 and state["variance"].shape == (3, 5)
    # the port continues from a JAX state: one FastIVA step from it equals the JAX x64 step
    Z = _from_planar(splitc.whiten_sc(_planar(_spectrogram(seed=12), np.float64)))
    Ws = np.stack([np.eye(3)[None].repeat(9, 0), np.zeros((9, 3, 3))])
    ref = _from_planar(splitc.fast_iva_step_sc(_planar(Z, np.float64), jnp.asarray(Ws)))
    state = from_jax_state({"Xw": np.asarray(_planar(Z, np.float64)), "W": Ws})
    assert state["Xw"].dtype == torch.complex128
    # 1e-9: the first step's filter is near singular in one bin, and the polar factor scales its rounding
    assert _rel_err(fast_iva_step(state["Xw"], state["W"]).numpy(), ref) <= 1e-9


def test_fixed_point_and_gradient_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    X = np.zeros((2, 3, 4), np.complex64)
    entry_points = [
        lambda: FastIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast,
                        dd_contrast_fn=_laplace_d_contrast),
        lambda: FasterIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast),
        lambda: GradLaplaceIVA(),
        lambda: NaturalGradGaussIVA(),
        lambda: AuxGaussIVA(),
        lambda: fast_fast_iva(X, n_iter=1),
        lambda: fast_faster_iva(X, n_iter=1),
        lambda: fast_grad_iva(X, n_iter=1),
    ]
    if torch.cuda.is_available():
        assert GradLaplaceIVA().device.type == "cuda"
    else:
        for call in entry_points:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    with pytest.raises(ValueError, match="dd_contrast|second-order"):
        FastIVA(contrast_fn=_laplace_contrast, d_contrast_fn=_laplace_d_contrast, device="cpu")
    with pytest.raises(ValueError, match="score_fn"):
        GradIVA(contrast_fn=_laplace_contrast, device="cpu")
