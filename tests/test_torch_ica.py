"""ssspy_tpu_torch time-domain ICA, PCA and whitening against the JAX package and the fixture.

Same numpy waveforms through the JAX classes and their port: the five ICA
classes (float64 within 1e-9, and float32), ``natural_grad_laplace_ica.npz``
at its 1e-6 (tests/regression/test_regression.py:179-186), the iteration
loss trace, callbacks and warm start, the state bridge on ICA's real state,
and ``pca``/``whiten`` in all four layouts (against the JAX transforms up
to each component's sign or phase, which the eigensolver fixes). All on
the CPU (``device="cpu"``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.bss import ica as jax_ica
from ssspy_tpu.transform import pca as jax_pca
from ssspy_tpu.transform import whiten as jax_whiten
from ssspy_tpu_torch.bss import (
    FastICA,
    FastICABase,
    GradICA,
    GradICABase,
    GradLaplaceICA,
    NaturalGradICA,
    NaturalGradLaplaceICA,
)
from ssspy_tpu_torch.transform import istft, pca, stft, whiten
from ssspy_tpu_torch.utils import from_jax_state, make_mixture
from tests.regression.test_regression import FIXTURE_DIR, _load

torch.set_num_threads(1)


def _waveform(n_channels=2, n_samples=2000, seed=0):
    return make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)


def _logcosh():
    """FastICA's log-cosh contrast, score and score derivative, for both packages."""
    jax_fns = (lambda y: jnp.log(jnp.cosh(y)), jnp.tanh, lambda y: 1 - jnp.tanh(y) ** 2)
    torch_fns = (lambda y: torch.log(torch.cosh(y)), torch.tanh, lambda y: 1 - torch.tanh(y) ** 2)
    return jax_fns, torch_fns


def _classes(name, is_holonomic):
    """``(jax instance, port instance)`` of one ICA class."""
    if name == "FastICA":
        (c, s, d), (tc, ts, td) = _logcosh()
        return (jax_ica.FastICA(contrast_fn=c, score_fn=s, d_score_fn=d),
                FastICA(contrast_fn=tc, score_fn=ts, d_score_fn=td, device="cpu"))
    kwargs = {"step_size": 0.05, "is_holonomic": is_holonomic}
    if name in ("GradLaplaceICA", "NaturalGradLaplaceICA"):
        port = {"GradLaplaceICA": GradLaplaceICA, "NaturalGradLaplaceICA": NaturalGradLaplaceICA}[name]
        return getattr(jax_ica, name)(**kwargs), port(device="cpu", **kwargs)
    port = {"GradICA": GradICA, "NaturalGradICA": NaturalGradICA}[name]
    return (getattr(jax_ica, name)(contrast_fn=jnp.abs, score_fn=jnp.sign, **kwargs),
            port(contrast_fn=torch.abs, score_fn=torch.sign, device="cpu", **kwargs))


CLASSES = ["GradICA", "NaturalGradICA", "FastICA", "GradLaplaceICA", "NaturalGradLaplaceICA"]


@pytest.mark.parametrize(
    "name,is_holonomic",
    [(name, is_holonomic) for name in CLASSES for is_holonomic in (False, True) if name != "FastICA" or not is_holonomic],
)
def test_ica_class_matches_the_jax_class(name, is_holonomic):
    x = _waveform(n_channels=3, seed=1)
    ref, method = _classes(name, is_holonomic)
    Y_jax = np.asarray(ref(x.copy(), n_iter=6))
    Y = method(torch.from_numpy(x.copy()), n_iter=6)
    assert Y.dtype == torch.float64 and Y.shape == x.shape
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9 * np.abs(Y_jax).max())
    np.testing.assert_allclose(method.loss, ref.loss, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(method.demix_filter.numpy(), np.asarray(ref.demix_filter), atol=1e-9)
    assert isinstance(method, FastICABase if name == "FastICA" else GradICABase)
    assert repr(method) == repr(ref)


@pytest.mark.parametrize("name", CLASSES)
def test_ica_class_matches_the_jax_class_f32(name):
    x = _waveform(n_channels=2, seed=2).astype(np.float32)
    ref, method = _classes(name, False)
    Y_jax = np.asarray(ref(x.copy(), n_iter=5))
    Y = method(torch.from_numpy(x.copy()), n_iter=5)
    assert Y.dtype == torch.float32
    assert np.abs(Y.numpy() - Y_jax).max() <= 1e-4 * np.abs(Y_jax).max()


def test_natural_grad_laplace_ica_matches_regression_fixture():
    """tests/regression/test_regression.py:179-186 on the port: float64 within 1e-6."""
    waveform = np.load(f"{FIXTURE_DIR}/input_time.npz")["waveform"]
    ica = NaturalGradLaplaceICA(step_size=0.05, device="cpu")
    Y = ica(torch.from_numpy(waveform.copy()), n_iter=20)
    np.testing.assert_allclose(Y.numpy(), _load("natural_grad_laplace_ica"), atol=1e-6)
    assert len(ica.loss) == 21 and ica.loss[-1] < ica.loss[0]


def test_callbacks_warm_start_and_a_second_call_match_jax():
    x = _waveform(seed=3)
    seen_jax, seen_torch = [], []
    ref = jax_ica.NaturalGradLaplaceICA(callbacks=lambda m: seen_jax.append(len(m.loss)))
    ica = NaturalGradLaplaceICA(callbacks=lambda m: seen_torch.append(len(m.loss)), device="cpu")
    W0 = np.array([[1.0, 0.2], [-0.1, 0.9]])
    Y_jax = np.asarray(ref(x.copy(), n_iter=3, demix_filter=W0))
    Y = ica(torch.from_numpy(x.copy()), n_iter=3, demix_filter=W0)
    assert seen_torch == seen_jax == [1, 2, 3, 4]
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-10)
    # a second call continues from the committed filter, as in the JAX class
    Y_jax = np.asarray(ref(x.copy(), n_iter=2, initial_call=False))
    Y = ica(torch.from_numpy(x.copy()), n_iter=2, initial_call=False)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-10)
    np.testing.assert_allclose(ica.loss, ref.loss, rtol=1e-9)


def test_state_bridge_takes_ica_state_as_real():
    """ICA's state is real: its waveform ``X (2, T)`` and ``W (2, 2)`` must not be read as planar complex."""
    x = _waveform(seed=4)
    W = np.array([[1.0, 0.3], [0.2, 1.0]])
    state = from_jax_state({"X": x, "W": W}, real_keys=("X", "W"))
    assert state["X"].dtype == torch.float64 and state["X"].shape == x.shape
    assert state["W"].shape == (2, 2)
    ref = jax_ica.NaturalGradLaplaceICA()
    ref(x.copy(), n_iter=0, demix_filter=W)
    step = ref.make_step()
    out = step({"X": jnp.asarray(x), "W": jnp.asarray(W)})
    method = NaturalGradLaplaceICA(device="cpu")
    method(state["X"], n_iter=0, demix_filter=state["W"])
    got = method.make_step()(state)
    np.testing.assert_allclose(got["W"].numpy(), np.asarray(out["W"]), atol=1e-12)
    # without real_keys a (2, ...) real X is read as planar, as the spectrogram states are
    assert from_jax_state({"X": x})["X"].is_complex()


def test_ica_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert NaturalGradLaplaceICA().device.type == "cuda"
        return
    for call in (lambda: NaturalGradLaplaceICA(), lambda: GradLaplaceICA(),
                 lambda: FastICA(contrast_fn=torch.abs, score_fn=torch.sign, d_score_fn=torch.sign)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="d_score_fn"):
        FastICA(contrast_fn=torch.abs, score_fn=torch.sign, device="cpu")


# ---- PCA and whitening ------------------------------------------------------------------------


def _layout(kind, rng):
    """A mixed input in each of the reference's four layouts, with its channel axis."""
    A = rng.standard_normal((3, 3))
    if kind == "2d-real":
        return np.einsum("mn,nt->mt", A, rng.laplace(size=(3, 500))), 0
    if kind == "3d-real":
        return np.einsum("mn,bnt->bmt", A, rng.laplace(size=(4, 3, 500))), 1
    s = rng.standard_normal((3, 5, 200)) + 1j * rng.standard_normal((3, 5, 200))
    if kind == "3d-complex":
        return np.einsum("mn,nit->mit", A, s), 0
    return np.einsum("mn,bnit->bmit", A, np.stack([s, 2 * s[::-1]])), 1


LAYOUTS = ["2d-real", "3d-complex", "3d-real", "4d-complex"]


def _align(got, ref, ch_axis):
    """``got`` with each component rotated onto ``ref``'s sign or phase (one per slice and component)."""
    reduce = tuple(ax for ax in range(got.ndim) if ax != ch_axis and ax == got.ndim - 1)
    inner = np.sum(got * ref.conj(), axis=reduce, keepdims=True)
    return got * (inner / np.abs(inner)).conj()


@pytest.mark.parametrize("kind", LAYOUTS)
def test_whiten_matches_jax_in_every_layout(kind):
    x, ch_axis = _layout(kind, np.random.default_rng(5))
    Z = whiten(torch.from_numpy(x), device="cpu").numpy()
    ref = np.asarray(jax_whiten(x))
    assert Z.shape == x.shape and Z.dtype == x.dtype
    np.testing.assert_allclose(_align(Z, ref, ch_axis), ref, atol=1e-10 * np.abs(ref).max())
    Zc = np.moveaxis(Z, ch_axis, -1)
    cov = np.einsum("...tm,...tn->...mn", Zc, Zc.conj()) / Zc.shape[-2]
    np.testing.assert_allclose(cov, np.broadcast_to(np.eye(3), cov.shape), atol=1e-10)


@pytest.mark.parametrize("ascend", [True, False])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_pca_matches_jax_in_every_layout(kind, ascend):
    x, ch_axis = _layout(kind, np.random.default_rng(6))
    Y = pca(torch.from_numpy(x), ascend=ascend, device="cpu").numpy()
    ref = np.asarray(jax_pca(x, ascend=ascend))
    assert Y.shape == x.shape
    np.testing.assert_allclose(_align(Y, ref, ch_axis), ref, atol=1e-10 * np.abs(ref).max())
    power = np.mean(np.abs(np.moveaxis(Y, ch_axis, 0)) ** 2, axis=tuple(range(1, Y.ndim)))
    assert (np.diff(power) <= 0).all() if ascend else (np.diff(power) >= 0).all()


def test_transforms_refuse_a_layout_the_reference_refuses():
    with pytest.raises(ValueError, match="real-valued"):
        whiten(torch.zeros((2, 5), dtype=torch.complex128), device="cpu")
    with pytest.raises(ValueError, match="complex-valued"):
        pca(torch.zeros((2, 2, 3, 4)), device="cpu")
    with pytest.raises(ValueError, match="dimension"):
        whiten(torch.zeros(5), device="cpu")


@pytest.mark.parametrize("transform", [pca, whiten])
def test_transforms_run_on_the_card_unless_asked_for_the_cpu(transform):
    x, _ = _layout("2d-real", np.random.default_rng(7))
    if torch.cuda.is_available():
        assert transform(x).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transform(x)
    assert transform(x, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("transform", ["stft", "istft"])
def test_stft_and_istft_run_on_the_card_unless_asked_for_the_cpu(transform):
    """A numpy array, or a tensor on another device, is transformed where the caller asks: the card by default."""
    x = make_mixture(seed=8, n_channels=2, duration_s=0.05)
    if transform == "stft":
        call, arg = stft, x
    else:
        call, arg = istft, stft(x, n_fft=64, device="cpu").numpy()
    if torch.cuda.is_available():
        assert call(arg, n_fft=64).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(arg, n_fft=64)
    out = call(arg, n_fft=64, device="cpu")
    assert out.device.type == "cpu" and torch.equal(out, call(torch.from_numpy(arg), n_fft=64, device="cpu"))
