"""ssspy_tpu_torch's FDICA against the JAX package, the reference fixtures and the easy tier's pins, on the CPU.

Same numpy inputs, made from a seed, through the JAX function and its port:
each FDICA step and the loss against its ``splitc`` counterpart in float64
(1e-10 relative); every class in complex128 on the six ``*fdica*.npz``
fixtures of ``tests/regression/fixtures`` (the reference's 1e-7); the
float32 fast paths against ``ssspy_tpu.fast.fast_aux_fdica`` and
``fast_grad_fdica`` (SI-SDR) and the easy tier's pins; the Laplace classes
against their fast paths (to the bit); the kernels each complex64 path
hands its inputs to. All on the CPU (``device="cpu"``), where the kernel
wrappers take their plain versions. Each JAX fast path runs once per module.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.bss.fdica import AuxFDICA as JaxAuxFDICA
from ssspy_tpu.fast import fast_aux_fdica as jax_fast_aux_fdica
from ssspy_tpu.fast import fast_grad_fdica as jax_fast_grad_fdica
from ssspy_tpu.ops import splitc
from ssspy_tpu.utils.select_pair import combination_pair_selector as jax_combination
from ssspy_tpu_torch.bss import (
    AuxFDICA,
    AuxLaplaceFDICA,
    GradFDICA,
    GradLaplaceFDICA,
    NaturalGradFDICA,
    NaturalGradLaplaceFDICA,
)
from ssspy_tpu_torch.fast import fast_aux_fdica, fast_grad_fdica
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops.fdica_steps import (
    aux_laplace_fdica_ip1_step,
    aux_laplace_fdica_ip2_step,
    fdica_laplace_loss,
    grad_laplace_fdica_step,
)
from ssspy_tpu_torch.utils import combination_pair_selector, from_jax_state, host_stft, make_mixture
from tests.regression.test_regression import N_ITER, _input, _load

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-10


def _planar(a):
    return jnp.asarray(np.stack([a.real, a.imag]))


def _from_planar(a):
    a = np.asarray(a)
    return a[0] + 1j * a[1]


def _run(fn, *args):
    """``fn(*args)`` jitted at XLA's lowest backend optimization, which compiles the sweeps in less time."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _si_sdr_db(est, ref):
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    return 10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err)))


def _spectrogram(n_channels=3, n_fft=32, n_frames=48, seed=0):
    """Small convolutive mixture STFT: ``(n_channels, n_fft // 2 + 1, n_frames)`` complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _problem(seed=3):
    rng = np.random.default_rng(seed)
    X = _spectrogram(seed=seed)[:, :17]
    noise = rng.standard_normal((17, 3, 3)) + 1j * rng.standard_normal((17, 3, 3))
    return X, np.eye(3)[None] + 0.2 * noise


# ---- the steps and the loss against splitc (float64) ------------------------------------------------------------


STEPS = {
    "IP1": (lambda Xs, Ws: splitc.aux_laplace_fdica_ip1_step_sc(Xs, Ws, eps=1e-10),
            lambda X, W: aux_laplace_fdica_ip1_step(X, W, eps=1e-10)),
    "IP2": (lambda Xs, Ws: splitc.aux_laplace_fdica_ip2_step_sc(Xs, Ws, eps=1e-10),
            lambda X, W: aux_laplace_fdica_ip2_step(X, W, eps=1e-10)),
    "grad": (lambda Xs, Ws: splitc.grad_laplace_fdica_step_sc(Xs, Ws, is_holonomic=False),
             lambda X, W: grad_laplace_fdica_step(X, W, is_holonomic=False)),
    "grad-holonomic": (lambda Xs, Ws: splitc.grad_laplace_fdica_step_sc(Xs, Ws),
                       lambda X, W: grad_laplace_fdica_step(X, W)),
    "natural-grad": (lambda Xs, Ws: splitc.grad_laplace_fdica_step_sc(Xs, Ws, natural=True),
                     lambda X, W: grad_laplace_fdica_step(X, W, natural=True)),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_fdica_step_matches_jax(name):
    X, W = _problem()
    jax_step, step = STEPS[name]
    ref = _from_planar(_run(jax_step, _planar(X), _planar(W)))
    state = from_jax_state({"X": np.asarray(_planar(X)), "W": np.asarray(_planar(W))})
    got = step(state["X"], state["W"])
    assert got.dtype == torch.complex128 and got.shape == W.shape
    assert _rel_err(got.numpy(), ref) <= TOL


def test_fdica_loss_matches_jax():
    X, W = _problem(4)
    ref = float(_run(splitc.fdica_laplace_loss_sc, _planar(X), _planar(W)))
    assert abs(float(fdica_laplace_loss(torch.from_numpy(X), torch.from_numpy(W))) - ref) <= TOL * abs(ref)


# ---- the classes on the regression fixtures (complex128) -------------------------------------------------------


FIXTURE_CASES = {
    "aux_laplace_fdica_ip1": lambda: AuxLaplaceFDICA(spatial_algorithm="IP", device="cpu"),
    "aux_laplace_fdica_ip2": lambda: AuxLaplaceFDICA(spatial_algorithm="IP2", device="cpu"),
    "grad_laplace_fdica_holonomic": lambda: GradLaplaceFDICA(is_holonomic=True, device="cpu"),
    "grad_laplace_fdica_nonholonomic": lambda: GradLaplaceFDICA(is_holonomic=False, device="cpu"),
    "natural_grad_laplace_fdica_holonomic": lambda: NaturalGradLaplaceFDICA(is_holonomic=True, device="cpu"),
    "natural_grad_laplace_fdica_nonholonomic": lambda: NaturalGradLaplaceFDICA(is_holonomic=False, device="cpu"),
}


@pytest.mark.parametrize("fixture", sorted(FIXTURE_CASES))
def test_class_matches_regression_fixture(fixture):
    """tests/regression/test_regression.py's FDICA cases on the port: complex128 within 1e-7."""
    method = FIXTURE_CASES[fixture]()
    Y = method(torch.from_numpy(_input()), n_iter=N_ITER)
    target = _load(fixture)
    assert Y.dtype == torch.complex128 and Y.shape == target.shape
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert min(_si_sdr_db(Y[n].numpy(), target[n]) for n in range(Y.shape[0])) > 50
    assert method.loss[-1] < method.loss[0]


def _laplace(y):
    return 2 * torch.abs(y)


def _jax_laplace(y):
    return 2 * jnp.abs(y)


def test_generic_aux_fdica_matches_the_jax_class():
    """The generic class (``d_contrast_fn(|y|) / flooring_fn(2 |y|)``) with a pair selector and MDP, unaligned."""
    X = _spectrogram(seed=5)[:2]
    common = dict(spatial_algorithm="IP2", scale_restoration="minimal_distortion_principle",
                  permutation_alignment=False)
    ref_method = JaxAuxFDICA(contrast_fn=_jax_laplace, d_contrast_fn=lambda y: 2 * jnp.ones_like(y), impl="complex",
                             pair_selector=functools.partial(jax_combination, sort=True), **common)
    ref = np.asarray(ref_method(X.copy(), n_iter=2))
    method = AuxFDICA(contrast_fn=_laplace, d_contrast_fn=lambda y: 2 * torch.ones_like(y), device="cpu",
                      pair_selector=functools.partial(combination_pair_selector, sort=True), **common)
    got = method(torch.from_numpy(X), n_iter=2)
    assert _rel_err(got.numpy(), ref) <= 1e-9
    np.testing.assert_allclose(method.loss, ref_method.loss, rtol=1e-10)


@pytest.mark.parametrize("spatial", ["IP1", "IP2"])
def test_generic_and_laplace_aux_fdica_agree_above_the_floor(spatial):
    """``2 / max(2 |y|, eps)`` and ``1 / max(|y|, eps)`` are one weight wherever ``|y| >= eps``: one trajectory, unaligned."""
    X = torch.from_numpy(_input())
    common = dict(spatial_algorithm=spatial, permutation_alignment=False, device="cpu")
    generic = AuxFDICA(contrast_fn=_laplace, d_contrast_fn=lambda y: 2 * torch.ones_like(y), **common)
    laplace = AuxLaplaceFDICA(**common)
    assert torch.equal(generic(X, n_iter=3), laplace(X, n_iter=3)) and generic.loss == laplace.loss


# ---- the fast paths ------------------------------------------------------------------------------------------


PORT_FAST = {
    "aux-IP1": lambda X: fast_aux_fdica(X, n_iter=5, device="cpu"),
    "aux-IP2": lambda X: fast_aux_fdica(X, n_iter=5, algorithm="IP2", device="cpu"),
    "grad": lambda X: fast_grad_fdica(X, n_iter=10, device="cpu"),
    "natural-grad-holonomic": lambda X: fast_grad_fdica(X, n_iter=10, natural=True, is_holonomic=True, device="cpu"),
}


@functools.lru_cache(maxsize=None)
def _jax_fast(name):
    """The JAX fast path's separated output on :func:`_spectrogram`, run once per module."""
    X = _spectrogram(seed=15)
    runs = {
        "aux-IP1": lambda: jax_fast_aux_fdica(X, n_iter=5),
        "aux-IP2": lambda: jax_fast_aux_fdica(X, n_iter=5, algorithm="IP2"),
        "grad": lambda: jax_fast_grad_fdica(X, n_iter=10),
        "natural-grad-holonomic": lambda: jax_fast_grad_fdica(X, n_iter=10, natural=True, is_holonomic=True),
    }
    return np.asarray(runs[name]()[0])


@pytest.mark.parametrize("name", sorted(PORT_FAST))
def test_fast_path_matches_the_jax_fast_path(name):
    """float32 both, aligned and rescaled both: the same permutation of every bin and >= 40 dB."""
    X = _spectrogram(seed=15)
    Y, W = PORT_FAST[name](X)
    assert Y.dtype == torch.complex64 and Y.shape == X.shape and W.shape == (X.shape[1], 3, 3)
    ref = _jax_fast(name)
    sdr = min(_si_sdr_db(Y[n].numpy().astype(np.complex128), ref[n]) for n in range(3))
    assert sdr >= 40.0, f"{name}: {sdr:.1f} dB"


@pytest.fixture(scope="module")
def easy_tier():
    """tests/test_fast_fidelity.py's mixture, STFT and quality measure on the port."""
    from tests.test_fast_fidelity import HOP, N_FFT, _best_perm_si_sdr
    from ssspy_tpu_torch.transform import istft, stft
    from ssspy_tpu_torch.utils import sample_speech_mixture

    images, _ = sample_speech_mixture(n_sources=2, max_duration=2.0, conv=True, seed=0)
    mix = images.sum(axis=0)
    X = stft(mix, n_fft=N_FFT, hop_length=HOP, device="cpu").numpy()

    def quality(Y):
        y = istft(Y.to(torch.complex128), n_fft=N_FFT, hop_length=HOP, length=mix.shape[-1], device="cpu")
        return _best_perm_si_sdr(y.numpy(), images[:, 0])

    with open(os.path.join(TESTS, "fidelity_pins.json")) as f:
        pins = json.load(f)
    return X, quality, pins


PINNED = {  # tests/test_fast_fidelity.py:233-250, :417-437
    "aux_fdica_IP1": lambda X: fast_aux_fdica(X, n_iter=30, device="cpu"),
    "aux_fdica_IP2": lambda X: fast_aux_fdica(X, n_iter=30, algorithm="IP2", device="cpu"),
    "grad_fdica_natural=False": lambda X: fast_grad_fdica(X, n_iter=100, device="cpu"),
    "grad_fdica_natural=True": lambda X: fast_grad_fdica(X, n_iter=100, natural=True, device="cpu"),
}


@pytest.mark.parametrize("pin", sorted(PINNED))
def test_fast_path_meets_the_fidelity_pin(pin, easy_tier):
    """tests/test_fast_fidelity.py's FDICA cases on the port: within 0.1 dB of the pinned reference SI-SDR."""
    X, quality, pins = easy_tier
    got = quality(PINNED[pin](X)[0])
    assert abs(got - pins[pin]) <= 0.1, f"{pin}: {got:.3f} vs {pins[pin]:.3f} dB"


# ---- the classes against their fast paths, the kernels, the state bridge, the card ---------------------------------


RAW = dict(permutation_alignment=False, scale_restoration=False, device="cpu")
CLASS_AND_FAST = {
    "IP1": (lambda: AuxLaplaceFDICA(spatial_algorithm="IP1", **RAW), lambda X: fast_aux_fdica(X, n_iter=4, **RAW)),
    "IP2": (lambda: AuxLaplaceFDICA(spatial_algorithm="IP2", **RAW),
            lambda X: fast_aux_fdica(X, n_iter=4, algorithm="IP2", **RAW)),
    "grad": (lambda: GradLaplaceFDICA(flooring_fn="f64", **RAW), lambda X: fast_grad_fdica(X, n_iter=4, **RAW)),
    "natural-grad-holonomic": (lambda: NaturalGradLaplaceFDICA(is_holonomic=True, flooring_fn="f64", **RAW),
                               lambda X: fast_grad_fdica(X, n_iter=4, natural=True, is_holonomic=True, **RAW)),
}


@pytest.mark.parametrize("name", sorted(CLASS_AND_FAST))
def test_laplace_class_equals_its_fast_path(name):
    """At the fast path's floor (1e-6 in complex64 for AuxFDICA, 1e-10 for the gradient), unaligned and unscaled: the
    class's aligner reads the amplitudes in the input's precision and the fast path's in float64, as in the JAX
    package, so aligned outputs may take another permutation in a bin that nearly ties."""
    X = torch.from_numpy(_spectrogram(seed=21).astype(np.complex64))
    make, fast = CLASS_AND_FAST[name]
    method = make()
    Y = method(X, n_iter=4)
    Y_fast, W_fast = fast(X)
    assert torch.equal(Y, Y_fast) and torch.equal(method.demix_filter, W_fast)


def test_complex64_paths_hand_the_kernels_what_they_take(monkeypatch):
    """IP1: K1 with (N, I, T) weights and K1b once an iteration; IP2: K1 at two sources once a pair, no K1b; gradient: none."""
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    checked = []

    def checking(X, varphi):
        K._check_weighted_covariance(X, varphi)
        checked.append(tuple(varphi.shape))
        return K.weighted_covariance_plain(X, varphi)

    def sweeping(W, U, eps=1e-10):
        K._check_ip1_sweep(W, U)
        checked.append("K1b")
        return K.ip1_sweep_plain(W, U, eps=eps)

    def refuse(*args, **kwargs):
        raise AssertionError("no FDICA path runs this kernel")

    monkeypatch.setattr(K, "weighted_covariance", checking)
    monkeypatch.setattr(K, "ip1_sweep", sweeping)
    for name in ("iss1_sweep", "jacobi_eigh", "ipa_congruence"):
        monkeypatch.setattr(K, name, refuse)
    X = _spectrogram(seed=17).astype(np.complex64)
    shape = (3,) + X.shape[1:]
    fast_aux_fdica(X, n_iter=2, device="cpu")
    AuxLaplaceFDICA(device="cpu")(torch.from_numpy(X), n_iter=1)
    assert checked == [shape, "K1b"] * 3
    checked.clear()
    fast_aux_fdica(X, n_iter=1, algorithm="IP2", device="cpu")
    assert checked == [(2,) + X.shape[1:]] * 3
    checked.clear()
    fast_grad_fdica(X, n_iter=2, device="cpu")
    AuxLaplaceFDICA(device="cpu")(torch.from_numpy(X.astype(np.complex128)), n_iter=1)  # complex128: plain routes
    assert checked == []


def test_state_bridge_carries_an_fdica_state():
    X, W = _problem(6)
    for dtype in (np.float32, np.float64):
        state = from_jax_state({"X": np.asarray(_planar(X)).astype(dtype), "W": np.asarray(_planar(W)).astype(dtype)})
        assert state["X"].dtype == state["W"].dtype == (torch.complex64 if dtype == np.float32 else torch.complex128)
        np.testing.assert_allclose(state["W"].numpy(), W, rtol=1e-6 if dtype == np.float32 else 0)
    method = AuxLaplaceFDICA(device="cpu")
    method(torch.from_numpy(X), n_iter=1, demix_filter=from_jax_state({"W": np.asarray(_planar(W))})["W"])
    assert method.loss[0] == pytest.approx(float(fdica_laplace_loss(torch.from_numpy(X), torch.from_numpy(W))))


def test_fdica_options_raise_as_the_jax_classes_do():
    with pytest.raises(ValueError, match="unsupported"):
        AuxLaplaceFDICA(spatial_algorithm="ISS1", device="cpu")
    with pytest.raises(ValueError, match="contrast_fn"):
        GradFDICA(score_fn=lambda y: y, device="cpu")
    with pytest.raises(ValueError, match="no ISS1"):
        fast_aux_fdica(np.zeros((2, 3, 4), np.complex64), algorithm="ISS1", device="cpu")
    method = NaturalGradFDICA(contrast_fn=_laplace, score_fn=lambda y: y, permutation_alignment="score", device="cpu")
    with pytest.raises(NotImplementedError, match="score"):
        method(torch.from_numpy(_spectrogram(seed=2)), n_iter=1)


def test_fdica_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    X = np.zeros((2, 3, 4), np.complex64)
    entry_points = [
        lambda: AuxLaplaceFDICA(),
        lambda: GradLaplaceFDICA(),
        lambda: fast_aux_fdica(X, n_iter=1),
        lambda: fast_grad_fdica(X, n_iter=1),
    ]
    if torch.cuda.is_available():
        assert AuxLaplaceFDICA().device.type == "cuda"
        return
    for call in entry_points:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
