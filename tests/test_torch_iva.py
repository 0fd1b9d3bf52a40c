"""ssspy_tpu_torch AuxIVA (IP1, ISS1) against the JAX package and the regression fixtures.

Same numpy inputs through the JAX function and its port: the f32 steps
and losses, the complex128 class on ``tests/regression/fixtures`` (the
reference's own 1e-7 tolerance), ``fast_auxiva``, the iteration driver's
callbacks / loss trace / warm start, STFT/iSTFT, scale restoration, the
waveform pipeline, the default device and the JAX-state bridge. All on
the CPU (``device="cpu"``), where the kernel wrappers take their plain
versions.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ssspy_tpu.algorithm import minimal_distortion_principle as jax_mdp
from ssspy_tpu.algorithm import projection_back as jax_projection_back
from ssspy_tpu.bss.iva import AuxIVA as JaxAuxIVA
from ssspy_tpu.fast import fast_auxiva as jax_fast_auxiva
from ssspy_tpu.ops.splitc import (
    auxiva_ip1_step_sc,
    auxiva_iss1_step_sc,
    clogabsdet_sc,
    iva_laplace_loss_sc,
)
from ssspy_tpu.transform import istft as jax_istft
from ssspy_tpu.transform import stft as jax_stft
from ssspy_tpu_torch import separate as torch_separate
from ssspy_tpu_torch.algorithm import minimal_distortion_principle, projection_back
from ssspy_tpu_torch.bss.iva import AuxIVA, AuxLaplaceIVA
from ssspy_tpu_torch.fast import fast_auxiva
from ssspy_tpu_torch.ops import auxiva_ip1_step, auxiva_iss1_step, clogabsdet, iva_laplace_loss
from ssspy_tpu_torch.transform import istft, stft
from ssspy_tpu_torch.utils import (
    complex_to_planar,
    from_jax_state,
    host_stft,
    make_mixture,
    planar_to_complex,
)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "regression", "fixtures")


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _spectrogram(n_channels=3, n_fft=64, n_frames=40, seed=0):
    """Small convolutive mixture STFT: (n_channels, n_fft//2 + 1, n_frames) complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _jax_contrast(y):
    return 2 * jnp.linalg.norm(y, axis=1)


def _jax_d_contrast(y):
    return 2 * jnp.ones_like(y)


def _torch_contrast(y):
    return 2 * torch.linalg.vector_norm(y, dim=1)


def _torch_d_contrast(y):
    return 2 * torch.ones_like(y)


def _jax_class(spatial_algorithm="IP1", **kwargs):
    return JaxAuxIVA(
        spatial_algorithm=spatial_algorithm,
        contrast_fn=_jax_contrast,
        d_contrast_fn=_jax_d_contrast,
        **kwargs,
    )


def _torch_class(spatial_algorithm="IP1", **kwargs):
    return AuxIVA(
        spatial_algorithm=spatial_algorithm,
        contrast_fn=_torch_contrast,
        d_contrast_fn=_torch_d_contrast,
        device="cpu",
        **kwargs,
    )


# ---- the step and its loss (f32) -------------------------------------------


@pytest.mark.parametrize("covariance_impl", ["einsum", "interpret"])
@pytest.mark.parametrize("n_channels", [3, 8])
def test_auxiva_ip1_step_and_loss_match_jax_f32(n_channels, covariance_impl):
    X = _spectrogram(n_channels=n_channels, n_frames=40, seed=n_channels)
    Xs = np.stack([X.real, X.imag]).astype(np.float32)
    rng = np.random.default_rng(1)
    W = np.eye(n_channels)[None] + 0.1 * (
        rng.standard_normal((33, n_channels, n_channels))
        + 1j * rng.standard_normal((33, n_channels, n_channels))
    )
    Ws = np.stack([W.real, W.imag]).astype(np.float32)

    ref = np.asarray(auxiva_ip1_step_sc(jnp.asarray(Xs), jnp.asarray(Ws), covariance_impl=covariance_impl))
    state = from_jax_state({"X": Xs, "W": Ws})
    assert state["X"].dtype == torch.complex64
    W_new = auxiva_ip1_step(state["X"], state["W"])
    assert _rel_err(complex_to_planar(W_new), ref) <= 1e-4

    # loss: the JAX logdet squares W into its Gram matrix (~1e-3 relative in f32)
    loss_ref = float(iva_laplace_loss_sc(jnp.asarray(Xs), jnp.asarray(ref)))
    loss = float(iva_laplace_loss(state["X"], W_new))
    assert abs(loss - loss_ref) <= 1e-3 * abs(loss_ref)
    logdet_ref = np.asarray(clogabsdet_sc(jnp.asarray(ref[0]), jnp.asarray(ref[1])))
    logdet = clogabsdet(W_new).numpy()
    assert np.abs(logdet - logdet_ref).max() <= 1e-3 * np.abs(logdet_ref).max()


@pytest.mark.parametrize("n_channels", [3, 8])
def test_auxiva_iss1_step_and_loss_match_jax_f32(n_channels):
    X = _spectrogram(n_channels=n_channels, n_frames=40, seed=20 + n_channels)
    rng = np.random.default_rng(21)
    W = np.eye(n_channels)[None] + 0.1 * (
        rng.standard_normal((33, n_channels, n_channels))
        + 1j * rng.standard_normal((33, n_channels, n_channels))
    )
    Y = np.einsum("inm,mit->nit", W, X)
    Xs, Ys = (np.stack([a.real, a.imag]).astype(np.float32) for a in (X, Y))

    ref = np.asarray(auxiva_iss1_step_sc(jnp.asarray(Ys)))
    state = from_jax_state({"X": Xs, "Y": Ys})
    Y_new = auxiva_iss1_step(state["Y"])
    assert Y_new.dtype == torch.complex64
    assert _rel_err(complex_to_planar(Y_new), ref) <= 1e-4

    # the Y-state loss recovers W by least squares (and squares it into its
    # Gram matrix on the JAX side: ~1e-3 relative in f32)
    loss_ref = float(iva_laplace_loss_sc(jnp.asarray(Xs), Ys=jnp.asarray(ref)))
    loss = float(iva_laplace_loss(state["X"], Y=Y_new))
    assert abs(loss - loss_ref) <= 1e-3 * abs(loss_ref)


# ---- the class (complex128) ----------------------------------------------------


def _si_sdr_db(est, ref):
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    return 10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err)))


@pytest.mark.parametrize("spatial_algorithm", ["IP", "IP1", "ISS", "ISS1"])
def test_auxiva_class_matches_regression_fixture(spatial_algorithm):
    X = np.load(os.path.join(FIXTURES, "input.npz"))["spectrogram"]
    fixture = "auxiva_iss1" if spatial_algorithm.startswith("ISS") else "auxiva_ip1"
    target = np.load(os.path.join(FIXTURES, f"{fixture}.npz"))["target"]
    iva = _torch_class(spatial_algorithm)
    Y = iva(torch.from_numpy(X.copy()), n_iter=10)
    assert Y.dtype == torch.complex128 and Y.shape == target.shape
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    for n in range(Y.shape[0]):
        assert _si_sdr_db(Y[n].numpy(), target[n]) > 50
    assert len(iva.loss) == 11 and iva.loss[-1] < iva.loss[0]


def test_aux_laplace_iva_is_the_laplace_auxiva():
    X = torch.from_numpy(_spectrogram(seed=3))
    for algorithm in ("IP", "ISS1"):
        Y_laplace = AuxLaplaceIVA(spatial_algorithm=algorithm, device="cpu")(X, n_iter=5)
        Y_generic = _torch_class(algorithm)(X, n_iter=5)
        torch.testing.assert_close(Y_laplace, Y_generic, rtol=0, atol=0)


def test_callbacks_and_loss_trace_match_jax():
    X = _spectrogram(seed=4)
    seen_jax, seen_torch = [], []
    jax_iva = _jax_class(callbacks=lambda m: seen_jax.append(len(m.loss)))
    torch_iva = _torch_class(callbacks=[lambda m: seen_torch.append(len(m.loss))])
    Y_jax = np.asarray(jax_iva(X.copy(), n_iter=6))
    Y_torch = torch_iva(torch.from_numpy(X.copy()), n_iter=6)

    assert seen_torch == seen_jax == list(range(1, 8))
    np.testing.assert_allclose(torch_iva.loss, jax_iva.loss, rtol=1e-9)
    np.testing.assert_allclose(Y_torch.numpy(), Y_jax, atol=1e-9)


def test_loss_trace_without_callbacks_matches_jax():
    X = _spectrogram(seed=5)
    jax_iva, torch_iva = _jax_class(), _torch_class()
    jax_iva(X.copy(), n_iter=6)
    torch_iva(torch.from_numpy(X.copy()), n_iter=6)
    assert all(isinstance(v, float) for v in torch_iva.loss)
    np.testing.assert_allclose(torch_iva.loss, jax_iva.loss, rtol=1e-9)

    # a second call continues from the committed state; initial_call=False
    # skips the loss of the starting point, as in the JAX class
    jax_iva(X.copy(), n_iter=2, initial_call=False)
    torch_iva(torch.from_numpy(X.copy()), n_iter=2, initial_call=False)
    assert len(torch_iva.loss) == len(jax_iva.loss) == 9
    np.testing.assert_allclose(torch_iva.loss, jax_iva.loss, rtol=1e-9)


def test_record_loss_off_keeps_no_trace_and_the_same_output():
    X = torch.from_numpy(_spectrogram(seed=6))
    quiet = _torch_class(record_loss=False)
    Y_quiet = quiet(X, n_iter=4)
    assert quiet.loss is None
    torch.testing.assert_close(Y_quiet, _torch_class()(X, n_iter=4), rtol=0, atol=0)


def test_warm_start_with_demix_filter_matches_jax():
    X = _spectrogram(seed=7)
    rng = np.random.default_rng(8)
    W0 = np.eye(3)[None] + 0.1 * (rng.standard_normal((33, 3, 3)) + 1j * rng.standard_normal((33, 3, 3)))
    jax_iva, torch_iva = _jax_class(scale_restoration=False), _torch_class(scale_restoration=False)
    Y_jax = np.asarray(jax_iva(X.copy(), n_iter=3, demix_filter=W0))
    Y_torch = torch_iva(torch.from_numpy(X.copy()), n_iter=3, demix_filter=W0)
    np.testing.assert_allclose(Y_torch.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(torch_iva.loss, jax_iva.loss, rtol=1e-9)


def test_update_once_and_compute_loss_follow_the_iteration():
    X = torch.from_numpy(_spectrogram(seed=9))
    iva = _torch_class(scale_restoration=False)
    iva(X, n_iter=2)
    loss_before = iva.compute_loss()
    iva.update_once()
    assert iva.compute_loss() <= loss_before
    stepped = _torch_class(scale_restoration=False)
    torch.testing.assert_close(stepped(X, n_iter=3), iva.output, rtol=0, atol=1e-12)


@pytest.mark.parametrize("scale_restoration", ["MDP", "projection_back"])
def test_scale_restoration_matches_jax(scale_restoration):
    X = _spectrogram(seed=10)
    Y_jax = np.asarray(_jax_class(scale_restoration=scale_restoration)(X.copy(), n_iter=3))
    Y_torch = _torch_class(scale_restoration=scale_restoration)(torch.from_numpy(X.copy()), n_iter=3)
    np.testing.assert_allclose(Y_torch.numpy(), Y_jax, atol=1e-9)


@pytest.mark.parametrize("reference_id", [0, None])
def test_projection_back_and_mdp_match_jax(reference_id):
    rng = np.random.default_rng(11)
    W = rng.standard_normal((5, 3, 3)) + 1j * rng.standard_normal((5, 3, 3))
    Y = rng.standard_normal((3, 5, 7)) + 1j * rng.standard_normal((3, 5, 7))
    X = rng.standard_normal((3, 5, 7)) + 1j * rng.standard_normal((3, 5, 7))
    W_t, Y_t, X_t = (torch.from_numpy(a) for a in (W, Y, X))
    pairs = [
        (projection_back(W_t, reference_id=reference_id), jax_projection_back(W, reference_id=reference_id)),
        (
            projection_back(Y_t, reference=X_t, reference_id=reference_id),
            jax_projection_back(Y, reference=X, reference_id=reference_id),
        ),
        (
            minimal_distortion_principle(Y_t, reference=X_t, reference_id=reference_id),
            jax_mdp(Y, reference=X, reference_id=reference_id),
        ),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("algorithm", ["IP2", "ISS2", "IPA"])
def test_unported_spatial_algorithms_raise(algorithm):
    if algorithm == "IPA":  # ported since: it constructs, and its keywords belong to it alone
        assert AuxLaplaceIVA(spatial_algorithm="IPA", device="cpu", newton_iter=2).newton_iter == 2
        with pytest.raises(ValueError, match="Invalid keywords"):
            AuxLaplaceIVA(spatial_algorithm="IP", device="cpu", newton_iter=2)
        return
    # ported since: the class and fast_auxiva run on the CPU and match their JAX twins
    X = _spectrogram(seed=26)
    jax_iva, torch_iva = _jax_class(algorithm), _torch_class(algorithm)
    Y_jax = np.asarray(jax_iva(X.copy(), n_iter=3))
    Y_torch = torch_iva(torch.from_numpy(X.copy()), n_iter=3)
    np.testing.assert_allclose(Y_torch.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(torch_iva.loss, jax_iva.loss, rtol=1e-9)
    assert (torch_iva.demix_filter is None) == (algorithm == "ISS2")
    Y_fast_jax, _ = jax_fast_auxiva(X, n_iter=3, algorithm=algorithm)
    Y_fast, W_fast = fast_auxiva(X, n_iter=3, algorithm=algorithm, device="cpu")
    assert Y_fast.dtype == torch.complex64 and (W_fast is None) == (algorithm == "ISS2")
    assert _rel_err(Y_fast.numpy(), Y_fast_jax) <= 1e-3


@pytest.mark.parametrize("scale_restoration", ["MDP", "projection_back"])
def test_iss1_scale_restoration_matches_jax(scale_restoration):
    X = _spectrogram(seed=10)
    jax_iva = _jax_class("ISS1", scale_restoration=scale_restoration)
    torch_iva = _torch_class("ISS1", scale_restoration=scale_restoration)
    Y_jax = np.asarray(jax_iva(X.copy(), n_iter=3))
    Y_torch = torch_iva(torch.from_numpy(X.copy()), n_iter=3)
    assert torch_iva.demix_filter is None
    np.testing.assert_allclose(Y_torch.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(torch_iva.loss, jax_iva.loss, rtol=1e-9)


def test_iss1_warm_start_and_callbacks_match_jax():
    X = _spectrogram(seed=23)
    rng = np.random.default_rng(24)
    W0 = np.eye(3)[None] + 0.1 * (rng.standard_normal((33, 3, 3)) + 1j * rng.standard_normal((33, 3, 3)))
    seen_jax, seen_torch = [], []
    jax_iva = _jax_class("ISS1", callbacks=lambda m: seen_jax.append(len(m.loss)))
    torch_iva = _torch_class("ISS1", callbacks=lambda m: seen_torch.append(len(m.loss)))
    Y_jax = np.asarray(jax_iva(X.copy(), n_iter=3, demix_filter=W0))
    Y_torch = torch_iva(torch.from_numpy(X.copy()), n_iter=3, demix_filter=W0)
    assert seen_torch == seen_jax == [1, 2, 3, 4]
    np.testing.assert_allclose(Y_torch.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(torch_iva.loss, jax_iva.loss, rtol=1e-9)


# ---- fast_auxiva ---------------------------------------------------------------


@pytest.mark.parametrize("scale_restoration", [True, False])
def test_fast_auxiva_matches_jax(scale_restoration):
    X = _spectrogram(n_channels=3, n_fft=64, n_frames=40, seed=13)
    assert X.shape == (3, 33, 40)
    Y_jax, W_jax = jax_fast_auxiva(X, n_iter=5, scale_restoration=scale_restoration)
    Y, W = fast_auxiva(X, n_iter=5, scale_restoration=scale_restoration, device="cpu")
    assert Y.dtype == torch.complex64 and Y.shape == X.shape and W.shape == (33, 3, 3)
    assert _rel_err(W.numpy(), W_jax) <= 1e-3
    assert _rel_err(Y.numpy(), Y_jax) <= 1e-3


def test_fast_auxiva_iss1_matches_jax():
    X = _spectrogram(n_channels=3, n_fft=64, n_frames=40, seed=25)
    Y_jax, W_jax = jax_fast_auxiva(X, n_iter=5, algorithm="ISS1")
    Y, W = fast_auxiva(X, n_iter=5, algorithm="ISS1", device="cpu")
    assert W is None and W_jax is None
    assert Y.dtype == torch.complex64 and Y.shape == X.shape
    assert _rel_err(Y.numpy(), Y_jax) <= 1e-3


# ---- the card is the default device ---------------------------------------------


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    X = np.zeros((2, 3, 4), np.complex64)
    entry_points = [
        lambda: AuxLaplaceIVA(),
        lambda: fast_auxiva(X, n_iter=1),
        lambda: fast_auxiva(X, n_iter=1, algorithm="ISS1"),
        lambda: torch_separate(np.zeros((2, 64)), AuxLaplaceIVA(device="cpu"), n_iter=1, n_fft=16),
    ]
    if torch.cuda.is_available():
        assert AuxLaplaceIVA().device.type == "cuda"
    else:
        for call in entry_points:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert AuxLaplaceIVA(device="cpu").device == torch.device("cpu")


# ---- STFT / iSTFT and the pipeline ------------------------------------------


@pytest.mark.parametrize(
    "shape,n_fft,hop,center",
    [((2, 1000), 128, None, True), ((3, 777), 64, 16, True), ((500,), 32, 8, False)],
)
def test_stft_istft_match_jax_f64(shape, n_fft, hop, center):
    x = np.random.default_rng(14).standard_normal(shape)
    S_ref = np.asarray(jax_stft(x, n_fft=n_fft, hop_length=hop, center=center))
    S = stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop, center=center, device="cpu")
    assert S.dtype == torch.complex128 and S.shape == S_ref.shape
    np.testing.assert_allclose(S.numpy(), S_ref, atol=1e-8)

    length = shape[-1]
    x_ref = np.asarray(jax_istft(S_ref, n_fft=n_fft, hop_length=hop, center=center, length=length))
    x_back = istft(S, n_fft=n_fft, hop_length=hop, center=center, length=length, device="cpu")
    np.testing.assert_allclose(x_back.numpy(), x_ref, atol=1e-8)
    if center:  # round trip (uncentred framing leaves the tail unframed)
        np.testing.assert_allclose(x_back.numpy(), x, atol=1e-8)


def test_stft_matches_the_host_stft_of_the_main_path():
    x = make_mixture()
    X = stft(torch.from_numpy(x), n_fft=512, hop_length=256, device="cpu")
    assert X.shape == (8, 257, 626)
    np.testing.assert_allclose(X.numpy(), host_stft(x), atol=1e-8)
    np.testing.assert_allclose(x, bench.make_mixture(), rtol=1e-10, atol=1e-10)


def test_pipeline_separate_returns_waveforms():
    x = make_mixture(n_channels=2, duration_s=0.25, seed=15).astype(np.float32)
    y = torch_separate(
        torch.from_numpy(x),
        AuxLaplaceIVA(spatial_algorithm="IP", device="cpu"),
        n_iter=3,
        n_fft=256,
        device="cpu",
    )
    assert y.shape == x.shape and y.dtype == torch.float32
    assert torch.isfinite(y).all()


def test_planar_conversion_round_trips():
    a = np.random.default_rng(16).standard_normal((2, 4, 5)).astype(np.float32)
    t = planar_to_complex(a)
    assert t.dtype == torch.complex64 and t.shape == (4, 5)
    np.testing.assert_array_equal(complex_to_planar(t), a)
    z = a[0] + 1j * a[1]
    state = from_jax_state({"X": z, "W": a})
    torch.testing.assert_close(state["X"], torch.from_numpy(z))
    torch.testing.assert_close(state["W"], t)
    with pytest.raises(ValueError):
        planar_to_complex(a[:1])


@pytest.mark.parametrize("spec", ["f32", "f64", "dtype", None])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flooring_matches_jax(spec, dtype):
    from ssspy_tpu.special.flooring import resolve_flooring_spec as jax_resolve
    from ssspy_tpu_torch.special.flooring import choose_flooring_fn, resolve_flooring_spec

    x = np.array([0.0, 1e-12, 1e-8, 1e-3, 2.0], dtype=dtype)
    floor = resolve_flooring_spec(spec)
    got = floor(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_resolve(spec)(jnp.asarray(x))))

    class Method:
        flooring_fn = staticmethod(floor)

    assert choose_flooring_fn("self", method=Method()) is floor
    assert choose_flooring_fn(floor) is floor
    np.testing.assert_array_equal(choose_flooring_fn(None)(torch.from_numpy(x)).numpy(), x)


def test_from_jax_state_decides_by_key_not_by_shape():
    """A 2-source ILRMA state: real NMF factors with a leading axis of 2 stay real."""
    rng = np.random.default_rng(26)
    Xs = rng.standard_normal((2, 2, 5, 7)).astype(np.float32)  # planar (M=2, I, T)
    Ws = rng.standard_normal((2, 5, 2, 2)).astype(np.float32)
    T = rng.random((2, 5, 3)).astype(np.float32)  # (N=2, I, K)
    V = rng.random((2, 3, 7))  # (N=2, K, T), float64
    state = from_jax_state({"X": Xs, "W": Ws, "T": T, "V": V})
    assert state["X"].dtype == torch.complex64 and state["X"].shape == (2, 5, 7)
    assert state["W"].dtype == torch.complex64 and state["W"].shape == (5, 2, 2)
    assert state["T"].dtype == torch.float32 and state["T"].shape == (2, 5, 3)
    assert state["V"].dtype == torch.float64 and state["V"].shape == (2, 3, 7)
    np.testing.assert_array_equal(state["T"].numpy(), T)
    # a complex class state passes as it is
    Y = Xs[0] + 1j * Xs[1]
    torch.testing.assert_close(from_jax_state({"Y": Y})["Y"], torch.from_numpy(Y))
    with pytest.raises(ValueError, match="unknown state key"):
        from_jax_state({"U": T})
    with pytest.raises(ValueError, match="must be real"):
        from_jax_state({"T": T + 0j})
