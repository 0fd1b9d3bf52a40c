"""ssspy_tpu_torch ILRMA (Gauss, t, GGD; IP1 and ISS1) against the JAX package and the fixtures.

Same numpy inputs through the JAX function and its port: the complex128
classes on ``tests/regression/fixtures`` (the reference's own 1e-7
tolerance), one f32 step and the loss against the split-complex steps,
the ``fast_*`` paths, projection-back normalization, warm start and
callbacks against the JAX class, and the waveform pipeline. All on the
CPU (``device="cpu"``), where the kernel wrappers take their plain
versions.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ssspy_tpu.bss.ilrma import GaussILRMA as JaxGaussILRMA
from ssspy_tpu.fast import fast_gauss_ilrma as jax_fast_gauss_ilrma
from ssspy_tpu.fast import fast_ggd_ilrma as jax_fast_ggd_ilrma
from ssspy_tpu.fast import fast_t_ilrma as jax_fast_t_ilrma
from ssspy_tpu.ops.splitc import (
    gauss_ilrma_ip1_step_sc,
    gauss_ilrma_iss1_step_sc,
    ilrma_ip_step_sc,
    ilrma_iss_step_sc,
    ilrma_loss_sc,
)
from ssspy_tpu_torch import separate as torch_separate
from ssspy_tpu_torch.bss import AuxLaplaceIVA, GaussILRMA, GGDILRMA, TILRMA
from ssspy_tpu_torch.fast import fast_auxiva, fast_gauss_ilrma, fast_ggd_ilrma, fast_t_ilrma
from ssspy_tpu_torch.ops import (
    gauss_ilrma_ip1_step,
    gauss_ilrma_iss1_step,
    ilrma_ip_step,
    ilrma_iss_step,
    ilrma_loss,
)
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.utils import complex_to_planar, from_jax_state, host_stft, make_mixture

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "regression", "fixtures")
N_ITER = 10
MODEL_KWARGS = {"gauss": {}, "t": {"dof": 100.0}, "ggd": {"shape": 1.5}}


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _spectrogram(n_channels=3, n_fft=64, n_frames=40, seed=0):
    """Small convolutive mixture STFT: (n_channels, n_fft//2 + 1, n_frames) complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _nmf_init(n_sources, n_bins, n_frames, n_basis=2, seed=5):
    """The warm start of tests/regression/test_regression.py:_nmf_init."""
    rng = np.random.default_rng(seed)
    return {
        "basis": rng.random((n_sources, n_bins, n_basis)),
        "activation": rng.random((n_sources, n_basis, n_frames)),
    }


# ---- the classes on the reference fixtures (complex128) -------------------------

_FIXTURE_CASES = [
    ("gauss_ilrma_ip1", GaussILRMA, "IP", {}),
    ("gauss_ilrma_iss1", GaussILRMA, "ISS1", {}),
    ("gauss_ilrma_ip1_me", GaussILRMA, "IP1", {"source_algorithm": "ME"}),
    ("gauss_ilrma_iss1_me", GaussILRMA, "ISS1", {"source_algorithm": "ME"}),
    ("t_ilrma_ip1", TILRMA, "IP", {"dof": 100}),
    ("t_ilrma_ip1_mm", TILRMA, "IP1", {"dof": 1000}),
    ("t_ilrma_ip1_me", TILRMA, "IP1", {"dof": 1000, "source_algorithm": "ME"}),
    ("t_ilrma_iss1_mm", TILRMA, "ISS1", {"dof": 1000}),
    ("t_ilrma_iss1_me", TILRMA, "ISS1", {"dof": 1000, "source_algorithm": "ME"}),
    ("ggd_ilrma_ip1", GGDILRMA, "IP1", {"beta": 1.5}),
    ("ggd_ilrma_iss1", GGDILRMA, "ISS1", {"beta": 1.5}),
]


@pytest.mark.parametrize(
    "fixture,cls,spatial,kwargs", _FIXTURE_CASES, ids=[c[0] for c in _FIXTURE_CASES]
)
def test_ilrma_class_matches_regression_fixture(fixture, cls, spatial, kwargs):
    X = np.load(os.path.join(FIXTURES, "input.npz"))["spectrogram"]
    target = np.load(os.path.join(FIXTURES, f"{fixture}.npz"))["target"]
    ilrma = cls(n_basis=2, spatial_algorithm=spatial, device="cpu", **kwargs)
    Y = ilrma(torch.from_numpy(X.copy()), n_iter=N_ITER, **_nmf_init(*X.shape))
    assert Y.dtype == torch.complex128 and Y.shape == target.shape
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert (ilrma.demix_filter is None) == spatial.startswith("ISS")
    assert len(ilrma.loss) == N_ITER + 1 and ilrma.loss[-1] < ilrma.loss[0]


# ---- one f32 step and the loss against the split-complex steps ---------------------


def _f32_state(n_channels=3, seed=30):
    X = _spectrogram(n_channels=n_channels, seed=seed)
    M, I, T = X.shape
    rng = np.random.default_rng(seed + 1)
    W = np.eye(M)[None] + 0.1 * (rng.standard_normal((I, M, M)) + 1j * rng.standard_normal((I, M, M)))
    Y = np.einsum("inm,mit->nit", W, X)
    Xs, Ws, Ys = (np.stack([a.real, a.imag]).astype(np.float32) for a in (X, W, Y))
    T0 = rng.random((M, I, 2)).astype(np.float32)
    V0 = rng.random((M, 2, T)).astype(np.float32)
    return Xs, Ws, Ys, T0, V0


def test_gauss_ilrma_steps_match_jax_f32():
    Xs, Ws, Ys, T0, V0 = _f32_state()
    state = from_jax_state({"X": Xs, "W": Ws, "Y": Ys, "T": T0, "V": V0})

    W_ref, T_ref, V_ref = gauss_ilrma_ip1_step_sc(*map(jnp.asarray, (Xs, Ws, T0, V0)))
    W, T, V = gauss_ilrma_ip1_step(state["X"], state["W"], state["T"], state["V"])
    assert W.dtype == torch.complex64 and T.dtype == V.dtype == torch.float32
    assert _rel_err(complex_to_planar(W), W_ref) <= 1e-4
    assert _rel_err(T.numpy(), T_ref) <= 1e-4 and _rel_err(V.numpy(), V_ref) <= 1e-4

    Y_ref, T_ref, V_ref = gauss_ilrma_iss1_step_sc(*map(jnp.asarray, (Ys, T0, V0)))
    Y, T, V = gauss_ilrma_iss1_step(state["Y"], state["T"], state["V"])
    assert _rel_err(complex_to_planar(Y), Y_ref) <= 1e-4
    assert _rel_err(T.numpy(), T_ref) <= 1e-4 and _rel_err(V.numpy(), V_ref) <= 1e-4


@pytest.mark.parametrize(
    "model,me", [("t", False), ("t", True), ("ggd", False)], ids=["t_MM", "t_ME", "ggd_MM"]
)
def test_generic_ilrma_steps_match_jax_f32(model, me):
    Xs, Ws, Ys, T0, V0 = _f32_state(seed=32)
    state = from_jax_state({"X": Xs, "W": Ws, "Y": Ys, "T": T0, "V": V0})
    kw = {**MODEL_KWARGS[model], "model": model, "me": me}

    refs = ilrma_ip_step_sc(*map(jnp.asarray, (Xs, Ws, T0, V0)), **kw)
    gots = ilrma_ip_step(state["X"], state["W"], state["T"], state["V"], **kw)
    for got, ref in zip(gots, refs):
        got = complex_to_planar(got) if got.is_complex() else got.numpy()
        assert _rel_err(got, ref) <= 1e-4

    refs = ilrma_iss_step_sc(*map(jnp.asarray, (Ys, T0, V0)), **kw)
    gots = ilrma_iss_step(state["Y"], state["T"], state["V"], **kw)
    for got, ref in zip(gots, refs):
        got = complex_to_planar(got) if got.is_complex() else got.numpy()
        assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("model", ["gauss", "t", "ggd"])
def test_ilrma_loss_matches_jax_f32(model):
    """1e-3: the JAX loss squares W into its Gram matrix (splitc.py:4153-4156)."""
    Xs, Ws, Ys, T0, V0 = _f32_state(seed=34)
    state = from_jax_state({"X": Xs, "W": Ws, "Y": Ys, "T": T0, "V": V0})
    kw = {**MODEL_KWARGS[model], "model": model}
    ref_w = float(ilrma_loss_sc(*map(jnp.asarray, (Xs, T0, V0)), Ws=jnp.asarray(Ws), **kw))
    ref_y = float(ilrma_loss_sc(*map(jnp.asarray, (Xs, T0, V0)), Ys=jnp.asarray(Ys), **kw))
    got_w = float(ilrma_loss(state["X"], state["T"], state["V"], W=state["W"], **kw))
    got_y = float(ilrma_loss(state["X"], state["T"], state["V"], Y=state["Y"], **kw))
    assert abs(got_w - ref_w) <= 1e-3 * abs(ref_w)
    assert abs(got_y - ref_y) <= 1e-3 * abs(ref_y)


# ---- the fast paths ----------------------------------------------------------------


_FAST_CASES = [
    ("gauss", jax_fast_gauss_ilrma, fast_gauss_ilrma, {}),
    ("gauss_me", jax_fast_gauss_ilrma, fast_gauss_ilrma, {"source_algorithm": "ME"}),
    ("t", jax_fast_t_ilrma, fast_t_ilrma, {"dof": 100}),
    ("ggd", jax_fast_ggd_ilrma, fast_ggd_ilrma, {"beta": 1.5}),
]


@pytest.mark.parametrize("algorithm", ["IP1", "ISS1"])
@pytest.mark.parametrize("name,jax_fn,torch_fn,kwargs", _FAST_CASES, ids=[c[0] for c in _FAST_CASES])
def test_fast_ilrma_matches_jax(name, jax_fn, torch_fn, kwargs, algorithm):
    X = _spectrogram(n_channels=3, n_fft=64, n_frames=40, seed=40)
    assert X.shape == (3, 33, 40)
    common = dict(n_basis=2, n_iter=5, algorithm=algorithm, **kwargs)
    Y_jax, (T_jax, V_jax), W_jax = jax_fn(X, rng=np.random.default_rng(41), **common)
    Y, (T, V), W = torch_fn(X, rng=np.random.default_rng(41), device="cpu", **common)
    assert Y.dtype == torch.complex64 and Y.shape == X.shape
    assert T.dtype == V.dtype == torch.float32
    assert _rel_err(Y.numpy(), Y_jax) <= 1e-3
    assert _rel_err(T.numpy(), T_jax) <= 1e-3 and _rel_err(V.numpy(), V_jax) <= 1e-3
    if algorithm == "IP1":
        assert _rel_err(W.numpy(), W_jax) <= 1e-3
    else:
        assert W is None and W_jax is None


# ---- the class against the JAX class: normalization, warm start, callbacks ---------


@pytest.mark.parametrize("spatial", ["IP1", "ISS1"])
def test_projection_back_normalization_matches_jax_class(spatial):
    X = _spectrogram(seed=50)
    init = _nmf_init(*X.shape, seed=51)
    common = dict(n_basis=2, spatial_algorithm=spatial, normalization="projection_back")
    jax_ilrma = JaxGaussILRMA(impl="complex", **common)
    torch_ilrma = GaussILRMA(device="cpu", **common)
    Y_jax = np.asarray(jax_ilrma(X.copy(), n_iter=3, **init))
    Y = torch_ilrma(torch.from_numpy(X.copy()), n_iter=3, **init)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(torch_ilrma.basis.numpy(), np.asarray(jax_ilrma.basis), rtol=1e-8)
    np.testing.assert_allclose(torch_ilrma.loss, jax_ilrma.loss, rtol=1e-9)


@pytest.mark.parametrize("spatial", ["IP1", "ISS1"])
def test_warm_start_and_callbacks_match_jax_class(spatial):
    X = _spectrogram(seed=52)
    rng = np.random.default_rng(53)
    W0 = np.eye(3)[None] + 0.1 * (rng.standard_normal((33, 3, 3)) + 1j * rng.standard_normal((33, 3, 3)))
    init = {**_nmf_init(*X.shape, seed=54), "demix_filter": W0}
    seen_jax, seen_torch = [], []
    jax_ilrma = JaxGaussILRMA(
        n_basis=2, spatial_algorithm=spatial, impl="complex",
        callbacks=lambda m: seen_jax.append(len(m.loss)),
    )
    torch_ilrma = GaussILRMA(
        n_basis=2, spatial_algorithm=spatial, device="cpu",
        callbacks=lambda m: seen_torch.append(len(m.loss)),
    )
    Y_jax = np.asarray(jax_ilrma(X.copy(), n_iter=3, **init))
    Y = torch_ilrma(torch.from_numpy(X.copy()), n_iter=3, **init)
    assert seen_torch == seen_jax == [1, 2, 3, 4]
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(torch_ilrma.loss, jax_ilrma.loss, rtol=1e-9)
    np.testing.assert_allclose(
        torch_ilrma.activation.numpy(), np.asarray(jax_ilrma.activation), rtol=1e-8
    )


def test_seeded_nmf_init_draws_as_the_jax_class():
    """Without a warm start both classes draw basis, then activation, from the rng."""
    X = _spectrogram(seed=55)
    jax_ilrma = JaxGaussILRMA(n_basis=3, impl="complex", rng=np.random.default_rng(56))
    torch_ilrma = GaussILRMA(n_basis=3, device="cpu", rng=np.random.default_rng(56))
    Y_jax = np.asarray(jax_ilrma(X.copy(), n_iter=2))
    Y = torch_ilrma(torch.from_numpy(X.copy()), n_iter=2)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)


# ---- every path hands the kernels what they take --------------------------------------


def test_every_path_hands_the_kernels_what_they_take(monkeypatch):
    """The kernels' own checks (dtype, shape, contiguity) pass on every path's inputs.

    On the CPU the wrappers take their plain versions before any check, so
    here each wrapper runs its kernel's checks (all but the device) first.
    """
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    checked = {}
    for name, check, plain in (
        ("weighted_covariance", K._check_weighted_covariance, K.weighted_covariance_plain),
        ("ip1_sweep", K._check_ip1_sweep, K.ip1_sweep_plain),
        ("iss1_sweep", K._check_iss1_sweep, K.iss1_sweep_plain),
    ):

        def checking(a, b, eps=None, _name=name, _check=check, _plain=plain):
            _check(a, b)
            checked[_name] = checked.get(_name, 0) + 1
            return _plain(a, b) if eps is None else _plain(a, b, eps)

        monkeypatch.setattr(K, name, checking)

    X = _spectrogram(seed=60).astype(np.complex64)
    Xt = torch.from_numpy(X)
    rng = np.random.default_rng
    for spatial in ("IP1", "ISS1"):
        for cls, kw in ((GaussILRMA, {}), (TILRMA, {"dof": 100}), (GGDILRMA, {"beta": 1.5})):
            cls(n_basis=2, spatial_algorithm=spatial, device="cpu", rng=rng(61), **kw)(Xt, n_iter=2)
        GaussILRMA(
            n_basis=2, spatial_algorithm=spatial, normalization="projection_back", device="cpu", rng=rng(62)
        )(Xt, n_iter=2)
        AuxLaplaceIVA(spatial_algorithm=spatial, device="cpu")(Xt, n_iter=2)
        fast_auxiva(X, n_iter=2, algorithm=spatial, device="cpu")
        fast_gauss_ilrma(X, n_basis=2, n_iter=2, algorithm=spatial, rng=rng(63), device="cpu")
        fast_t_ilrma(X, n_basis=2, dof=100, n_iter=2, algorithm=spatial, rng=rng(64), device="cpu")
        fast_ggd_ilrma(X, n_basis=2, beta=1.5, n_iter=2, algorithm=spatial, rng=rng(65), device="cpu")
    assert set(checked) == {"weighted_covariance", "ip1_sweep", "iss1_sweep"}


# ---- what is not ported, the default device, the pipeline ---------------------------


@pytest.mark.parametrize("algorithm", ["IP2", "ISS2", "IPA"])
def test_unported_ilrma_options_raise(algorithm):
    X, T, V = torch.zeros((2, 3, 4), dtype=torch.complex64), torch.ones((2, 3, 2)), torch.ones((2, 2, 4))
    W = torch.eye(2, dtype=torch.complex64).expand(3, 2, 2)
    if algorithm == "IPA":  # ported since, as the partitioning: Gauss only, and never with demixing filters
        assert GaussILRMA(n_basis=2, spatial_algorithm="IPA", partitioning=True, device="cpu").partitioning
        with pytest.raises(ValueError, match="no IPA"):
            TILRMA(n_basis=2, dof=100, spatial_algorithm="IPA", device="cpu")
        with pytest.raises(ValueError, match="unsupported option"):
            ilrma_ip_step(X, W, T, V, spatial="IPA")
        with pytest.raises(ValueError, match="Gauss"):
            ilrma_iss_step(X, T, V, model="t", dof=100.0, spatial="IPA")
        return
    # ported since: the class and fast_gauss_ilrma run on the CPU and match their JAX twins
    Xs = _spectrogram(seed=66)
    init = {"basis": np.random.default_rng(67).random((3, 33, 2)), "activation": np.random.default_rng(68).random((3, 2, 40))}
    ref = JaxGaussILRMA(n_basis=2, spatial_algorithm=algorithm)
    Y_jax = np.asarray(ref(Xs.copy(), n_iter=3, **init))
    ilrma = GaussILRMA(n_basis=2, spatial_algorithm=algorithm, device="cpu")
    Y = ilrma(torch.from_numpy(Xs.copy()), n_iter=3, **init)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-9)
    np.testing.assert_allclose(ilrma.loss, ref.loss, rtol=1e-9)
    Y_fast_jax = jax_fast_gauss_ilrma(Xs, n_basis=2, n_iter=3, algorithm=algorithm, rng=np.random.default_rng(69))[0]
    Y_fast = fast_gauss_ilrma(Xs, n_basis=2, n_iter=3, algorithm=algorithm, rng=np.random.default_rng(69),
                              device="cpu")[0]
    assert _rel_err(Y_fast.numpy(), Y_fast_jax) <= 1e-3
    # each step takes its own family of spatial updates only
    if algorithm == "IP2":
        assert ilrma_ip_step(X + 1, W, T, V, spatial=algorithm)[0].shape == W.shape
        with pytest.raises(ValueError, match="unsupported option"):
            ilrma_iss_step(X, T, V, spatial=algorithm)
    else:
        assert ilrma_iss_step(X + 1, T, V, spatial=algorithm)[0].shape == X.shape
        with pytest.raises(ValueError, match="unsupported option"):
            ilrma_ip_step(X, W, T, V, spatial=algorithm)


def test_ilrma_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    X = np.zeros((2, 3, 4), np.complex64)
    entry_points = [
        lambda: GaussILRMA(n_basis=2),
        lambda: TILRMA(n_basis=2, dof=100, spatial_algorithm="ISS1"),
        lambda: GGDILRMA(n_basis=2, beta=1.5),
        lambda: fast_gauss_ilrma(X, n_basis=2, n_iter=1),
        lambda: fast_t_ilrma(X, n_basis=2, dof=100, n_iter=1, algorithm="ISS1"),
        lambda: fast_ggd_ilrma(X, n_basis=2, beta=1.5, n_iter=1),
    ]
    if torch.cuda.is_available():
        assert GaussILRMA(n_basis=2).device.type == "cuda"
    else:
        for call in entry_points:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert GaussILRMA(n_basis=2, device="cpu").device == torch.device("cpu")


def test_pipeline_separates_with_demix_free_ilrma():
    x = make_mixture(n_channels=2, duration_s=0.25, seed=57).astype(np.float32)
    method = GaussILRMA(
        n_basis=2, spatial_algorithm="ISS1", device="cpu", rng=np.random.default_rng(58)
    )
    y = torch_separate(torch.from_numpy(x), method, n_iter=3, n_fft=256, device="cpu")
    assert method.demix_filter is None
    assert y.shape == x.shape and y.dtype == torch.float32
    assert torch.isfinite(y).all()
