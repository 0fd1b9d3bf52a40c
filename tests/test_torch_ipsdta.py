"""ssspy_tpu_torch IPSDTA (Gauss and Student's t, MM + VCD) against the JAX package and the fixtures.

Same numpy inputs through the JAX function and its port: the step in
complex128 against the JAX x64 step (``ssspy_tpu.ops.splitc.ipsdta_vcd_step_sc``)
on even and remainder blocks, and once in complex64 against the JAX f32
step; the loss; the VCD sweep with its singular branch; the classes on
``tests/regression/fixtures`` and, with ``source_normalization=False``,
against the JAX complex class; the fast paths against the classes; the
routes of the complex64 paths through the kernels' own checks; the state
bridge. All on the CPU (``device="cpu"``), where the kernel wrappers take
their plain versions; the kernels are held against them on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``. Each JAX run is compiled
once per module (the JAX step takes seconds to compile).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssspy_tpu.bss.ipsdta import GaussIPSDTA as JaxGaussIPSDTA
from ssspy_tpu.ops.splitc import _vcd_sweep_sc, ipsdta_loss_sc, ipsdta_vcd_step_sc
from ssspy_tpu_torch.bss import BlockDecompositionIPSDTABase, GaussIPSDTA, IPSDTABase, TIPSDTA
from ssspy_tpu_torch.fast import fast_gauss_ipsdta, fast_t_ipsdta
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops.ipsdta_steps import (
    ipsdta_loss,
    ipsdta_vcd_step,
    merge_bins,
    normalize_psdtf,
    part_shapes,
    random_psdtf,
    split_bins,
    vcd_covariance,
    vcd_sweep,
)
from ssspy_tpu_torch.utils import from_jax_state, host_stft, make_mixture
from ssspy_tpu_torch.utils.dataset import hard_speech_mixture
from tests.regression.test_regression import _input, _load, _psdtf_init

torch.set_num_threads(1)

N_ITER = 2
# (dof, I, M): tests/ops/test_splitc_ipsdta.py:85-97, two blocks; 8 bins divide, 9 leave a remainder part.
# Two channels: the JAX step unrolls its VCD sweep over bins x sources, and its compile time grows with it.
CASES = {
    "gauss-even": (None, 8, 2),
    "gauss-remainder": (None, 9, 2),
    "t-even": (5.0, 8, 2),
    "t-remainder": (5.0, 9, 2),
}
F32_CASE = "t-remainder"


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _problem(seed, M, I, T_frames=12, K_=2, n_blocks=2):
    """A random mixture, diagonal basis parts and activation (tests/ops/test_splitc_ipsdta.py:23-35)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M, I, T_frames)) + 1j * rng.standard_normal((M, I, T_frames))
    parts = [rng.random((M, K_, B, J))[..., None] * np.eye(J) for B, J in part_shapes(I, n_blocks)]
    V0 = np.maximum(rng.random((M, K_, T_frames)), 1e-10)
    return X, parts, V0


def _run_jax(X, parts, V0, dof, dtype):
    """``N_ITER`` JAX steps and the loss after them; the routes of the port's dtype (see the module)."""
    real = np.float64 if dtype == np.complex128 else np.float32
    impls = dict(psd_impl="eigh", gmean_impl="eigh2") if dtype == np.complex128 else dict(psd_impl="ridge", gmean_impl="chol")
    M, I = X.shape[:2]
    Xs = jnp.asarray(np.stack([X.real, X.imag]).astype(real))
    W0 = np.tile(np.eye(M), (I, 1, 1))
    Ws = jnp.asarray(np.stack([W0, 0 * W0]).astype(real))
    T_parts = [jnp.asarray(np.stack([p.real, p.imag]).astype(real)) for p in parts]
    V = jnp.asarray(V0.astype(real))
    step = jax.jit(functools.partial(ipsdta_vcd_step_sc, dof=dof, inv_impl="gj", **impls))
    for _ in range(N_ITER):
        Ws, T_parts, V = step(Xs, Ws, T_parts, V)
    loss = jax.jit(functools.partial(ipsdta_loss_sc, dof=dof, psd_impl=impls["psd_impl"], inv_impl="gj"))(Xs, Ws, T_parts, V)
    W = np.asarray(Ws[0]) + 1j * np.asarray(Ws[1])
    return W, [np.asarray(p[0]) + 1j * np.asarray(p[1]) for p in T_parts], np.asarray(V), float(loss)


def _run_port(X, parts, V0, dof, dtype):
    real = torch.float64 if dtype == np.complex128 else torch.float32
    M, I = X.shape[:2]
    Xt = torch.from_numpy(X.astype(dtype))
    W = torch.eye(M, dtype=Xt.dtype).expand(I, M, M).clone()
    T_parts = [torch.from_numpy(p.astype(dtype)) for p in parts]
    V = torch.from_numpy(V0).to(real)
    for _ in range(N_ITER):
        W, T_parts, V = ipsdta_vcd_step(Xt, W, T_parts, V, dof=dof)
    loss = ipsdta_loss(Xt, W, T_parts, V, dof=dof)
    assert loss.dim() == 0
    return W.numpy(), [p.numpy() for p in T_parts], V.numpy(), float(loss)


@pytest.fixture(scope="module")
def runs():
    """``{case: (problem, jax result, port result)}``, complex128, and the complex64 case under ``"f32"``."""
    out = {}
    for seed, (case, (dof, I, M)) in enumerate(CASES.items(), start=1):
        problem = _problem(seed, M, I)
        out[case] = (problem, _run_jax(*problem, dof, np.complex128), _run_port(*problem, dof, np.complex128))
    problem = out[F32_CASE][0]
    dof = CASES[F32_CASE][0]
    out["f32"] = (problem, _run_jax(*problem, dof, np.complex64), _run_port(*problem, dof, np.complex64))
    return out


# ---- the step and the loss against the JAX step --------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_x64(runs, case):
    _, (W_ref, T_ref, V_ref, _), (W, T_parts, V, _) = runs[case]
    assert len(T_parts) == len(T_ref) == (2 if case.endswith("remainder") else 1)
    np.testing.assert_allclose(W, W_ref, atol=1e-8)
    np.testing.assert_allclose(V, V_ref, atol=1e-8)
    for got, want in zip(T_parts, T_ref):
        np.testing.assert_allclose(got, want, atol=1e-8)


def test_step_matches_jax_f32(runs):
    """complex64 (ridge model, Cholesky geometric mean, K3's plain version) against the JAX f32 step on the same routes.

    Each side sums its products in another order, over two iterations of
    multiplicative updates and a VCD sweep: measured 1.5e-6 to 3e-6
    relative to each tensor's largest entry; held at 1e-4.
    """
    _, (W_ref, T_ref, V_ref, _), (W, T_parts, V, _) = runs["f32"]
    assert W.dtype == np.complex64 and V.dtype == np.float32
    assert _rel_err(W, W_ref) <= 1e-4 and _rel_err(V, V_ref) <= 1e-4
    for got, want in zip(T_parts, T_ref):
        assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("case", list(CASES) + ["f32"])
def test_loss_matches_jax(runs, case):
    """The loss after the steps: complex128 at 1e-10 relative, complex64 at 1e-5 (f32 sums of T terms)."""
    _, (*_, loss_ref), (*_, loss) = runs[case]
    assert abs(loss - loss_ref) <= (1e-5 if case == "f32" else 1e-10) * abs(loss_ref)


@pytest.mark.parametrize("J", [1, 3])
def test_vcd_sweep_matches_jax_and_its_singular_branch(J):
    """The sweep against ``splitc._vcd_sweep_sc`` in float64; at ``J = 1`` no other bin feeds ``g``, ``xi_hat = 0``,
    and every update takes the singular branch ``c = 1 / sqrt(xi)``."""
    rng = np.random.default_rng(50 + J)
    B, M, T = 2, 3, 20
    X = rng.standard_normal((M, B, J, T)) + 1j * rng.standard_normal((M, B, J, T))
    A = rng.standard_normal((M, T, B, J, J)) + 1j * rng.standard_normal((M, T, B, J, J))
    R_inv = A @ A.conj().swapaxes(-1, -2) + np.eye(J)
    RXX = vcd_covariance(torch.from_numpy(R_inv), torch.from_numpy(X))
    W0 = np.eye(M) + 0.1 * (rng.standard_normal((B, J, M, M)) + 1j * rng.standard_normal((B, J, M, M)))
    got = vcd_sweep(torch.from_numpy(W0), RXX).numpy()
    # the JAX package's einsum of the same covariance (splitc.py:3577-3596)
    RXX_ref = np.einsum("ntbji,pbit,qbjt->bijnpq", R_inv, X, X.conj()) / T
    np.testing.assert_allclose(RXX.numpy(), RXX_ref, atol=1e-12 * np.abs(RXX_ref).max())
    ref = _vcd_sweep_sc(jnp.asarray(W0.real), jnp.asarray(W0.imag), jnp.asarray(RXX_ref.real), jnp.asarray(RXX_ref.imag))
    np.testing.assert_allclose(got, np.asarray(ref[0]) + 1j * np.asarray(ref[1]), atol=1e-10)
    if J == 1:
        # the singular branch normalizes each row: w^H U w = 1
        U = RXX.numpy()[:, 0, 0]
        w = got[:, 0].conj()
        quad = np.einsum("bnm,bnmp,bnp->bn", w.conj(), U, w)
        np.testing.assert_allclose(quad, 1.0, atol=1e-10)


def test_a_silent_bin_stays_finite():
    """A bin with x = 0 makes its VCD solves singular: its filters keep their value and every other value stays finite.

    The JAX step on the CPU (``solve`` of the real embedding) turns every
    filter non-finite in that case; the port freezes the row, as its IP1
    sweep does.
    """
    X, parts, V0 = _problem(5, 2, 8)
    X[:, 3] = 0
    for dtype in (np.complex128, np.complex64):
        Xt = torch.from_numpy(X.astype(dtype))
        W = torch.eye(2, dtype=Xt.dtype).expand(8, 2, 2).clone()
        state = (W, [torch.from_numpy(p.astype(dtype)) for p in parts], torch.from_numpy(V0).to(Xt.real.dtype))
        for _ in range(3):
            state = ipsdta_vcd_step(Xt, *state)
        W, T_parts, V = state
        for t in (W, *T_parts, V):
            assert torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all()
        assert torch.equal(W[3], torch.eye(2, dtype=W.dtype))
        assert not torch.equal(W[2], torch.eye(2, dtype=W.dtype))
        assert np.isfinite(float(ipsdta_loss(Xt, W, T_parts, V)))


def test_part_shapes_split_and_merge():
    assert part_shapes(257, 64) == [(63, 4), (1, 5)]
    assert part_shapes(257, 16) == [(15, 16), (1, 17)]
    assert part_shapes(129, 4) == [(3, 32), (1, 33)]
    assert part_shapes(8, 2) == [(2, 4)]
    A = torch.arange(2 * 9 * 3).reshape(2, 9, 3)
    parts = split_bins(A, 1, part_shapes(9, 2))
    assert [tuple(p.shape) for p in parts] == [(2, 1, 4, 3), (2, 1, 5, 3)]
    assert torch.equal(merge_bins(parts, 1), A)


# ---- the classes ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls,kwargs,name", [(GaussIPSDTA, {}, "gauss_ipsdta_vcd"), (TIPSDTA, {"dof": 1000}, "t_ipsdta_vcd")])
def test_class_matches_regression_fixture(cls, kwargs, name):
    """tests/regression/test_regression.py:162-168, 316-322 on the port, complex128, atol 1e-7 (measured ~6e-14).

    4 blocks of the fixture's 129 bins: J = 32 and a remainder part of 33.
    """
    X = _input()
    ipsdta = cls(n_basis=2, n_blocks=4, device="cpu", **kwargs)
    Y = ipsdta(X.copy(), n_iter=3, **_psdtf_init(*X.shape))
    target = _load(name)
    assert Y.dtype == torch.complex128 and tuple(Y.shape) == target.shape
    np.testing.assert_allclose(Y.numpy(), target, atol=1e-7)
    assert isinstance(ipsdta.basis, tuple) and [tuple(p.shape[-2:]) for p in ipsdta.basis] == [(32, 32), (33, 33)]
    assert ipsdta.n_remains == 1 and len(ipsdta.loss) == 4 and ipsdta.loss[-1] < ipsdta.loss[0]


def test_source_normalization_false_matches_the_jax_complex_class():
    """Without the unit-trace normalization (which the JAX split-complex engine cannot run), against the JAX complex class."""
    X, parts, V0 = _problem(7, 2, 9)
    kw = dict(n_basis=2, n_blocks=2, source_normalization=False, scale_restoration=False)
    ref = JaxGaussIPSDTA(impl="complex", **kw)
    Y_ref = np.asarray(ref(X.copy(), n_iter=N_ITER, basis=tuple(p.astype(complex) for p in parts), activation=V0.copy()))
    got = GaussIPSDTA(device="cpu", **kw)
    Y = got(X.copy(), n_iter=N_ITER, basis=tuple(p.astype(complex) for p in parts), activation=V0.copy())
    np.testing.assert_allclose(Y.numpy(), Y_ref, atol=1e-8)
    np.testing.assert_allclose(got.activation.numpy(), np.asarray(ref.activation), atol=1e-8)
    np.testing.assert_allclose(got.loss, np.asarray(ref.loss), rtol=1e-10)
    # the basis is left unnormalized: the traces differ from one
    trace = sum(p.diagonal(dim1=-2, dim2=-1).real.sum(dim=(-2, -1)) for p in got.basis)
    assert float((trace - 1).abs().max()) > 1e-3


def test_class_attributes_warm_start_and_what_raises():
    X, parts, V0 = _problem(8, 2, 9)
    ipsdta = GaussIPSDTA(n_basis=2, n_blocks=2, rng=np.random.default_rng(3), device="cpu")
    assert isinstance(ipsdta, BlockDecompositionIPSDTABase) and isinstance(ipsdta, IPSDTABase)
    with pytest.raises(AttributeError, match="n_remains"):
        ipsdta.n_remains
    Y = ipsdta(X, n_iter=2)
    assert ipsdta.n_remains == 1 and len(ipsdta.basis) == 2 and ipsdta.activation.shape == (2, 2, 12)
    assert ipsdta.demix_filter.shape == (9, 2, 2) and Y.shape == X.shape
    R = ipsdta.reconstruct_block_decomposition_psdtf(ipsdta.basis, ipsdta.activation)
    assert [tuple(r.shape) for r in R] == [(2, 12, 1, 4, 4), (2, 12, 1, 5, 5)]
    assert torch.linalg.eigvalsh(R[1]).min() >= 1e-10 * (1 - 1e-6)
    ipsdta.normalize_block_decomposition_psdtf()
    trace = sum(p.diagonal(dim1=-2, dim2=-1).real.sum(dim=(-2, -1)) for p in ipsdta.basis)
    np.testing.assert_allclose(trace.numpy(), 1.0, rtol=1e-12)
    # a warm start from the committed state continues the same trajectory
    cont = GaussIPSDTA(n_basis=2, n_blocks=2, scale_restoration=False, device="cpu")
    straight = GaussIPSDTA(n_basis=2, n_blocks=2, scale_restoration=False, device="cpu")
    straight(X, n_iter=3, basis=tuple(torch.from_numpy(p.astype(complex)) for p in parts), activation=V0)
    cont(X, n_iter=1, basis=tuple(torch.from_numpy(p.astype(complex)) for p in parts), activation=V0)
    cont2 = GaussIPSDTA(n_basis=2, n_blocks=2, scale_restoration=False, device="cpu")
    Y2 = cont2(X, n_iter=2, basis=cont.basis, activation=cont.activation, demix_filter=cont.demix_filter)
    # the normalization of the start is the identity on an already normalized basis, up to rounding
    np.testing.assert_allclose(Y2.numpy(), straight.output.numpy(), atol=1e-9)
    # one part when the blocks divide the bins
    even = TIPSDTA(n_basis=2, n_blocks=2, dof=5, rng=np.random.default_rng(3), device="cpu")
    even(X[:, :8], n_iter=1)
    assert isinstance(even.basis, torch.Tensor) and even.basis.shape == (2, 2, 2, 4, 4) and even.n_remains == 0
    assert "TIPSDTA(" in repr(even) and "dof=5.0" in repr(even)
    for algorithms, error in (
        (dict(source_algorithm="EM"), NotImplementedError),
        (dict(spatial_algorithm="FPI"), NotImplementedError),
        (dict(source_algorithm="ME"), ValueError),
        (dict(spatial_algorithm="IP1"), ValueError),
    ):
        with pytest.raises(error):
            GaussIPSDTA(n_basis=2, n_blocks=2, device="cpu", **algorithms)(X, n_iter=1)
    with pytest.raises(ValueError, match="reference_id"):
        TIPSDTA(n_basis=2, n_blocks=2, dof=5, reference_id=None, device="cpu")


def test_fast_paths_match_the_classes():
    """``fast_gauss_ipsdta`` and ``fast_t_ipsdta`` run the classes' step from the same draws: bit for bit in complex64."""
    X, _, _ = _problem(9, 3, 9)
    for fast, cls, kw in ((fast_gauss_ipsdta, GaussIPSDTA, {}), (fast_t_ipsdta, TIPSDTA, {"dof": 5.0})):
        Y, (T_parts, V), W = fast(X, n_basis=2, n_blocks=2, n_iter=3, rng=np.random.default_rng(4), device="cpu", **kw)
        assert Y.dtype == torch.complex64 and Y.shape == X.shape and W.shape == (9, 3, 3)
        assert isinstance(T_parts, list) and [tuple(p.shape) for p in T_parts] == [(3, 2, 1, 4, 4), (3, 2, 1, 5, 5)]
        method = cls(n_basis=2, n_blocks=2, rng=np.random.default_rng(4), record_loss=False, device="cpu", **kw)
        Y_cls = method(torch.from_numpy(X.astype(np.complex64)), n_iter=3)
        assert torch.equal(V, method.activation)
        for a, b in zip(T_parts, method.basis):
            assert torch.equal(a, b)
        np.testing.assert_allclose(Y.numpy(), Y_cls.numpy(), atol=1e-6 * float(Y_cls.abs().max()))
        Y_raw, _, W_raw = fast(X, n_basis=2, n_blocks=2, n_iter=3, rng=np.random.default_rng(4), device="cpu",
                               scale_restoration=False, **kw)
        assert not torch.equal(W_raw, W)


def test_state_bridge_takes_the_ipsdta_basis():
    """``T_parts`` by key: the JAX fast path's planar parts and the class's complex parts; ``T`` stays real."""
    rng = np.random.default_rng(60)
    parts = [rng.standard_normal(shape).astype(np.float32) for shape in ((2, 2, 2, 3, 4, 4), (2, 2, 2, 1, 5, 5))]
    state = from_jax_state({"T_parts": parts, "V": rng.random((2, 2, 7))})
    assert [t.dtype for t in state["T_parts"]] == [torch.complex64, torch.complex64]
    assert [tuple(t.shape) for t in state["T_parts"]] == [(2, 2, 3, 4, 4), (2, 2, 1, 5, 5)]
    np.testing.assert_array_equal(state["T_parts"][1].imag.numpy(), parts[1][1])
    complex_parts = [p[0] + 1j * p[1].astype(np.float64) for p in parts]
    state = from_jax_state({"T_parts": tuple(complex_parts)})
    assert state["T_parts"][0].dtype == torch.complex128
    X, parts, V0 = _problem(10, 2, 9)
    # a JAX class state round trip runs the port's step
    Xt = torch.from_numpy(X)
    W = torch.eye(2, dtype=Xt.dtype).expand(9, 2, 2).clone()
    bridged = from_jax_state({"X": X, "W": W.numpy(), "T_parts": [p.astype(complex) for p in parts], "V": V0})
    W1, T1, V1 = ipsdta_vcd_step(bridged["X"], bridged["W"], bridged["T_parts"], bridged["V"])
    assert W1.shape == (9, 2, 2) and [p.shape for p in T1] == [p.shape for p in parts]
    with pytest.raises(ValueError, match="real"):
        from_jax_state({"T": complex_parts[0]})
    with pytest.raises(ValueError, match="list of parts"):
        from_jax_state({"T_parts": parts[0]})


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is driven by chip_smoke.py")
    X, _, _ = _problem(11, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussIPSDTA(n_basis=2, n_blocks=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast_t_ipsdta(X, n_basis=2, n_blocks=2, dof=5, n_iter=1)


# ---- the complex64 paths through the kernels' own checks -------------------------------------


@pytest.fixture
def checked(monkeypatch):
    """Each kernel wrapper runs its kernel's checks (all but the device's) before its plain version, and counts."""
    monkeypatch.setattr(K, "_check_cuda", lambda name, *tensors: None)
    counts = {}
    for name, check, plain in (
        ("gj_inverse", K._check_gj_inverse, K.gj_inverse_plain),
        ("jacobi_eigh", K._check_jacobi_eigh, K.jacobi_eigh_plain),
    ):

        def wrapper(A, *args, _name=name, _check=check, _plain=plain):
            _check(A)
            counts.setdefault(_name, []).append(A.shape[-1])
            return _plain(A, *args)

        monkeypatch.setattr(K, name, wrapper)
    return counts


@pytest.mark.parametrize("model", ["gauss", "t"])
def test_complex64_paths_hand_the_kernels_what_they_take(checked, model):
    """K3 three times per part and iteration; K7 once per part (Gauss, the geometric mean) or twice (t, Q^1/2 and M^-1/2).

    The class's loss launches no kernel.
    """
    X, _, _ = _problem(12, 3, 9)
    n_iter = 2
    fast = fast_gauss_ipsdta if model == "gauss" else functools.partial(fast_t_ipsdta, dof=5)
    fast(X, n_basis=2, n_blocks=2, n_iter=n_iter, rng=np.random.default_rng(5), device="cpu")
    per_part = 1 if model == "gauss" else 2
    assert sorted(checked["gj_inverse"]) == sorted([4, 5] * 3 * n_iter)
    assert sorted(checked["jacobi_eigh"]) == sorted([8, 10] * per_part * n_iter)
    checked.clear()
    cls = GaussIPSDTA if model == "gauss" else functools.partial(TIPSDTA, dof=5)
    cls(n_basis=2, n_blocks=2, rng=np.random.default_rng(5), device="cpu")(X.astype(np.complex64), n_iter=n_iter)
    assert len(checked["gj_inverse"]) == 2 * 3 * n_iter and len(checked["jacobi_eigh"]) == 2 * per_part * n_iter


def test_hard_tier_block_sizes_take_k3_at_17_and_torch_eigh_at_34(checked):
    """The hard tier's 16 blocks of 257 bins give J = 16 and 17 (tests/test_hard_fidelity.py:371-377).

    Here 33 bins in 2 blocks give the same two sizes: K3 takes both, K7
    the 32 x 32 embedding, and the 34 x 34 one goes to ``torch.linalg.eigh``.
    """
    X, _, _ = _problem(13, 2, 33, T_frames=20)
    Y, (T_parts, V), _ = fast_gauss_ipsdta(X, n_basis=2, n_blocks=2, n_iter=1, rng=np.random.default_rng(6), device="cpu")
    assert [tuple(p.shape[-2:]) for p in T_parts] == [(16, 16), (17, 17)]
    assert sorted(set(checked["gj_inverse"])) == [16, 17] and len(checked["gj_inverse"]) == 6
    assert checked["jacobi_eigh"] == [32]
    assert torch.isfinite(torch.view_as_real(Y)).all() and torch.isfinite(V).all()


def test_t_step_stays_finite_in_complex64_on_the_ridge_model():
    """``fast_t_ipsdta``'s route on a 0.6 s cut of the 8-channel mixture (64 blocks, ``dof = 1000``).

    Here the JAX float32 step on its ridge model goes non-finite at the
    second iteration: its inverse square root turns the rounding of ``M``
    below zero into ``1 / eps``. The port floors the eigenvalues instead
    (``ipsdta_steps._basis_update``) and follows the complex128 run.
    """
    X = host_stft(make_mixture(seed=0, duration_s=0.6))
    losses = {}
    for dtype in (np.complex64, np.complex128):
        Xt = torch.from_numpy(X.astype(dtype))
        M, I, T = Xt.shape
        T_parts, V = random_psdtf(np.random.default_rng(0), M, 8, T, part_shapes(I, 64), Xt.dtype, "cpu", 1e-10)
        state = (torch.eye(M, dtype=Xt.dtype).expand(I, M, M).clone(), *normalize_psdtf(T_parts, V))
        losses[dtype] = []
        for _ in range(3):
            state = ipsdta_vcd_step(Xt, *state, dof=1000.0)
            losses[dtype].append(float(ipsdta_loss(Xt, *state, dof=1000.0)))
    assert all(np.isfinite(losses[np.complex64])) and losses[np.complex64][-1] < losses[np.complex64][0]
    np.testing.assert_allclose(losses[np.complex64], losses[np.complex128], rtol=1e-5)


def test_hard_scenario_copy_matches_the_jax_package(tmp_path):
    """The port's copy of the hard scenario's generator draws the same waveforms (1 s here; chip_smoke runs 10 s)."""
    from ssspy_tpu.utils.dataset import hard_speech_mixture as jax_hard_speech_mixture

    got, rate = hard_speech_mixture(duration=1.0)
    want, want_rate = jax_hard_speech_mixture(duration=1.0, cache_dir=str(tmp_path))
    assert rate == want_rate == 16000 and got.shape == (4, 4, 16000)
    np.testing.assert_array_equal(got, want)
